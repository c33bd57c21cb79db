"""Host C++ kernels of the torch port, built with ``g++`` at first use
(the port's own copies of the JAX package's ``native/`` sources)."""
