"""ctypes binding of the ffmpeg catch-all decoder (``zebra_av.cpp``, the
port's own copy of the JAX package's source).

Built with ``g++`` at first use into ``zebra_tpu_torch/_build/`` against the
system ffmpeg development libraries (libavformat, libavcodec, libswresample,
libavutil). Where their headers or libraries are absent the build fails,
:func:`available` is False and :func:`decode_any` returns None, as in the
JAX package: the audio model's decode chain then goes on to its last
resorts. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading

import numpy as np

from zebra_tpu_torch.native import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zebra_av.cpp")
_FFLIBS = ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")

_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    """The loaded decoder library, or None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        built = build_library(_SRC, "zebra_av", (["-O2"],), link=_FFLIBS)
        if built is None:
            return None
        try:
            lib = ctypes.CDLL(built[0])
        except OSError:  # built elsewhere, runtime libraries missing here
            return None
        lib.za_decode.restype = ctypes.c_int
        lib.za_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.za_encode_test.restype = ctypes.c_int
        lib.za_encode_test.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ]
        lib.za_free.restype = None
        lib.za_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the shim builds and loads here."""
    return get_lib() is not None


def decode_any(data: bytes) -> tuple[np.ndarray, int] | None:
    """Audio bytes (any ffmpeg-supported codec) -> (mono float32 samples,
    native sample rate), or None when ffmpeg is unavailable or the bytes are
    not decodable audio."""
    lib = get_lib()
    if lib is None:
        return None
    tmp = None
    try:
        with tempfile.NamedTemporaryFile(delete=False) as f:
            f.write(data)
            tmp = f.name
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_longlong(0)
        rate = ctypes.c_int(0)
        rc = lib.za_decode(tmp.encode(), ctypes.byref(out), ctypes.byref(n), ctypes.byref(rate))
        if rc != 0 or n.value <= 0 or rate.value <= 0:
            return None
        try:
            samples = np.ctypeslib.as_array(out, shape=(n.value,)).astype(np.float32, copy=True)
        finally:
            lib.za_free(out)
        return samples, int(rate.value)
    finally:
        if tmp is not None:
            os.unlink(tmp)


def encode_test_tone(codec: str, container: str, rate: int = 44100,
                     n: int = 44100, freq: float = 440.0) -> bytes | None:
    """For tests: a sine of ``n`` samples encoded with the named ffmpeg codec
    and container, as file bytes, or None where the shim or that encoder is
    unavailable. Exercises decode paths with no sample files on disk."""
    lib = get_lib()
    if lib is None:
        return None
    with tempfile.NamedTemporaryFile(delete=False) as f:
        tmp = f.name
    try:
        rc = lib.za_encode_test(tmp.encode(), codec.encode(), container.encode(), rate, n, freq)
        if rc != 0:
            return None
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)
