"""ctypes binding of the native FLAC decoder (``zebra_flac.cpp``, the port's
own copy of the JAX package's source).

Built with ``g++`` at first use into ``zebra_tpu_torch/_build/`` through
:func:`zebra_tpu_torch.native.build_library`; nothing is built at import. The
audio model calls :func:`decode_flac` for ``fLaC``-magic payloads and falls
through to the next decoder when there is no toolchain or the stream is
corrupt.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from zebra_tpu_torch.native import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zebra_flac.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    """The loaded decoder library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        built = build_library(_SRC, "zebra_flac", (["-O2"],))
        if built is None:
            return None
        lib = ctypes.CDLL(built[0])
        lib.zf_decode.restype = ctypes.c_int
        lib.zf_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.zf_free.restype = None
        lib.zf_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the decoder builds and loads here."""
    return get_lib() is not None


def decode_flac_raw(data: bytes) -> tuple[np.ndarray, int, int, int]:
    """Decode FLAC bytes to raw integer PCM: ``(samples [n, channels] int32,
    rate, channels, bits per sample)``. Raises ValueError on non-FLAC input,
    corrupt streams (CRC failures included) or without the native toolchain."""
    lib = get_lib()
    if lib is None:
        raise ValueError("native FLAC decoder unavailable (no g++ toolchain)")
    out = ctypes.POINTER(ctypes.c_int32)()
    nsamples = ctypes.c_uint64()
    channels = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    bps = ctypes.c_uint32()
    rc = lib.zf_decode(data, len(data), ctypes.byref(out), ctypes.byref(nsamples),
                       ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (rc={rc})")
    try:
        n = int(nsamples.value) * int(channels.value)
        arr = np.ctypeslib.as_array(out, shape=(n,)).astype(np.int32)
    finally:
        lib.zf_free(out)
    return arr.reshape(-1, int(channels.value)), int(rate.value), int(channels.value), int(bps.value)


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode FLAC bytes to (mono float32 samples in [-1, 1], sample rate)."""
    pcm, rate, _channels, bps = decode_flac_raw(data)
    arr = pcm.astype(np.float32) / float(2 ** (bps - 1))
    return arr.mean(axis=1), rate
