"""System-codec bindings: mp3 via libmpg123, ogg-vorbis via libvorbisfile
(the port's own copy of ``zebra_tpu/native/codecs.py``, unchanged below).

The reference decodes every compressed codec natively through the symphonia
crate (its ``src/model/audio.rs:35-75``). Our chain: stdlib
containers + the in-tree C++ FLAC decoder handle the lossless formats;
this module covers the two ubiquitous lossy ones by binding the system
codec libraries over ctypes — true sample rates, float output, no Python
package dependencies. ``soundfile``/``pygame`` remain later fallbacks in
``models/audio.py`` for exotic codecs or systems without these libs.

Both decoders read from a temp file: the file-path entry points
(``mpg123_open`` / ``ov_fopen``) avoid re-plumbing the C callback-reader
APIs through ctypes, and the bytes are already fully in memory anyway.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import tempfile

import numpy as np

# -- libmpg123 (mp3) ---------------------------------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_ENC_FLOAT_32 = 0x200


@functools.lru_cache(maxsize=1)
def _libmpg123():
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    try:
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
    except AttributeError:
        return None
    # mpg123_init is a no-op since 1.27 but required before that; call it
    # when present and ignore failure.
    try:
        lib.mpg123_init()
    except Exception:
        pass
    return lib


def looks_like_mp3(data: bytes) -> bool:
    """Cheap sniff: ID3v2 tag or an MPEG *audio* frame sync at offset 0.
    The layer bits must be nonzero — ADTS/AAC shares the 0xFFFx sync but
    sets layer=00 (reserved in MPEG audio), and mpg123 will happily decode
    an ADTS stream into garbage if we let it (caught by
    ``tests/test_codecs.py::test_audio_to_data_decodes_aac_and_opus``)."""
    if data[:3] == b"ID3":
        return True
    return (
        len(data) >= 2
        and data[0] == 0xFF
        and (data[1] & 0xE0) == 0xE0
        and (data[1] >> 1) & 0x3 != 0  # layer I/II/III, not ADTS's 00
    )


def decode_mp3(data: bytes) -> tuple[np.ndarray, int] | None:
    """mp3 bytes -> (mono float32 samples, true sample rate), or None when
    libmpg123 is unavailable or the stream yields no audio."""
    lib = _libmpg123()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        return None
    tmp = None
    try:
        with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
            f.write(data)
            tmp = f.name
        # force float32 output at whatever native rate the stream declares
        lib.mpg123_format_none(h)
        for rate in (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000):
            lib.mpg123_format(h, rate, 3, _MPG123_ENC_FLOAT_32)  # 3 = mono|stereo
        if lib.mpg123_open(h, tmp.encode()) != _MPG123_OK:
            return None
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(enc)) != _MPG123_OK:
            return None
        if enc.value != _MPG123_ENC_FLOAT_32 or channels.value <= 0:
            return None
        chunks = []
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf, np.float32,
                                            count=done.value // 4).copy())
            if rc == _MPG123_DONE:
                break
            if rc == -11:  # MPG123_NEW_FORMAT — format announcement, benign
                continue
            if rc != _MPG123_OK:
                break  # stream error — keep whatever decoded so far
        if not chunks:
            return None
        samples = np.concatenate(chunks)
        if channels.value > 1:
            samples = samples.reshape(-1, channels.value).mean(axis=1)
        if not len(samples):
            return None
        return samples, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
        if tmp is not None:
            os.unlink(tmp)


# -- libvorbisfile (ogg-vorbis) ----------------------------------------------

#: sizeof(OggVorbis_File) is ~944 bytes on x86-64; allocate with a wide
#: margin since we only ever treat it as an opaque blob.
_OV_FILE_BYTES = 4096


class _VorbisInfo(ctypes.Structure):
    # leading fields of vorbis_info (codec.h) — enough for rate/channels
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


@functools.lru_cache(maxsize=1)
def _libvorbisfile():
    name = ctypes.util.find_library("vorbisfile") or "libvorbisfile.so.3"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    try:
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_clear.argtypes = [ctypes.c_void_p]
    except AttributeError:
        return None
    return lib


def looks_like_ogg(data: bytes) -> bool:
    return data[:4] == b"OggS"


def decode_ogg(data: bytes) -> tuple[np.ndarray, int] | None:
    """ogg-vorbis bytes -> (mono float32 samples, true sample rate), or None
    when libvorbisfile is unavailable or the stream isn't vorbis (e.g.
    ogg-opus — falls through to soundfile/SDL_mixer in the caller)."""
    lib = _libvorbisfile()
    if lib is None:
        return None
    vf = (ctypes.c_char * _OV_FILE_BYTES)()
    tmp = None
    opened = False
    try:
        with tempfile.NamedTemporaryFile(suffix=".ogg", delete=False) as f:
            f.write(data)
            tmp = f.name
        if lib.ov_fopen(tmp.encode(), vf) != 0:
            return None
        opened = True
        info = lib.ov_info(vf, -1)
        if not info:
            return None
        channels, rate = info.contents.channels, int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            return None
        chunks = []
        buf = (ctypes.c_char * (1 << 16))()
        section = ctypes.c_int(0)
        while True:
            # signed 16-bit little-endian PCM, interleaved
            n = lib.ov_read(vf, buf, len(buf), 0, 2, 1, ctypes.byref(section))
            if n <= 0:  # 0 = EOF; negative = hole/bad link — stop either way
                break
            chunks.append(np.frombuffer(buf, np.int16, count=n // 2).copy())
        if not chunks:
            return None
        pcm = np.concatenate(chunks).astype(np.float32) / 32768.0
        if channels > 1:
            pcm = pcm.reshape(-1, channels).mean(axis=1)
        return pcm, rate
    finally:
        if opened:
            lib.ov_clear(vf)
        if tmp is not None:
            os.unlink(tmp)
