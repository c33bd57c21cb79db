"""Audio embedding: decode -> log-frequency spectrogram image -> ViT tower
(the port of ``zebra_tpu/models/audio.py``).

The host decodes each document to mono f32 samples (:func:`audio_to_data`:
WAV, AIFF / AIFC and AU through the standard library, FLAC through the
in-tree C++ decoder, mp3 and ogg-vorbis through the system libmpg123 /
libvorbisfile, anything else through the ffmpeg shim, then ``soundfile`` and
``pygame`` as last resorts). The spectrogram runs on the model's device as
torch ops: 224 Hann-windowed frames of 1024 samples over the zero-padded 30
s buffer, ``torch.fft.rfft`` magnitudes (taken in f64, so the card and the
CPU agree to 1e-5; the JAX package's f32 transform is within 5e-6 of
them on the CPU), a log-frequency resample of the 512
bins to 224, ``log1p``, each spectrogram scaled by its own minimum and
maximum, flipped so low frequencies sit at the bottom; that image, as three
ImageNet-normalised channels, goes through the shared ViT tower. Every batch
is padded to ``batch_size`` clips, so a clip embeds to bitwise the same
vector in any batch and at any row.
"""

from __future__ import annotations

import functools
import io
import wave

import numpy as np
import torch

from zebra_tpu_torch.models.base import upload
from zebra_tpu_torch.models.image import IMAGENET_MEAN, IMAGENET_STD, VitTowerModel
from zebra_tpu_torch.models.vit import IMAGE_SIZE

N_FFT = 1024  # 512 frequency bins, the reference's 512-bin sonogram
TARGET_FRAMES = IMAGE_SIZE
TARGET_BINS = IMAGE_SIZE
MAX_SAMPLES = 16000 * 30  # 30 s at 16 kHz: every clip is cut or padded to this


def _pcm_to_float(raw: bytes, width: int, channels: int, big_endian: bool) -> np.ndarray:
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
    if dtype is None:
        raise ValueError(f"unsupported PCM sample width {width}")
    arr = np.frombuffer(raw, dtype=dtype)
    if big_endian and width > 1:
        arr = arr.byteswap()
    samples = arr.astype(np.float32)
    if width == 1:
        samples = (samples - 128.0) / 128.0
    else:
        samples = samples / float(2 ** (8 * width - 1))
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1)
    return samples


def _stdlib_module(name: str):
    """``aifc`` / ``sunau``, deprecated in Python 3.11 and removed in 3.13
    (None there: the chain goes on to soundfile)."""
    import importlib
    import warnings

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return importlib.import_module(name)
    except ImportError:
        return None


def audio_to_data(data: bytes) -> tuple[np.ndarray, int]:
    """Decode audio bytes to mono float32 samples and their sample rate, by
    the JAX package's chain: WAV, AIFF / AIFC, AU / SND, FLAC (native), ogg
    (libvorbisfile), mp3 (libmpg123), the ffmpeg shim, soundfile, pygame."""
    try:
        with wave.open(io.BytesIO(data)) as w:
            raw = w.readframes(w.getnframes())
            return _pcm_to_float(raw, w.getsampwidth(), w.getnchannels(), False), w.getframerate()
    except wave.Error:
        pass
    if data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC"):
        aifc = _stdlib_module("aifc")
        if aifc is not None:
            with aifc.open(io.BytesIO(data)) as a:
                raw = a.readframes(a.getnframes())
                # uncompressed (and 'sowt', which aifc byteswaps on read) PCM
                # arrives big-endian; ulaw / alaw decode to native-endian
                be = a.getcomptype() in (b"NONE", b"sowt")
                return (_pcm_to_float(raw, a.getsampwidth(), a.getnchannels(), be),
                        int(a.getframerate()))
    if data[:4] == b".snd":
        sunau = _stdlib_module("sunau")
        if sunau is not None:
            with sunau.open(io.BytesIO(data)) as a:
                raw = a.readframes(a.getnframes())
                # uncompressed AU PCM is big-endian; mu-law decodes native-endian
                be = a.getcomptype() == "NONE"
                return (_pcm_to_float(raw, a.getsampwidth(), a.getnchannels(), be),
                        int(a.getframerate()))
    if data[:4] == b"fLaC":
        from zebra_tpu_torch.native.flac import decode_flac

        try:
            return decode_flac(data)
        except ValueError:
            pass  # corrupt stream or no toolchain: the next decoders
    from zebra_tpu_torch.native import codecs

    if codecs.looks_like_ogg(data):
        decoded = codecs.decode_ogg(data)
        if decoded is not None:
            return decoded
    if codecs.looks_like_mp3(data):
        decoded = codecs.decode_mp3(data)
        if decoded is not None:
            return decoded
    from zebra_tpu_torch.native import av

    decoded = av.decode_any(data)
    if decoded is not None:
        return decoded
    try:
        import soundfile as sf
    except ImportError:
        sf = None
    if sf is not None:
        samples, rate = sf.read(io.BytesIO(data), dtype="float32", always_2d=True)
        return samples.mean(axis=1), int(rate)
    decoded = _decode_via_sdl_mixer(data)
    if decoded is not None:
        return decoded
    raise ValueError(
        "unsupported audio container (WAV/AIFF/AU/FLAC natively; mp3/ogg "
        "via system libmpg123/libvorbisfile; install `soundfile` or "
        "`pygame` for other compressed codecs)"
    )


_SDL_MIXER_RATE = 44100


def _decode_via_sdl_mixer(data: bytes) -> tuple[np.ndarray, int] | None:
    """mp3 / ogg-vorbis through SDL_mixer (bundled with ``pygame``), which
    resamples every stream to its mixer rate; None without pygame or for
    bytes SDL_mixer does not take."""
    import os

    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")  # decode only, headless
    try:
        import pygame
        import pygame.sndarray
    except ImportError:
        return None
    if not pygame.mixer.get_init():
        try:
            pygame.mixer.init(frequency=_SDL_MIXER_RATE, size=-16, channels=2)
        except pygame.error:
            return None
    try:
        snd = pygame.mixer.Sound(io.BytesIO(data))
    except pygame.error:
        return None
    samples = pygame.sndarray.array(snd).astype(np.float32) / 32768.0
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    return samples, int(pygame.mixer.get_init()[0])


@functools.lru_cache(maxsize=None)
def _spectrogram_constants(device: str):
    """``(Hann window [1024], log-frequency bin indices [224] int64)`` on
    ``device``. The window is symmetric (``jnp.hanning``); the bins are
    ``logspace(0, log10(511), 224)`` taken in f32 and truncated, the JAX
    package's integers exactly."""
    window = torch.hann_window(N_FFT, periodic=False, dtype=torch.float32)
    stop = float(torch.log10(torch.tensor(N_FFT // 2 - 1, dtype=torch.float32)))
    bins = torch.logspace(0, stop, TARGET_BINS, dtype=torch.float32).to(torch.int32).long()
    return window.to(device), bins.to(device)


def spectrogram(samples: torch.Tensor) -> torch.Tensor:
    """``[n, MAX_SAMPLES]`` f32 zero-padded clips -> ``[n, 224 bins, 224
    frames]`` images in [0, 1] (each scaled by its own minimum and maximum;
    low frequencies at the bottom)."""
    window, bins = _spectrogram_constants(str(samples.device))
    hop = (MAX_SAMPLES - N_FFT) // (TARGET_FRAMES - 1)
    frames = samples.unfold(-1, N_FFT, hop)[:, :TARGET_FRAMES] * window  # [n, 224, 1024]
    # the transform in f64: cuFFT's f32 rounding moves the quiet bins, after
    # log1p and the min-max scaling, by up to 2e-5 from the CPU's
    mag = torch.abs(torch.fft.rfft(frames.double(), dim=-1))[..., : N_FFT // 2].float()
    logmag = torch.log1p(mag[..., bins])  # [n, 224 frames, 224 bins]
    lo = logmag.amin(dim=(1, 2), keepdim=True)
    hi = logmag.amax(dim=(1, 2), keepdim=True)
    img = (logmag - lo) / torch.clamp(hi - lo, min=1e-6)
    return img.transpose(1, 2).flip(1)


def pad_samples(samples: np.ndarray) -> np.ndarray:
    """A clip cut or zero-padded to :data:`MAX_SAMPLES`."""
    buf = np.zeros(MAX_SAMPLES, dtype=np.float32)
    take = min(len(samples), MAX_SAMPLES)
    buf[:take] = samples[:take]
    return buf


def image_from_spectrogram(img: torch.Tensor) -> torch.Tensor:
    """``[n, 224, 224]`` in [0, 1] -> ``[n, 224, 224, 3]`` ImageNet-normalised."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(img.device)
    std = torch.from_numpy(IMAGENET_STD).to(img.device)
    return (img[..., None].expand(*img.shape, 3) - mean) / std


class VitAudioModel(VitTowerModel):
    """768-d audio embeddings: the spectrogram image through the ViT tower
    (the reference's audio ``VitBasePatch16_224``)."""

    name = "vit-audio"

    def __init__(self, mode: str = "embeddings_mean", batch_size: int = 16, seed: int = 0,
                 device=None, mesh=None):
        super().__init__(mode, batch_size, seed, device, mesh)

    def pixels(self, documents: list[bytes]) -> torch.Tensor:
        host = np.zeros((self.batch_size, MAX_SAMPLES), np.float32)
        for i, d in enumerate(documents):
            host[i] = pad_samples(audio_to_data(d)[0])
        return image_from_spectrogram(spectrogram(upload(host, self.device)))

    def status(self) -> dict:
        degr = super().status()["degradations"]
        from zebra_tpu_torch.native import av, codecs

        have_lossy = av.available() or (codecs._libmpg123() is not None
                                        and codecs._libvorbisfile() is not None)
        for module in ("soundfile", "pygame"):  # the last resorts
            if not have_lossy:
                try:
                    __import__(module)
                    have_lossy = True
                except ImportError:
                    pass
        if not have_lossy:
            degr = degr + [
                "mp3/ogg codecs unavailable — install system "
                "libmpg123/libvorbisfile, the 'audio' extra (soundfile), "
                "or pygame; WAV/AIFF/AU/FLAC decode natively"
            ]
        return {"semantic": not degr, "degradations": degr}
