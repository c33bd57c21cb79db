"""The port's media path against the JAX package's, on the CPU: image
preprocessing (bitwise), the audio decode chain (samples and rates equal,
container by container), the FLAC decoder on the cases of
``tests/test_flac.py``, the spectrogram (atol 1e-5; the log-frequency bin
indices exactly), the sixel encoder (the same string), the image and audio
models on one checkpoint (atol 1e-5) with their batch invariance, and the
CLI's image and audio verbs with ``--device cpu``."""

import io
import os
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.flac_encoder import encode_flac
from zebra_tpu import sixel as JSIX
from zebra_tpu.models import audio as JA
from zebra_tpu.models import image as JI
from zebra_tpu.models import vit as JV
from zebra_tpu.native import flac as JF
from zebra_tpu_torch import sixel as TSIX
from zebra_tpu_torch.cli import main
from zebra_tpu_torch.models import audio as TA
from zebra_tpu_torch.models import image as TI
from zebra_tpu_torch.models import vit as TV
from zebra_tpu_torch.native import av as TAV
from zebra_tpu_torch.native import codecs as TC
from zebra_tpu_torch.native import flac as TF

from test_torch_vit import _hf_checkpoint

SPEC_ATOL = 1e-5
EMBED_ATOL = 1e-5


def _image(seed, w, h, fmt="JPEG", mode="RGB"):
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    rng.integers(0, 256, (h, w))], axis=-1).astype(np.uint8)
    img = Image.fromarray(arr).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _tone(freq, seconds=1.0, rate=16000, width=2, channels=1):
    t = np.arange(int(seconds * rate)) / rate
    x = np.sin(2 * np.pi * freq * t) * 0.6
    if channels > 1:
        x = np.stack([x, 0.5 * x], axis=1)
    return x


def _wav(x, rate=16000, width=2):
    frames = x if x.ndim == 1 else x.reshape(-1)
    if width == 1:
        raw = (frames * 127 + 128).astype(np.uint8).tobytes()
    else:
        raw = (frames * (2 ** (8 * width - 1) - 1)).astype(f"<i{width}").tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1 if x.ndim == 1 else x.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)
    return buf.getvalue()


def _stdlib_writer(name, x, rate=16000):
    mod = TA._stdlib_module(name)
    if mod is None:
        pytest.skip(f"{name} is not in this Python's standard library")

    class Kept(io.BytesIO):  # the writers close their file when they close
        def close(self):
            pass

    buf = Kept()
    w = mod.open(buf, "wb")
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(rate)
    w.writeframes((x * 32767).astype(">i2").tobytes())
    w.close()
    return buf.getvalue()


def _pygame_sample(ext):
    try:
        import pygame.examples
    except ImportError:
        return None
    path = os.path.join(os.path.dirname(pygame.examples.__file__), "data", f"house_lo.{ext}")
    return open(path, "rb").read() if os.path.exists(path) else None


# -- images --------------------------------------------------------------------


@pytest.mark.parametrize("w,h,fmt,mode", [(320, 240, "JPEG", "RGB"), (240, 320, "PNG", "RGB"),
                                          (100, 60, "PNG", "L"), (224, 224, "PNG", "RGBA"),
                                          (641, 233, "JPEG", "RGB")])
def test_load_image224_is_bitwise_the_jax_packages(w, h, fmt, mode):
    data = _image(w * h, w, h, fmt, mode)
    got, want = TI.load_image224(data), JI.load_image224(data)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the audio decode chain ------------------------------------------------------


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_wav_decodes_as_the_jax_package(width, channels):
    data = _wav(_tone(440, 0.3, channels=channels), width=width)
    (gs, gr), (ws, wr) = TA.audio_to_data(data), JA.audio_to_data(data)
    assert gr == wr == 16000 and np.array_equal(gs, ws)


@pytest.mark.parametrize("container", ["aifc", "sunau"])
def test_aiff_and_au_decode_as_the_jax_package(container):
    data = _stdlib_writer(container, _tone(330, 0.3), rate=22050)
    (gs, gr), (ws, wr) = TA.audio_to_data(data), JA.audio_to_data(data)
    assert gr == wr == 22050 and len(gs) == 4800 and np.array_equal(gs, ws)


@pytest.mark.parametrize("ext", ["mp3", "ogg"])
def test_mp3_and_ogg_decode_as_the_jax_package(ext):
    data = _pygame_sample(ext)
    lib = TC._libmpg123() if ext == "mp3" else TC._libvorbisfile()
    if data is None or lib is None:
        pytest.skip(f"no {ext} sample file or no system {ext} library here")
    (gs, gr), (ws, wr) = TA.audio_to_data(data), JA.audio_to_data(data)
    assert gr == wr and len(gs) > 10000 and np.array_equal(gs, ws)


def test_flac_decodes_as_the_jax_package():
    s = _walk(800, -(2**14), 2**14, seed=19)
    data = encode_flac(s, rate=8000, blocksize=256)
    (gs, gr), (ws, wr) = TA.audio_to_data(data), JA.audio_to_data(data)
    assert gr == wr == 8000 and np.array_equal(gs, ws)
    np.testing.assert_allclose(gs, s.astype(np.float32) / 2**15, atol=1e-6)


def test_undecodable_bytes_raise_as_in_the_jax_package():
    for pkg in (TA, JA):
        with pytest.raises(ValueError, match="unsupported audio container"):
            pkg.audio_to_data(b"not audio at all" * 8)
    assert TAV.available() == __import__("zebra_tpu.native.av", fromlist=["av"]).available()


# -- FLAC: the cases of tests/test_flac.py ---------------------------------------


def _walk(n, lo, hi, seed=0, step=40):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-step, step + 1, n)), lo, hi).astype(np.int64)


def _stereo(seed=7, n=500):
    left = _walk(n, -(2**14), 2**14, seed=seed)
    return np.stack([left, left + _walk(n, -200, 200, seed=seed + 1)], axis=1)


FLAC_CASES = {
    "constant": (lambda: np.full(512, -1234), dict(blocksize=256)),
    "verbatim": (lambda: np.random.default_rng(1).integers(-(2**15), 2**15, 300),
                 dict(blocksize=256, kind="verbatim")),
    **{f"fixed{o}": (lambda o=o: _walk(600, -(2**14), 2**14 - 1, seed=o),
                     dict(blocksize=256, kind="fixed", order=o)) for o in range(5)},
    "lpc": (lambda: _walk(512, -(2**14), 2**14 - 1, seed=9),
            dict(blocksize=256, kind="lpc", lpc_coefs=[3 << 8, -(3 << 8), 1 << 8], lpc_shift=9,
                 lpc_precision=12)),
    "lpc32": (lambda: _walk(300, -(2**13), 2**13, seed=3),
              dict(blocksize=256, kind="lpc", lpc_coefs=[0] * 31 + [1 << 5], lpc_shift=5,
                   lpc_precision=8)),
    "wasted": (lambda: _walk(256, -(2**12), 2**12, seed=4) << 3,
               dict(blocksize=256, kind="fixed", order=1, wasted=3)),
    **{f"partitions{p}": (lambda p=p: _walk(512, -(2**14), 2**14, seed=p),
                          dict(blocksize=512, kind="fixed", order=2, partition_order=p))
       for p in range(4)},
    "rice2": (lambda: _walk(256, -(2**14), 2**14, seed=5),
              dict(blocksize=256, kind="fixed", order=1, rice2=True)),
    "escape": (lambda: _walk(512, -(2**14), 2**14, seed=6),
               dict(blocksize=512, kind="fixed", order=2, partition_order=2,
                    escape_parts=(1, 3))),
    "stereo": (_stereo, dict(blocksize=256)),
    **{f"{m}-verbatim": (_stereo, dict(blocksize=256, mode=m, kind="verbatim"))
       for m in ("left-side", "right-side", "mid-side")},
    **{f"{m}-fixed": (lambda: _stereo(seed=11), dict(blocksize=256, mode=m, kind="fixed",
                                                     order=2))
       for m in ("left-side", "right-side", "mid-side")},
    "four-channels": (lambda: np.random.default_rng(12).integers(-(2**15), 2**15, (256, 4)),
                      dict(blocksize=256, kind="verbatim")),
    **{f"bps{b}": (lambda b=b: _walk(256, -(2 ** (b - 1)), 2 ** (b - 1) - 1, seed=b,
                                     step=1 << max(1, b - 8)), dict(bps=b, blocksize=256))
       for b in (8, 12, 16, 20, 24, 32)},
    **{f"blocksize{n}": (lambda n=n: _walk(n * 2, -(2**14), 2**14, seed=13), dict(blocksize=n))
       for n in (192, 256, 576, 1024)},
    "explicit250": (lambda: _walk(1000, -(2**14), 2**14, seed=14), dict(blocksize=250)),
    "explicit300": (lambda: _walk(900, -(2**14), 2**14, seed=15), dict(blocksize=300)),
    "many-frames": (lambda: _walk(4096, -(2**14), 2**14, seed=16), dict(blocksize=256)),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_roundtrips_as_the_jax_decoder(case):
    make, kw = FLAC_CASES[case]
    samples = np.asarray(make(), np.int64)
    data = encode_flac(samples, rate=16000, **kw)
    pcm, rate, ch, bps = TF.decode_flac_raw(data)
    want = JF.decode_flac_raw(data)
    assert (rate, ch, bps) == want[1:] == (16000, samples.reshape(len(samples), -1).shape[1],
                                           kw.get("bps", 16))
    np.testing.assert_array_equal(pcm, want[0])
    np.testing.assert_array_equal(pcm.astype(np.int64), samples.reshape(len(samples), -1))


def test_flac_rejects_what_the_jax_decoder_rejects():
    data = encode_flac(_walk(512, -1000, 1000, seed=17), blocksize=256)
    corrupt = bytearray(encode_flac(_walk(512, -1000, 1000, seed=18), blocksize=256,
                                    kind="verbatim"))
    corrupt[-20] ^= 0x40
    for bad in (b"RIFF" + b"\x00" * 64, data[: len(data) // 2 - 3], bytes(corrupt)):
        for dec in (TF.decode_flac_raw, JF.decode_flac_raw):
            with pytest.raises(ValueError):
                dec(bad)
    stereo = np.stack([np.full(256, 1 << 13), np.zeros(256, np.int64)], axis=1)
    mono, rate = TF.decode_flac(encode_flac(stereo, bps=16, blocksize=256, kind="verbatim"))
    assert rate == 16000 and np.array_equal(mono, np.full(256, 0.125, np.float32))


# -- the spectrogram -------------------------------------------------------------


def test_spectrogram_constants_are_the_jax_packages():
    window, bins = TA._spectrogram_constants("cpu")
    want = np.asarray(jnp.logspace(0, jnp.log10(JA.N_FFT // 2 - 1), JA.TARGET_BINS)
                      .astype(jnp.int32))
    np.testing.assert_array_equal(bins.numpy(), want)
    np.testing.assert_allclose(window.numpy(), np.asarray(jnp.hanning(JA.N_FFT)), atol=1e-6)  # ulps
    assert (TA.N_FFT, TA.TARGET_FRAMES, TA.TARGET_BINS, TA.MAX_SAMPLES) == (
        JA.N_FFT, JA.TARGET_FRAMES, JA.TARGET_BINS, JA.MAX_SAMPLES)


@pytest.mark.parametrize("signal", ["tone", "chirp", "noise", "silence"])
def test_spectrogram_matches_jax(signal):
    rng = np.random.default_rng(3)
    t = np.arange(32000) / 16000
    x = {"tone": np.sin(2 * np.pi * 440 * t), "chirp": np.sin(2 * np.pi * (200 + 900 * t) * t),
         "noise": rng.standard_normal(32000) * 0.3, "silence": np.zeros(32000)}[signal]
    buf = TA.pad_samples(x.astype(np.float32))
    want = np.asarray(JA._spectrogram_fn()(jnp.asarray(buf)))
    got = TA.spectrogram(torch.from_numpy(buf[None]))[0].numpy()
    assert got.shape == (224, 224)
    np.testing.assert_allclose(got, want, atol=SPEC_ATOL, rtol=0)
    img = TA.image_from_spectrogram(torch.from_numpy(got[None]))[0].numpy()
    ref = (np.repeat(got[:, :, None], 3, axis=2) - JI.IMAGENET_MEAN) / JI.IMAGENET_STD
    assert np.array_equal(img, ref)


# -- the image and audio models --------------------------------------------------


@pytest.fixture
def one_checkpoint(monkeypatch, tmp_path):
    """Both packages' towers from one embeddings checkpoint (the mode the
    models run), their caches empty before and after."""
    path = str(tmp_path / "vit.npz")
    np.savez(path, **_hf_checkpoint(11, 0))
    monkeypatch.setenv("ZEBRA_TPU_VIT_WEIGHTS", path)
    for clear in (JV._tower_and_params.cache_clear, TV.tower.cache_clear):
        clear()
    yield path
    for clear in (JV._tower_and_params.cache_clear, TV.tower.cache_clear):
        clear()
    JV.WEIGHT_STATUS.clear()
    TV.WEIGHT_STATUS.clear()


def test_image_model_matches_jax_and_is_batch_invariant(one_checkpoint):
    docs = [_image(i, 200 + 13 * i, 150 + 7 * i, "PNG") for i in range(35)]
    model = TI.VitImageModel(device="cpu")
    got = model.embed_documents(docs)
    assert got.shape == (35, 768) and model.status() == JI.VitImageModel().status()
    np.testing.assert_allclose(got, JI.VitImageModel().embed_documents(docs),
                               atol=EMBED_ATOL, rtol=0)
    alone = model.embed_documents(docs[33:34])[0]
    for other in (got[33], model.embed_documents(docs[20:34])[13]):
        assert np.array_equal(alone.view(np.uint32), other.view(np.uint32))


def test_audio_model_matches_jax_and_flac_twins_embed_bitwise(one_checkpoint):
    signals = [_tone(150 + 70 * i, 2.0) if i % 2 else
               np.sin(2 * np.pi * (100 + 300 * i * np.arange(32000) / 32000)
                      * np.arange(32000) / 16000) * 0.5 for i in range(18)]
    pcm = [np.round(s * 32767).astype(np.int64) for s in signals]
    wavs = [_wav(p.astype(np.float64) / 32767) for p in pcm]
    pcm = [np.frombuffer(w[44:], "<i2").astype(np.int64) for w in wavs]  # as stored
    flacs = [encode_flac(p, rate=16000, blocksize=1024) for p in pcm[:4]]
    model = TA.VitAudioModel(device="cpu")
    got = model.embed_documents(wavs)
    assert got.shape == (18, 768)
    np.testing.assert_allclose(got, JA.VitAudioModel().embed_documents(wavs),
                               atol=EMBED_ATOL, rtol=0)
    twins = model.embed_documents(flacs)
    assert np.array_equal(twins.view(np.uint32), got[:4].view(np.uint32))
    assert np.array_equal(model.embed_documents(wavs[17:])[0].view(np.uint32),
                          got[17].view(np.uint32))
    assert model.status() == JA.VitAudioModel().status()


# -- sixel -----------------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(30, 14), (800, 100), (321, 200)])
def test_sixel_encode_is_the_jax_packages(w, h, monkeypatch):
    data = _image(w + h, w, h, "PNG")
    assert TSIX.sixel_encode(data) == JSIX.sixel_encode(data)
    assert TSIX.sixel_encode(data, max_width=64) == JSIX.sixel_encode(data, max_width=64)
    for term, want in (("xterm-sixel", True), ("foot", True), ("xterm", False)):
        monkeypatch.setenv("TERM", term)
        assert TSIX.terminal_supports_sixel() == JSIX.terminal_supports_sixel() == want


# -- the CLI ---------------------------------------------------------------------


def test_cli_image_and_audio_verbs(tmp_path, monkeypatch, capsys):
    """``image insert`` of two files, ``image query --preview`` (the hit as
    sixel graphics), ``audio insert``, ``audio query --play`` through a
    stand-in player on the PATH (it receives the hit as PCM WAV), and
    without one the message the JAX package prints."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ZEBRA_TPU_WEIGHTS_CACHE", str(tmp_path / "weights"))
    monkeypatch.delenv("ZEBRA_TPU_VIT_WEIGHTS", raising=False)
    cpu = ["--device", "cpu"]
    for i in range(2):
        (tmp_path / f"{i}.png").write_bytes(_image(i, 90 + 40 * i, 70, "PNG"))
        (tmp_path / f"{i}.wav").write_bytes(_wav(_tone(300 + 200 * i, 0.5)))
    assert main(["--database-path", "i.zebra", *cpu, "image", "insert", "0.png", "1.png"]) == 0
    out = capsys.readouterr()
    assert "Inserted 2 image document(s) (768-dimensional" in out.out
    assert "random-init ViT weights" in out.err
    assert main(["--database-path", "i.zebra", *cpu, "image", "query", "1.png",
                 "--preview"]) == 0
    out = capsys.readouterr().out
    assert "Query 0:" in out and "\x1bPq" in out and out.count("\x1b\\") == 1
    assert TSIX.sixel_encode((tmp_path / "1.png").read_bytes()) in out
    assert main(["--database-path", "a.zebra", *cpu, "audio", "insert", "0.wav", "1.wav"]) == 0
    bindir = tmp_path / "bin"
    bindir.mkdir()
    player = bindir / "aplay"
    player.write_text(f"#!/bin/sh\n/bin/cp \"$1\" {tmp_path / 'played.wav'}\n")
    player.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    capsys.readouterr()
    assert main(["--database-path", "a.zebra", *cpu, "audio", "query", "1.wav", "--play"]) == 0
    out = capsys.readouterr().out
    assert "Query 0:" in out and "playback unavailable" not in out
    played, rate = TA.audio_to_data((tmp_path / "played.wav").read_bytes())
    want, _ = TA.audio_to_data((tmp_path / "1.wav").read_bytes())
    assert rate == 16000 and np.abs(played - want).max() <= 1 / 32767
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert main(["--database-path", "a.zebra", *cpu, "audio", "query", "0.wav", "--play"]) == 0
    assert "playback unavailable: no system audio player" in capsys.readouterr().out
