"""The native C++ host data plane of the PyTorch port
(statecatcher_tpu_torch/native: ``csrc/audio.cc`` and ``csrc/tokenizer.cc``,
built with g++ into build/native/) against its pure-Python versions and
the JAX package's native library.

  * The WAV decoder (PCM16, PCM32, float32, stereo, resampled) equals the
    numpy reader bit for bit, and JAX's native decoder; garbage is refused.
  * ``data/audio.py`` takes the native route when it is live.
  * The Viterbi encoder equals the Python segmentation, and JAX's.
  * ``available()`` and ``load_error()`` report which path is live; the
    library builds from the sources into a directory git ignores.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import statecatcher_tpu.native as j_native
from statecatcher_tpu.tokenizer.unigram import UnigramTokenizer as JUnigram
from statecatcher_tpu_torch import native
from statecatcher_tpu_torch.data import audio
from statecatcher_tpu_torch.data.audio import read_wav_bytes, resampled_count, resample_linear
from statecatcher_tpu_torch.data.audio import to_mono, write_wav_bytes
from statecatcher_tpu_torch.tokenizer.unigram import UnigramTokenizer, _viterbi_segment

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def live():
    assert native.available(), native.load_error()     # g++ is a test requirement here
    return native


def _wav(samples: np.ndarray, sr: int, fmt: str) -> bytes:
    """A RIFF/WAVE of ``samples`` (frames × channels) as PCM16, PCM32 or float32."""
    code, bits, data = {"pcm16": (1, 16, lambda x: (x * 32767).astype("<i2")),
                        "pcm32": (1, 32, lambda x: (x * 2147483647).astype("<i4")),
                        "f32": (3, 32, lambda x: x.astype("<f4"))}[fmt]
    ch = samples.shape[1]
    raw = data(samples).tobytes()
    fmt_chunk = struct.pack("<HHIIHH", code, ch, sr, sr * ch * bits // 8, ch * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk + b"data" + struct.pack(
        "<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _python_decode(blob: bytes, target_sr: int) -> np.ndarray:
    wav, sr, _ = read_wav_bytes(blob)
    wav = to_mono(wav)
    if sr != target_sr:
        wav = resample_linear(wav, sr, target_sr, n_out=resampled_count(len(wav), sr, target_sr))
    return wav


@pytest.mark.parametrize("fmt,channels,sr", [("pcm16", 1, 16000), ("pcm16", 2, 16000),
                                             ("pcm32", 1, 16000), ("f32", 2, 16000),
                                             ("pcm16", 1, 8000), ("f32", 1, 44100)])
def test_native_wav_decoder_matches_python_and_jax(live, fmt, channels, sr):
    rng = np.random.default_rng(channels * sr)
    x = rng.uniform(-0.9, 0.9, (sr // 3 + 7, channels)).astype(np.float32)
    blob = _wav(x, sr, fmt)
    got = live.decode_wav_native(blob, 16000)
    want = _python_decode(blob, 16000)
    assert got.dtype == np.float32 and len(got) == len(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_native.decode_wav_native(blob, 16000))


def test_native_wav_decoder_refuses_garbage(live):
    assert live.decode_wav_native(b"nonsense" * 10, 16000) is None
    assert live.decode_wav_native(b"RIFF\x00\x00\x00\x00WAVE", 16000) is None


def test_decode_audio_takes_the_native_route(live, monkeypatch):
    blob = write_wav_bytes(np.random.default_rng(1).uniform(-0.5, 0.5, 4000).astype(np.float32),
                           8000)
    calls = []
    monkeypatch.setattr(audio, "decode_wav_native",
                        lambda data, sr: calls.append(sr) or live.decode_wav_native(data, sr))
    got = audio.decode_audio(blob, 16000)
    assert calls == [16000]
    np.testing.assert_array_equal(got, _python_decode(blob, 16000))
    # not live: the numpy reader gives the same samples
    monkeypatch.setattr(audio, "decode_wav_native", lambda data, sr: None)
    np.testing.assert_array_equal(audio.decode_audio(blob, 16000), got)


CORPUS = ["the quick brown fox jumps over the lazy dog",
          "pack my box with five dozen liquor jugs", "über naïve café"] * 10


def test_native_viterbi_matches_python_and_jax(live):
    tok, jtok = UnigramTokenizer.train(CORPUS, vocab_size=64), JUnigram.train(CORPUS, vocab_size=64)
    assert tok._native is not None and jtok._native is not None
    for text in ("the quick brown fox", "lazy dozen jugs", "a b c", "naïve über café",
                 "jumps¤over", "zzz"):
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        py_ids = []
        for w in text.split():
            seg = _viterbi_segment("▁" + w, tok._logp, tok._max_len)
            py_ids.extend(tok._id_of[p] for p in seg) if seg else py_ids.extend(
                tok._encode_with_unk("▁" + w))
        assert ids == py_ids, text


def test_available_reports_the_live_path(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("STATECATCHER_NO_NATIVE", "1")
    assert not native.available() and "STATECATCHER_NO_NATIVE" in native.load_error()
    assert native.decode_wav_native(write_wav_bytes(np.zeros(10, np.float32), 16000),
                                    16000) is None
    tok = UnigramTokenizer.train(CORPUS, vocab_size=48)
    assert tok._native is None and tok.encode("the lazy dog")      # the Python path
    with pytest.raises(RuntimeError, match="STATECATCHER_NO_NATIVE"):
        native.NativeVocab(["a"], [2], [0.0])
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("STATECATCHER_NO_NATIVE")
    assert native.available() and native.load_error() is None


def test_library_builds_from_the_sources_into_an_ignored_directory(tmp_path, monkeypatch):
    """A fresh build directory: the first use builds the library (named by
    the sources' hash) with g++, and git ignores where it lands."""
    path = native.library_path()
    assert path.parent == REPO / "build" / "native" and path.exists()
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=REPO)
    assert ignored.returncode == 0
    code = ("import statecatcher_tpu_torch.native as n, pathlib, sys; "
            f"n.BUILD_DIR = pathlib.Path({str(tmp_path)!r}); "
            "assert n.available(), n.load_error(); print(n.library_path())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    built = Path(out.stdout.strip())
    assert built.parent == tmp_path and built.name == path.name and built.exists()
