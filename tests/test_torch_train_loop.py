"""The training loop of the PyTorch port (statecatcher_tpu_torch/train/loop.py)
and its data plane, against the JAX package.

* Both ``train()``s on a generated local WAV+VTT fixture from the same
  initial parameters (the JAX hook ``initial_params=``): the per-segment loss
  histories agree.  As in tests/test_torch_train_step.py both sides compute
  in float64 (the JAX scan step's float32 skip-branch zeros read as
  float64), and the port's step is given the JAX frontend's features; the
  histories agree to rtol 1e-8.
* The port killed mid-recording-batch and resumed from its checkpoint gives
  the uninterrupted run's loss history exactly.
* The data-plane copies give the JAX package's results on the same bytes:
  WAV decode, VTT cues, chunking, compact group assembly, the character
  tokenizer, WER/CER and the loss outlier detector.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.train.step as j_step_module
import statecatcher_tpu_torch.train.step as step_module
from statecatcher_tpu import metrics as jmetrics
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.data import audio as jaudio
from statecatcher_tpu.data import chunking as jchunking
from statecatcher_tpu.data import pipeline as jpipeline
from statecatcher_tpu.data import vtt as jvtt
from statecatcher_tpu.frontend import compute_features as j_compute_features
from statecatcher_tpu.tokenizer.char import CharTokenizer as JCharTokenizer
from statecatcher_tpu_torch import metrics
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.data import audio, chunking, pipeline, vtt
from statecatcher_tpu_torch.data.local import LocalSpeechDataset
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.tokenizer import CharTokenizer, load_tokenizer
from statecatcher_tpu_torch.train.loop import train
from test_torch_train_step import _JnpF64
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

WORDS = ["hello", "world", "testing", "audio", "stream", "state"]


def write_fixture(d, seed, n=3, seconds=4, sr=8000):
    """n recordings of PCM16 noise with two 3-word cues each (the verify
    skill's recipe)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        x = rng.uniform(-0.3, 0.3, size=seconds * sr).astype(np.float32)
        with open(os.path.join(d, f"rec{i}.wav"), "wb") as f:
            f.write(audio.write_wav_bytes(x, sr))
        lines = ["WEBVTT", ""]
        cue = seconds / 2
        for j in range(2):
            lines += [f"00:00:{j * cue:06.3f} --> 00:00:{(j + 1) * cue:06.3f}",
                      " ".join(rng.choice(WORDS, size=3)), ""]
        with open(os.path.join(d, f"rec{i}.vtt"), "w") as f:
            f.write("\n".join(lines))
    return d


def tiny_overrides(data_dir, model_dir, *extra):
    return ["--model.encoder", "lucyrnn", "--model.hidden_size", "16",
            "--model.num_layers", "2", "--model.lucyrnn.kernel_impl", "xla-scan",
            "--data.source", "local", "--data.local_dir", data_dir,
            "--data.batch_samplerate", "8000", "--data.batch_size", "2",
            "--data.target_duration", "2.0", "--data.num_workers", "2",
            "--train.model_dir", model_dir, "--train.log_every_n", "4",
            "--train.epochs", "100", "--train.segments_per_dispatch", "2",
            "--train.optim.lr", "3e-3", *extra]


def _initial_model(cfg, vocab):
    import dataclasses

    mcfg = dataclasses.replace(cfg.model, vocab_size=vocab)
    model = build_speech_model(mcfg, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 3, gate_weight_scale=0.1)     # gate inputs near their offset biases
    return model, mcfg


def test_train_loss_history_matches_jax(tmp_path, monkeypatch):
    from statecatcher_tpu.train.loop import train as j_train

    data = write_fixture(str(tmp_path / "data"), 0)
    ov = tiny_overrides(data, "", "--train.steps", "6", "--train.ctc_impl", "lattice",
                        "--model.dtype", "float64", "--model.param_dtype", "float64")
    cfg = Config().apply_overrides(ov + ["--train.model_dir", str(tmp_path / "t")])
    jcfg = JConfig().apply_overrides(ov + ["--train.model_dir", str(tmp_path / "j")])
    vocab = CharTokenizer.train(_cue_texts(data)).vocab_size
    model, mcfg = _initial_model(cfg, vocab)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}

    monkeypatch.setattr(j_step_module, "jnp", _JnpF64())
    with jax.enable_x64(True):
        want = j_train(jcfg, initial_params=torch_to_flax(sd, mcfg))
    monkeypatch.setattr(step_module, "compute_features", lambda x, fe: torch.from_numpy(
        np.array(j_compute_features(jnp.asarray(x.numpy()), jcfg.frontend))))
    got = train(cfg, initial_params=sd, device="cpu")

    assert got["global_step"] == want["global_step"] == 6
    assert len(got["loss_history"]) == 6
    np.testing.assert_allclose(got["loss_history"], want["loss_history"], rtol=1e-8, atol=0)
    assert os.path.exists(os.path.join(got["run_dir"], "tokenizer.json"))
    tok = load_tokenizer(os.path.join(got["run_dir"], "tokenizer.json"))
    assert tok.vocab_size == vocab


def _cue_texts(d):
    out = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".vtt"):
            out += [t for _, _, t in vtt.vtt_to_segments_with_text(open(os.path.join(d, name)).read())]
    return out


def test_kill_and_resume_mid_recording_batch_is_exact(tmp_path):
    """steps=3 stops after the first segment of the second recording batch;
    the resumed run re-enters at seg_idx=1 with the saved carry."""
    data = write_fixture(str(tmp_path / "data"), 1)
    cfg = lambda name, *extra: Config().apply_overrides(
        tiny_overrides(data, str(tmp_path / name), *extra))
    full = train(cfg("full", "--train.steps", "6"), device="cpu")
    part = train(cfg("part", "--train.steps", "3"), device="cpu")
    meta = json.load(open(os.path.join(part["run_dir"], "ckpt", "3", "meta.json")))
    assert meta["cursor"] == {"batches_done": 1, "seg_idx": 1}
    resumed = train(cfg("resumed", "--train.steps", "6", "--train.resume_from",
                        part["run_dir"]), device="cpu")
    assert (full["global_step"], part["global_step"], resumed["global_step"]) == (6, 3, 6)
    assert part["loss_history"] + resumed["loss_history"] == full["loss_history"]
    assert all(np.isfinite(full["loss_history"]))


# --------------------------------------------------------------------------- #
# Data plane, tokenizer, metrics: same bytes, same results
# --------------------------------------------------------------------------- #
def test_wav_decode_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, 12345).astype(np.float32)
    wav = audio.write_wav_bytes(x, 16000)
    assert wav == jaudio.write_wav_bytes(x, 16000)
    got, want = audio.decode_audio_fast(wav, 16000), jaudio.decode_audio_fast(wav, 16000)
    assert got.dtype == want.dtype == np.int16                  # PCM16 passthrough
    np.testing.assert_array_equal(got, want)
    # resampling: the JAX package's default path (its native C++ decoder)
    # sizes the output rounding halves away from zero, 6173 samples here
    got = audio.decode_audio(wav, 8000)
    want = jaudio.decode_audio(wav, 8000)
    assert got.dtype == want.dtype == np.float32 and len(got) == len(want) == 6173
    np.testing.assert_array_equal(got, want)
    a, b = audio.read_wav_bytes(wav), jaudio.read_wav_bytes(wav)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    np.testing.assert_array_equal(audio.resample_linear(x, 16000, 11025),
                                  jaudio.resample_linear(x, 16000, 11025))


def test_vtt_and_chunking_match_jax():
    doc = ("WEBVTT\n\n00:00.000 --> 00:03.500 align:start\nfirst cue\nsecond line\n\n"
           "bad --> cue\nskipped\n\n00:00:03.500 --> 00:00:09.000\nthird\n\n"
           "00:09.000 --> 00:17.250\nfourth cue\n\n01:00:00.000 --> 01:00:01.000\nlate\n")
    assert vtt.vtt_to_segments_with_text(doc) == jvtt.vtt_to_segments_with_text(doc)
    assert vtt.parse_timestamp("01:02:03.250") == jvtt.parse_timestamp("01:02:03.250")
    rng = np.random.default_rng(5)
    for dtype in (np.int16, np.float32):
        x = (rng.uniform(-0.3, 0.3, 20 * 8000) * (32767 if dtype == np.int16 else 1)).astype(dtype)
        for window in (4.0, 8.0):
            got = chunking.preprocess_recording(x, doc, 8000, int(window * 8000))
            want = jchunking.preprocess_recording(x, doc, 8000, int(window * 8000))
            assert got[1] == want[1] and got[3] == want[3]
            for a, b in zip(got[0] + got[2], want[0] + want[2]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_compact_group_assembly_matches_jax(tmp_path):
    data = write_fixture(str(tmp_path / "data"), 6, n=3, seconds=6)
    ds = LocalSpeechDataset(data, batch_samplerate=8000)
    ds.start_session(batch_size=3)
    _, _, items = ds.fetch_next_batch()
    S = 2 * 8000
    recs = [ds.load_and_preprocess_batch_item(it, S) for it in items]
    batches = []
    for mod in (pipeline, jpipeline):
        b = mod.PreparedBatch(epoch=0, batch_id=0)
        for a, t, m, meta in recs:
            b.audio_items.append(a)
            b.text_items.append(t)
            b.mask_items.append(m)
            b.meta_items.append(meta)
        batches.append(b)
    pool, jpool = pipeline.GroupBufferPool(), jpipeline.GroupBufferPool()
    for group_ids in ([0, 1], [2], [0, 1]):                  # the third reuses a slot
        got = pipeline.assemble_compact_group(batches[0], group_ids, 2, 4, S, pool=pool)
        want = jpipeline.assemble_compact_group(batches[1], group_ids, 2, 4, S, pool=jpool)
        assert got[0].dtype == want[0].dtype == np.int16
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    for si in range(3):
        for a, b in zip(pipeline.stack_segment_slice(batches[0], si, S),
                        jpipeline.stack_segment_slice(batches[1], si, S)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pipeline_get_raises_when_its_thread_fails():
    """A prefetch thread that dies hands its error to ``get`` instead of
    leaving the training loop waiting on an empty queue."""

    class Malformed:
        def fetch_next_batch(self):
            return 0, 0, [{}]

        def load_and_preprocess_batch_item(self, item, target_samples):
            return ("too", "short")                 # not (audio, texts, masks, ...)

    pipe = pipeline.BatchPipeline(Malformed(), 16, num_workers=1).start()
    try:
        with pytest.raises(RuntimeError, match="prefetch thread") as info:
            pipe.get()
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        pipe.stop()


def test_char_tokenizer_matches_jax(tmp_path):
    corpus = ["hello world", "state carried across segments", "zebra ÿ"]
    t, j = CharTokenizer.train(corpus), JCharTokenizer.train(corpus)
    assert t.to_dict() == j.to_dict() and t.vocab_size == j.vocab_size and t.blank_id == 0
    for text in ("hello there", "quiz?", ""):
        ids = t.encode(text)
        assert ids == j.encode(text) and t.decode_ids(ids) == j.decode_ids(ids)
    assert CharTokenizer.train(corpus, max_vocab=6).to_dict() == JCharTokenizer.train(
        corpus, max_vocab=6).to_dict()
    t.save(str(tmp_path / "tok.json"))
    assert load_tokenizer(str(tmp_path / "tok.json")).to_dict() == t.to_dict()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_tokenizer(str(tmp_path / "x.model"))


def test_wer_and_outlier_detector_match_jax():
    refs = ["the cat sat", "on the mat", "", "a b c d"]
    hyps = ["the cat sat down", "on mat", "extra", "a x c"]
    assert metrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert metrics.cer(refs, hyps) == jmetrics.cer(refs, hyps)
    rng = np.random.default_rng(7)
    xs = list(rng.normal(1.0, 0.05, 300)) + [3.0, float("nan"), 1.02, 9.0]
    a = metrics.LossOutlierDetector(6.0, 128, 32, 0.05)
    b = jmetrics.LossOutlierDetector(6.0, 128, 32, 0.05)
    flags = [(a.update(x, scale=1.0), b.update(x, scale=1.0)) for x in xs]
    assert all(p == q for p, q in flags) and a.flagged == b.flagged >= 2
