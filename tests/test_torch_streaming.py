"""Streaming recognizer of the PyTorch port (statecatcher_tpu_torch/
streaming.py): chunked streaming == offline decode of the same frames (the
spec of tests/test_streaming.py), finish() flushes, and the port's tokens
equal the JAX StreamingRecognizer's on the same weights and audio."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.frontend import compute_features as j_features
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.streaming import StreamingRecognizer as JStreamingRecognizer
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch
from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from statecatcher_tpu_torch.streaming import StreamingRecognizer

_OVERRIDES = [
    "--model.encoder", "lucyrnn", "--model.hidden_size", "16",
    "--model.num_layers", "2", "--model.vocab_size", "8",
]


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JConfig().apply_overrides(_OVERRIDES), Config().apply_overrides(_OVERRIDES)
    jmodel = j_build_model(jcfg.model, 80)
    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.5, 0.5, size=16000 * 2).astype(np.float32)
    feats = j_features(jnp.asarray(audio[None]), jcfg.frontend)
    params = jmodel.init(jax.random.PRNGKey(3), feats, j_init_carry(jcfg.model, 1))
    # seeded random weights everywhere: the output projection is zero at init
    # and would decode nothing.  On this audio the smallest gap between a
    # frame's two best log-probs is ~4e-3, far above f32 round-off, so the
    # argmax of both packages is the same frame by frame.
    wrng = np.random.default_rng(1)

    def draw(v):
        v = np.asarray(v)
        if v.ndim == 2:
            return (wrng.standard_normal(v.shape) * (1.5 / np.sqrt(v.shape[0]))).astype(np.float32)
        return (v + 0.1 * wrng.standard_normal(v.shape)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, jax.device_get(params))
    model = build_model(cfg.model, 80, device="cpu")
    model.load_state_dict(flax_to_torch(params, cfg.model))
    return cfg, model, (jcfg, jmodel, params), audio


def _offline_tokens(cfg, model, audio, n_frames):
    with torch.inference_mode():
        feats = compute_features(torch.from_numpy(audio[None]), cfg.frontend)[:, :n_frames]
        logits, _ = model(feats, init_carry(cfg.model, 1, device="cpu"), None)
        lp = torch.log_softmax(logits.to(torch.float32), -1)
    return ctc_greedy_decode_to_lists(lp, torch.tensor([lp.shape[1]]))[0]


@pytest.mark.parametrize("feed", [160, 1333, 4000])
def test_streaming_matches_offline_greedy(setup, feed):
    cfg, model, _, audio = setup
    rec = StreamingRecognizer(model, cfg, chunk_frames=16, device="cpu")
    for i in range(0, len(audio), feed):
        rec.accept_waveform(audio[i:i + feed])
    hop, win = cfg.frontend.hop_length, cfg.frontend.n_fft
    n_chunks = (len(audio) - (win - hop)) // rec.chunk_samples
    want = _offline_tokens(cfg, model, audio, n_chunks * rec.chunk_frames)
    assert len(want) > 5
    assert rec.tokens == want


def test_streaming_finish_flushes(setup):
    cfg, model, _, audio = setup
    rec = StreamingRecognizer(model, cfg, chunk_frames=16, device="cpu")
    rec.accept_waveform(audio)
    partial = rec.tokens
    rec.finish()
    # after finish every frame of the audio has been decoded, as offline
    want = _offline_tokens(cfg, model, audio, None)
    assert rec.tokens == want and len(want) >= len(partial)
    rec.reset()
    assert rec.tokens == []


@pytest.mark.parametrize("feed", [1333, 4000])
def test_streaming_matches_jax_recognizer(setup, feed):
    cfg, model, (jcfg, jmodel, params), audio = setup
    rec = StreamingRecognizer(model, cfg, chunk_frames=16, device="cpu")
    jrec = JStreamingRecognizer(jmodel, params, jcfg, chunk_frames=16)
    for i in range(0, len(audio), feed):
        rec.accept_waveform(audio[i:i + feed])
        jrec.accept_waveform(audio[i:i + feed])
    rec.finish()
    jrec.finish()
    assert len(jrec.tokens) > 5
    assert rec.tokens == jrec.tokens
    assert rec.text == jrec.text


def test_committed_text_matches_jax_recognizer(setup):
    """Greedy CTC commits every emitted token: ``committed_text`` is the ids
    joined by spaces without a tokenizer and ``decode_ids`` with one, as in
    JAX, mid-stream and after ``finish``."""
    from statecatcher_tpu.tokenizer.char import CharTokenizer as JCharTokenizer
    from statecatcher_tpu_torch.tokenizer.char import CharTokenizer

    cfg, model, (jcfg, jmodel, params), audio = setup
    texts = ["abc", "def"]                               # 7 ids, the vocab of 8
    for tok, jtok in ((None, None), (CharTokenizer.train(texts), JCharTokenizer.train(texts))):
        rec = StreamingRecognizer(model, cfg, chunk_frames=16, tokenizer=tok, device="cpu")
        jrec = JStreamingRecognizer(jmodel, params, jcfg, chunk_frames=16, tokenizer=jtok)
        half = len(audio) // 2
        for part in (audio[:half], audio[half:]):
            rec.accept_waveform(part)
            jrec.accept_waveform(part)
            assert rec.committed_text == jrec.committed_text
        rec.finish()
        jrec.finish()
        assert len(jrec.committed_tokens) > 5
        assert rec.committed_tokens == jrec.committed_tokens
        assert rec.committed_text == jrec.committed_text


def test_unported_decoders_raise(setup):
    cfg, model, _, _ = setup
    with pytest.raises(NotImplementedError, match="not ported"):
        StreamingRecognizer(model, cfg, decoder="beam", device="cpu")
    # "rnnt" is ported (tests/test_torch_rnnt_decode.py); it needs a joiner
    with pytest.raises(ValueError, match="mode='rnnt'"):
        StreamingRecognizer(model, cfg, decoder="rnnt", device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        StreamingRecognizer(model, Config().apply_overrides(
            _OVERRIDES + ["--model.stack_order", "3"]), chunk_frames=16, device="cpu")
