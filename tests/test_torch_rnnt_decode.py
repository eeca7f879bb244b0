"""RNN-T greedy decoding of the PyTorch port (statecatcher_tpu_torch/
rnnt_decode.py) and the streaming recognizer's ``decoder="rnnt"`` against the
JAX package.

  * ``rnnt_greedy_decode`` over two carried segments, with a short row and a
    buffer that fills up, in float64 on both sides: the same tokens, buffer,
    lengths and last tokens (argmax of the same float64 logits).
  * ``StreamingRecognizer(decoder="rnnt")`` against the JAX recognizer on
    the same weights and audio (float32 encoder; both decode the float32
    join-space projections with float32 tables), through drains of a small
    buffer and ``finish()``; and against the port's own offline decode of the
    same frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu import rnnt_decode as jdec
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.streaming import StreamingRecognizer as JStreamingRecognizer
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.rnnt_decode import (
    rnnt_decode_init,
    rnnt_drain,
    rnnt_greedy_decode,
    rnnt_state_to_lists,
)
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import randomize_
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

OVERRIDES = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
             "--model.vocab_size", "8", "--model.rnnt_pred_emb_dim", "6",
             "--model.rnnt_joiner_dim", "10"]


def _decode_problem(seed, B=3, T=12, J=6, V=7):
    rng = np.random.default_rng(seed)
    enc = [rng.standard_normal((B, T, J)) for _ in range(2)]
    table = rng.standard_normal((V, J))
    k = rng.standard_normal((J, V))
    b = rng.standard_normal(V) * 0.5
    b[0] += 1.0                                         # blank wins some frames, not all
    return enc, table, k, b, np.array([T, T - 5, T], np.int32)


def test_greedy_decode_matches_jax_over_carried_segments():
    enc, table, k, b, in_lens = _decode_problem(0)
    max_out = 24                                        # row 0 fills it up
    with jax.enable_x64(True):
        jst = None
        jstates = []
        for e in enc:
            jst = jdec.rnnt_greedy_decode(jnp.asarray(e), jnp.asarray(table), jnp.asarray(k),
                                          jnp.asarray(b), jnp.asarray(in_lens), blank_id=0,
                                          init_state=jst, max_out=max_out)
            jstates.append(jax.tree.map(np.asarray, jst))
    st = rnnt_decode_init(3, max_out, 0)
    for e, want in zip(enc, jstates):
        st = rnnt_greedy_decode(*map(torch.from_numpy, (e, table, k, b, in_lens)), blank_id=0,
                                init_state=st)
        for name in ("last_token", "out_buf", "out_len"):
            np.testing.assert_array_equal(getattr(st, name).numpy(), getattr(want, name),
                                          err_msg=name)
    assert st.out_len.max() == max_out and st.out_len.min() > 0
    assert rnnt_state_to_lists(st) == jdec.rnnt_state_to_lists(jstates[-1])
    drained, com = rnnt_drain(st)
    assert com == rnnt_state_to_lists(st)
    assert not drained.out_len.any() and torch.equal(drained.last_token, st.last_token)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = Config().apply_overrides(OVERRIDES), JConfig().apply_overrides(OVERRIDES)
    model = build_speech_model(cfg.model, 80, "rnnt", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 2)
    params = torch_to_flax(model.state_dict(), cfg.model)
    audio = np.random.default_rng(1).uniform(-0.5, 0.5, 16000 * 2).astype(np.float32)
    return cfg, model, (jcfg, j_build_speech(jcfg.model, 80, "rnnt"), params), audio


def _offline(cfg, model, audio):
    with torch.inference_mode():
        feats = compute_features(torch.from_numpy(audio[None]), cfg.frontend)
        enc_out, _ = model(feats)
        enc_p = model.rnnt_project_encoder(enc_out).float()
        tables = [t.float() for t in model.rnnt_decode_tables()]
        st = rnnt_greedy_decode(enc_p, *tables, torch.tensor([enc_p.shape[1]]), blank_id=0,
                                max_out=4 * enc_p.shape[1])
    return rnnt_state_to_lists(st)[0]


@pytest.mark.parametrize("feed", [1333, 4000])
def test_rnnt_streaming_matches_jax_and_offline(setup, feed):
    cfg, model, (jcfg, jmodel, params), audio = setup
    rec = StreamingRecognizer(model, cfg, chunk_frames=16, decoder="rnnt", max_out=64,
                              device="cpu")
    jrec = JStreamingRecognizer(jmodel, params, jcfg, chunk_frames=16, decoder="rnnt", max_out=64)
    for i in range(0, len(audio), feed):
        rec.accept_waveform(audio[i:i + feed])
        jrec.accept_waveform(audio[i:i + feed])
    assert rec.committed_tokens == jrec.committed_tokens and len(rec.committed_tokens) > 0
    rec.finish()
    jrec.finish()
    assert len(jrec.tokens) > 20
    assert rec.tokens == jrec.tokens and rec.text == jrec.text
    assert rec.tokens == _offline(cfg, model, audio)
    rec.reset()
    assert rec.tokens == [] and rec.committed_tokens == []
