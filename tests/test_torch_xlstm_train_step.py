"""The xLSTM (2 blocks, E=32, 2 heads, dqk = dv = 16, chunk 16, vocab 24)
through the PyTorch port's entry points: one CTC segment-group step of
``make_segment_scan_step`` in lockstep with the JAX package's, and one
streaming pass of ``StreamingRecognizer`` against the offline decode.

The step: both packages start from the same parameters (``testing.
randomize_`` on the port's model, bridged by ``convert.torch_to_flax``) and
run one group of K=2 segments of 4000 samples at B=3 (a partial sample mask,
a ``row_valid=False`` row) from a zero carry, in float32, the port's step fed
the JAX frontend's features; the JAX side runs its XLA chunkwise form, the
port ``auto`` (its chunkwise form on the CPU).  Held: per-segment losses to
rtol 1e-5, grad norms to 1e-4 (float32 sums in other orders through the
model and the CTC lattice), the greedy output equal, the carry to rtol 2e-4
and atol 2e-5 of the model tests, and the parameter updates within 1 % of
their norm: at lr 1e-6 (as for LucyRNN, tests/test_torch_train_step.py),
Adam's first, sign-like steps move a parameter whose gradient is near zero
by ±lr on round-off alone.

The stream: 2 s of audio fed in pieces of three sizes, 32-frame chunks;
the tokens equal the offline greedy decode of the same frames (the chunks
of the encode are the offline encode's chunks, so the sums are the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu_torch.train.step as step_module
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.frontend import compute_features as j_compute_features
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu.train.step import make_segment_scan_step as j_scan_step
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

K, B, S, U, V = 2, 3, 4000, 6, 24
BASE = ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "32",
        "--model.xlstm.num_heads", "2", "--model.xlstm.num_blocks", "2",
        "--model.xlstm.qk_dim_factor", "1.0", "--model.xlstm.chunk_size", "16",
        "--model.vocab_size", str(V), "--train.optim.lr", "1e-6"]


def _group(seed):
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.3, 0.3, (K, B, S)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, (K, B)).astype(np.int32)
    lens[:, 0] = S
    mask = np.arange(S)[None, None, :] < lens[..., None]
    tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
    tok_lens = rng.integers(1, U + 1, (K, B)).astype(np.int32)
    row_valid = np.ones((K, B), bool)
    row_valid[:, 2] = False
    return audio, mask, tokens, tok_lens, row_valid, np.ones((K,), bool)


def test_ctc_group_step_matches_jax_in_lockstep(monkeypatch):
    cfg, jcfg = Config().apply_overrides(BASE), JConfig().apply_overrides(BASE)
    model = build_speech_model(cfg.model, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    group = _group(3)

    jmodel = j_build_speech(jcfg.model, 80, "ctc")
    jstate = jax.jit(lambda rng: j_init_state(jmodel, jcfg, rng, 80, 8))(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(lambda t, p: jnp.asarray(p, t.dtype),
                                                jstate.params, params))
    jstep = j_scan_step(jmodel, jcfg, blank_id=0, ctc_impl="lattice")
    jstate, jcarry, jout = jstep(jstate, j_init_carry(jcfg.model, B), *map(jnp.asarray, group))

    monkeypatch.setattr(step_module, "compute_features", lambda audio, fe: torch.from_numpy(
        np.array(j_compute_features(jnp.asarray(audio.numpy()), jcfg.frontend))))
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl="lattice")
    _, carry, out = step(state, init_carry(cfg.model, B, device="cpu"),
                         *map(torch.from_numpy, group[:5]), group[5])

    np.testing.assert_allclose(out.loss.numpy(), np.asarray(jout.loss), rtol=1e-5)
    np.testing.assert_allclose(out.grad_norm.numpy(), np.asarray(jout.grad_norm), rtol=1e-4)
    np.testing.assert_allclose(out.per_loss.numpy(), np.asarray(jout.per_loss), rtol=1e-5)
    np.testing.assert_array_equal(out.in_lens.numpy(), np.asarray(jout.in_lens))
    np.testing.assert_array_equal(out.preds.numpy(), np.asarray(jout.preds))
    np.testing.assert_array_equal(out.keep.numpy(), np.asarray(jout.keep))
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(carry[k].numpy(), np.asarray(jcarry[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=f"carry {k}")
    p0 = torch_to_flax(p0, cfg.model)
    p1 = torch_to_flax(model.state_dict(), cfg.model)
    leaves = lambda t: [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(t)]
    d_t = np.concatenate([b - a for a, b in zip(leaves(p0), leaves(p1))])
    d_j = np.concatenate([b - a for a, b in zip(leaves(p0), leaves(jstate.params))])
    assert np.abs(d_j).max() > 0
    assert np.linalg.norm(d_t - d_j) <= 1e-2 * np.linalg.norm(d_j)


@pytest.mark.parametrize("feed", [700, 4000])
def test_streaming_matches_offline_greedy(feed):
    cfg = Config().apply_overrides(BASE)
    model = build_speech_model(cfg.model, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 2)
    audio = np.random.default_rng(4).uniform(-0.5, 0.5, 16000 * 2).astype(np.float32)
    rec = StreamingRecognizer(model, cfg, chunk_frames=32, device="cpu")
    for i in range(0, len(audio), feed):
        rec.accept_waveform(audio[i:i + feed])
    hop, win = cfg.frontend.hop_length, cfg.frontend.n_fft
    n_frames = (len(audio) - (win - hop)) // rec.chunk_samples * rec.chunk_frames
    with torch.inference_mode():
        feats = compute_features(torch.from_numpy(audio[None]), cfg.frontend)[:, :n_frames]
        logits, _ = model(feats, init_carry(cfg.model, 1, device="cpu"), None)
        lp = torch.log_softmax(logits.float(), -1)
    want = ctc_greedy_decode_to_lists(lp, torch.tensor([lp.shape[1]]))[0]
    assert len(want) > 5
    assert rec.tokens == want
