"""The RNN-T train step of the PyTorch port with ``rnnt_impl="pallas"`` and
the default band (``train.rnnt_band=-1``: band 32 at a padded U of 64), in
lockstep with the JAX package's ``make_segment_scan_step``, whose banded
Pallas kernels run in interpret mode on the CPU: a tiny LucyRNN (2 layers ×
16, vocab 24, joiner 20) from the same parameters, one group of K=2 carried
segments with a row_valid=False row, compared per segment (loss, grad norm,
per-utterance NLL, the encoder's CTC greedy output) and after the group (the
parameters and the carry).

Both run in float32 (the JAX kernel computes its joint in float32 whatever
the model's dtype): losses and per-utterance NLLs to rtol 2e-5, grad norms
to 2e-4, the carry to 1e-4 of its scale; the parameters to 2·lr·K plus
rtol 1e-5, since Adam moves a component whose gradient is near zero by ±lr
on the sign of its round-off.
"""

import jax
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt_band as jrb
import statecatcher_tpu_torch.train.step as step_module
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu.train.step import make_segment_scan_step as j_scan_step
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.train.step import (
    init_train_state,
    make_segment_scan_step,
    resolve_rnnt_band,
)
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_step import _jax_features

pytestmark = pytest.mark.usefixtures("single_torch_thread")

K, B, S, U, V = 2, 3, 4000, 64, 24
LR = 1e-5
ARGS = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
        "--model.vocab_size", str(V), "--model.lucyrnn.kernel_impl", "xla-scan",
        "--train.optim.lr", str(LR), "--train.mode", "rnnt", "--train.rnnt_impl", "pallas",
        "--model.rnnt_pred_emb_dim", "12", "--model.rnnt_joiner_dim", "20"]


@pytest.fixture(autouse=True)
def _interpret():
    jrb._INTERPRET[0] = True
    yield
    jrb._INTERPRET[0] = False


def _group(seed):
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.3, 0.3, (K, B, S)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, (K, B)).astype(np.int32)
    lens[:, 0] = S
    mask = np.arange(S)[None, None, :] < lens[..., None]
    tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
    tok_lens = rng.integers(10, U + 1, (K, B)).astype(np.int32)
    tok_lens[0, 0] = U
    row_valid = np.ones((K, B), bool)
    row_valid[:, 2] = False
    return audio, mask, tokens, tok_lens, row_valid, np.ones((K,), bool)


def test_banded_rnnt_step_matches_jax_in_lockstep(monkeypatch):
    cfg, jcfg = Config().apply_overrides(ARGS), JConfig().apply_overrides(ARGS)
    assert resolve_rnnt_band(cfg.train.rnnt_band, U) == 32
    model = build_speech_model(cfg.model, 80, "rnnt", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1, gate_weight_scale=0.1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    group = _group(17)

    jmodel = j_build_speech(jcfg.model, 80, "rnnt")
    jstate = jax.jit(lambda rng: j_init_state(jmodel, jcfg, rng, 80, 8))(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(
        lambda tmpl, p: jax.numpy.asarray(p, tmpl.dtype), jstate.params, params))
    jstate, jcarry, jouts = j_scan_step(jmodel, jcfg, blank_id=0)(
        jstate, j_init_carry(jcfg.model, B), *map(jax.numpy.asarray, group))

    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0)
    state, carry, outs = step(state, init_carry(cfg.model, B, device="cpu"),
                              *map(torch.from_numpy, group[:5]), group[5])

    for k, rtol in (("loss", 2e-5), ("per_loss", 2e-5), ("grad_norm", 2e-4)):
        np.testing.assert_allclose(getattr(outs, k).numpy(), np.asarray(getattr(jouts, k)),
                                   rtol=rtol, atol=0, err_msg=k)
    for k in ("in_lens", "preds", "keep"):
        np.testing.assert_array_equal(getattr(outs, k).numpy(), np.asarray(getattr(jouts, k)))
    assert (outs.per_loss.numpy()[:, :2] > 0).all()
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(torch_to_flax(model.state_dict(), cfg.model)),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * LR * K,
                                   err_msg=jax.tree_util.keystr(path))
    for k in ("h", "s"):
        want = np.asarray(jcarry[k])
        np.testing.assert_allclose(carry[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f"carry {k}")
