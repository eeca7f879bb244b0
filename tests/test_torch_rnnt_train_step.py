"""The segment-group train step of the PyTorch port in RNN-T mode
(``--train.mode rnnt``) in lockstep with the JAX package's
``make_segment_scan_step``: a tiny LucyRNN (2 layers × 16, vocab 24) with
the predictor/joiner (embedding 12, join space 20), from the same parameters
(``convert.torch_to_flax``), 2 groups of K=2 segments with the carry
threaded, compared per segment (loss, grad norm, per-utterance NLL, the CTC
greedy output of the encoder) and after each group (every parameter, the
carry).

On the CPU both packages resolve ``rnnt_impl="auto"`` to the chunked
``rnnt_loss_fused``.  Both compute in float64 (JAX with x64; its float32
casts in the step and in ``ops/rnnt.py`` are read as float64), with the
harness and tolerances of tests/test_torch_train_step.py: losses, grad
norms, parameters and the carry to rtol 1e-9/1e-8, per-utterance losses to
1e-7 (float32 outputs).
"""

import jax
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt as j_rnnt_module
import statecatcher_tpu.train.step as j_step_module
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
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_step import ATOL, BASE, RTOL, B, _close, _groups, _jax_features, _JnpF64

pytestmark = pytest.mark.usefixtures("single_torch_thread")

RNNT = BASE + ["--train.mode", "rnnt", "--model.rnnt_pred_emb_dim", "12",
               "--model.rnnt_joiner_dim", "20"]
_JAX = {}


def _run_jax(cfg, params, groups, monkeypatch):
    monkeypatch.setattr(j_step_module, "jnp", _JnpF64())
    monkeypatch.setattr(j_rnnt_module, "jnp", _JnpF64())
    with jax.enable_x64(True):
        if "step" not in _JAX:
            model = j_build_speech(cfg.model, 80, "rnnt")
            _JAX["init"] = jax.jit(lambda rng: j_init_state(model, cfg, rng, 80, 8))
            _JAX["step"] = j_scan_step(model, cfg, blank_id=0)
        state = _JAX["init"](jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree.map(
            lambda tmpl, p: jax.numpy.asarray(p, tmpl.dtype), state.params, params))
        carry = j_init_carry(cfg.model, B)
        res = []
        for grp in groups:
            state, carry, outs = _JAX["step"](state, carry, *map(jax.numpy.asarray, grp))
            res.append(({k: np.asarray(getattr(outs, k)) for k in outs._fields},
                        jax.tree.map(np.asarray, state.params),
                        {k: np.asarray(v) for k, v in carry.items()}))
    return res


def _run_torch(cfg, model, groups):
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0)
    carry = init_carry(cfg.model, B, device="cpu")
    res = []
    for audio, mask, tokens, tok_lens, row_valid, seg_valid in groups:
        state, carry, outs = step(state, carry, *map(torch.from_numpy, (
            audio, mask, tokens, tok_lens, row_valid)), seg_valid)
        res.append(({k: getattr(outs, k).numpy() for k in outs._fields},
                    torch_to_flax(model.state_dict(), cfg.model),
                    {k: v.numpy() for k, v in carry.items()}))
    return res


@pytest.mark.parametrize("case", ["adam", "row_invalid", "seg_invalid"])
def test_rnnt_segment_scan_step_matches_jax_in_lockstep(case, monkeypatch):
    cfg, jcfg = Config().apply_overrides(RNNT), JConfig().apply_overrides(RNNT)
    model = build_speech_model(cfg.model, 80, "rnnt", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1, gate_weight_scale=0.1)     # gate inputs near their offset biases
    params = torch_to_flax(model.state_dict(), cfg.model)
    assert "joiner" in params["params"]
    groups = _groups(case, seed=len(case) + 100)
    want = _run_jax(jcfg, params, groups, monkeypatch)
    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    got = _run_torch(cfg, model, groups)

    for g, ((t_out, t_par, t_car), (j_out, j_par, j_car)) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "per_loss"):
            _close(t_out[k], j_out[k], RTOL[k], 0, f"group {g} {k}")
        np.testing.assert_array_equal(t_out["in_lens"], j_out["in_lens"])
        np.testing.assert_array_equal(t_out["preds"], j_out["preds"])
        np.testing.assert_array_equal(t_out["keep"], j_out["keep"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(t_par),
                                     jax.tree_util.tree_leaves_with_path(j_par)):
            _close(a, b, RTOL["params"], ATOL["params"], f"group {g} {jax.tree_util.keystr(path)}")
        for k in ("h", "s"):
            _close(t_car[k], j_car[k], RTOL["carry"], ATOL["carry"], f"group {g} carry {k}")
    # the per-utterance transducer NLL goes to the filter as it is: the
    # masked mean over valid rows is the loss
    out, valid = got[0][0], groups[0][4]
    np.testing.assert_allclose(out["loss"], (out["per_loss"] * valid).sum(1) / valid.sum(1),
                               rtol=1e-6)
