"""The segment-group train step of the PyTorch port
(statecatcher_tpu_torch/train/step.py) in lockstep with the JAX package's
``make_segment_scan_step``: a tiny LucyRNN-CTC (2 layers × 16, vocab 24) from
the same parameters (``convert.torch_to_flax``), 2 groups of 2 segments with
the carry threaded, compared per segment (loss, grad norm, greedy output) and
after each group (every parameter, the carry).

Both sides compute the model in float64 (JAX with x64; the JAX side runs the
sequential ``xla-scan`` cell and the "lattice" CTC, the port the plain
versions of K1/K2 and its lattice), and the port's step is given the JAX
frontend's features (the two frontends agree to f32 round-off, tested in
tests/test_torch_frontend.py).  Losses, grad norms, parameters and the carry
agree to rtol 1e-9, parameters and the carry after two updates to 1e-8
(per-utterance losses 1e-7: float32 outputs, as in JAX).
Weights come from ``testing.randomize_`` with the gate projections scaled by
0.1, so every gate input stays near its offset bias, away from the gate
chain's singular points where round-off is amplified without bound.
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
import statecatcher_tpu.train.step as j_step_module
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu.train.step import make_segment_scan_step as j_scan_step
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

K, B, S, U, V = 2, 3, 4000, 6, 24
BASE = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
        "--model.vocab_size", str(V), "--model.lucyrnn.kernel_impl", "xla-scan",
        "--model.dtype", "float64", "--model.param_dtype", "float64",
        "--train.optim.lr", "3e-3"]

RTOL = {"loss": 1e-9, "grad_norm": 1e-9, "per_loss": 1e-7, "params": 1e-8, "carry": 1e-8}
# params: 5e-9 absolute, because the learning-rate schedule is evaluated in
# float32 (as in JAX) and the two libraries' cos may differ by one ulp
ATOL = {"params": 5e-9, "carry": 1e-10}

# case → config overrides; the optimizer cases are run by
# tests/test_torch_train_optim.py with the same harness
CASES = {
    "adam": [],
    "int16_audio": [],
    "row_invalid": [],
    "seg_invalid": [],
    "nan_segment": [],
}


def _groups(case, seed):
    """Two groups of (audio, mask, tokens, tok_lens, row_valid, seg_valid)."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(2):
        audio = rng.uniform(-0.3, 0.3, (K, B, S)).astype(np.float32)
        lens = rng.integers(S // 2, S + 1, (K, B)).astype(np.int32)
        lens[:, 0] = S
        mask = np.arange(S)[None, None, :] < lens[..., None]
        tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
        tok_lens = rng.integers(1, U + 1, (K, B)).astype(np.int32)
        row_valid = np.ones((K, B), bool)
        seg_valid = np.ones((K,), bool)
        if case == "int16_audio":
            audio = np.clip(np.rint(audio * 32767.0), -32768, 32767).astype(np.int16)
            mask = lens                                         # prefix lengths
        if case == "row_invalid":
            row_valid[:, 2] = False
        if case == "seg_invalid" and g == 1:
            seg_valid[1] = False
        if case == "nan_segment" and g == 1:
            audio[0, 1, 100:200] = np.nan
        out.append((audio, mask, tokens, tok_lens, row_valid, seg_valid))
    return out


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``: the skipped-segment
    branch of the JAX scan step builds its zeros as float32, which
    ``lax.cond`` refuses beside the float64 loss of an x64 run."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


_JAX_STEPS = {}


def _jax_step(cfg):
    """The JAX train-state init and scan step of ``cfg``, both jitted and
    built once per config (cases with the same config share a compilation)."""
    key = cfg.to_json()
    if key not in _JAX_STEPS:
        model = j_build_speech(cfg.model, 80, "ctc")
        init = jax.jit(lambda rng: j_init_state(model, cfg, rng, 80, 8))
        _JAX_STEPS[key] = (init, j_scan_step(model, cfg, blank_id=0, ctc_impl="lattice"))
    return _JAX_STEPS[key]


def _run_jax(cfg, params, groups, monkeypatch):
    monkeypatch.setattr(j_step_module, "jnp", _JnpF64())
    with jax.enable_x64(True):
        init, step = _jax_step(cfg)
        state = init(jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree.map(
            lambda tmpl, p: jnp.asarray(p, tmpl.dtype), state.params, params))
        carry = j_init_carry(cfg.model, B)
        res = []
        for grp in groups:
            state, carry, outs = step(state, carry, *map(jnp.asarray, grp))
            res.append(({k: np.asarray(getattr(outs, k)) for k in outs._fields},
                        jax.tree.map(np.asarray, state.params),
                        {k: np.asarray(v) for k, v in carry.items()}))
    return res


def _jax_features(jfe):
    """The JAX package's frontend in place of the port's, so both steps see
    the same features (the frontends agree to f32 round-off, tested in
    tests/test_torch_frontend.py; Adam would carry that round-off into the
    updates of gradient components that cancel over frames)."""
    def features(audio, fe):
        return torch.from_numpy(np.array(j_compute_features(jnp.asarray(audio.numpy()), jfe)))
    return features


def _run_torch(cfg, model, groups):
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl="lattice")
    carry = init_carry(cfg.model, B, device="cpu")
    res = []
    for audio, mask, tokens, tok_lens, row_valid, seg_valid in groups:
        state, carry, outs = step(state, carry, *map(torch.from_numpy, (
            audio, mask, tokens, tok_lens, row_valid)), seg_valid)
        res.append(({k: getattr(outs, k).numpy() for k in outs._fields},
                    torch_to_flax(model.state_dict(), cfg.model),
                    {k: v.numpy() for k, v in carry.items()}))
    return res


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_segment_scan_step_matches_jax_in_lockstep(case, monkeypatch):
    check_lockstep(case, CASES[case], monkeypatch)


def check_lockstep(case, overrides, monkeypatch):
    """Run both packages' scan steps over two groups of ``case`` and compare."""
    ov = BASE + overrides
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    model = build_speech_model(cfg.model, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1, gate_weight_scale=0.1)     # gate inputs near their offset biases
    params = torch_to_flax(model.state_dict(), cfg.model)
    groups = _groups(case, seed=len(case))
    want = _run_jax(jcfg, params, groups, monkeypatch)
    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    got = _run_torch(cfg, model, groups)

    for g, ((t_out, t_par, t_car), (j_out, j_par, j_car)) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "per_loss"):
            _close(t_out[k], j_out[k], RTOL[k], 0, f"group {g} {k}")
        np.testing.assert_array_equal(t_out["in_lens"], j_out["in_lens"])
        live = np.isfinite(j_out["loss"])
        np.testing.assert_array_equal(t_out["preds"][live], j_out["preds"][live])
        np.testing.assert_array_equal(t_out["keep"][live], j_out["keep"][live])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(t_par),
                                     jax.tree_util.tree_leaves_with_path(j_par)):
            _close(a, b, RTOL["params"], ATOL["params"], f"group {g} {jax.tree_util.keystr(path)}")
        for k in ("h", "s"):
            _close(t_car[k], j_car[k], RTOL["carry"], ATOL["carry"], f"group {g} carry {k}")

    if case == "nan_segment":
        # the poisoned row's loss is zeroed (zero_infinity) but its gradient
        # is NaN: the segment changed nothing (held against JAX above)
        out = got[1][0]
        assert np.isfinite(out["loss"][0]) and not np.isfinite(out["grad_norm"][0])
        assert np.isfinite(out["grad_norm"][1])
    if case == "seg_invalid":
        assert got[1][0]["loss"][1] == 0.0 and not got[1][0]["keep"][1].any()
    if case == "accumulation":
        # the first micro-step of each pair leaves the parameters unchanged
        assert got[0][0]["grad_norm"][0] > 0
