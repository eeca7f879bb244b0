"""The port's train step under a mesh of gloo ranks on the CPU
(``python -m statecatcher_tpu_torch.parallel.dryrun``) against the JAX
package's ``make_segment_scan_step`` under the same mesh on virtual CPU
devices:

  * data parallelism over 2 ranks (``MeshConfig(data_parallel=2)``), CTC and
    RNN-T, with one ``row_valid=False`` row on one rank only, so the ranks
    hold different numbers of valid rows and only the global masked mean
    agrees with JAX;
  * tensor parallelism, mp=2 (the forward, as tests/test_tensor_parallel.py,
    and the step) and dp=2 × mp=2 (the step), the JAX side's gate
    projections sharded by its ``shard_params_tp``;
  * sequence parallelism (``kernel_impl="sp"``) over 2 ranks against JAX's
    "sp" step, whose scans run ``linear_scan_time_sharded`` over 'model'.

A tiny LucyRNN (2 layers × 16, vocab 24), one group of K=2 segments at
B=4, weights from ``testing.randomize_`` (gate projections × 0.1) through
``convert.py`` to JAX and back.  Both sides compute in float64 (JAX with
x64, its float32 casts read as float64, as tests/test_torch_train_step.py
does), with that test's tolerances: losses and grad norms rtol 1e-9,
per-utterance losses 1e-7, parameters and the carry after the update 1e-8
(atol 5e-9 and 1e-10).  Both steps are given one frontend, as that test
gives them: here the audio itself, 80 samples of each frame's hop, which
both compute exactly (a sharded JAX step computes its float32 MFCCs with
other round-off than an unsharded one, and Adam's second update carries
that into parameters at 5e-4 of their step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt as j_rnnt_module
import statecatcher_tpu.train.step as j_step_module
from statecatcher_tpu.config import Config as JConfig, MeshConfig as JMeshConfig
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.parallel.mesh import make_mesh_plan as j_make_mesh_plan
from statecatcher_tpu.parallel.mesh import shard_params_tp as j_shard_params_tp
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu.train.step import make_segment_scan_step as j_scan_step
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.frontend import num_frames
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import randomize_
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_step import ATOL, RTOL, _JnpF64
from torch_ranks import dryrun, rank_budget  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

K, B, S, U, V = 2, 4, 4000, 6, 24
BASE = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
        "--model.vocab_size", str(V), "--model.lucyrnn.kernel_impl", "xla-scan",
        "--model.dtype", "float64", "--model.param_dtype", "float64",
        "--train.optim.lr", "3e-3", "--train.ctc_impl", "lattice"]
RNNT = ["--train.mode", "rnnt", "--model.rnnt_pred_emb_dim", "12", "--model.rnnt_joiner_dim", "20"]


def _group(seed):
    """One group of the global batch; row 1 (data rank 1's first row under
    dp=2) is invalid, so rank 0 holds 2 valid rows and rank 1 one."""
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.3, 0.3, (K, B, S)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, (K, B)).astype(np.int32)
    lens[:, 0] = S
    row_valid = np.ones((K, B), bool)
    row_valid[:, 1] = False
    return {"audio": audio, "mask": np.arange(S)[None, None, :] < lens[..., None],
            "tokens": rng.integers(1, V, (K, B, U)).astype(np.int32),
            "tok_lens": rng.integers(1, U + 1, (K, B)).astype(np.int32),
            "row_valid": row_valid, "seg_valid": np.ones((K,), bool)}


def _setup(overrides, seed):
    """(port config, JAX config, flax params, port state dict, group, JAX
    features of the group's audio)."""
    cfg, jcfg = Config().apply_overrides(overrides), JConfig().apply_overrides(overrides)
    model = build_speech_model(cfg.model, 80, cfg.train.mode, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1, gate_weight_scale=0.1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    group = _group(seed)
    return cfg, jcfg, params, flax_to_torch(params, cfg.model), group, _frames(group["audio"])


def _frames(audio):
    """The tests' frontend: (..., S) audio → (..., T, 80): the first 80
    samples of each hop of S/T (T = the frontend's frame count)."""
    T = num_frames(S, Config().frontend)
    return audio[..., :T * (S // T)].reshape(*audio.shape[:-1], T, S // T)[..., :80]


def _run_jax(jcfg, params, group, mesh_cfg, n_dev, monkeypatch, tp=False, forward=False,
             x64=True):
    """JAX's step (and forward of segment 0) under a (data, model) mesh of
    ``n_dev`` virtual devices; in float64 unless ``x64`` is False."""
    if x64:
        monkeypatch.setattr(j_step_module, "jnp", _JnpF64())
        monkeypatch.setattr(j_rnnt_module, "jnp", _JnpF64())
    monkeypatch.setattr(j_step_module, "compute_features", lambda audio, fe: _frames(audio))
    plan = j_make_mesh_plan(mesh_cfg, jax.devices()[:n_dev])
    with jax.enable_x64(x64):
        model = j_build_speech(jcfg.model, 80, jcfg.train.mode)
        state = jax.jit(lambda r: j_init_state(model, jcfg, r, 80, 8))(jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree.map(
            lambda t, p: jnp.asarray(p, t.dtype), state.params, params))
        state = plan.shard_replicated(state)
        if tp:
            state = state.replace(params=j_shard_params_tp(state.params, plan))
        carry = plan.shard_batch(j_init_carry(jcfg.model, B))
        out = {}
        if forward:
            from statecatcher_tpu.frontend import compute_frame_mask

            feats = jnp.asarray(_frames(group["audio"][0]))
            fm, _ = compute_frame_mask(jnp.asarray(group["mask"][0]), feats.shape[1])
            logits, st = jax.jit(lambda p, f, c, m: model.apply(p, f, c, m))(
                state.params, plan.shard_batch(feats), carry, plan.shard_batch(fm))
            out["forward"] = (np.asarray(logits), {k: np.asarray(v) for k, v in st.items()})
        step = j_scan_step(model, jcfg, blank_id=0, ctc_impl="lattice", mesh_plan=plan)
        state, carry, outs = step(state, carry, *(jnp.asarray(group[k]) for k in (
            "audio", "mask", "tokens", "tok_lens", "row_valid", "seg_valid")))
        out["outs"] = {k: np.asarray(getattr(outs, k)) for k in ("loss", "grad_norm", "per_loss")}
        out["params"] = jax.tree.map(np.asarray, state.params)
        out["carry"] = {k: np.asarray(v) for k, v in carry.items()}
    return out


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _check(ranks, want, cfg, mode, dp):
    """Every rank's result against JAX's (the loss, grad norm, parameters and
    global carry are global; per-utterance losses are each rank's rows)."""
    for r, res in enumerate(ranks):
        got = res[mode]
        assert got["plan"][0] == dp
        _close(got["loss"], want["outs"]["loss"], RTOL["loss"], 0, f"rank {r} loss")
        _close(got["grad_norm"], want["outs"]["grad_norm"], RTOL["grad_norm"], 0,
               f"rank {r} grad_norm")
        d = r // (len(ranks) // dp)
        _close(got["per_loss"], want["outs"]["per_loss"][:, d::dp], RTOL["per_loss"], 0,
               f"rank {r} per_loss")
        flat = jax.tree_util.tree_leaves_with_path
        for (path, a), (_, b) in zip(flat(torch_to_flax(got["params"], cfg.model)),
                                     flat(want["params"])):
            _close(a, np.asarray(b), RTOL["params"], ATOL["params"],
                   f"rank {r} {jax.tree_util.keystr(path)}")
        for k in ("h", "s"):
            _close(got["carry"][k], want["carry"][k], RTOL["carry"], ATOL["carry"],
                   f"rank {r} carry {k}")


@pytest.mark.parametrize("mode", ["ctc", "rnnt"])
def test_data_parallel_step_matches_jax(tmp_path, mode, monkeypatch, rank_budget):
    ov = BASE + (RNNT if mode == "rnnt" else [])
    cfg, jcfg, params, sd, group, feats = _setup(ov, seed=3)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=2), 2, monkeypatch)
    ranks = dryrun(tmp_path, rank_budget, 2, {"overrides": ov, "params": sd, "group": group,
                                 "features": feats,
                                 "modes": [("dp", ["--mesh.data_parallel", "2"])]})
    _check(ranks, want, cfg, "dp", dp=2)


def test_tensor_parallel_forward_and_step_match_jax(tmp_path, monkeypatch, rank_budget):
    cfg, jcfg, params, sd, group, feats = _setup(BASE, seed=4)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=1, model_parallel=2), 2,
                    monkeypatch, tp=True, forward=True)
    ranks = dryrun(tmp_path, rank_budget, 2, {"overrides": BASE, "params": sd, "group": group,
                                 "features": feats, "forward": True,
                                 "modes": [("tp", ["--mesh.data_parallel", "1",
                                                   "--mesh.model_parallel", "2"])]})
    logits, state = want["forward"]
    for r, res in enumerate(ranks):
        fwd = res["tp"]["forward"]
        _close(fwd["logits"], logits, RTOL["loss"], 1e-12, f"rank {r} forward logits")
        for k in ("h", "s"):
            _close(fwd["state"][k], state[k], RTOL["carry"], ATOL["carry"], f"rank {r} forward {k}")
    _check(ranks, want, cfg, "tp", dp=1)
    # the model rank's shard of the gate projection: 7 gates × 8 of the 16 columns
    assert ranks[0]["tp"]["plan"] == (1, 2, False)


def test_data_and_tensor_parallel_step_matches_jax(tmp_path, monkeypatch, rank_budget):
    cfg, jcfg, params, sd, group, feats = _setup(BASE, seed=5)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=2, model_parallel=2), 4,
                    monkeypatch, tp=True)
    ranks = dryrun(tmp_path, rank_budget, 4, {"overrides": BASE, "params": sd, "group": group,
                                 "features": feats,
                                 "modes": [("dptp", ["--mesh.data_parallel", "2",
                                                     "--mesh.model_parallel", "2"])]})
    _check(ranks, want, cfg, "dptp", dp=2)


def test_sequence_parallel_step_matches_jax(tmp_path, monkeypatch, rank_budget):
    ov = BASE + ["--model.lucyrnn.kernel_impl", "sp"]
    cfg, jcfg, params, sd, group, feats = _setup(ov, seed=6)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=1, model_parallel=2), 2,
                    monkeypatch)
    ranks = dryrun(tmp_path, rank_budget, 2, {"overrides": ov, "params": sd, "group": group,
                                 "features": feats,
                                 "modes": [("sp", ["--mesh.data_parallel", "1",
                                                   "--mesh.model_parallel", "2"])]})
    _check(ranks, want, cfg, "sp", dp=1)
    assert ranks[0]["sp"]["plan"] == (1, 2, True)
