"""Tensor parallelism of the xLSTM, the LSTM and the RWKV: the port's train
step under a mesh of gloo ranks on the CPU (``python -m
statecatcher_tpu_torch.parallel.dryrun``) against the JAX package's
``make_segment_scan_step`` under the same mesh on virtual CPU devices, its
parameters placed by JAX's ``shard_params_tp``.

  * The xLSTM (E=32, 2 heads, 2 blocks, dqk = dv = 16, chunk 16,
    ``ffn_proj_factor`` 2.5: d_ff 80), in float32.  JAX shards q, k, v and
    the FFN's gate and up; the port's model rank m holds head m and FFN
    columns [40·m, 40·(m+1)).  mp=2: the forward of segment 0 and the step
    through "auto" (the chunkwise form on the CPU), "fused" and "pallas"
    (K9's and K10's plain versions on the rank's head) and "auto" with
    ``ffn_remat`` (JAX's step without it: the recompute changes no value);
    dp=2 × mp=2: the step.  The tolerances of
    tests/test_torch_xlstm_train_step.py: losses rtol 1e-5, grad norms 1e-4,
    the carry rtol 2e-4 / atol 2e-5, the updates within 1 % of their norm
    (lr 1e-6).  Float32, because the port takes the mLSTM's products in
    float64 under float64 and JAX does not (ROADMAP.md §3).
  * The LSTM (mp=2) and the RWKV (dp=2 × mp=2): no leaf is sharded, in JAX
    as here, so every model rank runs the whole step on its data group's
    rows; float64 at tests/test_torch_train_step.py's tolerances.
  * The refusals: JAX's ``shard_params_tp`` and the port both raise
    ``ValueError`` for the config's default ``ffn_proj_factor`` 2.667 (d_ff
    85 at E=32, 1365 at E=512) at mp=2, and the port for 2 heads over mp=4.

The group (K=2, B=4, one ``row_valid=False`` row) and the frontend (the
audio's own samples, which both packages compute exactly) are
tests/test_torch_parallel_step.py's.
"""

import jax
import numpy as np
import pytest
import torch

import statecatcher_tpu.models.rwkv as j_rwkv
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.config import MeshConfig as JMeshConfig
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.parallel.mesh import make_mesh_plan as j_make_mesh_plan
from statecatcher_tpu.parallel.mesh import shard_params_tp as j_shard_params_tp
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu_torch.config import Config, MeshConfig
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan, shard_model_tp
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_parallel_step import V, _close, _run_jax, _setup
from test_torch_train_step import ATOL, RTOL, _JnpF64
from torch_ranks import dryrun, rank_budget  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

XLSTM = ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "32",
         "--model.xlstm.num_heads", "2", "--model.xlstm.num_blocks", "2",
         "--model.xlstm.qk_dim_factor", "1.0", "--model.xlstm.chunk_size", "16",
         "--model.xlstm.ffn_proj_factor", "2.5", "--model.vocab_size", str(V),
         "--train.optim.lr", "1e-6", "--train.ctc_impl", "lattice"]
F64 = ["--model.hidden_size", "16", "--model.num_layers", "2", "--model.vocab_size", str(V),
       "--model.dtype", "float64", "--model.param_dtype", "float64",
       "--train.optim.lr", "3e-3", "--train.ctc_impl", "lattice"]
LSTM = ["--model.encoder", "lstm"] + F64
RWKV = ["--model.encoder", "rwkv"] + F64
# the xLSTM's float32 tolerances (tests/test_torch_xlstm_train_step.py)
F32_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "per_loss": 1e-5, "carry": 2e-4}
F32_CARRY_ATOL = 2e-5


def _tp(dp, mp, *extra):
    return ["--mesh.data_parallel", str(dp), "--mesh.model_parallel", str(mp), *extra]


def _check_outs(got, want, rtol, r, dp, n_ranks, what):
    """The loss and grad norm (global) and rank r's rows' per-utterance loss."""
    for k in ("loss", "grad_norm"):
        _close(got[k], want["outs"][k], rtol[k], 0, f"{what} rank {r} {k}")
    d = r // (n_ranks // dp)
    _close(got["per_loss"], want["outs"]["per_loss"][:, d::dp], rtol["per_loss"], 0,
           f"{what} rank {r} per_loss")


def _check_f32(ranks, want, cfg, params0, mode, dp):
    """A float32 xLSTM mode on every rank against JAX's step."""
    flat = lambda tree: np.concatenate([np.asarray(x, np.float64).ravel()
                                        for x in jax.tree_util.tree_leaves(tree)])
    p0, pj = flat(params0), flat(want["params"])
    assert np.abs(pj - p0).max() > 0
    for r, res in enumerate(ranks):
        got = res[mode]
        assert got["plan"][:2] == (dp, 2)
        _check_outs(got, want, F32_RTOL, r, dp, len(ranks), mode)
        for k, v in want["carry"].items():
            _close(got["carry"][k], v, F32_RTOL["carry"], F32_CARRY_ATOL,
                   f"{mode} rank {r} carry {k}")
        pt = flat(torch_to_flax(got["params"], cfg.model))
        assert np.linalg.norm(pt - pj) <= 1e-2 * np.linalg.norm(pj - p0), f"{mode} rank {r}"


def _check_f64(ranks, want, cfg, mode, dp):
    """A float64 mode on every rank against JAX's step, at the tolerances of
    tests/test_torch_train_step.py."""
    for r, res in enumerate(ranks):
        got = res[mode]
        assert got["plan"][:2] == (dp, 2)
        _check_outs(got, want, RTOL, r, dp, len(ranks), mode)
        flat = jax.tree_util.tree_leaves_with_path
        for (path, a), (_, b) in zip(flat(torch_to_flax(got["params"], cfg.model)),
                                     flat(want["params"])):
            _close(a, np.asarray(b), RTOL["params"], ATOL["params"],
                   f"{mode} rank {r} {jax.tree_util.keystr(path)}")
        for k, v in want["carry"].items():
            _close(got["carry"][k], v, RTOL["carry"], ATOL["carry"], f"{mode} rank {r} carry {k}")


def test_xlstm_tensor_parallel_forward_and_steps_match_jax(tmp_path, monkeypatch, rank_budget):
    """mp=2: the forward and the step by "auto", "fused", "pallas" and "auto"
    with ffn_remat, each on the rank's head, in one launch."""
    cfg, jcfg, params, sd, group, feats = _setup(XLSTM, seed=7)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=1, model_parallel=2), 2,
                    monkeypatch, tp=True, forward=True, x64=False)
    modes = [("auto", _tp(1, 2)),
             ("fused", _tp(1, 2, "--model.xlstm.kernel_impl", "fused")),
             ("pallas", _tp(1, 2, "--model.xlstm.kernel_impl", "pallas")),
             ("remat", _tp(1, 2, "--model.xlstm.ffn_remat", "true"))]
    ranks = dryrun(tmp_path, rank_budget, 2, {"overrides": XLSTM, "params": sd, "group": group,
                                              "features": feats, "forward": True,
                                              "modes": modes})
    logits, state = want["forward"]
    for mode, _ in modes:
        for r, res in enumerate(ranks):
            fwd = res[mode]["forward"]
            _close(fwd["logits"], logits, 1e-5, 1e-6, f"{mode} rank {r} forward logits")
            for k, v in state.items():
                _close(fwd["state"][k], v, F32_RTOL["carry"], F32_CARRY_ATOL,
                       f"{mode} rank {r} forward {k}")
        _check_f32(ranks, want, cfg, params, mode, dp=1)
    # the sharded leaves were each rank's own block: q of 2 × 16 rows, one head
    assert ranks[0]["auto"]["plan"] == (1, 2, False)


def test_xlstm_data_and_tensor_parallel_step_matches_jax(tmp_path, monkeypatch, rank_budget):
    cfg, jcfg, params, sd, group, feats = _setup(XLSTM, seed=8)
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=2, model_parallel=2), 4,
                    monkeypatch, tp=True, x64=False)
    ranks = dryrun(tmp_path, rank_budget, 4, {"overrides": XLSTM, "params": sd, "group": group,
                                              "features": feats,
                                              "modes": [("dptp", _tp(2, 2))]})
    _check_f32(ranks, want, cfg, params, "dptp", dp=2)


@pytest.mark.parametrize("encoder,dp", [("lstm", 1), ("rwkv", 2)])
def test_replicated_encoders_tensor_parallel_step_matches_jax(tmp_path, monkeypatch, rank_budget,
                                                              encoder, dp):
    """No leaf of the LSTM or the RWKV is sharded: each model rank runs the
    whole step, and the result is JAX's TP step's."""
    ov = {"lstm": LSTM, "rwkv": RWKV}[encoder]
    cfg, jcfg, params, sd, group, feats = _setup(ov, seed=9 + dp)
    monkeypatch.setattr(j_rwkv, "jnp", _JnpF64())
    want = _run_jax(jcfg, params, group, JMeshConfig(data_parallel=dp, model_parallel=2), 2 * dp,
                    monkeypatch, tp=True)
    ranks = dryrun(tmp_path, rank_budget, 2 * dp, {"overrides": ov, "params": sd, "group": group,
                                                   "features": feats,
                                                   "modes": [("tp", _tp(dp, 2))]})
    _check_f64(ranks, want, cfg, "tp", dp)


def _xlstm(*extra):
    return Config().apply_overrides(XLSTM + list(extra))


def test_tensor_parallel_refusals_match_jax():
    """d_ff = int(E · 2.667) is odd (85 at E=32): JAX's ``shard_params_tp``
    and the port both refuse it at mp=2, naming the FFN leaf; 2.5 passes in
    both.  The port also refuses 2 heads over mp=4 (a rank holds whole
    heads), and the flagship's 1365 at E=512."""
    plan = j_make_mesh_plan(JMeshConfig(data_parallel=1, model_parallel=2), jax.devices()[:2])
    for factor, ok in (("2.667", False), ("2.5", True)):
        ov = XLSTM + ["--model.xlstm.ffn_proj_factor", factor]
        jcfg = JConfig().apply_overrides(ov)
        jmodel = j_build_speech(jcfg.model, 80, "ctc")
        jparams = jax.jit(lambda r: j_init_state(jmodel, jcfg, r, 80, 8))(
            jax.random.PRNGKey(0)).params
        model = build_speech_model(Config().apply_overrides(ov).model, 80, "ctc", device="cpu")
        port_plan = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=2), world=2, rank=1)
        if ok:
            j_shard_params_tp(jparams, plan)
            assert "asr.encoder.block0_ffn.gate.weight" in shard_model_tp(model, port_plan)
            assert model.asr.encoder.block0_ffn.gate.weight.shape == (40, 32)
        else:
            with pytest.raises(ValueError, match="divisible by 2"):
                j_shard_params_tp(jparams, plan)
            with pytest.raises(ValueError, match=r"block0_ffn\.gate\.weight: 85 rows .*2\.667"):
                shard_model_tp(model, port_plan)
    four = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=4), world=4, rank=0)
    model = build_speech_model(_xlstm().model, 80, "ctc", device="cpu")
    with pytest.raises(ValueError, match=r"block0_mlstm\.q\.weight: its 2 heads"):
        shard_model_tp(model, four)
    flagship = build_speech_model(Config().apply_overrides(["--model.encoder", "xlstm"]).model,
                                  80, "ctc", device="cpu")
    two = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=2), world=2, rank=0)
    with pytest.raises(ValueError, match="1365 rows"):
        shard_model_tp(flagship, two)
