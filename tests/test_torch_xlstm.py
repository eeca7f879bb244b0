"""The xLSTM encoder of the PyTorch port (statecatcher_tpu_torch/models/
xlstm.py) against the JAX package's on the same numpy-seeded inputs and
converted weights, in float32 on both sides: ``mlstm_recurrent``,
``mlstm_chunkwise`` (ragged T, nonzero carry; float32 and bf16 operands),
RMSNorm, the SwiGLU FFN, ``XLSTMEncoder`` through ``ASRModel`` over three
carried segments (a nonzero start carry, a partial frame mask on the last)
and its
parameter gradients, ``init_carry`` and the weight bridge.

Tolerances.  Values: rtol 2e-4, atol 2e-5, those of the JAX package's own
comparison of its fused kernel with its chunkwise form
(tests/test_mlstm_fused.py): float32 sums in other orders through the
exponential gating.  Gradients: rtol 5e-3, atol 5e-4 of the same file.  bf16
operands: both sides round the same values to bf16 and sum in float32, so h
(bf16) is within a few bf16 steps (rtol 2e-2, atol 2e-3); the float32 states
within 2e-3 of their scale, because the write weights k·w are rounded to
bf16 from float32 values that differ by round-off, so one may round a bf16
step (2^-8) apart.  The JAX side always runs its XLA chunkwise form (its
CPU path); the port's ``fused`` and ``pallas`` impls run the plain versions
of K9 and K10 here.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models import xlstm as jx
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.models import xlstm as tx
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from statecatcher_tpu_torch.models.layers import RMSNorm
from statecatcher_tpu_torch.models.speech import build_speech_model
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

VAL = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-3, atol=5e-4)
B, F, V = 2, 8, 12


def mlstm_inputs(seed, B=2, H=2, T=21, dqk=16, dv=16):
    """q, k, v (B, H, T, d), raw gates (B, H, T), a nonzero carry."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    return [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
            2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), np.abs(0.1 * r(B, H, dqk)),
            0.1 * r(B, H)]


def _close(got, want, what, **tol):
    for name, a, b in zip(("h", "C_T", "n_T", "m_T"), got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mlstm_chunkwise_matches_jax(chunk):
    xs = mlstm_inputs(chunk)
    want = jx.mlstm_chunkwise(*map(jnp.asarray, xs), chunk)
    got = tx.mlstm_chunkwise(*map(torch.from_numpy, xs), chunk)
    _close([t.numpy() for t in got], want, f"chunk {chunk}", **VAL)


def test_mlstm_chunkwise_bf16_operands_match_jax():
    xs = mlstm_inputs(5)
    jq = [jnp.asarray(x, jnp.bfloat16) for x in xs[:3]]
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in xs[:3]]
    want = jx.mlstm_chunkwise(*jq, *map(jnp.asarray, xs[3:]), 8)
    got = tx.mlstm_chunkwise(*tq, *map(torch.from_numpy, xs[3:]), 8)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    _close([got[0].float().numpy()], [np.asarray(want[0], np.float32)], "bf16",
           rtol=2e-2, atol=2e-3)
    for name, a, b in zip(("C_T", "n_T", "m_T"), got[1:], want[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-3 * np.abs(b).max(),
                                   err_msg=name)


def test_mlstm_recurrent_matches_jax():
    xs = mlstm_inputs(11, T=13)
    want = jx.mlstm_recurrent(*map(jnp.asarray, xs))
    got = tx.mlstm_recurrent(*map(torch.from_numpy, xs))
    _close([t.numpy() for t in got], want, "recurrent", **VAL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 16)) * 2.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = fnn.RMSNorm(dtype=jd).apply({"params": {"scale": jnp.asarray(scale)}},
                                       jnp.asarray(x, jd))
    norm = RMSNorm(16, dtype=getattr(torch, dtype), param_dtype=torch.float32)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    jffn = jx.SwiGLUFFN(embedding_dim=16, proj_factor=2.667)
    params = jffn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ffn = tx.SwiGLUFFN(16, 2.667, dtype=torch.float32, param_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("gate", "up", "down"):
            k = np.asarray(params["params"][name]["kernel"])
            getattr(ffn, name).weight.copy_(torch.from_numpy(k.T.copy()))
        got = ffn(torch.from_numpy(x))
    assert ffn.gate.weight.shape == (42, 16) and ffn.gate.bias is None
    np.testing.assert_allclose(got.numpy(), np.asarray(jffn.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def _overrides(impl="chunkwise", proj=-1, stack=1):
    return ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "32",
            "--model.xlstm.num_heads", "2", "--model.xlstm.num_blocks", "2",
            "--model.xlstm.qk_dim_factor", "1.0", "--model.xlstm.chunk_size", "8",
            "--model.xlstm.kernel_impl", impl, "--model.vocab_size", str(V),
            "--model.input_proj_dim", str(proj), "--model.stack_order", str(stack)]


def _random_params(jmodel, x, seed):
    """The JAX model's parameters with noise added everywhere (vocab_proj
    is zero at init)."""
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.ndim == 2:
            return (rng.standard_normal(a.shape) * (1.0 / np.sqrt(a.shape[0]))).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


def _carry(cfg, seed):
    rng = np.random.default_rng(seed)
    c = init_carry(cfg.model, B, device="cpu")
    out = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in c.items()}
    out["n"] = np.abs(out["n"])
    return out


_JAX_REF = {}


def _jax_reference(proj, stack):
    """The JAX model's parameters, inputs and results for one config (the
    XLA chunkwise form), computed once for all the port's impls: logits and
    carry after each of three carried segments of T=42 frames (ragged
    against chunk 8 at the stacked rate too) from a nonzero carry, a partial
    frame mask on the last; and the parameter gradients of a weighted sum of
    the first segment's logits."""
    key = (proj, stack)
    if key not in _JAX_REF:
        jcfg = JConfig().apply_overrides(_overrides("chunkwise", proj, stack))
        cfg = Config().apply_overrides(_overrides("chunkwise", proj, stack))
        rng = np.random.default_rng(7)
        feats = [rng.standard_normal((B, 42, F)).astype(np.float32) for _ in range(3)]
        Te = 42 // stack
        masks = [np.ones((B, Te), bool) for _ in range(3)]
        masks[2][1, Te // 2:] = False
        jmodel = j_build_model(jcfg.model, F)
        params = _random_params(jmodel, feats[0], 1)
        carry0 = _carry(cfg, 2)
        apply = jax.jit(jmodel.apply)
        jc, outs = {k: jnp.asarray(v) for k, v in carry0.items()}, []
        for x, m in zip(feats, masks):
            jl, jc = apply(params, jnp.asarray(x), jc, jnp.asarray(m))
            outs.append((np.asarray(jl), {k: np.asarray(v) for k, v in jc.items()}))
        w = rng.standard_normal((B, Te, V)).astype(np.float32)
        jcar = {k: jnp.asarray(v) for k, v in carry0.items()}
        grads = jax.jit(jax.grad(lambda p: jnp.sum(apply(p, jnp.asarray(feats[0]), jcar)[0] * w)))(
            params)
        _JAX_REF[key] = (params, feats, masks, carry0, outs, w, jax.device_get(grads))
    return _JAX_REF[key]


@pytest.mark.parametrize("impl", ["chunkwise", "recurrent", "fused", "pallas", "auto"])
def test_asr_model_matches_jax_over_carried_segments(impl):
    """The port's ASRModel with each ``kernel_impl`` (input projection 24,
    frame stacking 2) against the JAX model's chunkwise form: logits and
    carry after each of three carried segments, then the gradients."""
    proj, stack = 24, 2
    params, feats, masks, carry0, outs, w, jg = _jax_reference(proj, stack)
    cfg = Config().apply_overrides(_overrides(impl, proj, stack))
    model = build_model(cfg.model, F, device="cpu")
    model.load_state_dict(flax_to_torch(params, cfg.model))
    tc = {k: torch.from_numpy(v) for k, v in carry0.items()}
    with torch.no_grad():
        for s, (x, m, (jl, jc)) in enumerate(zip(feats, masks, outs)):
            tl, tc = model(torch.from_numpy(x), tc, torch.from_numpy(m))
            np.testing.assert_allclose(tl.numpy(), jl, err_msg=f"segment {s}", **VAL)
            for k in ("C", "n", "m"):
                np.testing.assert_allclose(tc[k].numpy(), jc[k], err_msg=f"segment {s} carry {k}",
                                           **VAL)
    logits, _ = model(torch.from_numpy(feats[0]), {k: torch.from_numpy(v)
                                                   for k, v in carry0.items()})
    (logits * torch.from_numpy(w)).sum().backward()
    tg = torch_to_flax({k: p.grad for k, p in model.named_parameters()}, cfg.model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tg),
                                 jax.tree_util.tree_leaves_with_path(jg)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path), **GRAD)


@pytest.mark.parametrize("carry_dtype", ["auto", "bfloat16"])
def test_init_carry_matches_jax(carry_dtype):
    ov = _overrides() + ["--model.carry_dtype", carry_dtype]
    want = j_init_carry(JConfig().apply_overrides(ov).model, 3)
    got = init_carry(Config().apply_overrides(ov).model, 3, device="cpu")
    assert set(got) == set(want) == {"C", "n", "m"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    model = build_model(Config().apply_overrides(ov).model, F, device="cpu")
    with torch.no_grad():
        _, state = model(torch.zeros(3, 10, F), got)
    assert all(state[k].dtype == got[k].dtype for k in got)


@pytest.mark.parametrize("kind", ["asr", "ctc"])
def test_weight_bridge_round_trips_bit_exactly(kind):
    """flax → torch → flax is bit-identical for the xLSTM's ASRModel and
    (under ``asr``) SpeechModel trees; a tree of another depth is refused."""
    params = _jax_reference(24, 2)[0]
    if kind == "ctc":
        params = {"params": {"asr": params["params"]}}
    cfg = Config().apply_overrides(_overrides(proj=24, stack=2))
    sd = flax_to_torch(params, cfg.model)
    model = (build_model(cfg.model, F, device="cpu") if kind == "asr"
             else build_speech_model(cfg.model, F, kind, device="cpu"))
    model.load_state_dict(sd)                                  # strict: names and shapes
    back = torch_to_flax(model.state_dict(), cfg.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    bad = Config().apply_overrides(_overrides(proj=24, stack=2) + ["--model.xlstm.num_blocks", "1"])
    with pytest.raises(ValueError, match="leaves"):
        flax_to_torch(params, bad.model)


def test_kernel_impl_routes():
    assert tx.resolve_kernel_impl("auto", True) == "fused"
    assert tx.resolve_kernel_impl("auto", False) == "chunkwise"
    for impl in ("fused", "pallas", "chunkwise", "recurrent"):
        assert tx.resolve_kernel_impl(impl, True) == tx.resolve_kernel_impl(impl, False) == impl
    with pytest.raises(ValueError, match="kernel_impl"):
        tx.resolve_kernel_impl("triton", False)


def test_randomize_gives_the_xlstm_logits():
    """vocab_proj is zero at init (greedy decoding of its logits emits
    nothing); ``testing.randomize_`` draws it, and keeps the gate biases
    near their init (−10 input, +3 forget)."""
    from statecatcher_tpu_torch.testing import randomize_

    model = build_model(Config().apply_overrides(_overrides()).model, F, device="cpu")
    assert not model.encoder.vocab_proj.weight.any()
    randomize_(model, 3)
    assert model.encoder.vocab_proj.weight.abs().min() > 0
    layer = model.encoder.block0_mlstm
    assert ((layer.igate.bias + 10.0).abs() < 0.5).all()
    assert ((layer.fgate.bias - 3.0).abs() < 0.5).all()
    with torch.no_grad():
        logits, _ = model(torch.randn(2, 30, F, generator=torch.Generator().manual_seed(0)))
    assert len(set(logits.argmax(-1).flatten().tolist())) > 1
