"""Backward of the fused LucyRNN cell in the PyTorch port (K2,
statecatcher_tpu_torch/ops/lucy_fused_lm.py): its plain version against the
JAX TPU kernel ``_fused_lm_bwd_impl`` run in Pallas interpret mode, the
autograd Function against ``jax.grad`` through the JAX ``custom_vjp``, and
``torch.autograd.gradcheck`` of the plain Function in float64.

Inputs are unit-normal gates whose k, v and h_pre biases are offset away from
0 (as ``testing.randomize_`` does for the model): near k = v = 0 the kv term
k·v/(q(q+ε)) has a derivative of order 1/q² and f32 round-off in the two
sides' different summation orders (sequential here, Hillis-Steele suffix
compositions in the kernel) would be amplified without bound.  With the
offsets, every output agrees to rtol 1e-4 plus 1e-6 of its own largest
value, f32 round-off over a few hundred recurrence steps.  The kernel itself
works in float32 (it casts its inputs), so the comparison is in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.lucy_fused_lm as jlm
from statecatcher_tpu_torch.ops.lucy_fused_lm import (
    lucy_cell_fused_lm,
    lucy_cell_fused_lm_bwd,
    lucy_cell_fused_lm_bwd_ref,
    lucy_cell_fused_lm_ref,
)
from test_torch_cuda import cell_data, conditioned_cell_data
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _close(got, want, name, rtol=1e-4, scale_tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    tol = rtol * np.abs(want) + scale_tol * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{name}: {bad.sum()} of {bad.size} off; worst |Δ| "
                           f"{np.abs(got - want).max():.3e} at scale {np.abs(want).max():.3e}")


@pytest.mark.parametrize("T", [7, 45, 300])
def test_plain_bwd_matches_jax_interpret_kernel(T):
    B, D = 2, 128
    gates, bias, h0, s0 = conditioned_cell_data(T, B, T, D)
    rng = np.random.default_rng(100 + T)
    g_h = rng.standard_normal((B, T, D)).astype(np.float32)
    g_s = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)     # nonzero carry path
    tg, tb, th0, ts0 = map(torch.from_numpy, (gates, bias, h0, s0))
    h_all, s_all = lucy_cell_fused_lm_ref(tg, tb, th0, ts0)
    want = jlm._fused_lm_bwd_impl.__wrapped__(
        jnp.asarray(gates), jnp.asarray(bias), jnp.asarray(h0), jnp.asarray(s0),
        jnp.asarray(h_all.numpy()), jnp.asarray(s_all.numpy()), jnp.asarray(g_h),
        jnp.asarray(g_s), chunk=32, interpret=True)
    got = lucy_cell_fused_lm_bwd_ref(tg, tb, th0, ts0, h_all, s_all,
                                     torch.from_numpy(g_h), torch.from_numpy(g_s))
    assert got[0].dtype == torch.float32 and got[0].shape == (B, T, 7 * D)
    for name, g, w in zip(("d_gates", "dh0", "ds0", "d_bias"), got, want):
        _close(g.numpy(), w, name)


def test_plain_bwd_takes_none_cotangents_as_zero():
    gates, bias, h0, s0 = map(torch.from_numpy, conditioned_cell_data(1, 2, 9, 8))
    h_all, s_all = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    g_h = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 8)).astype(np.float32))
    a = lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, None)
    b = lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, torch.zeros_like(g_h))
    before = lucy_cell_fused_lm_bwd.launches
    c = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, None)
    assert lucy_cell_fused_lm_bwd.launches == before          # nothing launched on the CPU
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.fixture
def jax_interpret(monkeypatch):
    """Run the JAX custom_vjp's Pallas kernels in interpret mode, as
    tests/test_lucy_fused_lm.py does."""
    monkeypatch.setattr(jlm, "_fused_lm_fwd_impl",
                        functools.partial(jlm._fused_lm_fwd_impl.__wrapped__, interpret=True))
    monkeypatch.setattr(jlm, "_fused_lm_bwd_impl",
                        functools.partial(jlm._fused_lm_bwd_impl.__wrapped__, interpret=True))


def test_function_grads_match_jax_grad(jax_interpret):
    B, T, D = 2, 37, 128
    gates, bias, h0, s0 = conditioned_cell_data(11, B, T, D)
    rng = np.random.default_rng(12)
    wh = rng.standard_normal((B, T, D)).astype(np.float32)
    ws = (0.1 * rng.standard_normal((B, T, D))).astype(np.float32)

    def j_loss(g, b, h, s):
        h_all, s_all = jlm.lucy_cell_fused_lm(g, b, h, s, 32)
        return jnp.sum(h_all * wh) + jnp.sum(s_all * ws)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (gates, bias, h0, s0)))
    args = [torch.from_numpy(x).requires_grad_() for x in (gates, bias, h0, s0)]
    h_all, s_all = lucy_cell_fused_lm(*args)
    ((h_all * torch.from_numpy(wh)).sum() + (s_all * torch.from_numpy(ws)).sum()).backward()
    for name, a, w in zip(("gates", "bias", "h0", "s0"), args, want):
        assert a.grad.dtype == torch.float32
        _close(a.grad.numpy(), w, name)


def test_function_gradcheck_f64():
    gates, bias, h0, s0 = conditioned_cell_data(13, 2, 5, 3, np.float64)
    args = [torch.from_numpy(x).requires_grad_() for x in (gates, bias, h0, s0)]
    assert torch.autograd.gradcheck(lucy_cell_fused_lm, args, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_function_grads_equal_autograd_of_plain_forward_f64():
    """Unconditioned unit-normal gates in float64: the closed-form backward
    equals autograd through the plain forward loop (the sqrt/divide gate
    chain) to 1e-9 of each gradient's scale."""
    gates, bias, h0, s0 = cell_data(14, 2, 23, 6, np.float64)
    w = torch.from_numpy(np.random.default_rng(15).standard_normal((2, 23, 6)))
    grads = []
    for fn in (lucy_cell_fused_lm, lucy_cell_fused_lm_ref):
        args = [torch.from_numpy(x).requires_grad_() for x in (gates, bias, h0, s0)]
        h_all, s_all = fn(*args)
        ((h_all * w).sum() + 0.1 * (s_all * w).sum()).backward()
        grads.append([a.grad.numpy() for a in args])
    for name, a, b in zip(("gates", "bias", "h0", "s0"), *grads):
        _close(a, b, name, rtol=1e-9, scale_tol=1e-9)
