"""The dual scan of the PyTorch port (K11,
statecatcher_tpu_torch/ops/lucy_pallas.py:lucy_dual_scan) against the JAX
package.

  * Forward: the port's plain version (what the wrapper runs on CPU
    tensors) against the JAX TPU kernel ``lucy_dual_scan`` run under
    ``pltpu.force_tpu_interpret_mode()``, in float32, on the four planes
    (a_s, b_s, a_h, h_pre_n) that JAX's ``lucy_gate_coeffs`` makes from
    conditioned gates, masked and unmasked, with D = 200 (not a multiple of
    128, which JAX pads), T = 257 and T = 300 (two of JAX's 256-row time
    chunks, the second ragged) and T = 1.
    Tolerances of the fused cell's kernel checks
    (tests/test_torch_cuda.py:assert_cell_close): h atol 2e-5, s within 1e-6
    of its scale plus 1e-4 relative (Hillis–Steele chunks against a
    sequential walk: f32 round-off only).
  * Gradients, in float64: the port's autograd Function (two adjoint scans
    through K5b's plain version, the rest in torch) against ``jax.vjp`` of
    the same function written as JAX's XLA split path (JAX's
    ``linear_scan(impl="xla-scan")`` twice around the tanh), in all six
    inputs; and ``lucy_cell_parallel(impl="pallas-dual")`` against JAX's
    ``lucy_cell_parallel(impl="xla-scan")`` with a bias, masked and not.
    Values to 1e-10, gradients to 1e-9 (tests/test_torch_lucyrnn_masked.py).
    No JAX gradient is taken through an interpret-mode kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.models.lucyrnn import lucy_cell_parallel as j_cell
from statecatcher_tpu.ops.lucy_pallas import lucy_dual_scan as j_dual_scan
from statecatcher_tpu.ops.lucy_pallas import lucy_gate_coeffs as j_gate_coeffs
from statecatcher_tpu.ops.scan import linear_scan as j_scan
from statecatcher_tpu_torch.models.lucyrnn import lucy_cell_parallel
from statecatcher_tpu_torch.ops.lucy_pallas import lucy_dual_scan, lucy_dual_scan_ref
from test_torch_cuda import assert_cell_close, conditioned_cell_data, single_torch_thread  # noqa: F401
from test_torch_lucy_fused_cell import GRAD, VAL, frame_mask

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def planes(seed, B, T, D, masked, dtype=np.float32):
    """(a_s, b_s, a_h, h_pre_n) from JAX's gate chain on conditioned gates,
    and h0, s0, as numpy arrays."""
    gates, bias, h0, s0 = conditioned_cell_data(seed, B, T, D, dtype)
    mask = frame_mask(B, T) if masked else None
    with jax.enable_x64(dtype == np.float64):
        a_s, b_s, a_h, _, h_pre_n = j_gate_coeffs(
            jnp.asarray(gates), None if mask is None else jnp.asarray(mask), jnp.asarray(bias))
        return [np.array(x) for x in (a_s, b_s, a_h, h_pre_n)] + [h0, s0]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,D", [(1, 128), (5, 128), (40, 200), (257, 128), (300, 128)])
def test_forward_matches_jax_interpret_kernel(T, D, masked):
    B = 2
    xs = planes(T + D, B, T, D, masked)
    with pltpu.force_tpu_interpret_mode():
        jh, js = j_dual_scan(*map(jnp.asarray, xs))
    before = lucy_dual_scan.launches
    th, ts = lucy_dual_scan(*map(torch.from_numpy, xs))
    assert lucy_dual_scan.launches == before                    # nothing launched on the CPU
    assert th.dtype == ts.dtype == torch.float32 and th.shape == (B, T, D)
    assert_cell_close(th.numpy(), ts.numpy(), np.asarray(jh), np.asarray(js))


def test_plain_bf16_computes_in_f32():
    xs = [torch.from_numpy(x) for x in planes(4, 2, 13, 8, True)]
    x16 = [x.to(torch.bfloat16) for x in xs[:4]] + xs[4:]
    h, s = lucy_dual_scan_ref(*x16)
    h32, s32 = lucy_dual_scan_ref(*[x.to(torch.float32) for x in x16])
    assert h.dtype == s.dtype == torch.bfloat16
    assert torch.equal(h, h32.to(torch.bfloat16)) and torch.equal(s, s32.to(torch.bfloat16))


def _j_dual_split(a_s, b_s, a_h, h_pre, h0, s0):
    """K11's function as JAX's XLA split path."""
    s_all = j_scan(a_s, b_s, s0, impl="xla-scan")
    c = jnp.tanh(h_pre + s_all)
    return j_scan(a_h, (1.0 - a_h) * c, h0, impl="xla-scan"), s_all


def test_function_grads_match_jax_split_path_f64():
    B, T, D = 2, 33, 8
    xs = planes(11, B, T, D, True, np.float64)
    rng = np.random.default_rng(12)
    w_h, w_s = rng.standard_normal((B, T, D)), rng.standard_normal((B, T, D))
    with jax.enable_x64(True):
        want, vjp = jax.vjp(_j_dual_split, *map(jnp.asarray, xs))
        jg = vjp((jnp.asarray(w_h), jnp.asarray(w_s)))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = lucy_dual_scan(*ts)
    ((got[0] * torch.from_numpy(w_h)).sum() + (got[1] * torch.from_numpy(w_s)).sum()).backward()
    for name, g_, w_ in zip(("h_all", "s_all"), got, want):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), err_msg=name, **VAL)
    for name, x, g in zip(("a_s", "b_s", "a_h", "h_pre", "h0", "s0"), ts, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD)


@pytest.mark.parametrize("masked", [True, False])
def test_cell_parallel_runs_k11_and_matches_jax_f64(masked):
    """``lucy_cell_parallel(impl="pallas-dual")``: the gate chain in torch,
    then K11's Function, against JAX's split path, values and gradients."""
    B, T, D = 3, 21, 8
    gates, bias, h0, s0 = conditioned_cell_data(13, B, T, D, np.float64)
    mask = frame_mask(B, T) if masked else None
    w = np.random.default_rng(14).standard_normal((B, T, D))

    def f(g, b, h, s):
        h_all, h_T, s_T = j_cell(g, h, s, impl="xla-scan", bias=b,
                                 frame_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(h_all * w) + jnp.sum(h_T) + 0.5 * jnp.sum(s_T), (h_all, h_T, s_T)

    with jax.enable_x64(True):
        (_, want), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (gates, bias, h0, s0)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (gates, bias, h0, s0)]
    got = lucy_cell_parallel(xs[0], xs[2], xs[3], impl="pallas-dual", bias=xs[1],
                             frame_mask=None if mask is None else torch.from_numpy(mask))
    assert got[0].grad_fn.name() == "_DualScanBackward"
    ((got[0] * torch.from_numpy(w)).sum() + got[1].sum() + 0.5 * got[2].sum()).backward()
    for name, g_, w_ in zip(("h_all", "h_T", "s_T"), got, want):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), err_msg=name, **VAL)
    for name, x, g in zip(("gates", "bias", "h0", "s0"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD)
