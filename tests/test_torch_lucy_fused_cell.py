"""The fused masked LucyRNN cell of the PyTorch port (K12,
statecatcher_tpu_torch/ops/lucy_pallas.py:lucy_fused_cell) against the JAX
package.

  * Forward: the port's plain version (what the wrapper runs on CPU
    tensors) against the JAX TPU kernel ``lucy_fused_cell`` run under
    ``pltpu.force_tpu_interpret_mode()``, in float32, masked and unmasked,
    with D = 200 (not a multiple of 128, which JAX pads) and T = 300 (two of
    JAX's 256-row time chunks).  Tolerances of the fused cell's kernel
    checks (tests/test_torch_cuda.py:assert_cell_close): h atol 2e-5, s
    within 1e-6 of its scale plus 1e-4 relative.  The TPU kernel composes
    each time chunk by Hillis–Steele doubling, the port walks time
    sequentially: the two differ by f32 round-off only.
  * The masks' edge cases, forward, the same way and to the same
    tolerances: T = 1, a row masked throughout (its h and s are h0 and s0
    at every step, exactly), a row whose first frame is masked (step 0
    keeps h0 and s0), and T = 257 (one step past JAX's 256-row chunk).
  * Gradients: ``lucy_cell_parallel(impl="pallas-fused"/"auto-fused")``,
    which adds the bias in the gates' dtype and runs the port's autograd
    Function (the gate chain's VJP by torch autograd, the two adjoint scans
    through K5b's plain version), against ``jax.value_and_grad`` of the XLA
    split path (``lucy_cell_parallel(impl="xla-scan")``) in float64: values
    to 1e-10, gradients (gates, bias, h0, s0) to 1e-9, the tolerances of
    tests/test_torch_lucyrnn_masked.py.  No JAX gradient is taken through an
    interpret-mode kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.models.lucyrnn import lucy_cell_parallel as j_cell
from statecatcher_tpu.ops.lucy_pallas import lucy_fused_cell as j_fused_cell
from statecatcher_tpu_torch.models.lucyrnn import lucy_cell_parallel
from statecatcher_tpu_torch.ops.lucy_pallas import lucy_fused_cell, lucy_fused_cell_ref
from test_torch_cuda import assert_cell_close, conditioned_cell_data, single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

VAL = dict(rtol=1e-10, atol=1e-12)
GRAD = dict(rtol=1e-9, atol=1e-11)


def frame_mask(B, T):
    """Row 1 ends early, row 0 has a hole."""
    mask = np.ones((B, T), bool)
    mask[1, (2 * T) // 3:] = False
    mask[0, T // 2] = False
    return mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,D", [(5, 128), (40, 200), (300, 128)])
def test_forward_matches_jax_interpret_kernel(T, D, masked):
    B = 2
    gates, bias, h0, s0 = conditioned_cell_data(T + D, B, T, D)
    g4 = (gates + bias).reshape(B, T, 7, D)
    mask = frame_mask(B, T) if masked else None
    with pltpu.force_tpu_interpret_mode():
        jh, js = j_fused_cell(jnp.asarray(g4), jnp.asarray(h0), jnp.asarray(s0),
                              None if mask is None else jnp.asarray(mask))
    before = lucy_fused_cell.launches
    th, ts = lucy_fused_cell(*map(torch.from_numpy, (g4, h0, s0)),
                             None if mask is None else torch.from_numpy(mask))
    assert lucy_fused_cell.launches == before                  # nothing launched on the CPU
    assert th.dtype == ts.dtype == torch.float32 and th.shape == (B, T, D)
    assert_cell_close(th.numpy(), ts.numpy(), np.asarray(jh), np.asarray(js))
    if masked:                                                  # row 1 frozen past its end
        end = (2 * T) // 3
        assert torch.equal(th[1, end:], th[1, end - 1:end].expand(T - end, D))


def edge_mask(case, B, T):
    """The frame mask of a mask edge case: None (unmasked), row 0 masked
    throughout, row 1's first frame masked, or the partial rows of
    ``frame_mask``."""
    if case == "none":
        return None
    mask = np.ones((B, T), bool)
    if case == "row masked throughout":
        mask[0] = False
    elif case == "first frame masked":
        mask[1, 0] = False
    else:
        mask = frame_mask(B, T)
    return mask


@pytest.mark.parametrize("T,D,case", [(1, 128, "none"), (1, 128, "partial rows"),
                                      (20, 128, "row masked throughout"),
                                      (20, 128, "first frame masked"),
                                      (257, 128, "partial rows")])
def test_forward_mask_edges_match_jax_interpret_kernel(T, D, case):
    B = 2
    gates, bias, h0, s0 = conditioned_cell_data(3 * T + D, B, T, D)
    g4 = (gates + bias).reshape(B, T, 7, D)
    mask = edge_mask(case, B, T)
    with pltpu.force_tpu_interpret_mode():
        jh, js = j_fused_cell(jnp.asarray(g4), jnp.asarray(h0), jnp.asarray(s0),
                              None if mask is None else jnp.asarray(mask))
    th, ts = lucy_fused_cell(*map(torch.from_numpy, (g4, h0, s0)),
                             None if mask is None else torch.from_numpy(mask))
    assert th.shape == ts.shape == (B, T, D)
    assert_cell_close(th.numpy(), ts.numpy(), np.asarray(jh), np.asarray(js))
    if case == "row masked throughout":
        for x, x0 in ((th, h0), (ts, s0)):
            assert torch.equal(x[0], torch.from_numpy(x0[0]).expand(T, D))
    if case == "first frame masked":
        assert torch.equal(th[1, 0], torch.from_numpy(h0[1]))
        assert torch.equal(ts[1, 0], torch.from_numpy(s0[1]))
        assert not torch.equal(th[1, 1], th[1, 0])


def test_plain_bf16_computes_in_f32():
    gates, bias, h0, s0 = conditioned_cell_data(4, 2, 13, 8)
    g4 = torch.from_numpy((gates + bias).reshape(2, 13, 7, 8)).to(torch.bfloat16)
    h0, s0 = torch.from_numpy(h0), torch.from_numpy(s0)
    mask = torch.from_numpy(frame_mask(2, 13))
    h, s = lucy_fused_cell_ref(g4, h0, s0, mask)
    h32, s32 = lucy_fused_cell_ref(g4.to(torch.float32), h0, s0, mask)
    assert h.dtype == s.dtype == torch.bfloat16
    assert torch.equal(h, h32.to(torch.bfloat16)) and torch.equal(s, s32.to(torch.bfloat16))


@pytest.mark.parametrize("impl,T,D,masked", [("pallas-fused", 21, 8, True),
                                              ("auto-fused", 40, 12, False)])
def test_grads_match_jax_split_path_f64(impl, T, D, masked):
    """The port's ``lucy_cell_parallel`` routes the impl to K12 (masked or
    not: ``_FusedMaskedCell``, neither K1 nor the split path) and its values and gradients,
    bias included, match JAX's split path in float64."""
    B = 3
    gates, bias, h0, s0 = conditioned_cell_data(7 * T, B, T, D, np.float64)
    mask = frame_mask(B, T) if masked else None
    w = np.random.default_rng(T).standard_normal((B, T, D))

    def f(g, b, h, s):
        h_all, h_T, s_T = j_cell(g, h, s, impl="xla-scan", bias=b,
                                 frame_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(h_all * w) + jnp.sum(h_T) + 0.5 * jnp.sum(s_T), (h_all, h_T, s_T)

    with jax.enable_x64(True):
        (_, want), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (gates, bias, h0, s0)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (gates, bias, h0, s0)]
    got = lucy_cell_parallel(xs[0], xs[2], xs[3], impl=impl, bias=xs[1],
                             frame_mask=None if mask is None else torch.from_numpy(mask))
    assert got[0].grad_fn.name() == "_FusedMaskedCellBackward"
    ((got[0] * torch.from_numpy(w)).sum() + got[1].sum() + 0.5 * got[2].sum()).backward()
    for name, g_, w_ in zip(("h_all", "h_T", "s_T"), got, want):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), err_msg=name, **VAL)
    for name, x, g in zip(("gates", "bias", "h0", "s0"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), err_msg=name, **GRAD)


def test_bias_is_added_in_the_gates_dtype():
    """Under bf16 the bias is rounded to bf16 and added in bf16 before the
    gate chain, as JAX's ``gates + bias.astype(gates.dtype)``."""
    B, T, D = 2, 9, 8
    gates, bias, h0, s0 = map(torch.from_numpy, conditioned_cell_data(5, B, T, D))
    gb16 = gates.to(torch.bfloat16)
    h_all, _, s_T = lucy_cell_parallel(gb16, h0.to(torch.bfloat16), s0.to(torch.bfloat16),
                                       impl="auto-fused", bias=bias)
    want_h, want_s = lucy_fused_cell_ref((gb16 + bias.to(torch.bfloat16)).reshape(B, T, 7, D),
                                         h0.to(torch.bfloat16), s0.to(torch.bfloat16))
    assert h_all.dtype == torch.bfloat16
    assert torch.equal(h_all, want_h) and torch.equal(s_T, want_s[:, -1])
