"""The masked LucyRNN cell of the PyTorch port (``mask_state_updates=True``)
and ``kernel_impl="pallas"``: the split path (gate chain, then the s-scan,
tanh and the h-scan through K5's plain versions) against the JAX package's
``lucy_cell_parallel(impl="xla-scan", frame_mask=…)`` and ``jax.grad`` of
it, in float64 (values to 1e-10, gradients to 1e-9); a row whose mask ends
early carries the state of its last valid frame; a 2-segment CTC training
group with ``mask_state_updates=True`` in lockstep with JAX's step (the
harness and tolerances of tests/test_torch_train_step.py); and the route of
every ``kernel_impl`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.models.lucyrnn import lucy_cell_parallel as j_cell
from statecatcher_tpu_torch.config import MeshConfig
from statecatcher_tpu_torch.models.lucyrnn import cell_route, lucy_cell_parallel
from statecatcher_tpu_torch.ops.scan_sp import sequence_parallel_scans
from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan
from test_torch_cuda import cell_data, conditioned_cell_data, single_torch_thread  # noqa: F401
from test_torch_train_step import check_lockstep

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _mask(B, T):
    mask = np.ones((B, T), bool)
    mask[1, 13:] = False                                     # ends early
    mask[0, 4] = False                                       # a hole
    return mask


@pytest.mark.parametrize("impl,masked", [("auto", True), ("fused-lm@32", True),
                                         ("pallas", True), ("pallas", False)])
def test_split_cell_and_grads_match_jax_f64(impl, masked):
    B, T, D = 3, 21, 8
    gates, bias, h0, s0 = conditioned_cell_data(3, B, T, D, np.float64)
    mask = _mask(B, T) if masked else None
    w = np.random.default_rng(4).standard_normal((B, T, D))

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
    ((got[0] * torch.from_numpy(w)).sum() + got[1].sum() + 0.5 * got[2].sum()).backward()
    for name, g_, w_ in zip(("h_all", "h_T", "s_T"), got, want):
        np.testing.assert_allclose(g_.detach().numpy(), np.asarray(w_), rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    for name, x, g in zip(("gates", "bias", "h0", "s0"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-9, atol=1e-11,
                                   err_msg=name)


def test_a_row_ending_early_carries_its_last_valid_state():
    B, T, D = 3, 21, 8
    gates, bias, h0, s0 = map(torch.from_numpy, cell_data(6, B, T, D, np.float64))
    mask = torch.from_numpy(_mask(B, T))
    h_all, h_T, s_T = lucy_cell_parallel(gates, h0, s0, impl="auto", bias=bias, frame_mask=mask)
    _, _, s_13 = lucy_cell_parallel(gates[:, :13].contiguous(), h0, s0, impl="auto", bias=bias,
                                    frame_mask=mask[:, :13])
    assert torch.equal(h_T[1], h_all[1, 12]) and torch.equal(h_all[1, 13:], h_all[1, 12:13].expand(8, D))
    assert torch.equal(s_T[1], s_13[1])
    assert not torch.equal(h_T[2], h_all[2, 12])             # an unmasked row moves on


def test_masked_ctc_step_matches_jax_in_lockstep(monkeypatch):
    check_lockstep("adam", ["--model.lucyrnn.mask_state_updates", "true"], monkeypatch)


@pytest.mark.parametrize("impl", ["auto", "assoc", "chunked", "xla-scan", "fused-lm@32",
                                  "pallas", "pallas-dual", "pallas-fused", "auto-fused", "sp"])
def test_cell_route_on_the_card(impl):
    """On the card a frame mask takes the split path (K5) for every scan
    algorithm, "pallas" always does; "pallas-fused"/"auto-fused" take K12
    and "pallas-dual" K11, masked or not; "sp" takes the split path with its
    scans sequence-parallel: masked, outside a ``sequence_parallel_scans``
    context it raises JAX's RuntimeError, and in a one-rank context it is
    the plain split path (here on the CPU, to float64 round-off)."""
    if impl == "sp":
        for masked in (False, True):
            assert cell_route(impl, on_cuda=True, masked=masked) == "split"
        B, T, D = 3, 21, 8
        gates, bias, h0, s0 = map(torch.from_numpy, cell_data(7, B, T, D, np.float64))
        mask = torch.from_numpy(_mask(B, T))
        with pytest.raises(RuntimeError, match="sequence_parallel_scans"):
            lucy_cell_parallel(gates, h0, s0, impl="sp", bias=bias, frame_mask=mask)
        with sequence_parallel_scans(make_mesh_plan(MeshConfig())):
            got = lucy_cell_parallel(gates, h0, s0, impl="sp", bias=bias, frame_mask=mask)
        want = lucy_cell_parallel(gates, h0, s0, impl="pallas", bias=bias, frame_mask=mask)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
        return
    if impl in ("pallas-dual", "pallas-fused", "auto-fused"):
        for masked in (False, True):
            assert cell_route(impl, on_cuda=True, masked=masked) == (
                "dual" if impl == "pallas-dual" else "k12")
        return
    assert cell_route(impl, on_cuda=True, masked=True) == "split"
    assert cell_route(impl, on_cuda=True, masked=False) == ("split" if impl == "pallas"
                                                            else "fused")
