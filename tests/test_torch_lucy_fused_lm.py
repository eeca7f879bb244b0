"""Fused LucyRNN cell of the PyTorch port (statecatcher_tpu_torch/ops/
lucy_fused_lm.py): its plain version against the JAX TPU kernel run in
Pallas interpret mode, the gate chain against JAX in float64, and the
dispatch of ``lucy_cell_parallel``.  The CUDA kernel against the plain
version is in tests/test_torch_cuda.py (card only), with the tolerances
used here: h atol 2e-5, s held to its own scale.  The two sides also write
the gate chain differently (JAX kernel: rsqrt products; port: the
sqrt/divide form of lucy_gate_coeffs), which agrees to about 1 ulp before
the recurrences amplify it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.lucy_fused_lm as jlm
from statecatcher_tpu.ops.lucy_pallas import lucy_gate_coeffs as j_gate_coeffs
from statecatcher_tpu_torch.config import MeshConfig
from statecatcher_tpu_torch.models.lucyrnn import cell_route, lucy_cell_parallel
from statecatcher_tpu_torch.ops.lucy_fused_lm import (
    lucy_cell_fused_lm,
    lucy_cell_fused_lm_ref,
)
from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
from statecatcher_tpu_torch.ops.scan_sp import sequence_parallel_scans
from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan
from test_torch_cuda import assert_cell_close, cell_data


@pytest.mark.parametrize("T", [7, 45, 300])
def test_plain_matches_jax_interpret_kernel(T):
    B, D = 2, 128
    gates, bias, h0, s0 = cell_data(T, B, T, D)
    jh, js = jlm._fused_lm_fwd_impl.__wrapped__(
        jnp.asarray(gates), jnp.asarray(bias), jnp.asarray(h0), jnp.asarray(s0),
        chunk=32, interpret=True)
    th, ts = lucy_cell_fused_lm_ref(*map(torch.from_numpy, (gates, bias, h0, s0)))
    assert th.dtype == ts.dtype == torch.float32
    assert_cell_close(th.numpy(), ts.numpy(), np.asarray(jh), np.asarray(js))


def test_gate_coeffs_match_jax_f64():
    B, T, D = 2, 9, 16
    gates, bias, _, _ = cell_data(1, B, T, D, np.float64)
    mask = np.random.default_rng(2).random((B, T)) > 0.3
    with jax.enable_x64(True):
        for m in (None, mask):
            want = j_gate_coeffs(jnp.asarray(gates), None if m is None else jnp.asarray(m),
                                 jnp.asarray(bias))
            got = lucy_gate_coeffs(torch.from_numpy(gates),
                                   None if m is None else torch.from_numpy(m),
                                   torch.from_numpy(bias))
            for g, w in zip(got, want):
                assert g.dtype == torch.float64
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    gates, bias, h0, s0 = map(torch.from_numpy, cell_data(3, 2, 11, 8))
    before = lucy_cell_fused_lm.launches
    for a, b in zip(lucy_cell_fused_lm(gates, bias, h0, s0),
                    lucy_cell_fused_lm_ref(gates, bias, h0, s0)):
        assert torch.equal(a, b)
    assert lucy_cell_fused_lm.launches == before      # nothing launched on the CPU


def test_plain_bf16_computes_in_f32():
    gates, bias, h0, s0 = map(torch.from_numpy, cell_data(4, 2, 13, 8))
    gb = gates.to(torch.bfloat16)
    h, s = lucy_cell_fused_lm_ref(gb, bias, h0, s0)
    h32, s32 = lucy_cell_fused_lm_ref(gb.to(torch.float32), bias, h0, s0)
    assert h.dtype == s.dtype == torch.bfloat16
    assert torch.equal(h, h32.to(torch.bfloat16)) and torch.equal(s, s32.to(torch.bfloat16))


def test_masked_plain_cell_matches_jax_f64():
    from statecatcher_tpu.models.lucyrnn import lucy_cell_parallel as j_cell

    B, T, D = 2, 10, 8
    gates, bias, h0, s0 = cell_data(5, B, T, D, np.float64)
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    mask[0, 3] = False
    with jax.enable_x64(True):
        want = j_cell(jnp.asarray(gates), jnp.asarray(h0), jnp.asarray(s0), impl="xla-scan",
                      frame_mask=jnp.asarray(mask), bias=jnp.asarray(bias))
    got = lucy_cell_parallel(*map(torch.from_numpy, (gates, h0, s0)), impl="auto",
                             frame_mask=torch.from_numpy(mask), bias=torch.from_numpy(bias))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("impl", ["auto", "fused-lm@32", "xla-scan", "assoc", "chunked", "pallas"])
def test_cell_route_sends_every_scan_to_the_kernel_on_cuda(impl):
    """Every scan algorithm runs a kernel on the card: the fused cell, or with
    a frame mask (and always for "pallas") the split path through K5."""
    unmasked = "split" if impl == "pallas" else "fused"
    assert cell_route(impl, on_cuda=True, masked=False) == unmasked
    assert cell_route(impl, on_cuda=False, masked=False) == unmasked
    assert cell_route(impl, on_cuda=False, masked=True) == "split"
    assert cell_route(impl, on_cuda=True, masked=True) == "split"


@pytest.mark.parametrize("impl", ["pallas-dual", "pallas-fused", "auto-fused", "sp"])
def test_cell_route_raises_for_unported_impls_on_cuda(impl):
    """No kernel_impl is left unported, on either device.  "sp" takes the
    split path with both scans sequence-parallel, as JAX's
    ``lucy_cell_parallel`` does: outside a ``sequence_parallel_scans``
    context it raises JAX's RuntimeError, and in a one-rank context it is
    the plain split path to float64 round-off.  The fused masked cell K12
    ("pallas-fused", "auto-fused") and the dual scan K11 ("pallas-dual")
    take their own routes, masked or not, on both devices."""
    if impl == "sp":
        for on_cuda in (False, True):
            for masked in (False, True):
                assert cell_route(impl, on_cuda=on_cuda, masked=masked) == "split"
        gates, bias, h0, s0 = map(torch.from_numpy, cell_data(5, 2, 19, 8, np.float64))
        with pytest.raises(RuntimeError, match="sequence_parallel_scans"):
            lucy_cell_parallel(gates, h0, s0, impl="sp", bias=bias)
        with sequence_parallel_scans(make_mesh_plan(MeshConfig())):
            got = lucy_cell_parallel(gates, h0, s0, impl="sp", bias=bias)
        want = lucy_cell_parallel(gates, h0, s0, impl="pallas", bias=bias)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    else:
        want = "dual" if impl == "pallas-dual" else "k12"
        for on_cuda in (False, True):
            for masked in (False, True):
                assert cell_route(impl, on_cuda=on_cuda, masked=masked) == want
    with pytest.raises(ValueError):
        cell_route("bogus", on_cuda=False, masked=False)
