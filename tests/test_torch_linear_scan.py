"""The linear scan of the PyTorch port (``ops/lucy_pallas.py``: the plain
versions of K5a and K5b in ``linear_scan_pallas``, and ``ops/scan.py:
linear_scan``) against the JAX package's sequential scan
``ops/scan.py:linear_scan_seq`` and ``jax.grad`` of it, in float64 (values
to 1e-12, gradients to 1e-10), over ragged T and with the gradient of s0;
and in bfloat16, where the scan carries float32 and rounds only its output
(equal to the float32 scan rounded once, which is JAX's to float32
round-off).

The forward (K5a's plain version, what ``linear_scan_pallas`` runs on CPU
tensors) is also held against the JAX TPU kernel's forward
``_linear_scan_pallas_fwd_impl`` run under
``pltpu.force_tpu_interpret_mode()``, forward only (no JAX gradient is
taken through an interpret-mode kernel), at T = 300 (not a multiple of its
256-row time chunk) and T = 1, D = 128: in float32 to 4e-6 of the state's
scale (the TPU kernel composes each chunk by Hillis–Steele doubling, the
port walks time sequentially: they differ by float32 round-off), in
bfloat16 to one bfloat16 step (both round a float32 carry once).  The
reverse scan (K5b's plain version, ``linear_scan_rev_ref``) is held the same
way against ``_linear_scan_pallas_rev_impl``, which visits its time chunks
from the latest: at T = 300 (the ragged chunk visited first, its rows past T
identity maps), T = 1 and D = 200 (JAX pads D to 128 lanes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops.lucy_pallas import _linear_scan_pallas_fwd_impl as j_pallas_fwd
from statecatcher_tpu.ops.lucy_pallas import _linear_scan_pallas_rev_impl as j_pallas_rev
from statecatcher_tpu.ops.scan import linear_scan as j_linear_scan
from statecatcher_tpu.ops.scan import linear_scan_seq as j_scan
from statecatcher_tpu_torch.config import MeshConfig
from statecatcher_tpu_torch.ops.lucy_pallas import (
    linear_scan_pallas,
    linear_scan_rev,
    linear_scan_rev_ref,
)
from statecatcher_tpu_torch.ops.scan import linear_scan, linear_scan_seq
from statecatcher_tpu_torch.ops.scan_sp import sequence_parallel_scans
from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _scan_data(seed, B, T, D, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (B, T, D)).astype(dtype),
            rng.standard_normal((B, T, D)).astype(dtype),
            rng.standard_normal((B, D)).astype(dtype),
            rng.standard_normal((B, T, D)).astype(dtype))


@pytest.mark.parametrize("B,T,D", [(2, 37, 5), (3, 1, 4), (1, 130, 16)])
def test_scan_and_grads_match_jax_float64(B, T, D):
    a, b, s0, w = _scan_data(T + D, B, T, D)

    def f(a, b, s0):
        s = j_scan(a, b, s0)
        return jnp.sum(s * w), s

    with jax.enable_x64(True):
        (_, want), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (a, b, s0)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (a, b, s0)]
    s = linear_scan_pallas(*xs)
    (s * torch.from_numpy(w)).sum().backward()
    assert s.dtype == torch.float64 and s.shape == (B, T, D)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    for name, x, g in zip(("a", "b", "s0"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_reverse_scan_is_the_adjoint_recursion():
    a, _, _, g = _scan_data(3, 2, 9, 3)
    lam = linear_scan_rev(torch.from_numpy(a), torch.from_numpy(g)).numpy()
    want = np.zeros_like(g)
    want[:, -1] = g[:, -1]
    for t in range(g.shape[1] - 2, -1, -1):
        want[:, t] = g[:, t] + a[:, t + 1] * want[:, t + 1]
    np.testing.assert_allclose(lam, want, rtol=1e-14)
    assert np.array_equal(linear_scan_rev_ref(torch.from_numpy(a), torch.from_numpy(g)).numpy(),
                          lam)


def test_bfloat16_carries_float32_and_rounds_its_output():
    a, b, s0, w = _scan_data(5, 2, 300, 8, np.float32)
    a = 0.97 + 0.06 * (a - 0.5)                              # slow decay: long memory
    a16, b16 = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    s = linear_scan_pallas(a16, b16, torch.from_numpy(s0))
    assert s.dtype == torch.bfloat16
    # the float32 scan of the same bf16 inputs (JAX's, to float32 round-off),
    # rounded once
    s32 = linear_scan_pallas(a16.float(), b16.float(), torch.from_numpy(s0))
    want = np.asarray(j_scan(jnp.asarray(a16.float().numpy()), jnp.asarray(b16.float().numpy()),
                             jnp.asarray(s0)))
    np.testing.assert_allclose(s32.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(s, s32.bfloat16())
    got = s.float().numpy()
    # a scan that rounded its state to bf16 every step drifts further
    drift = linear_scan_seq(a16, b16, torch.from_numpy(s0).bfloat16()).float().numpy()
    assert np.abs(drift - want).mean() > 4 * np.abs(got - want).mean()
    # the gradient comes back in the inputs' dtypes
    a_g, b_g = a16.clone().requires_grad_(), b16.clone().requires_grad_()
    s0_g = torch.from_numpy(s0).requires_grad_()
    (linear_scan_pallas(a_g, b_g, s0_g).float() * torch.from_numpy(w)).sum().backward()
    assert a_g.grad.dtype == b_g.grad.dtype == torch.bfloat16 and s0_g.grad.dtype == torch.float32


def test_linear_scan_dispatch():
    """Every scan algorithm is K5; "sp" is the sequence-parallel scan, which
    outside a ``sequence_parallel_scans`` context raises JAX's RuntimeError
    and in a one-rank context is K5 to round-off (its shard scanned from
    zero, then the entry state applied through the decay products)."""
    a, b, s0, _ = _scan_data(7, 2, 11, 3)
    xs = list(map(torch.from_numpy, (a, b, s0)))
    want = linear_scan_pallas(*xs)
    for impl in ("auto", "assoc", "chunked", "xla-scan", "pallas"):
        assert torch.equal(linear_scan(*xs, impl=impl), want)
    with pytest.raises(RuntimeError) as got:
        linear_scan(*xs, impl="sp")
    with pytest.raises(RuntimeError) as jax_error:
        j_linear_scan(*(jnp.asarray(x) for x in (a, b, s0)), impl="sp")
    assert str(got.value) == str(jax_error.value)
    with sequence_parallel_scans(make_mesh_plan(MeshConfig())):
        torch.testing.assert_close(linear_scan(*xs, impl="sp"), want, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        linear_scan(*xs, impl="bogus")


@pytest.mark.parametrize("B,T,D,dtype", [(2, 300, 128, np.float32), (3, 1, 128, np.float32),
                                         (2, 300, 128, "bfloat16")])
def test_forward_matches_jax_interpret_kernel(B, T, D, dtype):
    a, b, s0, _ = _scan_data(T + D + 1, B, T, D, np.float32)
    a = 0.97 + 0.06 * (a - 0.5)                              # slow decay: long memory
    xs = [torch.from_numpy(a), torch.from_numpy(b)]
    if dtype == "bfloat16":
        xs = [x.bfloat16() for x in xs]
    with pltpu.force_tpu_interpret_mode():
        want = j_pallas_fwd(*(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32) for x in xs), jnp.asarray(s0))
    s = linear_scan_pallas(*xs, torch.from_numpy(s0))
    assert s.dtype == xs[0].dtype and s.shape == (B, T, D) and want.shape == (B, T, D)
    got, want = s.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6 * np.abs(want).max())


@pytest.mark.parametrize("B,T,D,dtype", [(2, 300, 128, np.float32), (3, 1, 128, np.float32),
                                         (2, 300, 200, np.float32), (2, 300, 128, "bfloat16"),
                                         (2, 1, 200, "bfloat16")])
def test_reverse_matches_jax_interpret_kernel(B, T, D, dtype):
    a, _, _, g = _scan_data(T + D + 2, B, T, D, np.float32)
    a = 0.97 + 0.06 * (a - 0.5)                              # slow decay: long memory
    xs = [torch.from_numpy(a), torch.from_numpy(g)]
    if dtype == "bfloat16":
        xs = [x.bfloat16() for x in xs]
    with pltpu.force_tpu_interpret_mode():
        want = j_pallas_rev(*(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32) for x in xs))
    lam = linear_scan_rev(*xs)
    assert lam.dtype == xs[0].dtype and lam.shape == (B, T, D) and want.shape == (B, T, D)
    got, want = lam.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6 * np.abs(want).max())
