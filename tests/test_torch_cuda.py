"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
version on the same inputs.  They skip without a card.  This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts= --noconftest -q

(``--noconftest`` because tests/conftest.py imports JAX; ``-o addopts=``
drops the ini file's ``-n auto``, which needs xdist.)

Kernels held here: K1 and K2 (the fused cell's forward and backward) and
K3 and K4 (the CTC α and β lattice), each against its plain version, and the
autograd Functions' gradients on the card against the CPU.

Tolerances of the fused cell forward (f32, unit-normal gates):
  * h is bounded by 1: atol 2e-5.
  * s is not: kv = k·v/(q(q+ε)) reaches ~1e5 where k and v are both near 0,
    and s accumulates it, so s is held against its own scale:
    |Δs| ≤ 1e-6·max|s_ref| + 1e-4·|s_ref|.
"""

import numpy as np
import pytest
import torch

from statecatcher_tpu_torch.ops.ctc_lattice import (
    ctc_alpha,
    ctc_alpha_ref,
    ctc_beta,
    ctc_beta_ref,
    ctc_nll_pallas,
    emit_log_probs,
    expand_labels,
    skip_allowed,
)
from statecatcher_tpu_torch.ops.lucy_fused_lm import (
    lucy_cell_fused_lm,
    lucy_cell_fused_lm_bwd,
    lucy_cell_fused_lm_bwd_ref,
    lucy_cell_fused_lm_ref,
)


def cell_data(seed, B, T, D, dtype=np.float32):
    """Unit-normal lane-major gates (B, T, 7D), bias, h0, s0 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 7 * D)).astype(dtype),
            (rng.standard_normal(7 * D) * 0.3).astype(dtype),
            (rng.standard_normal((B, D)) * 0.1).astype(dtype),
            (rng.standard_normal((B, D)) * 0.1).astype(dtype))


def conditioned_cell_data(seed, B, T, D, dtype=np.float32):
    """``cell_data`` with the k and v biases offset by ±2 and h_pre by ±1
    (random signs), as ``testing.randomize_`` does for the model: away from
    k = v = 0 and h_pre = 0, where the gate chain's derivatives blow up."""
    gates, bias, h0, s0 = cell_data(seed, B, T, D, dtype)
    rng = np.random.default_rng(seed + 1000)
    bias = bias.copy()
    bias[2 * D:4 * D] += 2.0 * np.where(rng.random(2 * D) < 0.5, -1.0, 1.0)
    bias[4 * D:5 * D] += np.where(rng.random(D) < 0.5, -1.0, 1.0)
    return gates, bias.astype(dtype), h0, s0


def assert_cell_close(h, s, h_ref, s_ref):
    np.testing.assert_allclose(h, h_ref, rtol=0, atol=2e-5)
    tol = 1e-6 * np.abs(s_ref).max() + 1e-4 * np.abs(s_ref)
    bad = np.abs(s - s_ref) > tol
    assert not bad.any(), (
        f"s: {bad.sum()} elements off; worst |Δ| {np.abs(s - s_ref).max():.3e} "
        f"at scale {np.abs(s_ref).max():.3e}")


@pytest.fixture(scope="module")
def single_torch_thread():
    """One intra-op thread for the CPU tests of the port: their plain versions
    loop over time with thousands of small ops, and PyTorch's thread pool
    spinning beside other test processes (pytest-xdist workers) slowed one
    such test 50-fold (0.3 s alone against > 80 s beside five copies)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")


def _on(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(2, 45, 128), (3, 33, 100), (1, 32, 512)])
def test_kernel_matches_plain_f32(cuda_device, B, T, D):
    gates, bias, h0, s0 = _on(cuda_device, cell_data(6, B, T, D))
    before = lucy_cell_fused_lm.launches
    with torch.inference_mode():
        h, s = lucy_cell_fused_lm(gates, bias, h0, s0)
        h_ref, s_ref = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    torch.cuda.synchronize()
    assert lucy_cell_fused_lm.launches == before + 1
    assert_cell_close(h.cpu().numpy(), s.cpu().numpy(), h_ref.cpu().numpy(),
                      s_ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_bf16(cuda_device):
    """bf16 gates: both sides compute in f32 from the same bf16 gates and
    round to bf16, so they differ by at most a bf16 rounding step of values
    that differ by f32 round-off: atol=rtol=2e-2 on h, scale-relative on s."""
    gates, bias, h0, s0 = _on(cuda_device, cell_data(7, 4, 64, 256))
    gates = gates.to(torch.bfloat16)
    with torch.inference_mode():
        h, s = lucy_cell_fused_lm(gates, bias, h0, s0)
        h_ref, s_ref = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    assert h.dtype == s.dtype == torch.bfloat16
    h, h_ref, s, s_ref = (t.float().cpu().numpy() for t in (h, h_ref, s, s_ref))
    np.testing.assert_allclose(h, h_ref, rtol=2e-2, atol=2e-2)
    assert (np.abs(s - s_ref) <= 1e-3 * np.abs(s_ref).max() + 1e-2 * np.abs(s_ref)).all()


@pytest.mark.cuda
def test_kernel_refuses_grad_and_bad_inputs(cuda_device):
    """The cell is differentiable on the card (K1 forward, K2 backward); the
    dtype, contiguity and shape refusals stay."""
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(8, 2, 5, 16))
    g = gates.clone().requires_grad_()
    before = lucy_cell_fused_lm_bwd.launches
    h, s = lucy_cell_fused_lm(g, bias, h0, s0)
    h.sum().backward()
    assert lucy_cell_fused_lm_bwd.launches == before + 1
    assert g.grad is not None and torch.isfinite(g.grad).all()
    with pytest.raises(TypeError):
        lucy_cell_fused_lm(gates.double(), bias, h0, s0)
    with pytest.raises(ValueError):
        lucy_cell_fused_lm(gates.transpose(0, 1).contiguous().transpose(0, 1), bias, h0, s0)
    with pytest.raises(ValueError):
        lucy_cell_fused_lm(gates, bias, h0[:1], s0)


def assert_grad_close(got, want, name, rtol=1e-4, scale_tol=1e-6):
    """|Δ| ≤ rtol·|want| + scale_tol·max|want| (f32 round-off of the two
    versions' different operation orders, on conditioned gates)."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    bad = np.abs(got - want) > rtol * np.abs(want) + scale_tol * np.abs(want).max()
    assert not bad.any() and np.isfinite(got).all(), (
        f"{name}: {bad.sum()} of {bad.size} off; worst |Δ| {np.abs(got - want).max():.3e} "
        f"at scale {np.abs(want).max():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(2, 45, 128), (3, 33, 100), (1, 300, 512)])
@pytest.mark.parametrize("with_gs", [True, False])
def test_bwd_kernel_matches_plain_f32(cuda_device, B, T, D, with_gs):
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(20, B, T, D))
    rng = np.random.default_rng(21)
    g_h = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda_device)
    g_s = (torch.from_numpy((0.1 * rng.standard_normal((B, T, D))).astype(np.float32))
           .to(cuda_device) if with_gs else None)
    with torch.inference_mode():
        h_all, s_all = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
        before = lucy_cell_fused_lm_bwd.launches
        got = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
        want = lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
    torch.cuda.synchronize()
    assert lucy_cell_fused_lm_bwd.launches == before + 1
    assert got[0].dtype == torch.float32 and got[0].shape == (B, T, 7 * D)
    for name, a, b in zip(("d_gates", "dh0", "ds0", "d_bias"), got, want):
        assert_grad_close(a.cpu().numpy(), b.cpu().numpy(), name)


@pytest.mark.cuda
def test_bwd_kernel_matches_plain_bf16(cuda_device):
    """bf16 gates, activations and cotangents, f32 math on both sides: the
    d_gates differ by a bf16 rounding step of values that differ by f32
    round-off (rtol 2e-2), dh0/ds0/d_bias are f32 sums (rtol 1e-3)."""
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(22, 4, 64, 256))
    gates = gates.to(torch.bfloat16)
    g_h = torch.randn(gates.shape[:2] + (256,), device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        h_all, s_all = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
        got = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, None)
        want = lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, None)
    assert got[0].dtype == torch.bfloat16
    assert_grad_close(got[0].float().cpu().numpy(), want[0].float().cpu().numpy(), "d_gates",
                      rtol=2e-2, scale_tol=1e-3)
    for name, a, b in zip(("dh0", "ds0", "d_bias"), got[1:], want[1:]):
        assert_grad_close(a.cpu().numpy(), b.cpu().numpy(), name, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
def test_cell_function_grads_on_card_match_cpu(cuda_device):
    gates, bias, h0, s0 = conditioned_cell_data(23, 2, 40, 64)
    w = np.random.default_rng(24).standard_normal((2, 40, 64)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        args = [torch.from_numpy(x).to(dev).requires_grad_() for x in (gates, bias, h0, s0)]
        h_all, s_all = lucy_cell_fused_lm(*args)
        wt = torch.from_numpy(w).to(dev)
        ((h_all * wt).sum() + 0.1 * (s_all * wt).sum()).backward()
        grads.append([a.grad.cpu().numpy() for a in args])
    for name, a, b in zip(("gates", "bias", "h0", "s0"), grads[1], grads[0]):
        assert_grad_close(a, b, name)


def ctc_data(seed, B, T, U, V):
    """Log-probs and labels; row 1 has no labels, row 2 a short input."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.integers(1, V, (B, U)).astype(np.int32))
    in_lens = torch.full((B,), T, dtype=torch.int32)
    label_lens = torch.full((B,), U, dtype=torch.int32)
    if B >= 3:
        label_lens[1] = 0
        labels[1] = 0
        in_lens[2] = T - 5
        label_lens[2] = max(U - 3, 0)
    return lp, labels, in_lens, label_lens


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V", [(3, 50, 8, 20), (4, 200, 40, 30), (3, 700, 600, 40)])
def test_ctc_kernels_match_plain(cuda_device, B, T, U, V):
    """α and β on the card against their plain versions: 2e-5 of each value
    where it is a lattice value (above −1e29), and the same dead states."""
    lp, labels, in_lens, label_lens = ctc_data(30 + U, B, T, U, V)
    ext = expand_labels(labels, 0)
    skip = skip_allowed(ext, 0)
    emit = emit_log_probs(lp, ext).contiguous()
    want_a, want_b = ctc_alpha_ref(emit, skip, in_lens), ctc_beta_ref(emit, skip, in_lens, label_lens)
    on = [t.to(cuda_device) for t in (emit, skip, in_lens, label_lens)]
    n = (ctc_alpha.launches, ctc_beta.launches)
    got_a, got_b = ctc_alpha(*on[:3]), ctc_beta(*on)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta.launches) == (n[0] + 1, n[1] + 1)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        got, want = got.cpu().numpy(), want.numpy()
        live = want > -1e29
        assert np.array_equal(live, got > -1e29)
        np.testing.assert_allclose(got[live], want[live], rtol=2e-6, atol=2e-5)


@pytest.mark.cuda
def test_ctc_function_grads_on_card_match_cpu(cuda_device):
    lp, labels, in_lens, label_lens = ctc_data(40, 3, 120, 20, 25)
    outs = []
    for dev in ("cpu", cuda_device):
        x = lp.clone().to(dev).requires_grad_()
        nll = ctc_nll_pallas(x, *(t.to(dev) for t in (in_lens, labels, label_lens)))
        nll.sum().backward()
        outs.append((nll.detach().cpu().numpy(), x.grad.cpu().numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-3, atol=2e-6)
    with pytest.raises(TypeError):
        ctc_alpha(torch.zeros((1, 2, 3), dtype=torch.float64, device=cuda_device),
                  torch.zeros((1, 3), dtype=torch.bool, device=cuda_device),
                  torch.ones(1, dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
def test_frontend_on_card_runs_full_f32(cuda_device):
    """The DFT/mel/DCT matmuls run in full f32 on the card (TF32 would keep
    ~3 digits): same features as the CPU within the JAX comparison's atol,
    and a refusal while TF32 matmuls are on."""
    from statecatcher_tpu_torch.config import FrontendConfig
    from statecatcher_tpu_torch.frontend import compute_features

    cfg = FrontendConfig()
    x = torch.from_numpy(np.random.default_rng(9).uniform(-0.5, 0.5, (2, 16333)).astype(np.float32))
    want = compute_features(x, cfg).numpy()
    got = compute_features(x.to(cuda_device), cfg).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            compute_features(x.to(cuda_device), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
