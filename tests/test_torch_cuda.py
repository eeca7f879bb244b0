"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
version on the same inputs.  They skip without a card.  This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts= --noconftest -q

(``--noconftest`` because tests/conftest.py imports JAX; ``-o addopts=``
drops the ini file's ``-n auto``, which needs xdist.)

Tolerances of the fused cell (f32, unit-normal gates):
  * h is bounded by 1: atol 2e-5.
  * s is not: kv = k·v/(q(q+ε)) reaches ~1e5 where k and v are both near 0,
    and s accumulates it, so s is held against its own scale:
    |Δs| ≤ 1e-6·max|s_ref| + 1e-4·|s_ref|.
"""

import numpy as np
import pytest
import torch

from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm, lucy_cell_fused_lm_ref


def cell_data(seed, B, T, D, dtype=np.float32):
    """Unit-normal lane-major gates (B, T, 7D), bias, h0, s0 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 7 * D)).astype(dtype),
            (rng.standard_normal(7 * D) * 0.3).astype(dtype),
            (rng.standard_normal((B, D)) * 0.1).astype(dtype),
            (rng.standard_normal((B, D)) * 0.1).astype(dtype))


def assert_cell_close(h, s, h_ref, s_ref):
    np.testing.assert_allclose(h, h_ref, rtol=0, atol=2e-5)
    tol = 1e-6 * np.abs(s_ref).max() + 1e-4 * np.abs(s_ref)
    bad = np.abs(s - s_ref) > tol
    assert not bad.any(), (
        f"s: {bad.sum()} elements off; worst |Δ| {np.abs(s - s_ref).max():.3e} "
        f"at scale {np.abs(s_ref).max():.3e}")


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
    gates, bias, h0, s0 = _on(cuda_device, cell_data(8, 2, 5, 16))
    with pytest.raises(NotImplementedError, match="backward"):
        lucy_cell_fused_lm(gates.requires_grad_(), bias, h0, s0)
    gates = gates.detach()
    with pytest.raises(TypeError):
        lucy_cell_fused_lm(gates.double(), bias, h0, s0)
    with pytest.raises(ValueError):
        lucy_cell_fused_lm(gates.transpose(0, 1).contiguous().transpose(0, 1), bias, h0, s0)
    with pytest.raises(ValueError):
        lucy_cell_fused_lm(gates, bias, h0[:1], s0)


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
