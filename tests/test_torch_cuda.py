"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
version on the same inputs.  They skip without a card.  This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist -o addopts= --noconftest -q

(``--noconftest`` because tests/conftest.py imports JAX; ``-o addopts=``
drops the ini file's ``-n auto``, which needs xdist.)

Kernels held here: K1 and K2 (the fused cell's forward and backward; also
at the edges of their time and column tiles, and bit for bit between two
calls), K3
and K4 (the CTC α and β lattice; also over the states a lane and the edges
of the warps' pipeline, rows with in_len 0 and in_len > T, bit for bit
between two calls and bit for bit the plain versions run on the card), K5a and K5b (the linear scan and its
adjoint), K6a and K6b (the fused RNN-T joint's forward and backward; both
on the tensor cores, also over ragged widths, the blank in any vocab tile
and bit for bit between two calls), K7a
and K7b (the transducer α and β lattice), K8a and K8b (the banded joint),
the banded α and β lattice (one to 17 window cells a lane, through the
frame ring and through the producer warp's own loads, and bit for bit
between two calls), K9a, K9b and K10 (the mLSTM; K9a and K9b also
over the chunk lengths, head counts and widths of their chunk-parallel
passes, with tied gates, and bit for bit between two calls; K9a and K10 at
the streaming shape of one chunk), K12 (the fused masked cell), K11 (the
dual scan), K5a and K5b (each also at the edges of its ring; K12 and K11
with fully masked rows) bit for bit the plain versions in f32; K1, K2,
K5a, K5b, K12 and K11 at B = 65536, past the grid's 65535 rows; the
autograd Functions' gradients on the card against the CPU; and the xLSTM
and native LucyRNN encoders on the card against the CPU; the LSTM encoder
(a torch recurrence) and the CTC and RNN-T beam searches on the card
against the CPU.

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
from statecatcher_tpu_torch.ops.rnnt_joint import (
    joint_blank_emit_bwd_ref,
    joint_blank_emit_ref,
    rnnt_joint_bwd,
    rnnt_joint_fwd,
    rnnt_loss_pallas,
)
from statecatcher_tpu_torch.ops.rnnt_band import (
    joint_blank_emit_banded_bwd_ref,
    joint_blank_emit_banded_ref,
    rnnt_band_alpha,
    rnnt_band_beta,
    rnnt_band_bwd,
    rnnt_band_fwd,
)
from statecatcher_tpu_torch.ops.rnnt_lattice import (
    rnnt_alpha,
    rnnt_alpha_ref,
    rnnt_beta,
    rnnt_beta_ref,
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


# Shapes at the edges of K1's and K2's tiles (time tiles of 8 or 16 steps,
# column tiles of 64 and 32): T not a multiple of the time tile and T below
# it, D = 100 and 200 (a ragged column tile; bf16 rows of D = 100 start on 8
# bytes, not 16), B = 1, and D = 5 / 6 (f32 rows on 4 / 8 bytes) and D = 33
# (bf16 rows on 2 bytes, copied without cp.async).
CELL_EDGE_SHAPES = [(1, 5, 200, torch.float32), (2, 1, 100, torch.float32),
                    (3, 45, 100, torch.float32), (1, 77, 200, torch.float32),
                    (2, 19, 5, torch.float32), (2, 23, 6, torch.float32),
                    (1, 9, 100, torch.bfloat16), (3, 45, 200, torch.bfloat16),
                    (2, 1, 200, torch.bfloat16), (2, 37, 33, torch.bfloat16)]


def _edge_id(case):
    B, T, D, dtype = case
    return f"B{B}-T{T}-D{D}-{str(dtype).split('.')[-1]}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype", CELL_EDGE_SHAPES, ids=map(_edge_id, CELL_EDGE_SHAPES))
def test_kernel_edge_shapes(cuda_device, B, T, D, dtype):
    """K1 at the edges of its tiles, against its plain version with the
    tolerances of test_kernel_matches_plain_f32 and _bf16."""
    gates, bias, h0, s0 = _on(cuda_device, cell_data(30 + T, B, T, D))
    gates = gates.to(dtype)
    with torch.inference_mode():
        h, s = lucy_cell_fused_lm(gates, bias, h0, s0)
        h_ref, s_ref = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    torch.cuda.synchronize()
    assert h.dtype == s.dtype == dtype and h.shape == s.shape == (B, T, D)
    h, h_ref, s, s_ref = (t.float().cpu().numpy() for t in (h, h_ref, s, s_ref))
    if dtype == torch.float32:
        assert_cell_close(h, s, h_ref, s_ref)
    else:
        np.testing.assert_allclose(h, h_ref, rtol=2e-2, atol=2e-2)
        assert (np.abs(s - s_ref) <= 1e-3 * np.abs(s_ref).max() + 1e-2 * np.abs(s_ref)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype", CELL_EDGE_SHAPES, ids=map(_edge_id, CELL_EDGE_SHAPES))
@pytest.mark.parametrize("with_gs", [True, False])
def test_bwd_kernel_edge_shapes(cuda_device, B, T, D, dtype, with_gs):
    """K2 at the edges of its tiles, against its plain version with the
    tolerances of test_bwd_kernel_matches_plain_f32 and _bf16."""
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(40 + T, B, T, D))
    gates = gates.to(dtype)
    rng = np.random.default_rng(41 + T)
    g_h = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(cuda_device)
    g_s = (torch.from_numpy((0.1 * rng.standard_normal((B, T, D))).astype(np.float32))
           .to(cuda_device).to(dtype) if with_gs else None)
    g_h = g_h.to(dtype)
    with torch.inference_mode():
        h_all, s_all = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
        got = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
        want = lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].shape == (B, T, 7 * D)
    names = ("d_gates", "dh0", "ds0", "d_bias")
    if dtype == torch.float32:
        for name, a, b in zip(names, got, want):
            assert_grad_close(a.cpu().numpy(), b.cpu().numpy(), name)
    else:
        assert_grad_close(got[0].float().cpu().numpy(), want[0].float().cpu().numpy(),
                          "d_gates", rtol=2e-2, scale_tol=1e-3)
        for name, a, b in zip(names[1:], got[1:], want[1:]):
            assert_grad_close(a.cpu().numpy(), b.cpu().numpy(), name, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_kernels_are_deterministic(cuda_device, dtype):
    """Two calls of K1 and two of K2 on the same inputs give bit-equal
    outputs: K2's d_bias partials are added in a fixed order, with no
    atomics."""
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(50, 3, 301, 512))
    gates = gates.to(dtype)
    g_h = torch.randn((3, 301, 512), device=cuda_device).to(dtype)
    g_s = 0.1 * torch.randn((3, 301, 512), device=cuda_device).to(dtype)
    with torch.inference_mode():
        first = [x.clone() for x in lucy_cell_fused_lm(gates, bias, h0, s0)]
        for name, a, b in zip(("h_all", "s_all"), first, lucy_cell_fused_lm(gates, bias, h0, s0)):
            assert torch.equal(a, b), name
        args = (gates, bias, h0, s0, *first, g_h, g_s)
        first = [x.clone() for x in lucy_cell_fused_lm_bwd(*args)]
        second = lucy_cell_fused_lm_bwd(*args)
    for name, a, b in zip(("d_gates", "dh0", "ds0", "d_bias"), first, second):
        assert torch.equal(a, b), name


def ctc_data(seed, B, T, U, V):
    """Log-probs and labels; row 1 has no labels, row 2 a short input, row 3
    (B ≥ 5) no input and row 4 an input longer than T."""
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
    if B >= 5:
        in_lens[3] = 0
        in_lens[4] = T + 7
    return lp, labels, in_lens, label_lens


def ctc_lattice_args(seed, B, T, U, V):
    """``ctc_data``'s emit (B, T, 2U+1), allow_skip and lengths."""
    lp, labels, in_lens, label_lens = ctc_data(seed, B, T, U, V)
    ext = expand_labels(labels, 0)
    return emit_log_probs(lp, ext).contiguous(), skip_allowed(ext, 0), in_lens, label_lens


def ctc_states_args(seed, B, T, S, V=30):
    """emit (B, T, S) for any S (blank at even states, labels at odd ones, so
    an even S ends on a label), allow_skip and lengths as ``ctc_data``'s."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)), -1)
    ext = torch.zeros((B, S), dtype=torch.int64)
    ext[:, 1::2] = torch.from_numpy(rng.integers(1, V, (B, S // 2)))
    in_lens = torch.tensor([T, T, T - 5, 0, T + 7][:B], dtype=torch.int32)
    label_lens = torch.tensor([S // 2, 0, S // 2 - 3, S // 2, S // 2][:B], dtype=torch.int32)
    return (emit_log_probs(lp, ext).contiguous(), skip_allowed(ext, 0), in_lens,
            label_lens.clamp(min=0))


def assert_ctc_kernels_match_plain(dev, emit, skip, in_lens, label_lens):
    """α and β on the card against their plain versions: 2e-5 + 2e-6 of each
    value where it is a lattice value (above −1e29), and the same dead
    states; one launch each."""
    want_a, want_b = ctc_alpha_ref(emit, skip, in_lens), ctc_beta_ref(emit, skip, in_lens, label_lens)
    on = [t.to(dev) for t in (emit, skip, in_lens, label_lens)]
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
@pytest.mark.parametrize("B,T,U,V", [(3, 50, 8, 20), (4, 200, 40, 30), (3, 700, 600, 40),
                                     (5, 40, 15, 20), (5, 45, 16, 20), (5, 80, 31, 40),
                                     (5, 80, 32, 40), (32, 1598, 128, 1024),
                                     (96, 64, 128, 1024), (5, 300, 600, 40)])
def test_ctc_kernels_match_plain(cuda_device, B, T, U, V):
    """α and β on the card against their plain versions: S = 2U+1 from one
    warp's states (31, 33) to three (63, 65), the training shape (B=32,
    T=1598, S=257), bench.py's batch (B=96) at a short T and S = 1201 (two
    states a lane); rows with in_len 0 and in_len > T where B ≥ 5."""
    assert_ctc_kernels_match_plain(cuda_device, *ctc_lattice_args(30 + U, B, T, U, V))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 64, 1024, 1025, 2048, 2049, 3072, 4096])
def test_ctc_kernels_match_plain_any_states(cuda_device, S):
    """Even S (a last label state) and the S where the states a lane step
    from 1 to 4 (1024, 2048, 3072 a block of 32 warps; 1025, 2049 the next),
    with in_len T, < T, 0 and > T and label_len 0."""
    assert_ctc_kernels_match_plain(cuda_device, *ctc_states_args(60 + S, 5, 24, S))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V", [(5, 400, 128, 1024), (5, 80, 600, 40)])
def test_ctc_kernels_are_the_plain_versions_bit_for_bit(cuda_device, B, T, U, V):
    """On the card, α and β equal their plain versions run there bit for bit:
    the kernels take the plain version's f32 operations in its order (the
    training checks compare Adam's first updates, which turn any other
    rounding of the CTC gradient into sign flips)."""
    emit, skip, in_lens, label_lens = (t.to(cuda_device)
                                       for t in ctc_lattice_args(80 + U, B, T, U, V))
    with torch.inference_mode():
        assert torch.equal(ctc_alpha(emit, skip, in_lens), ctc_alpha_ref(emit, skip, in_lens))
        assert torch.equal(ctc_beta(emit, skip, in_lens, label_lens),
                           ctc_beta_ref(emit, skip, in_lens, label_lens))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V", [(32, 1598, 128, 1024), (5, 80, 600, 40)])
def test_ctc_kernels_are_deterministic(cuda_device, B, T, U, V):
    """Two calls of α and β give the same bits."""
    emit, skip, in_lens, label_lens = (t.to(cuda_device)
                                       for t in ctc_lattice_args(70 + U, B, T, U, V))
    for fn, args in ((ctc_alpha, (emit, skip, in_lens)),
                     (ctc_beta, (emit, skip, in_lens, label_lens))):
        first = fn(*args).clone()
        assert torch.equal(first, fn(*args)), fn.__name__


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


def lattice_data(seed, B, T, U):
    """Blank and emit log-prob lattices; row 0 has u_len 0, row 1 a short
    input, row 3 (where B > 3) no frame (t_len = 0), the others full
    lengths."""
    rng = np.random.default_rng(seed)
    blank = torch.from_numpy((rng.standard_normal((B, T, U + 1)) - 1.5).astype(np.float32))
    emit = torch.from_numpy((rng.standard_normal((B, T, U)) - 1.5).astype(np.float32))
    t_lens = torch.full((B,), T, dtype=torch.int32)
    u_lens = torch.full((B,), U, dtype=torch.int32)
    u_lens[0] = 0
    if B > 1:
        t_lens[1] = max(T - T // 3, 1)
        u_lens[1] = U // 2
    if B > 3:
        t_lens[3] = 0
    return blank, emit, t_lens, u_lens


def assert_lattice_close(got, want):
    """The same dead states (≤ −1e29), and live values within 2e-5 + 2e-6 of
    their size.  On the scan route (U+1 > 1024) these are f32 log-sum-exp
    chains in two operation orders (the kernels scan each frame within
    warps, the plain versions over all columns); on the wavefront the plain
    versions walk the kernels' diagonals in their operations."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    live = want > -1e29
    assert np.array_equal(live, got > -1e29)
    np.testing.assert_allclose(got[live], want[live], rtol=2e-6, atol=2e-5)


# (B, T, U): U+1 = 12, 41 and 49 (the frame ring), 1 (no labels), 129 (the
# producer's own loads), 1024 (the wavefront's widest), then 1025 and 1501
# (the scan route, two 1024-column chunks)
RNNT_LATTICE_CASES = [(3, 45, 11), (4, 200, 40), (2, 33, 0), (3, 70, 128), (2, 20, 1500),
                      (4, 200, 48), (4, 30, 1023), (4, 20, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U", RNNT_LATTICE_CASES)
def test_rnnt_lattice_kernels_match_plain(cuda_device, B, T, U):
    """K7a/K7b against their plain versions: U+1 from 1 (no labels) through
    the wavefront's frame ring (49), its producer's own loads (129, 1024) and
    the scan route (1025, 1501), with a u_len = 0 row, a short row and, where
    B > 3, a row of no frame."""
    blank, emit, t_lens, u_lens = lattice_data(50 + U, B, T, U)
    want_a = rnnt_alpha_ref(blank, emit, t_lens)
    want_b = rnnt_beta_ref(blank, emit, t_lens, u_lens)
    on = [t.to(cuda_device) for t in (blank, emit, t_lens, u_lens)]
    n = (rnnt_alpha.launches, rnnt_beta.launches)
    got_a, got_b = rnnt_alpha(*on[:3]), rnnt_beta(*on)
    torch.cuda.synchronize()
    assert (rnnt_alpha.launches, rnnt_beta.launches) == (n[0] + 1, n[1] + 1)
    assert_lattice_close(got_a, want_a)
    assert_lattice_close(got_b, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U", [(4, 200, 48), (2, 33, 0), (4, 70, 128), (4, 30, 1023)])
def test_rnnt_lattice_kernels_are_the_plain_versions_bit_for_bit(cuda_device, B, T, U):
    """On the wavefront route, α and β equal their plain versions run on the
    card bit for bit on every live value (the dead ones, ≤ −1e29, agree as
    dead): the plain versions walk the anti-diagonals in the kernels'
    operations, and the accurate log-sum-exp is torch.logaddexp's (the
    training checks compare the exact loss's gradients, whose single-Z
    occupancies turn any other rounding of α and β into gradients a few
    percent apart)."""
    blank, emit, t_lens, u_lens = (t.to(cuda_device) for t in lattice_data(60 + U, B, T, U))
    with torch.inference_mode():
        for got, want in ((rnnt_alpha(blank, emit, t_lens), rnnt_alpha_ref(blank, emit, t_lens)),
                          (rnnt_beta(blank, emit, t_lens, u_lens),
                           rnnt_beta_ref(blank, emit, t_lens, u_lens))):
            live = want > -1e29
            assert torch.equal(live, got > -1e29)
            assert torch.equal(got[live], want[live])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U", [(4, 200, 48), (4, 70, 128), (4, 20, 1024)])
def test_rnnt_lattice_kernels_are_deterministic(cuda_device, B, T, U):
    """Two calls of K7a and K7b give the same bits (the wavefront's frame ring
    and its producer's own loads; the scan route)."""
    blank, emit, t_lens, u_lens = (t.to(cuda_device) for t in lattice_data(70 + U, B, T, U))
    for fn, args in ((rnnt_alpha, (blank, emit, t_lens)),
                     (rnnt_beta, (blank, emit, t_lens, u_lens))):
        first = fn(*args).clone()
        assert torch.equal(first, fn(*args)), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U", [(3, 200, 48), (2, 70, 130)])
def test_rnnt_alpha_is_the_banded_alpha_without_a_band(cuda_device, B, T, U):
    """K7a's α equals the banded α on K7's cells when the band starts at 0
    and covers every label (window Wp ≥ U+1, the tables padded with −1e30):
    the two walk the same recurrence in the same order, K7 with the
    accurate log-sum-exp and the banded kernel with the fast one, so they
    agree to phase 8's tolerance."""
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_alpha

    blank, emit, t_lens, _ = (t.to(cuda_device) for t in lattice_data(90 + U, B, T, U))
    t_lens = t_lens.clamp(min=1)                     # the banded walk runs at least one frame
    Tb, Wp = 8, -(-(U + 1) // 8) * 8
    Tp = -(-T // Tb) * Tb
    blank_b = torch.full((B, Tp, Wp), -1e30, device=cuda_device)
    emit_b = torch.full((B, Tp, Wp), -1e30, device=cuda_device)
    blank_b[:, :T, :U + 1] = blank
    emit_b[:, :T, :U] = emit
    o = torch.zeros((B, Tp // Tb), dtype=torch.int32, device=cuda_device)
    got = rnnt_alpha(blank, emit, t_lens)
    band = rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb)[:, :T, :U + 1]
    live = band > -1e29
    assert torch.equal(live, got > -1e29)
    d = (got - band)[live].abs()
    assert (d <= 2e-5 + 1e-5 * band[live].abs()).all(), d.max().item()


def joint_data(seed, B, T, U, J, V, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    enc, pred = f(B, T, J).to(dev, dtype), f(B, U + 1, J).to(dev, dtype)
    k, b = f(J, V, scale=0.1).to(dev), f(V, scale=0.1).to(dev)
    labels = torch.from_numpy(rng.integers(0, V, (B, U)).astype(np.int32)).to(dev)
    g_blank = f(B, T, U + 1, scale=0.1).to(dev)
    g_emit = f(B, T, U, scale=0.1).to(dev)
    return enc, pred, k, b, labels, g_blank, g_emit


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,J,V,blank_id", [(3, 45, 11, 40, 150, 5), (2, 17, 0, 64, 100, 0),
                                                (2, 30, 9, 64, 1024, 0), (1, 7, 3, 100, 70, 69)])
def test_rnnt_joint_kernels_match_plain(cuda_device, B, T, U, J, V, blank_id):
    """K6a/K6b against their plain versions in f32: ragged rows (B·T·(U+1)
    not a multiple of the 128-row tile; T and U+1 not multiples of the
    backward's 16 × 8 patch), ragged vocab tiles, U+1 = 1,
    J = 100 (the 128-wide instance), blank_id ≠ 0.  Forward to 1e-5
    (f32 contractions of 40-100 terms in two orders), gradients to 1e-4
    relative plus 1e-5 of each output's largest value."""
    enc, pred, k, b, labels, g_blank, g_emit = joint_data(60 + J, B, T, U, J, V, cuda_device)
    n = (rnnt_joint_fwd.launches, rnnt_joint_bwd.launches)
    got = rnnt_joint_fwd(enc, pred, k, b, labels, blank_id)
    want = joint_blank_emit_ref(enc, pred, k, b, labels, blank_id)
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    lse = want[2]
    got = rnnt_joint_bwd(enc, pred, k, b, labels, lse, g_blank, g_emit, blank_id)
    want = joint_blank_emit_bwd_ref(enc, pred, k, b, labels, lse, g_blank, g_emit, blank_id)
    torch.cuda.synchronize()
    assert (rnnt_joint_fwd.launches, rnnt_joint_bwd.launches) == (n[0] + 1, n[1] + 1)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), got, want):
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-4, scale_tol=1e-5)


@pytest.mark.cuda
def test_rnnt_joint_kernels_match_plain_bf16(cuda_device):
    """bf16 enc/pred: both versions round the same operands to bf16 and sum
    in f32.  A joint or d_logits value whose f32 round-off straddles a bf16
    rounding boundary rounds one bf16 step apart, so the forward is held to
    2e-3 and the gradients to 1e-2 relative plus 1e-3 of their scale."""
    enc, pred, k, b, labels, g_blank, g_emit = joint_data(70, 3, 40, 12, 64, 256, cuda_device,
                                                          torch.bfloat16)
    got = rnnt_joint_fwd(enc, pred, k, b, labels, 0)
    want = joint_blank_emit_ref(enc, pred, k, b, labels, 0)
    assert got[0].dtype == torch.float32
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    got = rnnt_joint_bwd(enc, pred, k, b, labels, want[2], g_blank, g_emit, 0)
    want = joint_blank_emit_bwd_ref(enc, pred, k, b, labels, want[2], g_blank, g_emit, 0)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), got, want):
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-2, scale_tol=1e-3)


@pytest.mark.cuda
def test_rnnt_loss_grads_on_card_match_cpu(cuda_device):
    """The whole exact loss (K6 + K7 and their backward) on the card against
    its plain versions on the CPU, with a row_valid=False row."""
    B, T, U, J, V = 3, 37, 9, 64, 200
    data = joint_data(80, B, T, U, J, V, "cpu")
    t_lens = torch.tensor([T, T - 11, T - 3], dtype=torch.int32)
    u_lens = torch.tensor([U, 0, U - 4], dtype=torch.int32)
    row_valid = torch.tensor([True, True, False])
    outs = []
    for dev in ("cpu", cuda_device):
        xs = [t.clone().to(dev).requires_grad_() for t in data[:4]]
        loss = rnnt_loss_pallas(*xs, data[4].to(dev), t_lens.to(dev), u_lens.to(dev),
                                blank_id=0, row_valid=row_valid.to(dev))
        loss.backward()
        outs.append((loss.item(), [x.grad.cpu().numpy() for x in xs]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    for name, a, c in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), outs[1][1], outs[0][1]):
        assert_grad_close(a, c, name, rtol=1e-4, scale_tol=1e-5)
    assert not outs[1][1][0][2].any()                        # the invalid row has no gradient


@pytest.mark.cuda
def test_rnnt_auto_band_trains_on_card(cuda_device):
    """The auto band above a padded U of 48 (band 32) runs the banded loss
    on the card: K8a/K8b and the banded lattice, one launch each."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import init_carry
    from statecatcher_tpu_torch.models.speech import build_speech_model
    from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

    cfg = Config().apply_overrides(["--model.encoder", "lucyrnn", "--model.hidden_size", "16",
                                    "--model.num_layers", "1", "--model.vocab_size", "20",
                                    "--train.mode", "rnnt"])
    model = build_speech_model(cfg.model, 80, "rnnt", device=cuda_device)
    step = make_segment_scan_step(model, cfg)
    state = init_train_state(model, cfg)
    K, B, S, U = 1, 2, 8000, 64                               # padded U above 48: band 32
    batch = [torch.zeros((K, B, S), device=cuda_device),
             torch.full((K, B), S, dtype=torch.int32, device=cuda_device),
             torch.ones((K, B, U), dtype=torch.int32, device=cuda_device),
             torch.full((K, B), 20, dtype=torch.int32, device=cuda_device),
             torch.ones((K, B), dtype=torch.bool, device=cuda_device)]
    counters = (rnnt_band_fwd, rnnt_band_bwd, rnnt_band_alpha, rnnt_band_beta)
    before = [c.launches for c in counters]
    _, _, outs = step(state, init_carry(cfg.model, B, device=cuda_device), *batch,
                      np.ones(K, bool))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1, 1]
    assert torch.isfinite(outs.loss).all() and torch.isfinite(outs.grad_norm).all()


def band_data(seed, B, T, U, J, V, band, Tb, dev, dtype=torch.float32):
    """Projections, labels, ragged lengths (row 0 full, row 1 short, the last
    row degenerate where B > 2), the band's offsets and cotangents."""
    from statecatcher_tpu_torch.ops.rnnt_band import band_offsets, band_width

    enc, pred, k, b, labels, _, _ = joint_data(seed, B, T, U, J, V, dev, dtype)
    t_lens = torch.full((B,), T, dtype=torch.int32)
    u_lens = torch.full((B,), U, dtype=torch.int32)
    t_lens[1], u_lens[1] = T - T // 3, U // 2
    if B > 2:
        t_lens[-1] = min(T, Tb - 2)                          # ends in block 0 with u_len = U
    Wp = band_width(band, U + 1, Tb)
    Tp = -(-T // Tb) * Tb
    o = band_offsets(t_lens, u_lens, Tp, -(-max(U + 1, Wp) // 8) * 8, Wp, Tb)
    rng = np.random.default_rng(seed + 1)
    g = lambda: torch.from_numpy((rng.standard_normal((B, Tp, Wp)) * 0.1).astype(np.float32))
    return (enc, pred, k, b, labels, o.to(dev), Wp, Tb, g().to(dev), g().to(dev),
            t_lens.to(dev), u_lens.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,J,V,band,Tb,blank_id",
                         [(3, 45, 40, 40, 150, 8, 8, 5), (2, 64, 30, 64, 1024, 32, 16, 0),
                          (3, 33, 9, 100, 70, 16, 8, 69)])
def test_band_kernels_match_plain(cuda_device, B, T, U, J, V, band, Tb, blank_id):
    """K8a/K8b against their plain versions in f32: ragged T (Tp > T), U+1
    above and below Wp, a degenerate row, time blocks of 8 and 16, J = 100
    (the 128-wide instance), blank_id ≠ 0.  Forward to 1e-5, gradients to
    1e-4 relative plus 1e-5 of each output's largest value (as K6)."""
    enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
        90 + J, B, T, U, J, V, band, Tb, cuda_device)
    n = (rnnt_band_fwd.launches, rnnt_band_bwd.launches)
    got = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb, blank_id)
    want = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb, blank_id)
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    args = (enc, pred, k, b, labels, o, want[2], g_blank, g_emit, Tb, blank_id)
    got, want = rnnt_band_bwd(*args), joint_blank_emit_banded_bwd_ref(*args)
    torch.cuda.synchronize()
    assert (rnnt_band_fwd.launches, rnnt_band_bwd.launches) == (n[0] + 1, n[1] + 1)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), got, want):
        assert x.shape == y.shape, name
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-4, scale_tol=1e-5)


@pytest.mark.cuda
def test_band_kernels_match_plain_bf16(cuda_device):
    """bf16 enc/pred, with K6's bf16 tolerances."""
    enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
        95, 3, 40, 30, 64, 256, 8, 8, cuda_device, torch.bfloat16)
    got = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb)
    want = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb)
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    args = (enc, pred, k, b, labels, o, want[2], g_blank, g_emit, Tb)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), rnnt_band_bwd(*args),
                          joint_blank_emit_banded_bwd_ref(*args)):
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-2, scale_tol=1e-3)


@pytest.mark.cuda
def test_band_bwd_degenerate_row_and_labels_outside_vocab(cuda_device):
    """K8b at a band with a degenerate row (its last frame in block 0) and
    labels outside [0, V), which select no column (no one-hot, no emit
    column), against its plain version in f32 (K6's tolerances)."""
    enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
        97, 3, 45, 40, 64, 150, 8, 8, cuda_device)
    labels = labels.clone()
    labels[0, ::5] = -1
    labels[2, 1::7] = 150 + 3
    got = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb)
    want = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb)
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    args = (enc, pred, k, b, labels, o, want[2], g_blank, g_emit, Tb)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), rnnt_band_bwd(*args),
                          joint_blank_emit_banded_bwd_ref(*args)):
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-4, scale_tol=1e-5)


def _bwd_args(kind, J, dev, dtype, seed):
    """The backward's arguments for K6b (``kind`` "joint") or K8b ("band"),
    with the forward's plain lse, and the kernel and its plain version."""
    if kind == "joint":
        enc, pred, k, b, labels, g_blank, g_emit = joint_data(seed, 3, 40, 12, J, 256, dev, dtype)
        lse = joint_blank_emit_ref(enc, pred, k, b, labels)[2]
        return ((enc, pred, k, b, labels, lse, g_blank, g_emit), rnnt_joint_bwd,
                joint_blank_emit_bwd_ref)
    enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
        seed, 3, 40, 30, J, 256, 8, 8, dev, dtype)
    lse = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb)[2]
    return ((enc, pred, k, b, labels, o, lse, g_blank, g_emit, Tb), rnnt_band_bwd,
            joint_blank_emit_banded_bwd_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("J", [40, 100])
def test_joint_bwd_bf16_ragged_widths(cuda_device, kind, J):
    """K6b/K8b with bf16 enc/pred at J = 40 (ragged in the 64-wide instance's
    tensor-core k-steps) and J = 100 (the 128-wide instance), with the bf16
    tolerances of test_rnnt_joint_kernels_match_plain_bf16."""
    args, kernel, plain = _bwd_args(kind, J, cuda_device, torch.bfloat16, 110 + J)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), kernel(*args),
                          plain(*args)):
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-2, scale_tol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_bwd_is_deterministic(cuda_device, kind, dtype):
    """Two calls of K6b/K8b on the same inputs give bit-equal outputs: the
    partial sums are added in a fixed order, with no atomics."""
    args, kernel, _ = _bwd_args(kind, 64, cuda_device, dtype, 120)
    first = [x.clone() for x in kernel(*args)]
    second = kernel(*args)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), first, second):
        assert torch.equal(x, y), name


# The forward's tolerance per input dtype, as test_rnnt_joint_kernels_match_plain
# (f32) and test_rnnt_joint_kernels_match_plain_bf16 hold it
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _fwd_args(kind, J, V, blank_id, dev, dtype, seed, U=12, band=8):
    """The forward's arguments for K6a (``kind`` "joint", B=3, T=40) or K8a
    ("band": B=3, T=40, time blocks of 8, a short and a degenerate row), and
    the kernel and its plain version."""
    if kind == "joint":
        enc, pred, k, b, labels, _, _ = joint_data(seed, 3, 40, U, J, V, dev, dtype)
        return (enc, pred, k, b, labels, blank_id), rnnt_joint_fwd, joint_blank_emit_ref
    enc, pred, k, b, labels, o, Wp, Tb, _, _, _, _ = band_data(seed, 3, 40, U, J, V, band, 8, dev,
                                                               dtype)
    return ((enc, pred, k, b, labels, o, Wp, Tb, blank_id), rnnt_band_fwd,
            joint_blank_emit_banded_ref)


def _assert_fwd_close(got, want, dtype):
    tol = FWD_TOL[dtype]
    for name, x, y in zip(("blank", "emit", "lse"), got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape, name
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J", [40, 64, 100])
@pytest.mark.parametrize("V", [70, 150, 1024])
def test_joint_fwd_ragged_widths(cuda_device, kind, dtype, J, V):
    """K6a/K8a on the tensor cores at J ragged in the 64-wide instance's
    k-steps (40), full (64) and in the 128-wide instance (100), and V in one
    partial vocab tile (70), two (150) and sixteen full ones (1024), f32
    (3xTF32) and bf16, against their plain versions."""
    args, kernel, plain = _fwd_args(kind, J, V, 0, cuda_device, dtype, 130 + J)
    _assert_fwd_close(kernel(*args), plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("V,blank_id", [(70, 69), (150, 64), (1024, 517)])
def test_joint_fwd_blank_in_any_vocab_tile(cuda_device, kind, V, blank_id):
    """The blank logit picked from the tile that holds it: the last column
    of a partial last tile (V=70), the first of the second tile, a middle
    tile's (1024, 517)."""
    args, kernel, plain = _fwd_args(kind, 64, V, blank_id, cuda_device, torch.float32, 140)
    _assert_fwd_close(kernel(*args), plain(*args), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_fwd_degenerate_row_and_window_past_labels(cuda_device, dtype):
    """K8a at a band whose window (Wp=24) reaches past U+1=10 (positions that
    read pred as 0 and select no label), with a degenerate row (its last
    frame in block 0) and labels outside [0, V)."""
    args, kernel, plain = _fwd_args("band", 64, 150, 0, cuda_device, dtype, 150, U=9, band=16)
    labels = args[4].clone()
    labels[0, ::3] = -1
    labels[2, 1::4] = 150 + 3
    args = args[:4] + (labels,) + args[5:]
    assert args[6] > 10
    _assert_fwd_close(kernel(*args), plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_fwd_is_deterministic(cuda_device, kind, dtype):
    """Two calls of K6a/K8a on the same inputs give bit-equal outputs."""
    args, kernel, _ = _fwd_args(kind, 64, 1024, 0, cuda_device, dtype, 160)
    first = [x.clone() for x in kernel(*args)]
    for name, x, y in zip(("blank", "emit", "lse"), first, kernel(*args)):
        assert torch.equal(x, y), name


# Joiner widths of the tiled products (J > 128): one past the 128-wide
# instance, ragged in the 64-wide contraction slices (200), NeMo's
# Conformer-Transducer joint_hidden (640), and 1024
WIDE_J = [129, 200, 640, 1024]
# The backward's tolerances per input dtype, as the J ≤ 128 tests hold them:
# (relative, share of each output's largest value)
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J", WIDE_J)
def test_wide_joint_kernels_match_plain(cuda_device, kind, dtype, J):
    """K6a/K6b and K8a/K8b above J = 128 (the tiled products) against their
    plain versions at the J ≤ 128 tests' tolerances (``FWD_TOL``,
    ``BWD_TOL``), blank_id 7: a J-term f32 contraction's round-off grows
    like √J ulps of its terms, ~3e-7 of a logit near 1 at J = 1024, well
    inside 1e-5."""
    args, kernel, plain = _fwd_args(kind, J, 256, 7, cuda_device, dtype, 170 + J)
    n = (rnnt_joint_fwd.launches, rnnt_band_fwd.launches)
    _assert_fwd_close(kernel(*args), plain(*args), dtype)
    assert rnnt_joint_fwd.launches + rnnt_band_fwd.launches == sum(n) + 1
    args, kernel, plain = _bwd_args(kind, J, cuda_device, dtype, 170 + J)
    rtol, scale_tol = BWD_TOL[dtype]
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), kernel(*args),
                          plain(*args)):
        assert x.shape == y.shape, name
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=rtol, scale_tol=scale_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("J", WIDE_J)
def test_wide_joint_is_deterministic(cuda_device, kind, dtype, J):
    """Two calls of the tiled products give bit-equal outputs, forward and
    backward: every partial sum (the chunks' d_K and d_bias added into each
    split's, the d_enc and d_pred sums) is added in a fixed order, with no
    atomics."""
    args, kernel, _ = _fwd_args(kind, J, 1024, 0, cuda_device, dtype, 180)
    first = [x.clone() for x in kernel(*args)]
    for name, x, y in zip(("blank", "emit", "lse"), first, kernel(*args)):
        assert torch.equal(x, y), name
    args, kernel, _ = _bwd_args(kind, J, cuda_device, dtype, 190)
    first = [x.clone() for x in kernel(*args)]
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), first, kernel(*args)):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("V,blank_id", [(70, 69), (150, 64), (1024, 517)])
def test_wide_joint_fwd_blank_in_any_vocab_tile(cuda_device, kind, V, blank_id):
    """The tiled products at J = 200 over one partial vocabulary tile (70),
    the blank the first column of the second (64 of 150) and in a middle
    tile (517 of 1024), f32."""
    args, kernel, plain = _fwd_args(kind, 200, V, blank_id, cuda_device, torch.float32, 200)
    _assert_fwd_close(kernel(*args), plain(*args), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint", "band"])
def test_wide_joint_over_several_chunks(cuda_device, kind):
    """More rows than one chunk of the tiled products (65,536): K6 at B=4,
    T=400, U=48 (78,400 rows in two chunks of whole 16-frame patch rows),
    K8 at U=128, band 32 (76,800 rows), J = 200, f32, against the plain
    versions, with a degenerate band row and, in the band, labels outside
    [0, V) (K6's plain version has no such labels: it indexes -1 as V - 1)."""
    J, V = 200, 256
    if kind == "joint":
        enc, pred, k, b, labels, g_blank, g_emit = joint_data(210, 4, 400, 48, J, V, cuda_device)
        fwd_args, kernel, plain = (enc, pred, k, b, labels, 3), rnnt_joint_fwd, joint_blank_emit_ref
    else:
        enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
            220, 4, 400, 128, J, V, 32, 8, cuda_device)
        labels[1, ::5] = V + 2
        fwd_args = (enc, pred, k, b, labels, o, Wp, Tb, 3)
        kernel, plain = rnnt_band_fwd, joint_blank_emit_banded_ref
    assert enc.shape[0] * enc.shape[1] * (fwd_args[6] if kind == "band" else 49) > 65536
    want = plain(*fwd_args)
    _assert_fwd_close(kernel(*fwd_args), want, torch.float32)
    if kind == "joint":
        args = (enc, pred, k, b, labels, want[2], g_blank, g_emit, 3)
        got, want = rnnt_joint_bwd(*args), joint_blank_emit_bwd_ref(*args)
    else:
        args = (enc, pred, k, b, labels, o, want[2], g_blank, g_emit, Tb, 3)
        got, want = rnnt_band_bwd(*args), joint_blank_emit_banded_bwd_ref(*args)
    for name, x, y in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), got, want):
        assert x.shape == y.shape, name
        assert_grad_close(x.cpu().numpy(), y.cpu().numpy(), name, rtol=1e-4, scale_tol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, -1])
def test_rnnt_wide_joiner_trains_on_card(cuda_device, band):
    """A joiner 640 wide (NeMo Conformer-Transducer's ``joint_hidden``) in
    the training step on the card: the exact loss through K6a/K6b
    (``train.rnnt_band`` 0, U = 24) and the default band above a padded U
    of 48 through K8a/K8b (U = 64), one launch of each, finite loss and
    grad norm."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import init_carry
    from statecatcher_tpu_torch.models.speech import build_speech_model
    from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

    cfg = Config().apply_overrides(["--model.encoder", "lucyrnn", "--model.hidden_size", "16",
                                    "--model.num_layers", "1", "--model.vocab_size", "40",
                                    "--model.rnnt_pred_emb_dim", "640",
                                    "--model.rnnt_joiner_dim", "640", "--train.mode", "rnnt",
                                    "--train.rnnt_band", str(band)])
    model = build_speech_model(cfg.model, 80, "rnnt", device=cuda_device)
    step = make_segment_scan_step(model, cfg)
    state = init_train_state(model, cfg)
    K, B, S, U = 1, 2, 8000, (24 if band == 0 else 64)
    batch = [torch.zeros((K, B, S), device=cuda_device),
             torch.full((K, B), S, dtype=torch.int32, device=cuda_device),
             torch.ones((K, B, U), dtype=torch.int32, device=cuda_device),
             torch.full((K, B), 20, dtype=torch.int32, device=cuda_device),
             torch.ones((K, B), dtype=torch.bool, device=cuda_device)]
    counters = (rnnt_joint_fwd, rnnt_joint_bwd) if band == 0 else (rnnt_band_fwd, rnnt_band_bwd)
    before = [c.launches for c in counters]
    _, _, outs = step(state, init_carry(cfg.model, B, device=cuda_device), *batch,
                      np.ones(K, bool))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]
    assert torch.isfinite(outs.loss).all() and torch.isfinite(outs.grad_norm).all()


def band_lattice_data(seed, B, T, U, band, Tb, dev):
    """``band_data``'s band and lengths with log-prob tables (B, Tp, Wp)
    made from its cotangents; where B ≥ 5, row B − 2 runs one frame."""
    from statecatcher_tpu_torch.ops.rnnt_band import band_offsets

    *_, o, Wp, Tb, g_blank, g_emit, t_lens, u_lens = band_data(seed, B, T, U, 8, 16, band, Tb,
                                                               dev)
    if B >= 5:
        t_lens[-2] = 1
        o = band_offsets(t_lens, u_lens, g_blank.shape[1], -(-max(U + 1, Wp) // 8) * 8, Wp, Tb)
    blank = (torch.log_softmax(torch.stack([g_blank, g_emit], -1) * 10, -1)[..., 0]).contiguous()
    emit = (torch.log_softmax(torch.stack([g_emit, g_blank], -1) * 10, -1)[..., 0]).contiguous()
    return blank, emit, o, Wp, t_lens, u_lens


# (B, T, U, band, Tb): Wp = 24, 48, 32 (time blocks of 16), then 48 at T = 400
# with band starts that step by 8 and 16, 80, 120 (past the frame ring,
# kRingMaxWp = 104) and 520 (17 cells a lane)
BAND_LATTICE_CASES = [(3, 45, 40, 8, 8), (4, 200, 120, 32, 8), (2, 70, 20, 40, 16),
                      (5, 400, 500, 32, 8), (5, 300, 200, 64, 8), (5, 300, 150, 100, 8),
                      (3, 120, 520, 500, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,band,Tb", BAND_LATTICE_CASES)
def test_band_lattice_kernels_match_plain(cuda_device, B, T, U, band, Tb):
    """The banded α/β against their plain versions: one to 17 window cells a
    lane, through the frame ring and the producer's own loads, band starts
    that step by 8 and by 16, short rows, a row of one frame (B ≥ 5) and a
    degenerate row whose band misses its corner (B > 2)."""
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_alpha_ref, rnnt_band_beta_ref

    blank, emit, o, Wp, t_lens, u_lens = band_lattice_data(100 + U, B, T, U, band, Tb,
                                                           cuda_device)
    if T >= 400:
        assert {8, 16} <= set(torch.diff(o[0]).tolist())
    n = (rnnt_band_alpha.launches, rnnt_band_beta.launches)
    got_a = rnnt_band_alpha(blank, emit, o, t_lens, Tb)
    got_b = rnnt_band_beta(blank, emit, o, t_lens, u_lens, Tb)
    torch.cuda.synchronize()
    assert (rnnt_band_alpha.launches, rnnt_band_beta.launches) == (n[0] + 1, n[1] + 1)
    assert_lattice_close(got_a, rnnt_band_alpha_ref(blank, emit, o, t_lens, Tb))
    want_b = rnnt_band_beta_ref(blank, emit, o, t_lens, u_lens, Tb)
    assert_lattice_close(got_b, want_b)
    if B > 2 and U + 1 > Wp:                         # the degenerate row: β dead everywhere
        assert (want_b[-1] <= -1e29).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,band,Tb", [(5, 400, 500, 32, 8), (3, 120, 520, 500, 8)])
def test_band_lattice_kernels_are_deterministic(cuda_device, B, T, U, band, Tb):
    """Two calls of the banded α and β give the same bits (frame ring and
    the producer's own loads)."""
    blank, emit, o, _, t_lens, u_lens = band_lattice_data(200 + U, B, T, U, band, Tb,
                                                          cuda_device)
    for fn, args in ((rnnt_band_alpha, (blank, emit, o, t_lens, Tb)),
                     (rnnt_band_beta, (blank, emit, o, t_lens, u_lens, Tb))):
        first = fn(*args).clone()
        assert torch.equal(first, fn(*args)), fn.__name__


@pytest.mark.cuda
def test_banded_loss_grads_on_card_match_cpu(cuda_device):
    """The whole banded loss (K8 + the banded lattice, forward and backward)
    on the card against its plain versions on the CPU, with a row_valid=False
    row and a degenerate row, at a pruning band and at a full one."""
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_loss_banded

    B, T, U, J, V = 4, 50, 30, 64, 200
    data = joint_data(110, B, T, U, J, V, "cpu")
    t_lens = torch.tensor([T, T - 11, T - 3, 5], dtype=torch.int32)
    u_lens = torch.tensor([U, 4, U - 4, U], dtype=torch.int32)
    row_valid = torch.tensor([True, True, False, True])
    for band in (8, U + 1):
        outs = []
        for dev in ("cpu", cuda_device):
            xs = [t.clone().to(dev).requires_grad_() for t in data[:4]]
            loss = rnnt_loss_banded(*xs, data[4].to(dev), t_lens.to(dev), u_lens.to(dev),
                                    row_valid=row_valid.to(dev), band=band)
            loss.backward()
            outs.append((loss.item(), [x.grad.cpu().numpy() for x in xs]))
        np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
        for name, a, c in zip(("d_enc", "d_pred", "d_kernel", "d_bias"), outs[1][1], outs[0][1]):
            assert_grad_close(a, c, name, rtol=1e-4, scale_tol=1e-5)
        assert not outs[1][1][0][2].any() and np.isfinite(outs[1][1][0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype", [(2, 45, 128, torch.float32), (3, 33, 100, torch.float32),
                                         (4, 64, 256, torch.bfloat16)])
def test_linear_scan_kernels_match_plain(cuda_device, B, T, D, dtype):
    """K5a/K5b against their plain versions: f32 equal (the same products
    and sums in the same order), bf16 within one bf16 step (both round the
    same f32 carry once, which may differ by f32 round-off)."""
    from statecatcher_tpu_torch.ops.lucy_pallas import (
        linear_scan_fwd,
        linear_scan_ref,
        linear_scan_rev,
        linear_scan_rev_ref,
    )

    rng = np.random.default_rng(T + D)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    a = torch.sigmoid(f(B, T, D) + 2.0).to(dtype)
    b, g = f(B, T, D).to(dtype), f(B, T, D).to(dtype)
    s0 = f(B, D)
    n = (linear_scan_fwd.launches, linear_scan_rev.launches)
    got = (linear_scan_fwd(a, b, s0), linear_scan_rev(a, g))
    want = (linear_scan_ref(a, b, s0), linear_scan_rev_ref(a, g))
    torch.cuda.synchronize()
    assert (linear_scan_fwd.launches, linear_scan_rev.launches) == (n[0] + 1, n[1] + 1)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        if dtype == torch.float32:
            assert torch.equal(x, y)
        else:
            x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
            assert (np.abs(x - y) <= 2.0 ** -7 * np.abs(y) + 1e-6).all()


@pytest.mark.cuda
def test_masked_cell_grads_on_card_match_cpu(cuda_device):
    """The split cell (gate chain, K5a forward, K5b backward) with a frame
    mask on the card against its plain version on the CPU."""
    from statecatcher_tpu_torch.models.lucyrnn import lucy_cell_parallel
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_fwd, linear_scan_rev

    gates, bias, h0, s0 = conditioned_cell_data(120, 3, 40, 64)
    mask = np.ones((3, 40), bool)
    mask[1, 25:] = False
    w = np.random.default_rng(121).standard_normal((3, 40, 64)).astype(np.float32)
    n = (linear_scan_fwd.launches, linear_scan_rev.launches)
    outs = []
    for dev in ("cpu", cuda_device):
        xs = [torch.from_numpy(x).to(dev).requires_grad_() for x in (gates, bias, h0, s0)]
        h_all, h_T, s_T = lucy_cell_parallel(xs[0], xs[2], xs[3], bias=xs[1],
                                             frame_mask=torch.from_numpy(mask).to(dev))
        ((h_all * torch.from_numpy(w).to(dev)).sum() + s_T.sum()).backward()
        outs.append([t.detach().cpu().numpy() for t in (h_all, s_T)] +
                    [x.grad.cpu().numpy() for x in xs])
    assert (linear_scan_fwd.launches, linear_scan_rev.launches) == (n[0] + 2, n[1] + 2)
    for name, a, c in zip(("h_all", "s_T", "gates", "bias", "h0", "s0"), outs[1], outs[0]):
        assert_grad_close(a, c, name)


def mlstm_kernel_data(seed, B, T, H, dqk, dv, chunk, dtype=torch.float32):
    """K9's kernel-level inputs (lane-major q/k/v, soft-capped gates), padded
    to the chunk multiple with random rows that the kernels must ignore, and
    a nonzero carry; from a numpy seed."""
    from statecatcher_tpu_torch.ops.mlstm_fused import soft_cap

    rng = np.random.default_rng(seed)
    L = min(chunk, max(8, T))
    Tp = -(-T // L) * L
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5)
    q, k, v = r(B, Tp, H * dqk).to(dtype), r(B, Tp, H * dqk).to(dtype), r(B, Tp, H * dv).to(dtype)
    i_c = soft_cap(2.0 * r(B, H, Tp), 15.0)
    logf = torch.nn.functional.logsigmoid(soft_cap(2.0 * r(B, H, Tp) + 1.0, 15.0))
    C0, n0, m0 = 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(), 0.1 * r(B, H)
    return [q, k, v, i_c, logf, C0, n0, m0], L, Tp


def assert_scaled_close(got, want, names, tol):
    """|Δ| ≤ tol·max|want| for each output (the forward's f32 round-off, held
    to each output's own scale)."""
    for name, a, c in zip(names, got, want):
        a, c = a.float().cpu().numpy(), c.float().cpu().numpy()
        assert np.isfinite(a).all(), name
        err, scale = np.abs(a - c).max(), np.abs(c).max()
        assert err <= tol * scale, f"{name}: max |Δ| {err:.3e} > {tol:g}·{scale:.3e}"


# (B, T, H, dqk, dv, chunk); the last three above 256: chunk 512
# (two threads' rows a gate scan, ragged T), E=2048's heads (dqk 512: dq and
# dk in two slabs), dqk 300 (a slab of 44 columns) at chunk 384
MLSTM_SHAPES = [(2, 45, 2, 16, 16, 16), (1, 300, 2, 128, 256, 128), (2, 70, 1, 32, 80, 32),
                (1, 600, 2, 128, 256, 256), (1, 1100, 2, 128, 256, 512),
                (1, 600, 1, 512, 1024, 128), (1, 700, 1, 300, 80, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", MLSTM_SHAPES)
def test_mlstm_fused_kernels_match_plain_f32(cuda_device, B, T, H, dqk, dv, chunk):
    """K9a and K9b against their plain versions at ragged T with a nonzero
    carry: the forward within 1e-4 of each output's scale (f32 sums in other
    orders), the gradients within 1e-3 relative plus 1e-4 of each output's
    largest value."""
    from statecatcher_tpu_torch.ops.mlstm_fused import (
        mlstm_fused_bwd,
        mlstm_fused_bwd_ref,
        mlstm_fused_fwd,
        mlstm_fused_fwd_ref,
    )

    ins, L, Tp = mlstm_kernel_data(B * T + dqk, B, T, H, dqk, dv, chunk)
    ins = [x.to(cuda_device) for x in ins]
    n = (mlstm_fused_fwd.launches, mlstm_fused_bwd.launches)
    got = mlstm_fused_fwd(*ins, L, T)
    torch.cuda.synchronize()
    want = mlstm_fused_fwd_ref(*ins, L, T)
    assert_scaled_close([got[0][:, :T]] + list(got[1:]), [want[0][:, :T]] + list(want[1:]),
                        ("h", "C_T", "n_T", "m_T"), 1e-4)
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    cots = [torch.randn(x.shape, generator=gen, device=cuda_device) for x in want]
    gb = mlstm_fused_bwd(*ins, *cots, L, T)
    torch.cuda.synchronize()
    gr = mlstm_fused_bwd_ref(*ins, *cots, L, T)
    assert (mlstm_fused_fwd.launches, mlstm_fused_bwd.launches) == (n[0] + 1, n[1] + 1)
    for name, a, c in zip(("dq", "dk", "dv", "dic", "dlogf", "dC0", "dn0", "dm0"), gb, gr):
        assert_grad_close(a.cpu().numpy(), c.cpu().numpy(), name, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", MLSTM_SHAPES)
def test_mlstm_kernels_at_any_shape_bf16_deterministic_and_k10(cuda_device, B, T, H, dqk, dv,
                                                                chunk):
    """At each shape of MLSTM_SHAPES: K9a/K9b in bf16 against their plain
    versions (h 2e-2 of its scale, dq, dk, dv 2e-2 relative plus 1e-3, the
    f32 outputs as in f32); two calls of K9a and K9b give the same bits in
    f32 and in bf16; K10 against mlstm_chunkwise in f32 within 1e-4 of each
    output's scale, two calls the same bits."""
    from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise
    from statecatcher_tpu_torch.ops.mlstm_fused import (
        mlstm_fused_bwd,
        mlstm_fused_bwd_ref,
        mlstm_fused_fwd,
        mlstm_fused_fwd_ref,
    )
    from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_pallas_fwd

    fwd_names = ("h", "C_T", "n_T", "m_T")
    for dtype in (torch.float32, torch.bfloat16):
        ins, L, Tp = mlstm_kernel_data(B * T + dqk + 1, B, T, H, dqk, dv, chunk, dtype)
        ins = [x.to(cuda_device) for x in ins]
        gen = torch.Generator(device=cuda_device).manual_seed(T + 1)
        cots = [torch.randn(x.shape, generator=gen, device=cuda_device).to(x.dtype)
                for x in (ins[2], ins[5], ins[6], ins[7])]
        cots[0][:, T:] = 0
        got = [x.clone() for x in mlstm_fused_fwd(*ins, L, T)]
        gb = [x.clone() for x in mlstm_fused_bwd(*ins, *cots, L, T)]
        for name, a, c in zip(fwd_names + K9B_NAMES, got + gb,
                              list(mlstm_fused_fwd(*ins, L, T)) +
                              list(mlstm_fused_bwd(*ins, *cots, L, T))):
            assert torch.equal(a, c), f"{name} ({dtype}): two calls differ"
        if dtype == torch.bfloat16:
            want = mlstm_fused_fwd_ref(*ins, L, T)
            assert_scaled_close([got[0][:, :T]], [want[0][:, :T]], fwd_names[:1], 2e-2)
            assert_scaled_close(got[1:], want[1:], fwd_names[1:], 1e-4)
            _assert_k9b_close(gb, mlstm_fused_bwd_ref(*ins, *cots, L, T), dtype)
    rng = np.random.default_rng(T + dqk)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5)
    ins = [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
           2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(), 0.1 * r(B, H)]
    ins = [x.to(cuda_device) for x in ins]
    n = mlstm_pallas_fwd.launches
    got = [x.clone() for x in mlstm_pallas_fwd(*ins, chunk)]
    again = mlstm_pallas_fwd(*ins, chunk)
    torch.cuda.synchronize()
    assert mlstm_pallas_fwd.launches == n + 2
    for name, a, c in zip(fwd_names, got, again):
        assert torch.equal(a, c), f"K10 {name}: two calls differ"
    assert_scaled_close(got, mlstm_chunkwise(*ins, chunk), fwd_names, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(64, 64), (512, 1024)])
def test_mlstm_kernels_launch_at_their_largest_chunk(cuda_device, dqk, dv):
    """At ``max_chunk``, the largest chunk whose blocks fit the card's shared
    memory, K9a and K9b (at the backward's limit) and K10 (at the forward's,
    T = 200) launch and match their plain versions.  The gates' exponents
    are differences of sums of logf over the chunk's rows (``sums``, the
    largest |Σ logf| of a head: ~3000 at 7782 rows), each known to a step
    of f32 of such a sum, 6e-8 of it: m_T is held to 1e-6·sums (16 steps),
    every other output to the f32 tolerances of the tests above plus that
    much of its scale.  A chunk one row larger raises ValueError naming the
    largest."""
    from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise
    from statecatcher_tpu_torch.ops import mlstm_pallas as mp
    from statecatcher_tpu_torch.ops.mlstm_fused import (
        _check,
        max_chunk,
        mlstm_fused_bwd,
        mlstm_fused_bwd_ref,
        mlstm_fused_fwd,
        mlstm_fused_fwd_ref,
        soft_cap,
    )

    def close(got, want, logf, names, rtol, scale_tol):
        sums = logf.sum(-1).abs().max().item()
        for name, a, c in zip(names, got, want):
            if name == "m_T":
                err = (a - c).abs().max().item()
                assert err <= 1e-6 * sums, f"m_T: max |Δ| {err:.3e} > 1e-6·{sums:.3e}"
            else:
                assert_grad_close(a.float().cpu().numpy(), c.float().cpu().numpy(), name,
                                  rtol=rtol, scale_tol=scale_tol + 1e-6 * sums)

    L = max_chunk(dqk, dv, True)
    ins, _, _ = mlstm_kernel_data(L + dqk, 1, L, 1, dqk, dv, L)
    ins = [x.to(cuda_device) for x in ins]
    got = mlstm_fused_fwd(*ins, L, L)
    want = mlstm_fused_fwd_ref(*ins, L, L)
    close(got, want, ins[4], ("h", "C_T", "n_T", "m_T"), 0.0, 1e-4)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    cots = [torch.randn(x.shape, generator=gen, device=cuda_device) for x in want]
    close(mlstm_fused_bwd(*ins, *cots, L, L), mlstm_fused_bwd_ref(*ins, *cots, L, L), ins[4],
          K9B_NAMES, 1e-3, 1e-4)
    big = [torch.zeros(1, L + 1, x.shape[-1]) if x.ndim == 3 and i < 3 else
           torch.zeros(*x.shape[:-1], L + 1) if i in (3, 4) else x.cpu()
           for i, x in enumerate(ins)]
    with pytest.raises(ValueError, match=f"at most {L} rows"):
        _check(*big, L + 1, L + 1, bwd=True)

    Lf = max_chunk(dqk, dv, False)
    rng = np.random.default_rng(dqk)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5)
    T = 200
    ins = [r(1, 1, T, dqk), r(1, 1, T, dqk), r(1, 1, T, dv), 2.0 * r(1, 1, T),
           2.0 * r(1, 1, T) + 1.0, 0.1 * r(1, 1, dqk, dv), (0.1 * r(1, 1, dqk)).abs(),
           0.1 * r(1, 1)]
    with pytest.raises(ValueError, match=f"at most {Lf} rows"):
        mp._check(*ins, Lf + 1)
    ins = [x.to(cuda_device) for x in ins]
    close(mp.mlstm_pallas_fwd(*ins, Lf), mlstm_chunkwise(*ins, Lf),
          torch.nn.functional.logsigmoid(soft_cap(ins[4], 15.0)), ("h", "C_T", "n_T", "m_T"),
          0.0, 1e-4)


@pytest.mark.cuda
def test_mlstm_fused_kernels_match_plain_bf16(cuda_device):
    """bf16 q/k/v (h, dq, dk, dv in bf16): both versions compute in f32 from
    the same bf16 values and round once, so a bf16 output is within a few
    bf16 steps of the plain one; the f32 outputs keep the f32 tolerances."""
    from statecatcher_tpu_torch.ops.mlstm_fused import (
        mlstm_fused_bwd,
        mlstm_fused_bwd_ref,
        mlstm_fused_fwd,
        mlstm_fused_fwd_ref,
    )

    B, T, H, dqk, dv, chunk = 2, 200, 2, 64, 128, 128
    ins, L, Tp = mlstm_kernel_data(7, B, T, H, dqk, dv, chunk, torch.bfloat16)
    ins = [x.to(cuda_device) for x in ins]
    got, want = mlstm_fused_fwd(*ins, L, T), mlstm_fused_fwd_ref(*ins, L, T)
    assert got[0].dtype == torch.bfloat16
    assert_scaled_close(got[:1], want[:1], ("h",), 2e-2)
    assert_scaled_close(got[1:], want[1:], ("C_T", "n_T", "m_T"), 1e-4)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cots = [torch.randn(x.shape, generator=gen, device=cuda_device).to(x.dtype) for x in want]
    gb = mlstm_fused_bwd(*ins, *cots, L, T)
    gr = mlstm_fused_bwd_ref(*ins, *cots, L, T)
    for name, a, c in zip(("dq", "dk", "dv"), gb[:3], gr[:3]):
        assert a.dtype == torch.bfloat16
        assert_grad_close(a.float().cpu().numpy(), c.float().cpu().numpy(), name, rtol=2e-2,
                          scale_tol=1e-3)
    for name, a, c in zip(("dic", "dlogf", "dC0", "dn0", "dm0"), gb[3:], gr[3:]):
        assert_grad_close(a.cpu().numpy(), c.cpu().numpy(), name, rtol=1e-3, scale_tol=1e-4)


# (T, H, dqk, dv, chunk) of K9b's chunk-parallel passes: L = 64, 128 and 256,
# T a multiple of L and not, 1, 2 and 4 heads, (dqk, dv) = (64, 128),
# (128, 256) and (256, 256)
K9B_SHAPES = [(640, 2, 64, 128, 64), (600, 1, 128, 256, 64), (500, 4, 64, 128, 128),
              (512, 2, 256, 256, 128), (700, 2, 128, 256, 256), (512, 1, 256, 256, 256),
              (300, 4, 64, 128, 256)]
K9B_NAMES = ("dq", "dk", "dv", "dic", "dlogf", "dC0", "dn0", "dm0")


def _k9b_case(seed, T, H, dqk, dv, chunk, dtype, dev, ties=False):
    ins, L, Tp = mlstm_kernel_data(seed, 2, T, H, dqk, dv, chunk, dtype)
    if ties:                                    # every a_s equal, m0 equal to it
        ins[3] = torch.full_like(ins[3], -0.3)
        ins[4] = torch.zeros_like(ins[4])
        ins[7] = torch.full_like(ins[7], -0.3)
    ins = [x.to(dev) for x in ins]
    gen = torch.Generator(device=dev).manual_seed(seed)
    cots = [torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
            for x in (ins[2], ins[5], ins[6], ins[7])]
    cots[0][:, T:] = 0                          # rows past T are not outputs
    return ins, cots, L


def _assert_k9b_close(got, want, dtype):
    """chip_smoke.py phase 17's tolerances: 1e-3 relative plus 1e-4 of each
    output's largest value; under bf16, dq, dk, dv 2e-2 plus 1e-3."""
    for i, (name, a, c) in enumerate(zip(K9B_NAMES, got, want)):
        bf = dtype == torch.bfloat16 and i < 3
        assert a.dtype == c.dtype, name
        assert_grad_close(a.float().cpu().numpy(), c.float().cpu().numpy(), name,
                          rtol=2e-2 if bf else 1e-3, scale_tol=1e-3 if bf else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,dqk,dv,chunk", K9B_SHAPES)
def test_mlstm_bwd_kernel_matches_plain(cuda_device, T, H, dqk, dv, chunk, dtype):
    """K9b against its plain version at B=2 over the chunk lengths, head
    counts and widths of its chunk-parallel passes."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd, mlstm_fused_bwd_ref

    ins, cots, L = _k9b_case(T + H + dqk, T, H, dqk, dv, chunk, dtype, cuda_device)
    n = mlstm_fused_bwd.launches
    got = mlstm_fused_bwd(*ins, *cots, L, T)
    torch.cuda.synchronize()
    assert mlstm_fused_bwd.launches == n + 1
    _assert_k9b_close(got, mlstm_fused_bwd_ref(*ins, *cots, L, T), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_bwd_kernel_with_tied_gates(cuda_device, dtype):
    """Equal input gates and no forgetting: the running max ties along the
    whole chunk, and max(m, R) and m' tie too (each tie an equal share)."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd, mlstm_fused_bwd_ref

    ins, cots, L = _k9b_case(3, 300, 2, 64, 128, 128, dtype, cuda_device, ties=True)
    _assert_k9b_close(mlstm_fused_bwd(*ins, *cots, L, 300),
                      mlstm_fused_bwd_ref(*ins, *cots, L, 300), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_bwd_kernel_is_deterministic(cuda_device, dtype):
    """Two calls of K9b on the same inputs give bit-equal outputs: partial
    sums in a fixed order, no atomics."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd

    ins, cots, L = _k9b_case(4, 700, 2, 128, 256, 256, dtype, cuda_device)
    first = [x.clone() for x in mlstm_fused_bwd(*ins, *cots, L, 700)]
    for name, a, c in zip(K9B_NAMES, first, mlstm_fused_bwd(*ins, *cots, L, 700)):
        assert torch.equal(a, c), name


# (B, T, H, dqk, dv, chunk, dtype, ties) of K9a's chunk-parallel passes: the
# streaming shape (one chunk: three launches), T = Tp - L + 1 (one valid row
# in the last chunk), L = 256 in bf16, tied gates, dv = 80 (a ragged column
# tile) and a narrow dv
K9A_CASES = [(1, 32, 2, 128, 256, 128, torch.float32, False),
             (1, 32, 2, 128, 256, 128, torch.bfloat16, False),
             (2, 257, 2, 128, 256, 128, torch.float32, False),
             (2, 600, 2, 128, 256, 256, torch.bfloat16, False),
             (2, 300, 2, 64, 128, 128, torch.float32, True),
             (2, 300, 2, 64, 128, 128, torch.bfloat16, True),
             (2, 70, 1, 32, 80, 32, torch.float32, False),
             (2, 200, 2, 64, 48, 64, torch.bfloat16, False)]


def _k9a_case(seed, B, T, H, dqk, dv, chunk, dtype, ties, dev):
    ins, L, _ = mlstm_kernel_data(seed, B, T, H, dqk, dv, chunk, dtype)
    if ties:                                    # every a_s equal, m0 equal to it
        ins[3] = torch.full_like(ins[3], -0.3)
        ins[4] = torch.zeros_like(ins[4])
        ins[7] = torch.full_like(ins[7], -0.3)
    return [x.to(dev) for x in ins], L


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk,dtype,ties", K9A_CASES)
def test_mlstm_fwd_kernel_matches_plain(cuda_device, B, T, H, dqk, dv, chunk, dtype, ties):
    """K9a against its plain version, one launch counted a call: each output
    within 1e-4 of its largest value (f32 sums in other orders), a bf16 h
    within 2e-2 (both versions round it once from f32)."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_fwd, mlstm_fused_fwd_ref

    ins, L = _k9a_case(T + dv, B, T, H, dqk, dv, chunk, dtype, ties, cuda_device)
    n = mlstm_fused_fwd.launches
    got = mlstm_fused_fwd(*ins, L, T)
    torch.cuda.synchronize()
    assert mlstm_fused_fwd.launches == n + 1
    want = mlstm_fused_fwd_ref(*ins, L, T)
    assert got[0].dtype == want[0].dtype == dtype
    assert_scaled_close([got[0][:, :T]], [want[0][:, :T]], ("h",),
                        1e-4 if dtype == torch.float32 else 2e-2)
    assert_scaled_close(got[1:], want[1:], ("C_T", "n_T", "m_T"), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,chunk", [(1598, 128), (32, 128)])
def test_mlstm_fwd_kernel_is_deterministic(cuda_device, dtype, T, chunk):
    """Two calls of K9a on the same inputs give bit-equal outputs: sums in a
    fixed order, no atomics."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_fwd

    ins, L = _k9a_case(5, 2, T, 2, 128, 256, chunk, dtype, False, cuda_device)
    first = [x.clone() for x in mlstm_fused_fwd(*ins, L, T)]
    for name, a, c in zip(("h", "C_T", "n_T", "m_T"), first, mlstm_fused_fwd(*ins, L, T)):
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", [(2, 45, 2, 16, 16, 16), (1, 300, 2, 128, 256, 128),
                                                (1, 32, 2, 128, 256, 128),
                                                (2, 500, 2, 64, 80, 256)])
def test_mlstm_pallas_kernel_matches_plain(cuda_device, B, T, H, dqk, dv, chunk):
    """K10 against mlstm_chunkwise (its plain version) at ragged T with a
    nonzero carry, within 1e-4 of each output's scale; its gradients (the
    plain version's autograd on both sides) on the card against the CPU."""
    from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise
    from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_chunkwise_pallas, mlstm_pallas_fwd

    rng = np.random.default_rng(T)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5)
    ins = [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
           2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(), 0.1 * r(B, H)]
    dev_ins = [x.to(cuda_device) for x in ins]
    n = mlstm_pallas_fwd.launches
    got = mlstm_pallas_fwd(*dev_ins, chunk)
    torch.cuda.synchronize()
    assert mlstm_pallas_fwd.launches == n + 1
    want = mlstm_chunkwise(*dev_ins, chunk)
    assert_scaled_close(got, want, ("h", "C_T", "n_T", "m_T"), 1e-4)
    ws = [torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)) for x in want]
    grads = []
    for dev in ("cpu", cuda_device):
        xs = [x.detach().to(dev).requires_grad_() for x in ins]
        outs = mlstm_chunkwise_pallas(*xs, chunk)
        loss = sum((o * w.to(dev)).sum() for o, w in zip(outs, ws))
        grads.append([g.cpu().numpy() for g in torch.autograd.grad(loss, xs)])
    for name, a, c in zip(("q", "k", "v", "i", "f", "C0", "n0", "m0"), *grads):
        assert_grad_close(a, c, "d" + name, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernels_on_a_ranks_heads_are_slices_of_all_heads(cuda_device, dtype):
    """Tensor parallelism runs K9a/K9b (and, in float32, K10) on a model
    rank's heads of the lane-major tensors.  At the flagship's shapes (B=32,
    T=1598, 2 heads, dqk 128, dv 256, chunk 128) the call on head m alone
    gives head m's slice of the all-heads call bit for bit: a head's
    arithmetic does not depend on the heads beside it."""
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd, mlstm_fused_fwd
    from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_pallas_fwd

    B, T, H, dqk, dv, chunk = 32, 1598, 2, 128, 256, 128
    ins, L, _ = mlstm_kernel_data(11, B, T, H, dqk, dv, chunk, dtype)
    ins = [x.to(cuda_device) for x in ins]
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    cots = [torch.randn(x.shape, generator=gen, device=cuda_device).to(x.dtype)
            for x in (ins[2], ins[5], ins[6], ins[7])]
    cots[0][:, T:] = 0                          # rows past T are not outputs
    fwd = mlstm_fused_fwd(*ins, L, T)
    bwd = mlstm_fused_bwd(*ins, *cots, L, T)
    # K10's head-major layout, on the first T rows and the raw gates' stand-ins
    heads = lambda x, d: x[:, :T].float().reshape(B, T, H, d).transpose(1, 2).contiguous()
    k10_ins = [heads(ins[0], dqk), heads(ins[1], dqk), heads(ins[2], dv),
               ins[3][..., :T].contiguous(), ins[4][..., :T].contiguous(), *ins[5:]]
    k10 = mlstm_pallas_fwd(*k10_ins, chunk) if dtype == torch.float32 else None
    for m in range(H):
        lanes = lambda x, d: x[..., m * d:(m + 1) * d].contiguous()
        head = lambda x: x[:, m:m + 1].contiguous()
        part = [lanes(ins[0], dqk), lanes(ins[1], dqk), lanes(ins[2], dv),
                *(head(x) for x in ins[3:])]
        part_cots = [lanes(cots[0], dv), *(head(x) for x in cots[1:])]
        got = mlstm_fused_fwd(*part, L, T)
        assert torch.equal(got[0][:, :T], lanes(fwd[0], dv)[:, :T]), f"K9a h, head {m}"
        for name, a, c in zip(("C_T", "n_T", "m_T"), got[1:], fwd[1:]):
            assert torch.equal(a, head(c)), f"K9a {name}, head {m}"
        got = mlstm_fused_bwd(*part, *part_cots, L, T)
        for name, a, c, d in zip(K9B_NAMES[:3], got, bwd, (dqk, dqk, dv)):
            assert torch.equal(a, lanes(c, d)), f"K9b {name}, head {m}"
        for name, a, c in zip(K9B_NAMES[3:], got[3:], bwd[3:]):
            assert torch.equal(a, head(c)), f"K9b {name}, head {m}"
        if k10 is not None:
            got = mlstm_pallas_fwd(*(head(x) for x in k10_ins), chunk)
            for name, a, c in zip(("h", "C_T", "n_T", "m_T"), got, k10):
                assert torch.equal(a, head(c)), f"K10 {name}, head {m}"


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "fused", "pallas"])
def test_xlstm_encoder_on_card_matches_cpu(cuda_device, impl):
    """The xLSTM encoder (2 blocks, E=64) with ``kernel_impl`` on the card
    against "chunkwise" on the CPU over two carried segments: logits and
    carry within 1e-4 of their scale, parameter gradients within 1e-3
    relative plus 1e-4 of each one's largest value."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import build_model, init_carry
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd, mlstm_fused_fwd
    from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_pallas_fwd

    ov = ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "64",
          "--model.xlstm.num_blocks", "2", "--model.xlstm.chunk_size", "32",
          "--model.vocab_size", "40"]
    cfg = Config().apply_overrides(ov)
    rng = np.random.default_rng(3)
    feats = [torch.from_numpy(rng.standard_normal((2, 75, 24)).astype(np.float32))
             for _ in range(2)]
    counters = (mlstm_fused_fwd, mlstm_fused_bwd, mlstm_pallas_fwd)
    n = [c.launches for c in counters]
    runs = []
    for dev, ki in (("cpu", "chunkwise"), (cuda_device, impl)):
        c = Config().apply_overrides(ov + ["--model.xlstm.kernel_impl", ki])
        model = build_model(c.model, 24, device=dev, generator=torch.Generator().manual_seed(0))
        w = model.encoder.vocab_proj.weight                  # zero at init
        with torch.no_grad():
            w.copy_(0.1 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1)))
        carry, outs, loss = init_carry(c.model, 2, device=dev), [], 0.0
        for x in feats:
            logits, carry = model(x.to(dev), carry)
            outs.append(logits)
            loss = loss + (logits * torch.linspace(-1, 1, 40, device=dev)).sum()
        loss.backward()
        runs.append(([o.detach().cpu() for o in outs] + [v.detach().cpu() for v in carry.values()],
                     {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}))
    assert_scaled_close(runs[1][0], runs[0][0], ("logits 0", "logits 1", "C", "n", "m"), 1e-4)
    for k, a in runs[1][1].items():
        assert_grad_close(a, runs[0][1][k], k, rtol=1e-3, scale_tol=1e-4)
    moved = [c.launches - k for c, k in zip(counters, n)]
    want = {"pallas": [0, 0, 4]}.get(impl, [4, 4, 0])
    assert moved == want, moved


def _frame_mask(B, T, dev):
    """Row 1 ends early, row 0 has a hole."""
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[1 % B, (2 * T) // 3:] = False
    mask[0, T // 2] = False
    return mask.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,T,D,dtype", [(2, 45, 128, torch.float32), (3, 33, 100, torch.float32),
                                         (1, 32, 512, torch.float32), (4, 64, 256, torch.bfloat16)])
def test_fused_cell_kernel_matches_plain(cuda_device, B, T, D, dtype, masked):
    """K12 against its plain version: f32 bit for bit (the same operations,
    each rounded once, in the same order); bf16 gates to a bf16 step, as
    K1's bf16 test."""
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_fused_cell, lucy_fused_cell_ref

    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(30 + T, B, T, D))
    g4 = (gates + bias).reshape(B, T, 7, D).to(dtype)
    mask = _frame_mask(B, T, cuda_device) if masked else None
    before = lucy_fused_cell.launches
    with torch.inference_mode():
        h, s = lucy_fused_cell(g4, h0, s0, mask)
        h_ref, s_ref = lucy_fused_cell_ref(g4, h0, s0, mask)
    torch.cuda.synchronize()
    assert lucy_fused_cell.launches == before + 1
    assert h.dtype == s.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(h, h_ref) and torch.equal(s, s_ref)
    h, s, h_ref, s_ref = (t.float().cpu().numpy() for t in (h, s, h_ref, s_ref))
    if dtype != torch.float32:
        np.testing.assert_allclose(h, h_ref, rtol=2e-2, atol=2e-2)
        assert (np.abs(s - s_ref) <= 1e-3 * np.abs(s_ref).max() + 1e-2 * np.abs(s_ref)).all()
    if masked:                                               # row 1 frozen past its end
        end = (2 * T) // 3
        assert (h[1 % B, end:] == h[1 % B, end - 1]).all()


# The ring's edges of K12 (time tiles of 12 steps, 3 stages, 64 columns a
# block) and of K5a (tiles of 32 steps, 4 stages, 32 columns a block in f32
# and 64 in bf16): T = 1, a tile's length ± 1 and S tiles + 1; ragged column
# tiles (D = 100, 520); B = 1 at the streaming shape; bf16 with odd D (rows on
# 2 bytes, copied without cp.async); and inputs offset by one element from
# their allocation (rows no longer on 16 bytes: the narrower copy units).
K12_RING_EDGES = [(2, 1, 128, torch.float32, False), (2, 11, 128, torch.float32, False),
                  (2, 13, 128, torch.float32, False), (2, 37, 128, torch.float32, False),
                  (3, 40, 100, torch.float32, False), (2, 30, 520, torch.float32, False),
                  (1, 32, 512, torch.float32, False), (2, 25, 101, torch.bfloat16, False),
                  (2, 37, 128, torch.bfloat16, False), (2, 29, 128, torch.float32, True),
                  (2, 29, 100, torch.bfloat16, True)]
K5A_RING_EDGES = [(2, 1, 128, torch.float32, False), (2, 31, 128, torch.float32, False),
                  (2, 33, 128, torch.float32, False), (2, 129, 128, torch.float32, False),
                  (3, 70, 100, torch.float32, False), (2, 65, 520, torch.float32, False),
                  (1, 32, 512, torch.float32, False), (2, 1, 256, torch.bfloat16, False),
                  (2, 129, 101, torch.bfloat16, False), (2, 65, 520, torch.bfloat16, False),
                  (2, 40, 128, torch.float32, True), (2, 40, 129, torch.bfloat16, True)]


# K5b walks K5a's ring backwards and K11 forwards (the same tiles of 32
# steps, 4 stages, 32 f32 / 64 bf16 columns a block): T = 1, a tile's length
# and ± 1, S tiles ± 1 and the flagship's 1598; D = 100, 128, 512, ragged and
# odd bf16 widths; inputs offset from their allocation by 1, 2 or 4 elements
# (copy units of 4 and 8 bytes in f32, of 2, 4 and 8 in bf16).
K5B_RING_EDGES = [(2, 1, 128, torch.float32, 0), (2, 31, 128, torch.float32, 0),
                  (2, 32, 128, torch.float32, 0), (2, 33, 128, torch.float32, 0),
                  (2, 127, 100, torch.float32, 0), (2, 129, 512, torch.float32, 0),
                  (2, 1598, 512, torch.float32, 0), (1, 32, 512, torch.float32, 0),
                  (3, 70, 100, torch.float32, 1), (2, 65, 128, torch.float32, 2),
                  (2, 1, 256, torch.bfloat16, 0), (2, 129, 101, torch.bfloat16, 0),
                  (2, 33, 520, torch.bfloat16, 0), (2, 127, 128, torch.bfloat16, 1),
                  (2, 31, 128, torch.bfloat16, 2), (2, 1598, 512, torch.bfloat16, 4)]
K11_RING_EDGES = [(2, 1, 128, torch.float32, 0), (2, 31, 128, torch.float32, 0),
                  (2, 32, 128, torch.float32, 0), (2, 33, 128, torch.float32, 0),
                  (2, 127, 100, torch.float32, 0), (2, 129, 512, torch.float32, 0),
                  (2, 1598, 512, torch.float32, 0), (1, 32, 512, torch.float32, 0),
                  (3, 40, 100, torch.float32, 1), (2, 65, 128, torch.float32, 2),
                  (2, 1, 256, torch.bfloat16, 0), (2, 129, 101, torch.bfloat16, 0),
                  (2, 33, 520, torch.bfloat16, 0), (2, 127, 128, torch.bfloat16, 1),
                  (2, 31, 128, torch.bfloat16, 2), (2, 1598, 512, torch.bfloat16, 4)]


def _ring_id(case):
    B, T, D, dtype, offset = case
    return (f"B{B}-T{T}-D{D}-{str(dtype).split('.')[-1]}"
            + ("-offset" if offset is True else f"-offset{offset}" if offset else ""))


def _offset_view(x, offset):
    """x itself, or a copy of x whose storage starts ``offset`` elements (one
    for True) past its allocation."""
    if not offset:
        return x
    n = int(offset)
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    view = buf[n:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _assert_equal_or_one_bf16_step(got, want):
    """f32: bit for bit; bf16: within one bf16 step (both round the same f32
    carry once, which may differ by f32 round-off)."""
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        x, y = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert (np.abs(x - y) <= 2.0 ** -7 * np.abs(y) + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,T,D,dtype,offset", K12_RING_EDGES, ids=map(_ring_id, K12_RING_EDGES))
def test_fused_cell_kernel_ring_edges(cuda_device, B, T, D, dtype, offset, masked):
    """K12 at the edges of its ring, against its plain version: f32 bit for
    bit, bf16 to one bf16 step; h and s both."""
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_fused_cell, lucy_fused_cell_ref

    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(60 + T + D, B, T, D))
    g4 = _offset_view((gates + bias).reshape(B, T, 7, D).to(dtype), offset)
    mask = _frame_mask(B, T, cuda_device) if masked else None
    before = lucy_fused_cell.launches
    with torch.inference_mode():
        h, s = lucy_fused_cell(g4, h0, s0, mask)
        h_ref, s_ref = lucy_fused_cell_ref(g4, h0, s0, mask)
    torch.cuda.synchronize()
    assert lucy_fused_cell.launches == before + 1
    assert h.shape == s.shape == (B, T, D)
    _assert_equal_or_one_bf16_step(h, h_ref)
    _assert_equal_or_one_bf16_step(s, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_cell_kernel_fully_masked_and_first_frame_masked_rows(cuda_device, dtype):
    """K12 with a row masked throughout (h and s stay h0 and s0 at every
    step, exactly) and a row whose first frame is masked (step 0 keeps h0,
    s0), against its plain version: f32 bit for bit, bf16 to one bf16 step."""
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_fused_cell, lucy_fused_cell_ref

    B, T, D = 3, 40, 200
    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(70, B, T, D))
    g4 = (gates + bias).reshape(B, T, 7, D).to(dtype)
    mask = torch.ones((B, T), dtype=torch.bool, device=cuda_device)
    mask[0] = False
    mask[1, 0] = False
    with torch.inference_mode():
        h, s = lucy_fused_cell(g4, h0, s0, mask)
        h_ref, s_ref = lucy_fused_cell_ref(g4, h0, s0, mask)
    torch.cuda.synchronize()
    _assert_equal_or_one_bf16_step(h, h_ref)
    _assert_equal_or_one_bf16_step(s, s_ref)
    for x, x0 in ((h, h0), (s, s0)):
        assert torch.equal(x[0], x0[0].to(dtype).expand(T, D))
        assert torch.equal(x[1, 0], x0[1].to(dtype))
        assert not torch.equal(x[1, 1], x0[1].to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype,offset", K5A_RING_EDGES, ids=map(_ring_id, K5A_RING_EDGES))
def test_linear_scan_fwd_ring_edges(cuda_device, B, T, D, dtype, offset):
    """K5a at the edges of its ring, against its plain version: f32 bit for
    bit, bf16 to one bf16 step."""
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_fwd, linear_scan_ref

    rng = np.random.default_rng(T + D)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    a = _offset_view(torch.sigmoid(f(B, T, D) + 2.0).to(dtype), offset)
    b = _offset_view(f(B, T, D).to(dtype), offset)
    s0 = f(B, D)
    before = linear_scan_fwd.launches
    got = linear_scan_fwd(a, b, s0)
    want = linear_scan_ref(a, b, s0)
    torch.cuda.synchronize()
    assert linear_scan_fwd.launches == before + 1 and got.shape == (B, T, D)
    _assert_equal_or_one_bf16_step(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype,offset", K5B_RING_EDGES, ids=map(_ring_id, K5B_RING_EDGES))
def test_linear_scan_rev_ring_edges(cuda_device, B, T, D, dtype, offset):
    """K5b at the edges of its ring, against its plain version: f32 bit for
    bit, bf16 to one bf16 step."""
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_rev, linear_scan_rev_ref

    rng = np.random.default_rng(T + D + 1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    a = _offset_view(torch.sigmoid(f(B, T, D) + 2.0).to(dtype), offset)
    g = _offset_view(f(B, T, D).to(dtype), offset)
    before = linear_scan_rev.launches
    got = linear_scan_rev(a, g)
    want = linear_scan_rev_ref(a, g)
    torch.cuda.synchronize()
    assert linear_scan_rev.launches == before + 1 and got.shape == (B, T, D)
    _assert_equal_or_one_bf16_step(got, want)


def _dual_planes(seed, B, T, D, dtype, dev, mask=None):
    """(a_s, b_s, a_h, h_pre_n) of the gate chain on conditioned gates, in
    ``dtype``, and h0, s0 (f32)."""
    from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs

    gates, bias, h0, s0 = _on(dev, conditioned_cell_data(seed, B, T, D))
    a_s, b_s, a_h, _, h_pre = lucy_gate_coeffs(gates, mask, bias)
    return [x.to(dtype) for x in (a_s, b_s, a_h, h_pre)], h0, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype,offset", K11_RING_EDGES, ids=map(_ring_id, K11_RING_EDGES))
def test_dual_scan_kernel_ring_edges(cuda_device, B, T, D, dtype, offset):
    """K11 at the edges of its ring, on the masked gate chain's planes,
    against its plain version: f32 bit for bit, bf16 to one bf16 step; h and
    s both."""
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_dual_scan, lucy_dual_scan_ref

    planes, h0, s0 = _dual_planes(80 + T + D, B, T, D, dtype, cuda_device,
                                  _frame_mask(B, T, cuda_device))
    planes = [_offset_view(x, offset) for x in planes]
    before = lucy_dual_scan.launches
    with torch.inference_mode():
        h, s = lucy_dual_scan(*planes, h0, s0)
        h_ref, s_ref = lucy_dual_scan_ref(*planes, h0, s0)
    torch.cuda.synchronize()
    assert lucy_dual_scan.launches == before + 1
    assert h.shape == s.shape == (B, T, D)
    _assert_equal_or_one_bf16_step(h, h_ref)
    _assert_equal_or_one_bf16_step(s, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_scan_kernel_fully_masked_and_first_frame_masked_rows(cuda_device, dtype):
    """K11 on the planes of a row masked throughout (a_h = a_s = 1, b_s = 0:
    h and s stay h0 and s0 at every step, exactly) and of a row whose first
    frame is masked (step 0 keeps h0, s0), against its plain version: f32
    bit for bit, bf16 to one bf16 step."""
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_dual_scan, lucy_dual_scan_ref

    B, T, D = 3, 40, 200
    mask = torch.ones((B, T), dtype=torch.bool, device=cuda_device)
    mask[0] = False
    mask[1, 0] = False
    planes, h0, s0 = _dual_planes(90, B, T, D, dtype, cuda_device, mask)
    assert (planes[0][0] == 1).all() and (planes[1][0] == 0).all() and (planes[2][0] == 1).all()
    with torch.inference_mode():
        h, s = lucy_dual_scan(*planes, h0, s0)
        h_ref, s_ref = lucy_dual_scan_ref(*planes, h0, s0)
    torch.cuda.synchronize()
    _assert_equal_or_one_bf16_step(h, h_ref)
    _assert_equal_or_one_bf16_step(s, s_ref)
    for x, x0 in ((h, h0), (s, s0)):
        assert torch.equal(x[0], x0[0].to(dtype).expand(T, D))
        assert torch.equal(x[1, 0], x0[1].to(dtype))
        assert not torch.equal(x[1, 1], x0[1].to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K5a", "K12", "K5b", "K11"])
def test_cell_kernels_take_a_batch_past_the_grid(cuda_device, kernel):
    """B = 65536, one row past the grid's 65535: the launcher walks the batch
    in two slices, and the wrapper's one call counts one launch.  Against the
    plain version, every row (the second slice's one row too): K5a, K5b, K12
    and K11 bit for bit in f32; K1 and K2 at their f32 tolerances (K1
    contracts its arithmetic); K2's d_bias (the wrapper's sum of the per-row
    sums of both slices) against the float64 sum of its own d_gates."""
    from statecatcher_tpu_torch.ops import lucy_pallas as lp

    B, T, D = 65536, 3, 8
    dev = cuda_device
    gates, bias, h0, s0 = _on(dev, conditioned_cell_data(100, B, T, D))
    rng = np.random.default_rng(101)
    g_h = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(dev)
    planes, _, _ = _dual_planes(102, B, T, D, torch.float32, dev)
    g4 = (gates + bias).reshape(B, T, 7, D)
    with torch.inference_mode():
        h_s = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    run = {
        "K1": (lucy_cell_fused_lm, lucy_cell_fused_lm, lucy_cell_fused_lm_ref,
               (gates, bias, h0, s0)),
        "K2": (lucy_cell_fused_lm_bwd, lucy_cell_fused_lm_bwd, lucy_cell_fused_lm_bwd_ref,
               (gates, bias, h0, s0, *h_s, g_h, 0.1 * g_h)),
        "K5a": (lp.linear_scan_fwd, lp.linear_scan_fwd, lp.linear_scan_ref,
                (planes[0], planes[1], s0)),
        "K12": (lp.lucy_fused_cell, lp.lucy_fused_cell, lp.lucy_fused_cell_ref, (g4, h0, s0)),
        "K5b": (lp.linear_scan_rev, lp.linear_scan_rev, lp.linear_scan_rev_ref,
                (planes[0], g_h)),
        "K11": (lp.lucy_dual_scan, lp.lucy_dual_scan, lp.lucy_dual_scan_ref, (*planes, h0, s0)),
    }
    counter, fn, ref, args = run[kernel]
    with torch.inference_mode():
        before = counter.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = ref(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].shape[0] == B
    if kernel == "K1":
        assert_cell_close(*(x.cpu().numpy() for x in got + want))
    elif kernel == "K2":
        for name, a, b in zip(("d_gates", "dh0", "ds0"), got, want):
            assert_grad_close(a.cpu().numpy(), b.cpu().numpy(), name)
        sums = got[0].double().sum(dim=(0, 1))
        np.testing.assert_allclose(got[3].cpu().numpy(), sums.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6 * got[0].double().abs().sum(dim=(0, 1)).max().item())
    else:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,dtype", [(2, 45, 128, torch.float32), (3, 33, 100, torch.float32),
                                         (4, 64, 256, torch.bfloat16)])
def test_dual_scan_kernel_matches_plain(cuda_device, B, T, D, dtype):
    """K11 against its plain version on the planes of the masked gate chain:
    f32 bit for bit, bf16 with the tolerances of the K12 test."""
    from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_dual_scan, lucy_dual_scan_ref

    gates, bias, h0, s0 = _on(cuda_device, conditioned_cell_data(40 + T, B, T, D))
    a_s, b_s, a_h, _, h_pre = (x.to(dtype) for x in lucy_gate_coeffs(
        gates, _frame_mask(B, T, cuda_device), bias))
    before = lucy_dual_scan.launches
    with torch.inference_mode():
        h, s = lucy_dual_scan(a_s, b_s, a_h, h_pre, h0, s0)
        h_ref, s_ref = lucy_dual_scan_ref(a_s, b_s, a_h, h_pre, h0, s0)
    torch.cuda.synchronize()
    assert lucy_dual_scan.launches == before + 1
    assert h.dtype == s.dtype == dtype
    if dtype == torch.float32:                  # the same operations, each rounded once
        assert torch.equal(h, h_ref) and torch.equal(s, s_ref)
    h, s, h_ref, s_ref = (t.float().cpu().numpy() for t in (h, s, h_ref, s_ref))
    if dtype != torch.float32:
        np.testing.assert_allclose(h, h_ref, rtol=2e-2, atol=2e-2)
        assert (np.abs(s - s_ref) <= 1e-3 * np.abs(s_ref).max() + 1e-2 * np.abs(s_ref)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("impl,masked,dtype", [
    ("pallas-fused", True, torch.float32), ("auto-fused", False, torch.float32),
    ("pallas-fused", True, torch.bfloat16), ("pallas-dual", True, torch.float32),
    ("pallas-dual", False, torch.float32)])
def test_k12_and_k11_cells_grads_on_card_match_cpu(cuda_device, impl, masked, dtype):
    """``lucy_cell_parallel`` with ``impl`` on the card (K12 or K11 forward,
    the backward's two adjoint scans through K5b) against the CPU (plain
    versions), values and gradients of gates, bias, h0 and s0.  f32 to
    ``assert_grad_close``'s 1e-4 relative plus 1e-6 of the scale; bf16
    gates, h0 and s0 to a bf16 step (2e-2 relative plus 1e-3 of the
    scale)."""
    from statecatcher_tpu_torch.models.lucyrnn import lucy_cell_parallel
    from statecatcher_tpu_torch.ops.lucy_pallas import (
        linear_scan_rev,
        lucy_dual_scan,
        lucy_fused_cell,
    )

    B, T, D = 3, 40, 64
    gates, bias, h0, s0 = conditioned_cell_data(50, B, T, D)
    w = np.random.default_rng(51).standard_normal((B, T, D)).astype(np.float32)
    counter = lucy_dual_scan if impl == "pallas-dual" else lucy_fused_cell
    n = (counter.launches, linear_scan_rev.launches)
    outs = []
    for dev in ("cpu", cuda_device):
        xs = [torch.from_numpy(x).to(dev).to(dtype if i != 1 else torch.float32).requires_grad_()
              for i, x in enumerate((gates, bias, h0, s0))]
        h_all, h_T, s_T = lucy_cell_parallel(
            xs[0], xs[2], xs[3], impl=impl, bias=xs[1],
            frame_mask=_frame_mask(B, T, dev) if masked else None)
        ((h_all.float() * torch.from_numpy(w).to(dev)).sum() + s_T.float().sum()).backward()
        outs.append([t.detach().float().cpu().numpy() for t in (h_all, s_T)] +
                    [x.grad.float().cpu().numpy() for x in xs])
    assert (counter.launches, linear_scan_rev.launches) == (n[0] + 1, n[1] + 2)
    tol = {} if dtype == torch.float32 else dict(rtol=2e-2, scale_tol=1e-3)
    for name, a, c in zip(("h_all", "s_T", "gates", "bias", "h0", "s0"), outs[1], outs[0]):
        assert_grad_close(a, c, name, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,decay", [(False, "learned"), (True, "prefix_sum")])
def test_native_encoder_on_card_matches_cpu(cuda_device, fused, decay):
    """The native LucyRNN (2 layers × 64, masked) on the card (K5a, K5b)
    against the CPU over two carried segments: logits and carry within 1e-4
    of their scale, parameter gradients within 1e-3 relative plus 1e-4 of
    each one's largest value (the xLSTM encoder test's tolerances)."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import build_model, init_carry
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_fwd, linear_scan_rev

    ov = ["--model.encoder", "lucyrnn", "--model.lucyrnn.variant", "native",
          "--model.hidden_size", "64", "--model.num_layers", "2", "--model.vocab_size", "40",
          "--model.lucyrnn.fused_ops", str(fused).lower(), "--model.lucyrnn.decay_mode", decay,
          "--model.lucyrnn.lambda_decay", "0.01", "--model.lucyrnn.mask_state_updates", "true"]
    cfg = Config().apply_overrides(ov)
    rng = np.random.default_rng(5)
    feats = [torch.from_numpy(rng.standard_normal((2, 75, 24)).astype(np.float32))
             for _ in range(2)]
    n = (linear_scan_fwd.launches, linear_scan_rev.launches)
    runs = []
    for dev in ("cpu", cuda_device):
        model = build_model(cfg.model, 24, device=dev, generator=torch.Generator().manual_seed(0))
        w = model.encoder.output_proj.weight                 # zero at init
        with torch.no_grad():
            w.copy_(0.1 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1)))
        carry, outs, loss = init_carry(cfg.model, 2, device=dev), [], 0.0
        for k, x in enumerate(feats):
            mask = _frame_mask(2, 75, dev) if k == 1 else None
            logits, carry = model(x.to(dev), carry, mask)
            outs.append(logits)
            loss = loss + (logits * torch.linspace(-1, 1, 40, device=dev)).sum()
        loss.backward()
        runs.append(([o.detach().cpu() for o in outs] + [v.detach().cpu() for v in carry.values()],
                     {k: p.grad.cpu().numpy() for k, p in model.named_parameters()
                      if p.grad is not None}))
    assert (linear_scan_fwd.launches - n[0], linear_scan_rev.launches - n[1]) == (8, 8)
    assert runs[1][0][2].shape == (2, 2, 64)                   # carry (B, L, D)
    assert_scaled_close(runs[1][0], runs[0][0], ("logits 0", "logits 1", "h", "s"), 1e-4)
    assert runs[1][1].keys() == runs[0][1].keys()
    for k, a in runs[1][1].items():
        assert_grad_close(a, runs[0][1][k], k, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
def test_lstm_encoder_on_card_matches_cpu(cuda_device):
    """The LSTM (2 layers × 64, a frame mask with holes and a row masked
    throughout) on the card against the CPU over two carried segments:
    logits and carry within 1e-4 of their scale, parameter gradients within
    1e-3 relative plus 1e-4 of each one's largest value."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import build_model, init_carry

    cfg = Config().apply_overrides(["--model.hidden_size", "64", "--model.num_layers", "2",
                                    "--model.vocab_size", "40"])
    rng = np.random.default_rng(6)
    feats = [torch.from_numpy(rng.standard_normal((3, 50, 24)).astype(np.float32))
             for _ in range(2)]
    mask = torch.ones((3, 50), dtype=torch.bool)
    mask[0, 10:20] = False
    mask[1] = False
    runs = []
    for dev in ("cpu", cuda_device):
        model = build_model(cfg.model, 24, device=dev, generator=torch.Generator().manual_seed(0))
        carry, outs, loss = init_carry(cfg.model, 3, device=dev), [], 0.0
        for k, x in enumerate(feats):
            logits, carry = model(x.to(dev), carry, mask.to(dev) if k else None)
            outs.append(logits)
            loss = loss + (logits * torch.linspace(-1, 1, 40, device=dev)).sum()
        loss.backward()
        runs.append(([o.detach().cpu() for o in outs] + [v.detach().cpu() for v in carry.values()],
                     {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}))
    assert_scaled_close(runs[1][0], runs[0][0], ("logits 0", "logits 1", "h", "c"), 1e-4)
    for k, a in runs[1][1].items():
        assert_grad_close(a, runs[0][1][k], k, rtol=1e-3, scale_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [0, 5])
def test_beam_searches_on_card_match_cpu(cuda_device, forced):
    """The CTC prefix beam (forced-blank frames whose non-blank log-probs tie
    at −1e30 among them) and the RNN-T beam on the card against the same
    functions on the CPU, in float64, where no two candidates tie by
    round-off: the same state but the scores, which agree to 1e-12."""
    from statecatcher_tpu_torch.beam import ctc_beam_search
    from statecatcher_tpu_torch.rnnt_decode import rnnt_beam_search

    rng = np.random.default_rng(7 + forced)
    x = rng.standard_normal((4, 40, 30)) * 2.5
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lp[0, :forced] = -1e30
    lp[0, :forced, 0] = 0.0
    in_lens = torch.tensor([40, 0, 17, 39])
    enc = torch.from_numpy(rng.standard_normal((4, 20, 6)))
    tables = [torch.from_numpy(rng.standard_normal(s)) for s in ((30, 6), (6, 30), (30,))]
    out = []
    for dev in ("cpu", cuda_device):
        st, tot = ctc_beam_search(torch.from_numpy(lp).to(dev), in_lens.to(dev), beam=6, topk=8,
                                  max_len=48)
        rst = rnnt_beam_search(enc.to(dev), *(t.to(dev) for t in tables), in_lens.to(dev) // 2,
                               beam=4, topk=4, max_out=32)
        out.append([x.cpu() for x in (*st, tot, *rst)])
    for a, b in zip(out[1], out[0]):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_every_kernel_on_the_second_card(cuda_device):
    """Each kernel wrapper launched on tensors of cuda:1 (the current device
    left at cuda:0) against its plain version: a multi-GPU rank trains on
    cuda:LOCAL_RANK.  Each kernel runs its first case of the single-card
    tests above, on the second card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from statecatcher_tpu_torch.ops import launch_counts

    dev = torch.device("cuda", 1)
    before = launch_counts()
    with torch.cuda.device(0):
        test_kernel_matches_plain_f32(dev, 2, 45, 128)                          # K1
        test_bwd_kernel_matches_plain_f32(dev, 2, 45, 128, True)                # K2
        test_ctc_kernels_match_plain(dev, 3, 50, 8, 20)                         # K3, K4
        test_linear_scan_kernels_match_plain(dev, 2, 45, 128, torch.float32)    # K5a, K5b
        test_rnnt_joint_kernels_match_plain(dev, 3, 45, 11, 40, 150, 5)         # K6a, K6b
        test_rnnt_lattice_kernels_match_plain(dev, *RNNT_LATTICE_CASES[0])      # K7a, K7b
        test_band_kernels_match_plain(dev, 3, 45, 40, 40, 150, 8, 8, 5)         # K8a, K8b
        test_band_lattice_kernels_match_plain(dev, *BAND_LATTICE_CASES[0])      # banded α, β
        test_mlstm_fused_kernels_match_plain_f32(dev, *MLSTM_SHAPES[0])         # K9a
        test_mlstm_bwd_kernel_matches_plain(dev, *K9B_SHAPES[0], torch.float32)  # K9b
        test_mlstm_pallas_kernel_matches_plain(dev, 2, 45, 2, 16, 16, 16)       # K10
        test_fused_cell_kernel_matches_plain(dev, 2, 45, 128, torch.float32, True)  # K12
        test_dual_scan_kernel_matches_plain(dev, 2, 45, 128, torch.float32)     # K11
    ran = {k for k, n in launch_counts().items() if n > before[k]}
    assert ran == set(before), f"not launched on cuda:1: {sorted(set(before) - ran)}"


@pytest.fixture
def one_rank_nccl(cuda_device):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sp_scan_in_a_one_rank_nccl_group_is_k5a(one_rank_nccl):
    """The sequence-parallel scan (ops/scan_sp.py) in a one-rank NCCL group:
    its shard is the whole segment, scanned by K5a from the zero state, and
    the exchange (an all_gather, and an all_reduce in backward) runs through
    NCCL.  From s0 = 0 it is K5a bit for bit; from any s0 it is K5a to
    float32 round-off, forward and backward (K5b)."""
    from statecatcher_tpu_torch.config import MeshConfig
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_fwd, linear_scan_pallas
    from statecatcher_tpu_torch.ops.scan import linear_scan
    from statecatcher_tpu_torch.ops.scan_sp import sequence_parallel_scans
    from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan

    dev = one_rank_nccl
    plan = make_mesh_plan(MeshConfig())
    assert plan.model.pg is not None                      # the collectives run through NCCL
    gen = torch.Generator().manual_seed(3)
    B, T, D = 4, 300, 512
    a = (0.5 + 0.5 * torch.rand(B, T, D, generator=gen)).to(dev)
    b = torch.randn(B, T, D, generator=gen).to(dev)
    s0 = torch.randn(B, D, generator=gen).to(dev)
    zero = torch.zeros_like(s0)
    n0 = linear_scan_fwd.launches
    with sequence_parallel_scans(plan):
        assert torch.equal(linear_scan(a, b, zero, impl="sp"), linear_scan_fwd(a, b, zero))
        assert linear_scan_fwd.launches == n0 + 2
        xs = [x.clone().requires_grad_() for x in (a, b, s0)]
        got = linear_scan(*xs, impl="sp")
        w = torch.randn(B, T, D, generator=gen).to(dev)
        (got * w).sum().backward()
    assert plan.model.stats["all_gather"] > 0 and plan.model.stats["all_reduce"] > 0
    ys = [x.clone().requires_grad_() for x in (a, b, s0)]
    want = linear_scan_pallas(*ys)
    (want * w).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for x, y, name in zip(xs, ys, ("a", "b", "s0")):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4, msg=name)
