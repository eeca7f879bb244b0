"""The arithmetic of K6/K8 on the tensor cores, rehearsed on the CPU.

The joint's kernels (``ops/csrc/rnnt_joint_core.cuh``) take their
contractions on the tensor cores (the forward the logits, the backward
three): f32 inputs as three TF32 products (3xTF32: x = hi + lo, hi =
rna_tf32(x), lo = rna_tf32(x − hi), a·b ≈ hi·hi + hi·lo + lo·hi with f32
sums), bf16 inputs on operands rounded to bf16 once.  Here that rounding is
emulated bit for bit on the int32 view and passed to the plain versions as
their ``matmul``; the result is held to the plain versions at the card tests'
tolerances (forward: 1e-5 in f32, 2e-3 in bf16; backward f32: 1e-4 relative
plus 1e-5 of each output's largest value), at the card tests' shapes and at
J=64, V=1024.  Also checked: the emit columns that the forward's wrapper
gathers (``rnnt_joint.emit_columns``), and the Python that sizes the
backward's grids and partial sums (``rnnt_joint.bwd_layout``), for every
shape of the card tests.
"""

import numpy as np
import pytest
import torch

from statecatcher_tpu_torch.ops.rnnt_band import (
    joint_blank_emit_banded_bwd_ref,
    joint_blank_emit_banded_ref,
)
from statecatcher_tpu_torch.ops.rnnt_joint import (
    bwd_layout,
    emit_columns,
    joint_blank_emit_bwd_ref,
    joint_blank_emit_ref,
)
from test_torch_cuda import assert_grad_close, band_data, joint_data
from test_torch_cuda import single_torch_thread  # noqa: F401

# (B, T, U, J, V, blank_id) of the card tests of K6b, and J=64, V=1024
JOINT_SHAPES = [(3, 45, 11, 40, 150, 5), (2, 17, 0, 64, 100, 0), (2, 30, 9, 64, 1024, 0),
                (1, 7, 3, 100, 70, 69), (3, 40, 12, 64, 256, 0), (3, 40, 12, 40, 256, 0),
                (3, 40, 12, 100, 256, 0)]
# (B, T, U, J, V, band, Tb, blank_id) of the card tests of K8b
BAND_SHAPES = [(3, 45, 40, 40, 150, 8, 8, 5), (2, 64, 30, 64, 1024, 32, 16, 0),
               (3, 33, 9, 100, 70, 16, 8, 69), (3, 40, 30, 64, 256, 8, 8, 0),
               (3, 40, 30, 40, 256, 8, 8, 0), (3, 40, 30, 100, 256, 8, 8, 0),
               (3, 45, 40, 64, 150, 8, 8, 0)]
NAMES = ("d_enc", "d_pred", "d_kernel", "d_bias")
FWD_NAMES = ("blank", "emit", "lse")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 fraction bits, ties away from zero."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)   # -0x2000 is 0xFFFFE000


def bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 → f32, round to nearest even, on the int32 view."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x7FFF + ((i >> 16) & 1)) & -0x10000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 product: the small terms first, f32 sums."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' bf16 product: each operand rounded to bf16, exact
    products, f32 sums."""
    return bf16(a) @ bf16(b)


def test_tf32_and_bf16_rounding():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32) * 10.0)
    # ties: 0x1000 below the kept bits rounds away from zero, in both signs
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2 * 2.0 ** -10]
    hi = tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    lo = tf32(x - hi)
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    assert torch.equal(bf16(x), x.to(torch.bfloat16).to(torch.float32))
    ties = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8)])
    assert torch.equal(bf16(ties), ties.to(torch.bfloat16).to(torch.float32))


def _joint_case(B, T, U, J, V, blank_id, dtype):
    enc, pred, k, b, labels, g_blank, g_emit = joint_data(60 + J, B, T, U, J, V, "cpu", dtype)
    lse = joint_blank_emit_ref(enc, pred, k, b, labels, blank_id)[2]
    return (enc, pred, k, b, labels, lse, g_blank, g_emit, blank_id)


def _band_case(B, T, U, J, V, band, Tb, blank_id, dtype):
    enc, pred, k, b, labels, o, Wp, Tb, g_blank, g_emit, _, _ = band_data(
        90 + J, B, T, U, J, V, band, Tb, "cpu", dtype)
    lse = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb, blank_id)[2]
    return (enc, pred, k, b, labels, o, lse, g_blank, g_emit, Tb, blank_id)


# the forward's products on the card and its tolerance there, per input dtype
FWD_PRODUCTS = {"3xtf32": (torch.float32, matmul_3xtf32, 1e-5),
                "bf16": (torch.bfloat16, matmul_bf16, 2e-3)}


@pytest.mark.parametrize("products", ["3xtf32", "bf16"])
@pytest.mark.parametrize("B,T,U,J,V,blank_id", JOINT_SHAPES)
def test_joint_fwd_tensor_core_products_within_card_tolerance(single_torch_thread, products, B,
                                                              T, U, J, V, blank_id):
    dtype, matmul, tol = FWD_PRODUCTS[products]
    enc, pred, k, b, labels, _, _ = joint_data(60 + J, B, T, U, J, V, "cpu", dtype)
    got = joint_blank_emit_ref(enc, pred, k, b, labels, blank_id, matmul=matmul)
    for name, x, y in zip(FWD_NAMES, got, joint_blank_emit_ref(enc, pred, k, b, labels, blank_id)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("products", ["3xtf32", "bf16"])
@pytest.mark.parametrize("B,T,U,J,V,band,Tb,blank_id", BAND_SHAPES)
def test_band_fwd_tensor_core_products_within_card_tolerance(single_torch_thread, products, B,
                                                             T, U, J, V, band, Tb, blank_id):
    dtype, matmul, tol = FWD_PRODUCTS[products]
    enc, pred, k, b, labels, o, Wp, Tb, _, _, _, _ = band_data(90 + J, B, T, U, J, V, band, Tb,
                                                               "cpu", dtype)
    args = (enc, pred, k, b, labels, o, Wp, Tb, blank_id)
    got = joint_blank_emit_banded_ref(*args, matmul=matmul)
    for name, x, y in zip(FWD_NAMES, got, joint_blank_emit_banded_ref(*args)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=tol, atol=tol, err_msg=name)


def _emit_logit_from_columns(enc, pred, ke, be, b, t, u):
    """The forward kernel's emit logit at rows (b, t, u): the f32 joint (0
    past T and U+1) · ke[b, u] + be[b, u], 0 at u ≥ U."""
    B, T, J = enc.shape
    U1, U = pred.shape[1], ke.shape[1]
    enc0 = torch.cat([enc.float(), torch.zeros(B, 1, J)], 1)
    pred0 = torch.cat([pred.float(), torch.zeros(B, 1, J)], 1)
    ke0, be0 = torch.cat([ke, torch.zeros(B, 1, J)], 1), torch.cat([be, torch.zeros(B, 1)], 1)
    joint = torch.tanh(enc0[b, t.clamp(max=T)] + pred0[b, u.clamp(max=U1)])
    uk = u.clamp(max=U)
    return (joint * ke0[b, uk]).sum(-1) + be0[b, uk]


def _check_emit_columns(k, b, labels, ke, be):
    B, U = labels.shape
    V = k.shape[1]
    assert ke.shape == (B, U, k.shape[0]) and be.shape == (B, U)
    assert ke.dtype == be.dtype == torch.float32 and ke.is_contiguous() and be.is_contiguous()
    ok = (labels >= 0) & (labels < V)
    assert ok.sum() < labels.numel() or U == 0                 # labels outside [0, V) too
    lab = labels.clamp(0, V - 1).long()
    assert torch.equal(ke[ok], k.t()[lab][ok]) and torch.equal(be[ok], b[lab][ok])
    assert not ke[~ok].any() and not be[~ok].any()


@pytest.mark.parametrize("B,T,U,J,V,blank_id", JOINT_SHAPES)
def test_joint_emit_columns_give_the_emit_logit(single_torch_thread, B, T, U, J, V, blank_id):
    """K6a's gathered columns at every card-test shape, with labels outside
    [0, V) (no column), against the plain version's emit logit (emit + lse)
    on the rows whose label lies inside."""
    enc, pred, k, b, labels, _, _ = joint_data(60 + J, B, T, U, J, V, "cpu")
    bad = labels.clone()
    bad[:, ::4] = -1
    bad[:, 1::5] = V + 3
    ke, be = emit_columns(k, b, bad)
    _check_emit_columns(k, b, bad, ke, be)
    _, emit, lse = joint_blank_emit_ref(enc, pred, k, b, labels, blank_id)
    bi, ti, ui = torch.meshgrid(torch.arange(B), torch.arange(T), torch.arange(U), indexing="ij")
    got = _emit_logit_from_columns(enc, pred, ke, be, bi, ti, ui)
    ok = ((bad >= 0) & (bad < V))[:, None, :].expand(B, T, U)
    np.testing.assert_allclose(got[ok].numpy(), (emit + lse[..., :U])[ok].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not got[~ok].any()


@pytest.mark.parametrize("B,T,U,J,V,band,Tb,blank_id", BAND_SHAPES)
def test_band_emit_columns_give_the_emit_logit(single_torch_thread, B, T, U, J, V, band, Tb,
                                               blank_id):
    """K8a's gathered columns at every card-test shape, with labels outside
    [0, V) and window positions u ≥ U (no column), against the banded plain
    version's emit logit (emit + lse) on every row."""
    enc, pred, k, b, labels, o, Wp, Tb, _, _, _, _ = band_data(90 + J, B, T, U, J, V, band, Tb,
                                                               "cpu")
    labels = labels.clone()
    labels[0, ::5] = -1
    labels[-1, 1::7] = V + 3
    ke, be = emit_columns(k, b, labels)
    _check_emit_columns(k, b, labels, ke, be)
    _, emit, lse = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb, blank_id)
    Tp = o.shape[1] * Tb
    bi, ti, wi = torch.meshgrid(torch.arange(B), torch.arange(Tp), torch.arange(Wp),
                                indexing="ij")
    ui = o.long()[bi, ti // Tb] + wi
    assert (ui >= U).any()                                     # window positions past the labels
    got = _emit_logit_from_columns(enc, pred, ke, be, bi, ti, ui)
    np.testing.assert_allclose(got.numpy(), (emit + lse).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T,U,J,V,blank_id", JOINT_SHAPES)
def test_joint_bwd_3xtf32_within_f32_tolerance(single_torch_thread, B, T, U, J, V, blank_id):
    args = _joint_case(B, T, U, J, V, blank_id, torch.float32)
    got = joint_blank_emit_bwd_ref(*args, matmul=matmul_3xtf32)
    for name, x, y in zip(NAMES, got, joint_blank_emit_bwd_ref(*args)):
        assert_grad_close(x.numpy(), y.numpy(), name, rtol=1e-4, scale_tol=1e-5)


@pytest.mark.parametrize("B,T,U,J,V,band,Tb,blank_id", BAND_SHAPES)
def test_band_bwd_3xtf32_within_f32_tolerance(single_torch_thread, B, T, U, J, V, band, Tb,
                                              blank_id):
    args = _band_case(B, T, U, J, V, band, Tb, blank_id, torch.float32)
    got = joint_blank_emit_banded_bwd_ref(*args, matmul=matmul_3xtf32)
    for name, x, y in zip(NAMES, got, joint_blank_emit_banded_bwd_ref(*args)):
        assert_grad_close(x.numpy(), y.numpy(), name, rtol=1e-4, scale_tol=1e-5)


@pytest.mark.parametrize("kind", ["joint", "band"])
@pytest.mark.parametrize("J", [40, 64, 100])
def test_bf16_operands_are_rounded_once(single_torch_thread, kind, J):
    """Under bf16 the plain versions already round every operand of a
    product (the joint, K and d_logits) to bf16, so rounding them again, as
    the tensor cores take them, changes nothing but the order of the f32
    sums."""
    if kind == "joint":
        args, fn = _joint_case(3, 40, 12, J, 256, 0, torch.bfloat16), joint_blank_emit_bwd_ref
    else:
        args, fn = (_band_case(3, 40, 30, J, 256, 8, 8, 0, torch.bfloat16),
                    joint_blank_emit_banded_bwd_ref)
    for name, x, y in zip(NAMES, fn(*args, matmul=matmul_bf16), fn(*args)):
        assert_grad_close(x.numpy(), y.numpy(), name, rtol=1e-5, scale_tol=1e-6)


def _check_layout(lay, B, TT, W, V, PT, n_sm, per_sm):
    PU = 128 // PT
    n_w, n_t, nb = lay["rows_grid"]
    assert nb == B and n_t == lay["n_t"]
    assert (n_w - 1) * PU < W <= n_w * PU and (n_t - 1) * PT < TT <= n_t * PT
    assert lay["n_grp"] * 8 == n_w * PU
    n_vs, nsplit = lay["dk_grid"]
    assert (n_vs - 1) * 128 < V <= n_vs * 128
    assert nsplit == lay["nsplit"] >= 1
    assert nsplit <= -(-(B * TT * W) // 64)                   # no split without a row tile
    assert lay["rec_rows"] % 64 == 0 and 0 <= lay["rec_rows"] - B * TT * W < 64
    assert n_vs * nsplit <= max(per_sm * n_sm, n_vs)          # one wave of resident blocks
    if nsplit < -(-(B * TT * W) // 64):
        assert n_vs * (nsplit + 1) > per_sm * n_sm            # and as full as it can be


@pytest.mark.parametrize("n_sm,per_sm", [(132, 1), (132, 2), (132, 4), (4, 1)])
def test_bwd_layout_fits_every_card_test_shape(n_sm, per_sm):
    for B, T, U, J, V, _ in JOINT_SHAPES + [(32, 1598, 48, 64, 1024, 0),
                                            (8, 400, 128, 64, 1024, 0)]:
        lay = bwd_layout(B, T, U + 1, V, 16, n_sm, per_sm)
        _check_layout(lay, B, T, U + 1, V, 16, n_sm, per_sm)
        assert lay["n_grp"] == -(-(U + 1) // 8)              # K6's d_enc partial groups
    for B, T, U, J, V, band, Tb, _ in BAND_SHAPES + [(32, 1598, 128, 64, 1024, 32, 8, 0)]:
        _, _, _, _, _, o, Wp, _, _, _, _, _ = band_data(0, B, T, U, J, V, band, Tb, "cpu")
        Tp = o.shape[1] * Tb
        lay = bwd_layout(B, Tp, Wp, V, 8, n_sm, per_sm)
        _check_layout(lay, B, Tp, Wp, V, 8, n_sm, per_sm)
        assert lay["n_t"] == Tp // 8                          # rnnt_band.cu's band_dpred_kernel
