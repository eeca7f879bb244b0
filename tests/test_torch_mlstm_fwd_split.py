"""The forward's order of work (K9a and K10, ``ops/csrc/mlstm_chunk.cuh``),
written out as plain torch here and held against the plain forward and
against JAX.

The kernels split the chunk step along its data dependencies: the gates of
each chunk (b, a, R by scans local to the chunk, ``rows_scan``: above 256
rows a thread takes ceil(L/256) consecutive rows, then m at each chunk's
entry by a scalar walk over the earlier chunks' (bL, A), then mu, sp, w, g),
each chunk's state term (Σ w k vᵀ and Σ w k), the elementwise scan of the
entry states, the exit state from the last chunk's term, and the outputs of
each 64-row tile of a chunk: acc = (q C_c)·sp·inv, then per 64-wide s-tile
up to the diagonal S = q kᵀ, W = inv·S∘E, the row sums sw and acc += W v;
den = max(|sw + sp·inv·q·n_c|, exp(−mu)), h = acc / den.  ``split_fwd``
below follows those passes; it is not on any path of the port.  Held:

  * against ``mlstm_fused_fwd_ref`` in float64: rtol 1e-9, atol 1e-12 (the
    same function, summed in another order), at T not a multiple of L, a
    single chunk (T = 32), L = 256, 384 and 512 with narrow widths, dqk =
    300, 320 and 512 at short T, dv not a multiple of 64, and tied input
    gates (every a_s equal, so the running max and both maxima tie; at L =
    512 a run of equal R crosses the threads' rows);
  * in K10's layout (head-major; the gates padded as the wrapper pads them,
    q, k, v zero past T; q pre-scaled and inv = 1) against the port's
    ``mlstm_chunkwise`` in float64 (the same tolerances) and the JAX
    package's pure-XLA ``mlstm_chunkwise`` in float32;
  * through the layer (``mlstm_fused`` with ``split_fwd`` as its forward)
    against the JAX package's K9a forward in interpret mode, forward only;
    against JAX in float32 at tests/test_torch_mlstm_fused.py's forward
    tolerances (rtol 2e-4, atol 2e-5);
  * with the card's products emulated in float32 (3xTF32 for every product
    with an f32 operand; bf16 operands rounded once for q·kᵀ under bf16
    inputs, as tests/test_torch_rnnt_joint_tc.py emulates the joint),
    against the plain forward at the card tests' tolerances (each output
    within 1e-4 of its largest value; a bf16 h within 2e-2).
No JAX gradient runs here.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import statecatcher_tpu.ops.mlstm_fused as jmf
from statecatcher_tpu.models.xlstm import mlstm_chunkwise as j_chunkwise
from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise
from statecatcher_tpu_torch.ops import mlstm_fused as mf
from test_torch_cuda import assert_scaled_close, mlstm_kernel_data
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_rnnt_joint_tc import bf16, matmul_3xtf32

pytestmark = pytest.mark.usefixtures("single_torch_thread")

TILE = 64
THREADS = 256
FWD = ("h", "C_T", "n_T", "m_T")


def rows_scan(x, add: bool):
    """The gate passes' inclusive scan over a chunk's rows (the last axis),
    ``rows_scan`` of mlstm_chunk.cuh: a sum (``add``) or a running max.
    Thread t takes the P = ceil(L/256) consecutive rows from t·P and forms
    their prefix, the threads' partials are scanned, each row but a thread's
    last adds the partial of the threads before its own, and the last takes
    the scan of the partials (at L <= 256, P = 1: the scan of the rows)."""
    scan = (lambda y, d: torch.cumsum(y, d)) if add else (lambda y, d: torch.cummax(y, d).values)
    L = x.shape[-1]
    P = -(-L // THREADS)
    n = -(-L // P)                                             # threads holding rows
    local = scan(F.pad(x, (0, n * P - L), value=0.0 if add else -float("inf"))
                 .reshape(*x.shape[:-1], n, P), -1)
    inc = scan(local[..., -1], -1)                             # the partials' scan
    pre = inc[..., :-1, None]                                  # the threads before each
    rest = local[..., 1:, :-1] + pre if add else torch.maximum(local[..., 1:, :-1], pre)
    head = torch.cat([local[..., :1, :-1], rest], -2)
    return torch.cat([head, inc[..., None]], -1).reshape(*x.shape[:-1], n * P)[..., :L]


def split_core(qh, kh, vh, ic, lf, C0, n0, m0, L, inv, mm=torch.matmul, mm_in=torch.matmul):
    """The forward's passes on head-major (B, H, Tp, d) inputs whose rows past
    T are already masked: ``mm`` takes every product with an f32 operand,
    ``mm_in`` q·kᵀ (both operands inputs).  Returns h (B, H, Tp, dv), C_T,
    n_T, m_T."""
    B, H, Tp, dqk = qh.shape
    NC = Tp // L
    ch = lambda x: x.reshape(B, H, NC, L, *x.shape[3:])          # (B, H, NC, L, ...)
    q_, k_, v_ = (ch(x) for x in (qh, kh, vh))
    ic_, lf_ = ic.reshape(B, H, NC, L), lf.reshape(B, H, NC, L)
    T_ = lambda x: x.transpose(-1, -2)

    # 1. gates: scans local to each chunk, then the scalar m walks the
    # chunks' (bL, A)
    b = rows_scan(lf_, True)
    a = ic_ - b
    R = rows_scan(a, False)
    bL, A = b[..., -1], R[..., -1]
    ms = [m0]
    for c in range(NC):
        ms.append(torch.maximum(ms[-1] + bL[..., c], bL[..., c] + A[..., c]))
    m = torch.stack(ms[:-1], -1)                               # (B, H, NC) entry m
    mn = torch.stack(ms[1:], -1)
    g = torch.exp(m + bL - mn)
    mu = b + torch.maximum(m[..., None], R)
    sp = torch.exp(b + m[..., None] - mu)
    w = torch.exp(bL[..., None] + a - mn[..., None])
    # 2./3. each chunk's state term, then the entry states by an elementwise
    # scan; 4. the exit state from the last chunk's term
    D = mm(T_(k_ * w[..., None]), v_)
    nD = (k_ * w[..., None]).sum(-2)
    Cs, ns = [C0], [n0]
    for c in range(NC):
        Cs.append(g[..., c, None, None] * Cs[-1] + D[:, :, c])
        ns.append(g[..., c, None] * ns[-1] + nD[:, :, c])
    C, n = torch.stack(Cs[:-1], 2), torch.stack(ns[:-1], 2)

    # 5. the outputs of each 64-row tile: the state term, then the s-tiles up
    # to the diagonal
    hs = []
    for t0 in range(0, L, TILE):
        rt = slice(t0, min(L, t0 + TILE))
        t = torch.arange(t0, rt.stop)[:, None]
        qt = q_[..., rt, :]
        spi = inv * sp[..., rt]
        acc = mm(qt, C) * spi[..., None]
        sw = torch.zeros_like(spi)
        for s0 in range(0, t0 + 1, TILE):
            st = slice(s0, min(L, s0 + TILE))
            s = torch.arange(s0, st.stop)[None, :]
            E = torch.where(s <= t, torch.exp(b[..., rt, None] + a[..., None, st] -
                                              mu[..., rt, None]), 0.0)
            W = inv * mm_in(qt, T_(k_[..., st, :])) * E
            sw = sw + W.sum(-1)
            acc = acc + mm(W, v_[..., st, :])
        qn = (qt * n[..., None, :]).sum(-1)
        den = torch.maximum((sw + spi * qn).abs(), torch.exp(-mu[..., rt]))
        hs.append(acc / den[..., None])
    h = torch.cat(hs, -2).reshape(B, H, Tp, -1)
    return h, Cs[-1], ns[-1], mn[..., -1]


def split_fwd(q, k, v, i_c, logf, C0, n0, m0, chunk, T, mm=torch.matmul, mm_in=torch.matmul):
    """K9a's passes in plain torch, with K9a's signature (lane-major q, k, v;
    rows ≥ T masked; q scaled by dqk^-½ inside)."""
    qh, kh, vh, ic, lf, _ = mf._masked_inputs(q, k, v, i_c, logf, T)
    L = min(chunk, qh.shape[2])
    h, C_T, n_T, m_T = split_core(qh, kh, vh, ic, lf, C0, n0, m0, L, qh.shape[3] ** -0.5,
                                  mm, mm_in)
    return mf._lanes(h, q.dtype), C_T, n_T, m_T


def split_fwd_heads(q, k, v, i_raw, f_raw, C0, n0, m0, chunk, mm=torch.matmul,
                    mm_in=torch.matmul):
    """K10's passes: what ``mlstm_pallas_fwd`` does around the kernels (pad
    the gates with values that keep the state, scale q, soft-cap,
    log-sigmoid; q, k, v read as 0 past T), then the passes with inv = 1."""
    T, dqk = q.shape[2], q.shape[3]
    pad = (-T) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        i_raw = F.pad(i_raw, (0, pad), value=mf.NEG)
        f_raw = F.pad(f_raw, (0, pad), value=30.0)
    ic = mf.soft_cap(i_raw, 15.0)
    lf = F.logsigmoid(mf.soft_cap(f_raw, 15.0))
    h, C_T, n_T, m_T = split_core(q * dqk ** -0.5, k, v, ic, lf, C0, n0, m0, chunk, 1.0, mm,
                                  mm_in)
    return h[:, :, :T], C_T, n_T, m_T


def _case(seed, B, T, H, dqk, dv, chunk, dtype=torch.float64, ties=False):
    ins, L, _ = mlstm_kernel_data(seed, B, T, H, dqk, dv, chunk)
    ins = [x.to(dtype) for x in ins]
    if ties:
        ins[3] = torch.full_like(ins[3], -0.3)                 # every a_s equal ...
        ins[4] = torch.zeros_like(ins[4])
        ins[7] = torch.full_like(ins[7], -0.3)                 # ... and m0 equal to it
    return ins, L


def _assert_f64(got, want):
    for name, x, y in zip(FWD, got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


# (B, T, H, dqk, dv, chunk): T not a multiple of L, one chunk, two row tiles,
# L = 256 (four row tiles) at narrow widths, dv not a multiple of 64; then
# above 256: L = 384 and 512 (two rows a thread in the gate scans), dqk = 320,
# 512 and 300 (not a multiple of 64) at short T
SHAPES = [(2, 45, 2, 16, 16, 16), (1, 32, 2, 16, 24, 32), (1, 200, 2, 32, 48, 128),
          (1, 300, 1, 8, 8, 256), (2, 70, 2, 12, 80, 32), (1, 700, 1, 8, 8, 384),
          (1, 1100, 1, 8, 12, 512), (1, 40, 1, 320, 16, 16), (1, 45, 2, 512, 8, 32),
          (1, 50, 1, 300, 20, 32)]


@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_split_matches_plain_forward_f64(B, T, H, dqk, dv, chunk, ties):
    ins, L = _case(B * T + dqk, B, T, H, dqk, dv, chunk, ties=ties)
    _assert_f64(split_fwd(*ins, L, T), mf.mlstm_fused_fwd_ref(*ins, L, T))


def _head_data(seed, B, T, H, dqk, dv, dtype=np.float64):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(dtype)
    return [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
            2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), np.abs(0.1 * r(B, H, dqk)),
            0.1 * r(B, H)]


@pytest.mark.parametrize("T,chunk,dv", [(45, 16, 16), (32, 32, 24), (300, 128, 80)])
def test_split_in_k10_layout_matches_chunkwise(T, chunk, dv):
    """K10's layout: the port's plain ``mlstm_chunkwise`` in float64, and the
    JAX package's XLA ``mlstm_chunkwise`` in float32."""
    B, H, dqk = 2, 2, 16
    xs = _head_data(T + dv, B, T, H, dqk, dv)
    got = split_fwd_heads(*map(torch.from_numpy, xs), chunk)
    _assert_f64(got, mlstm_chunkwise(*map(torch.from_numpy, xs), chunk))
    xs32 = [x.astype(np.float32) for x in xs]
    got = split_fwd_heads(*map(torch.from_numpy, xs32), chunk)
    want = j_chunkwise(*map(jnp.asarray, xs32), chunk)
    for name, x, y in zip(FWD, got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("T", [32, 45])
def test_split_through_layer_matches_interpret_mode_kernel(T, monkeypatch):
    """``mlstm_fused`` with ``split_fwd`` as its forward against the JAX
    package's K9a forward kernel in interpret mode (raw gates, the soft cap,
    the padding), in float32."""
    B, H, dqk, dv = 2, 2, 16, 16
    rng = np.random.default_rng(300 + T)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    d = [r(B, T, H * dqk), r(B, T, H * dqk), r(B, T, H * dv), r(B, T, H) * 2.0,
         r(B, T, H) * 2.0 + 1.0, r(B, H, dqk, dv) * 0.1, np.abs(r(B, H, dqk)) * 0.1,
         r(B, H) * 0.1]
    monkeypatch.setattr(jmf, "_fused_fwd_impl",
                        functools.partial(jmf._fused_fwd_impl.__wrapped__, interpret=True))
    want = jmf.mlstm_fused(*map(jnp.asarray, d), 16)
    monkeypatch.setattr(mf, "mlstm_fused_fwd", split_fwd)
    got = mf.mlstm_fused(*map(torch.from_numpy, d), 16)
    for name, x, y in zip(FWD, got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4, atol=2e-5, err_msg=name)


def _mm_bf16_inputs(a, b):
    """bf16 m16n8k16 on operands that are bf16 values: exact products, f32 sums."""
    return bf16(a) @ bf16(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk,ties", [(2, 200, 2, 64, 128, 128, False),
                                                      (1, 300, 2, 32, 48, 256, False),
                                                      (2, 70, 1, 32, 80, 32, True),
                                                      (1, 32, 2, 64, 128, 32, False),
                                                      (1, 1100, 1, 16, 16, 512, True),
                                                      (1, 70, 1, 512, 64, 32, False),
                                                      (1, 50, 1, 300, 20, 32, False)])
def test_split_on_emulated_tensor_cores_within_card_tolerance(dtype, B, T, H, dqk, dv, chunk,
                                                              ties):
    ins, L = _case(11 + T, B, T, H, dqk, dv, chunk, torch.float32, ties=ties)
    if dtype == torch.bfloat16:
        ins[:3] = [x.to(dtype) for x in ins[:3]]
    mm_in = matmul_3xtf32 if dtype == torch.float32 else _mm_bf16_inputs
    got = split_fwd(*ins, L, T, mm=matmul_3xtf32, mm_in=mm_in)
    want = mf.mlstm_fused_fwd_ref(*ins, L, T)
    assert got[0].dtype == want[0].dtype == dtype
    assert_scaled_close(got[:1], want[:1], FWD[:1], 1e-4 if dtype == torch.float32 else 2e-2)
    assert_scaled_close(got[1:], want[1:], FWD[1:], 1e-4)


def test_split_in_k10_layout_on_emulated_tensor_cores():
    """K10's layout and inv = 1 with the products in 3xTF32, against
    ``mlstm_chunkwise`` within 1e-4 of each output's scale (the card tests'
    tolerance)."""
    B, H, T, dqk, dv, chunk = 2, 2, 300, 64, 128, 128
    xs = [torch.from_numpy(x) for x in _head_data(5, B, T, H, dqk, dv, np.float32)]
    got = split_fwd_heads(*xs, chunk, mm=matmul_3xtf32, mm_in=matmul_3xtf32)
    assert_scaled_close(got, mlstm_chunkwise(*xs, chunk), FWD, 1e-4)
