"""K9b's order of work (``ops/csrc/mlstm_fused.cu``), written out as plain
torch here and held against the plain backward and against JAX.

The kernel splits the chunk adjoint along its data dependencies: every
chunk's entry state (its state term per chunk, then an elementwise scan), a
chunk-parallel local pass (den, dqn, dmu, dsp, rowD = swg/den + dqn·sw, dq,
the chunk's own dC_c and dn_c), the reverse scans of dC' and dn' (and dg),
a chunk-parallel pass for dk and dv (w·Y, w·Z, colD), the gate chain with
dm' = 0 and the fix-up that adds dm''s terms once every chunk's (dmc, to1) is
known.  Above dqk = 256 the rows' and dk's passes take dq and dk in slabs of
256 columns, q·U and k·(Y + dn') summed over the slabs in order; the gate
passes scan a chunk's rows as ``rows_scan`` (test_torch_mlstm_fwd_split.py)
does, and the chain counts each tie by walking its run of equal R, which at
L > 256 crosses the threads' rows.  ``split_bwd`` below follows those passes;
it is not on any path of the port.  Held:

  * against ``mlstm_fused_bwd_ref`` in float64: rtol 1e-9, atol 1e-11 (the
    same function, summed in another order), at T not a multiple of L, a
    single chunk, L = 256, 384 and 512 with narrow widths, dqk = 300, 320 and
    512 at short T, and tied input gates (every a_s equal, so the running max
    and both maxima tie);
  * against ``jax.vjp`` of the JAX package's pure-XLA ``mlstm_chunkwise``
    through the layer (``mlstm_fused`` with ``split_bwd`` as its backward),
    in float32 at the tolerances of tests/test_torch_mlstm_fused.py (rtol
    5e-3, atol 5e-4; JAX takes its products in float32);
  * with the card's products emulated in float32 (3xTF32 for every product
    with an f32 operand; bf16 operands rounded once for q·kᵀ and dh·vᵀ under
    bf16 inputs, as tests/test_torch_rnnt_joint_tc.py emulates the joint),
    against the plain backward at the card tests' tolerances (1e-3 relative
    plus 1e-4 of each output's largest value; bf16 dq, dk, dv 2e-2 plus
    1e-3).
No JAX gradient runs through a Pallas kernel here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.models.xlstm import mlstm_chunkwise as j_chunkwise
from statecatcher_tpu_torch.ops import mlstm_fused as mf
from test_torch_cuda import assert_grad_close, mlstm_kernel_data
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_mlstm_fwd_split import rows_scan
from test_torch_rnnt_joint_tc import bf16, matmul_3xtf32

pytestmark = pytest.mark.usefixtures("single_torch_thread")

NAMES = ("dq", "dk", "dv", "dic", "dlogf", "dC0", "dn0", "dm0")
SLAB = 256


def slabs(dqk):
    """The column slabs of dq and dk: one below 256 columns, else 256 each."""
    return [slice(d0, min(dqk, d0 + SLAB)) for d0 in range(0, dqk, SLAB)]


def rev_scan(x):
    """sum_{u >= t} x_u over a chunk's rows, as the kernels take it: the rows
    reversed, ``rows_scan``, reversed back."""
    return torch.flip(rows_scan(torch.flip(x, (-1,)), True), (-1,))


def run_ties(a, R, dR):
    """The chain's tie terms as its walk takes them: each row r counts the
    rows s <= r of its run of equal R with a_s = R_r (cnt), and a row s with
    a_s = R_s adds dR_u / cnt_u over the rows u >= s of its run.  R does not
    decrease, so a run is a segment of rows."""
    new = torch.ones_like(R, dtype=torch.bool)
    new[..., 1:] = R[..., 1:] != R[..., :-1]
    seg = torch.cumsum(new.long(), -1)                         # run index of each row
    hit = (a == R).to(a.dtype)
    same = seg[..., :, None] == seg[..., None, :]              # (r, s) in one run
    tri = torch.ones(R.shape[-1], R.shape[-1], dtype=torch.bool).tril()
    cnt = (same & tri).to(a.dtype) @ hit[..., None]            # rows s <= r of r's run
    share = (same & tri.T).to(a.dtype) @ (dR / cnt[..., 0])[..., None]   # rows u >= s
    return cnt[..., 0], hit * share[..., 0]


def _tie(x, y):
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0)).to(x.dtype)


def split_bwd(q, k, v, i_c, logf, C0, n0, m0, dh, dC_T, dn_T, dm_T, chunk, T,
              mm=torch.matmul, mm_in=torch.matmul):
    """K9b's passes in plain torch: ``mm`` takes every product with an f32
    operand, ``mm_in`` the two whose operands are both inputs (q·kᵀ, dh·vᵀ)."""
    qh, kh, vh, ic, lf, valid = mf._masked_inputs(q, k, v, i_c, logf, T)
    dhh = torch.where(valid[:, None], mf._heads(dh, i_c.shape[1]), 0.0)
    B, H, Tp, dqk = qh.shape
    L = min(chunk, Tp)
    NC = Tp // L
    inv = float(dqk) ** -0.5
    ch = lambda x: x.reshape(B, H, NC, L, *x.shape[3:])        # (B, H, NC, L, ...)
    q_, k_, v_, dh_ = (ch(x) for x in (qh, kh, vh, dhh))
    ic_, lf_ = ic.reshape(B, H, NC, L), lf.reshape(B, H, NC, L)
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    T_ = lambda x: x.transpose(-1, -2)

    # 1. gates: block scans local to each chunk, then the scalar m walks the
    # chunks' (bL, A)
    b = rows_scan(lf_, True)
    a = ic_ - b
    R = rows_scan(a, False)
    bL, A = b[..., -1], R[..., -1]
    ms = [m0]
    for c in range(NC - 1):
        ms.append(torch.maximum(ms[-1] + bL[..., c], bL[..., c] + A[..., c]))
    m = torch.stack(ms, -1)                                    # (B, H, NC) entry m
    mn = torch.maximum(m + bL, bL + A)
    g = torch.exp(m + bL - mn)
    mu = b + torch.maximum(m[..., None], R)
    sp = torch.exp(b + m[..., None] - mu)
    w = torch.exp(bL[..., None] + a - mn[..., None])
    # 2./3. each chunk's state term, then the entry states by an elementwise scan
    D = mm(T_(k_ * w[..., None]), v_)
    nD = (k_ * w[..., None]).sum(-2)
    Cs, ns = [C0], [n0]
    for c in range(NC - 1):
        Cs.append(g[..., c, None, None] * Cs[-1] + D[:, :, c])
        ns.append(g[..., c, None] * ns[-1] + nD[:, :, c])
    C, n = torch.stack(Cs, 2), torch.stack(ns, 2)

    # 4. the local pass: row sums of W = S E and W G, U = dh Cᵀ and q·U slab by
    # slab, then dq
    E = torch.where(tri, torch.exp(b[..., :, None] + a[..., None, :] - mu[..., :, None]), 0.0)
    S = inv * mm_in(q_, T_(k_))
    G = mm_in(dh_, T_(v_))
    U = torch.cat([mm(dh_, T_(C[..., sl, :])) for sl in slabs(dqk)], -1)
    W = S * E
    sw, swg = W.sum(-1), (W * G).sum(-1)
    qnn = (q_ * n[..., None, :]).sum(-1)
    qU = 0.0
    for sl in slabs(dqk):
        qU = qU + (q_[..., sl] * U[..., sl]).sum(-1)
    qn = sw + sp * inv * qnn
    emu = torch.exp(-mu)
    den = torch.maximum(qn.abs(), emu)
    dden = -(swg + sp * inv * qU) / den ** 2
    toq = _tie(qn.abs(), emu)
    dqn = dden * toq * torch.sign(qn)
    dmud = -dden * (1.0 - toq) * emu
    dsp = inv * qU / den + inv * dqn * qnn
    rowD = swg / den + dqn * sw
    Q = E * (G / den[..., None] + dqn[..., None])
    dq = inv * sp[..., None] * (U / den[..., None] + dqn[..., None] * n[..., None, :])
    dq = dq + torch.cat([mm(inv * Q, k_[..., sl]) for sl in slabs(dqk)], -1)
    # 5. each chunk's own entry adjoints
    dCc = mm(T_(q_ * (inv * sp / den)[..., None]), dh_)
    dnc = (q_ * (inv * sp * dqn)[..., None]).sum(-2)
    # 6. the reverse scans: dC', dn' of every chunk, dg
    lam, lamn = [None] * NC, [None] * NC
    x, xn = dC_T, dn_T
    for c in range(NC - 1, -1, -1):
        lam[c], lamn[c] = x, xn
        x = g[..., c, None, None] * x + dCc[:, :, c]
        xn = g[..., c, None] * xn + dnc[:, :, c]
    dC0, dn0 = x, xn
    lam, lamn = torch.stack(lam, 2), torch.stack(lamn, 2)
    dg = (lam * C).sum((-1, -2)) + (lamn * n).sum(-1)
    # 7./8. dk (slab by slab, k·wY summed over the slabs in order), dv, colD and
    # w·dw
    wY = torch.cat([mm(v_ * w[..., None], T_(lam[..., sl, :])) for sl in slabs(dqk)], -1)
    wY = wY + w[..., None] * lamn[..., None, :]
    dZ = 0.0
    for sl in slabs(dqk):
        dZ = dZ + (k_[..., sl] * wY[..., sl]).sum(-1)
    dk = wY + torch.cat([mm(T_(inv * Q), q_[..., sl]) for sl in slabs(dqk)], -1)
    colD = (S * Q).sum(-2)
    dv = mm(k_ * w[..., None], lam) + mm(T_(W / den[..., None]), dh_)
    # 9. the gate chain with dm' = 0
    dX = dsp * sp
    dmu = dmud - rowD - dX
    db = rowD + dX + dmu
    tom = _tie(m[..., None].expand_as(R), R)
    sum_dz = dZ.sum(-1)
    dY = dg * g
    dm_tot = -sum_dz - dY
    to1 = _tie(m + bL, bL + A)
    dmc = (dX + dmu * tom).sum(-1) + dY + dm_tot * to1
    dR = dmu * (1.0 - tom)
    dR = torch.cat([dR[..., :-1], (dR[..., -1] + dm_tot * (1.0 - to1))[..., None]], -1)
    db = torch.cat([db[..., :-1], (db[..., -1] + sum_dz + dY + dm_tot)[..., None]], -1)
    cnt, ties = run_ties(a, R, dR)
    da = colD + dZ + ties
    dlf = rev_scan(db - da)
    # 10. the fix-up: dm' of each chunk from the later chunks' (dmc, to1)
    dms = [None] * NC
    x = dm_T
    for c in range(NC - 1, -1, -1):
        dms[c] = x
        x = dmc[..., c] + to1[..., c] * x
    dm0 = x
    dmx = torch.stack(dms, -1)                                 # each chunk's dm'
    last = (a == A[..., None]).to(a.dtype)                     # the ties of R_{L-1}
    share = dmx * (1.0 - to1) / cnt[..., -1]
    dic = da + share[..., None] * last
    after = rev_scan(last)
    dlf = dlf + dmx[..., None] - share[..., None] * after

    lanes = lambda x, dt: mf._lanes(torch.where(valid[:, None], x.reshape(B, H, Tp, -1), 0.0), dt)
    flat = lambda x: torch.where(valid, x.reshape(B, H, Tp), 0.0)
    return (lanes(dq, q.dtype), lanes(dk, k.dtype), lanes(dv, v.dtype), flat(dic), flat(dlf),
            dC0, dn0, dm0)


def _case(seed, B, T, H, dqk, dv, chunk, dtype=torch.float64, ties=False):
    ins, L, Tp = mlstm_kernel_data(seed, B, T, H, dqk, dv, chunk)
    ins = [x.to(dtype) for x in ins]
    if ties:
        ins[3] = torch.full_like(ins[3], -0.3)                 # every a_s equal ...
        ins[4] = torch.zeros_like(ins[4])
        ins[7] = torch.full_like(ins[7], -0.3)                 # ... and m0 equal to it
    rng = np.random.default_rng(seed + 1)
    cot = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    dh = cot(B, Tp, H * dv)
    dh[:, T:] = 0                                              # rows past T are not outputs
    return ins, [dh, cot(B, H, dqk, dv), cot(B, H, dqk), cot(B, H)], L


# (B, T, H, dqk, dv, chunk): T a multiple of L and not, one chunk, L = 256;
# then above 256: L = 384 and 512 (two rows a thread in the gate passes),
# dqk = 320 and 512 (two slabs) and 300 (a slab of 44 columns) at short T
SHAPES = [(2, 45, 2, 16, 16, 16), (2, 64, 1, 16, 24, 16), (1, 20, 2, 16, 16, 32),
          (1, 300, 1, 8, 8, 256), (2, 70, 2, 12, 20, 32), (1, 700, 1, 8, 8, 384),
          (1, 1100, 1, 8, 12, 512), (1, 40, 1, 320, 16, 16), (1, 45, 2, 512, 8, 32),
          (1, 50, 1, 300, 20, 32)]


@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_split_matches_plain_backward_f64(B, T, H, dqk, dv, chunk, ties):
    ins, cots, L = _case(B * T + dqk, B, T, H, dqk, dv, chunk, ties=ties)
    got = split_bwd(*ins, *cots, L, T)
    want = mf.mlstm_fused_bwd_ref(*ins, *cots, L, T)
    for name, x, y in zip(NAMES, got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9, atol=1e-11, err_msg=name)


def _jax_chunkwise(args, B, H, dqk, dv, chunk):
    q, k, v, i_raw, f_raw, C0, n0, m0 = args
    T = q.shape[1]
    tr = lambda x, dd: x.reshape(B, T, H, dd).transpose(0, 2, 1, 3)
    h, C_T, n_T, m_T = j_chunkwise(tr(q, dqk), tr(k, dqk), tr(v, dv), i_raw.transpose(0, 2, 1),
                                   f_raw.transpose(0, 2, 1), C0, n0, m0, chunk)
    return h.transpose(0, 2, 1, 3).reshape(B, T, H * dv), C_T, n_T, m_T


@pytest.mark.parametrize("T,chunk", [(45, 16), (32, 32)])
def test_split_through_layer_matches_jax_vjp(T, chunk, monkeypatch):
    """``mlstm_fused`` with ``split_bwd`` as its backward against ``jax.vjp``
    of the XLA chunkwise form (raw gates, the soft cap, the padding)."""
    B, H, dqk, dv = 2, 2, 16, 16
    rng = np.random.default_rng(200 + T)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    d = [r(B, T, H * dqk), r(B, T, H * dqk), r(B, T, H * dv), r(B, T, H) * 2.0,
         r(B, T, H) * 2.0 + 1.0, r(B, H, dqk, dv) * 0.1, np.abs(r(B, H, dqk)) * 0.1,
         r(B, H) * 0.1]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H * dv), (B, H, dqk, dv), (B, H, dqk), (B, H))]
    want, vjp = jax.vjp(lambda *a: _jax_chunkwise(a, B, H, dqk, dv, chunk),
                        *(jnp.asarray(x) for x in d))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    monkeypatch.setattr(mf, "mlstm_fused_bwd", split_bwd)
    xs = [torch.from_numpy(x).requires_grad_() for x in d]
    got = mf.mlstm_fused(*xs, chunk)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, x, gj in zip(["q", "k", "v", "i_raw", "f_raw", "C0", "n0", "m0"], xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=5e-3, atol=5e-4,
                                   err_msg=f"d_{name}")


def _mm_bf16_inputs(a, b):
    """bf16 m16n8k16 on operands that are bf16 values: exact products, f32 sums."""
    return bf16(a) @ bf16(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,dqk,dv,chunk,ties", [(2, 200, 2, 64, 128, 128, False),
                                                      (1, 300, 2, 32, 48, 256, False),
                                                      (2, 70, 1, 32, 80, 32, True),
                                                      (1, 1100, 1, 16, 16, 512, True),
                                                      (1, 70, 1, 512, 64, 32, False),
                                                      (1, 50, 1, 300, 20, 32, False)])
def test_split_on_emulated_tensor_cores_within_card_tolerance(dtype, B, T, H, dqk, dv, chunk,
                                                              ties):
    ins, cots, L = _case(7 + T, B, T, H, dqk, dv, chunk, torch.float32, ties=ties)
    if dtype == torch.bfloat16:
        ins[:3] = [x.to(dtype) for x in ins[:3]]
        cots[0] = cots[0].to(dtype)
    mm_in = matmul_3xtf32 if dtype == torch.float32 else _mm_bf16_inputs
    got = split_bwd(*ins, *cots, L, T, mm=matmul_3xtf32, mm_in=mm_in)
    want = mf.mlstm_fused_bwd_ref(*ins, *cots, L, T)
    for i, (name, x, y) in enumerate(zip(NAMES, got, want)):
        bf = dtype == torch.bfloat16 and i < 3
        assert x.dtype == y.dtype, name
        assert_grad_close(x.float().numpy(), y.float().numpy(), name,
                          rtol=2e-2 if bf else 1e-3, scale_tol=1e-3 if bf else 1e-4)
