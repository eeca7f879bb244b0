"""The fused lane-major chunkwise mLSTM: K9a (forward) and K9b (backward).

Replaces two TPU kernels of ``statecatcher_tpu/ops/mlstm_fused.py``:

  * K9a, ``_fwd_kernel`` (:158, launched by ``_fused_fwd_impl``, :199) →
    ``mlstm_fused_fwd`` of ``ops/csrc/mlstm_fused.cu``: q, k (B, Tp, H·dqk)
    and v (B, Tp, H·dv) in the model dtype (float32 or bfloat16), the
    soft-capped input gate ĩ and log-forget (B, H, Tp) f32, the carried
    (C0, n0, m0) f32 → h (B, Tp, H·dv) in q's dtype and (C_T, n_T, m_T) f32;
  * K9b, ``_bwd_kernel`` (:251, launched by ``_fused_bwd_impl``, :322) →
    ``mlstm_fused_bwd``: the same inputs and the cotangents (dh, dC_T, dn_T,
    dm_T) → dq, dk, dv in their inputs' dtypes, dĩ, dlogf, dC0, dn0, dm0 f32.

Rows t ≥ T of the padded time axis are masked inside both (q, k, v and dh
read as 0, ĩ as −1e30, log-forget as 0), and their gradients are 0.  The
math of one chunk is ``mlstm_chunk_step`` (the JAX package's ``_chunk_step``,
:50): every product in float32 whatever the inputs' dtype, q scaled by
dqk^-½ inside.  The TPU kernels walk the chunks in order, the backward
taking ``jax.vjp`` of the chunk step in registers; here the chunk step and
its adjoint, written out as ``mlstm_chunk_bwd_ref``, are split along their
data dependencies into chunk-parallel passes on the tensor cores
(``ops/csrc/mlstm_chunk.cuh``, ``ops/csrc/mlstm_fused.cu``).

``mlstm_fused`` is the layer's entry (the JAX package's :417): it pads T to a
chunk multiple, applies the soft cap and log-sigmoid to the gates in f32,
moves them to (B, H, Tp), runs ``_MLSTMFused`` (a ``torch.autograd.Function``
over K9a/K9b, the JAX package's ``custom_vjp``) and slices the tail off.

``mlstm_fused_fwd_ref`` and ``mlstm_fused_bwd_ref`` (the masked chunk loop,
forward and in reverse) are the plain versions.  Each wrapper runs its plain
version only for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from statecatcher_tpu_torch.ops._kernels import MAX_GRID_YZ

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Soft cap (tanh saturation) of the gate pre-activations."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def _tie_split(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of the gradient of max(x, y) that goes to x: 1, ½ on a tie, 0."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0)).to(x.dtype)


# --------------------------------------------------------------------------- #
# One chunk and its adjoint (batched over the leading axes)
# --------------------------------------------------------------------------- #
def mlstm_chunk_step(qc, kc, vc, ic, lfc, C, n, m, inv_sqrt_d: float):
    """One chunk of the stabilised chunkwise mLSTM, the JAX package's
    ``_chunk_step``: qc, kc (..., L, dqk), vc (..., L, dv), ic, lfc (..., L),
    C (..., dqk, dv), n (..., dqk), m (...) → (h (..., L, dv), C', n', m')."""
    L = qc.shape[-2]
    tri = torch.ones(L, L, dtype=torch.bool, device=qc.device).tril()
    b = torch.cumsum(lfc, -1)
    a = ic - b
    bL = b[..., -1]
    R = torch.where(tri, a[..., None, :], NEG).amax(-1)          # max_{s≤t} a_s
    mu = b + torch.maximum(m[..., None], R)
    D = torch.where(tri, b[..., :, None] + a[..., None, :] - mu[..., :, None], NEG)
    E = torch.exp(D)
    S = (qc @ kc.transpose(-1, -2)) * inv_sqrt_d
    num_local = (S * E) @ vc
    nvec_local = E @ kc
    sp = torch.exp(b + m[..., None] - mu)
    num_prev = (qc @ C) * (sp * inv_sqrt_d)[..., None]
    nvec = nvec_local + n[..., None, :] * sp[..., None]
    qn = (qc * nvec).sum(-1) * inv_sqrt_d
    den = torch.maximum(qn.abs(), torch.exp(-mu))
    h = (num_local + num_prev) / den[..., None]

    m_new = torch.maximum(m + bL, bL + R[..., -1])
    g = torch.exp(m + bL - m_new)
    w = torch.exp(bL[..., None] + a - m_new[..., None])
    kw = kc * w[..., None]
    C_new = g[..., None, None] * C + kw.transpose(-1, -2) @ vc
    n_new = g[..., None] * n + kw.sum(-2)
    return h, C_new, n_new, m_new


def mlstm_chunk_bwd_ref(qc, kc, vc, ic, lfc, C, n, m, dh, dC_new, dn_new, dm_new,
                        inv_sqrt_d: float):
    """The adjoint of ``mlstm_chunk_step``, written out: the cotangents of
    (h, C', n', m') → (dqc, dkc, dvc, dic, dlfc, dC, dn, dm).  A tied
    ``maximum`` or running max sends each tied branch an equal share, as
    JAX's autodiff does; |x| has derivative sign(x) (0 at 0)."""
    L = qc.shape[-2]
    tri = torch.ones(L, L, dtype=torch.bool, device=qc.device).tril()
    # the forward, recomputed
    b = torch.cumsum(lfc, -1)
    a = ic - b
    bL = b[..., -1]
    a_mat = torch.where(tri, a[..., None, :], NEG)
    R = a_mat.amax(-1)
    mu = b + torch.maximum(m[..., None], R)
    E = torch.where(tri, torch.exp(b[..., :, None] + a[..., None, :] - mu[..., :, None]), 0.0)
    S = (qc @ kc.transpose(-1, -2)) * inv_sqrt_d
    W = S * E
    sp = torch.exp(b + m[..., None] - mu)
    qC = qc @ C
    nvec = E @ kc + n[..., None, :] * sp[..., None]
    qn = (qc * nvec).sum(-1) * inv_sqrt_d
    emu = torch.exp(-mu)
    den = torch.maximum(qn.abs(), emu)
    num = W @ vc + qC * (sp * inv_sqrt_d)[..., None]
    A = R[..., -1]
    x1, x2 = m + bL, bL + A
    m_new = torch.maximum(x1, x2)
    g = torch.exp(m + bL - m_new)
    w = torch.exp(bL[..., None] + a - m_new[..., None])

    # h = num / max(|qn|, e^{−μ})
    dnum = dh / den[..., None]
    dden = -(dh * num).sum(-1) / den ** 2
    to_q = _tie_split(qn.abs(), emu)
    dqn = dden * to_q * torch.sign(qn)
    dmu = -dden * (1.0 - to_q) * emu
    # qn = q·nvec/√d, nvec = E k + sp n
    dnvec = (inv_sqrt_d * dqn)[..., None] * qc
    dq = (inv_sqrt_d * dqn)[..., None] * nvec
    dE = dnvec @ kc.transpose(-1, -2)
    dk = E.transpose(-1, -2) @ dnvec
    dsp = (dnvec * n[..., None, :]).sum(-1)
    dn = (sp[..., None] * dnvec).sum(-2)
    # num = (S∘E) v + sp/√d · q C
    dW = dnum @ vc.transpose(-1, -2)
    dv = W.transpose(-1, -2) @ dnum
    dsp = dsp + inv_sqrt_d * (dnum * qC).sum(-1)
    dqC = dnum * (sp * inv_sqrt_d)[..., None]
    dq = dq + dqC @ C.transpose(-1, -2)
    dC = qc.transpose(-1, -2) @ dqC
    dS = dW * E
    dE = dE + dW * S
    dq = dq + inv_sqrt_d * (dS @ kc)
    dk = dk + inv_sqrt_d * (dS.transpose(-1, -2) @ qc)
    # E = exp(b_t + a_s − μ_t) for s ≤ t
    dD = torch.where(tri, dE * E, 0.0)
    db = dD.sum(-1)
    da = dD.sum(-2)
    dmu = dmu - dD.sum(-1)
    # sp = exp(b + m − μ)
    dX = dsp * sp
    db = db + dX
    dm = dX.sum(-1)
    dmu = dmu - dX
    # μ = b + max(m, R)
    db = db + dmu
    to_m = _tie_split(m[..., None].expand_as(R), R)
    dm = dm + (dmu * to_m).sum(-1)
    dR = dmu * (1.0 - to_m)

    # the state advance: C' = g C + Σ w_t k_t v_tᵀ, n' = g n + Σ w_t k_t
    dC = dC + g[..., None, None] * dC_new
    dn = dn + g[..., None] * dn_new
    dg = (dC_new * C).sum((-1, -2)) + (dn_new * n).sum(-1)
    Y = vc @ dC_new.transpose(-1, -2)                     # Y_t = dC' v_t
    dw = (kc * (Y + dn_new[..., None, :])).sum(-1)
    dk = dk + w[..., None] * (Y + dn_new[..., None, :])
    dv = dv + w[..., None] * (kc @ dC_new)
    dZ = dw * w
    da = da + dZ
    dbL = dZ.sum(-1)
    dm_tot = dm_new - dZ.sum(-1)
    dY = dg * g
    dm = dm + dY
    dbL = dbL + dY
    dm_tot = dm_tot - dY
    # m' = max(m + bL, bL + A)
    to_x1 = _tie_split(x1, x2)
    dm = dm + dm_tot * to_x1
    dbL = dbL + dm_tot
    dR = torch.cat([dR[..., :-1], (dR[..., -1] + dm_tot * (1.0 - to_x1))[..., None]], -1)
    # R_t = max_{s≤t} a_s: each tie gets an equal share
    hit = (tri & (a_mat == R[..., None])).to(dR.dtype)
    da = da + ((dR / hit.sum(-1))[..., :, None] * hit).sum(-2)
    # a = ĩ − b, b = cumsum(logf)
    dic = da
    db = db - da
    db = torch.cat([db[..., :-1], (db[..., -1] + dbL)[..., None]], -1)
    dlf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
    return dq, dk, dv, dic, dlf, dC, dn, dm


# --------------------------------------------------------------------------- #
# Plain versions of K9a and K9b
# --------------------------------------------------------------------------- #
def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, Tp, H·d) → (B, H, Tp, d) in float32 (float64 stays)."""
    B, Tp, G = x.shape
    cdt = torch.promote_types(x.dtype, torch.float32)
    return x.to(cdt).reshape(B, Tp, H, G // H).transpose(1, 2)


def _masked_inputs(q, k, v, i_c, logf, T: int):
    """Per-head f32 views with rows ≥ T masked: q/k/v 0, ĩ −1e30, logf 0."""
    H = i_c.shape[1]
    Tp = q.shape[1]
    valid = torch.arange(Tp, device=q.device) < T
    qh, kh, vh = (torch.where(valid[:, None], _heads(x, H), 0.0) for x in (q, k, v))
    ic = torch.where(valid, i_c, NEG)
    lf = torch.where(valid, logf, 0.0)
    return qh, kh, vh, ic, lf, valid


def _lanes(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, Tp, d) → (B, Tp, H·d) in ``dtype``."""
    B, H, Tp, d = x.shape
    return x.transpose(1, 2).reshape(B, Tp, H * d).to(dtype)


def mlstm_fused_fwd_ref(q, k, v, i_c, logf, C0, n0, m0, chunk: int, T: int):
    """Plain K9a: the masked chunk loop."""
    qh, kh, vh, ic, lf, _ = _masked_inputs(q, k, v, i_c, logf, T)
    Tp, dqk = qh.shape[2], qh.shape[3]
    L = min(chunk, Tp)
    inv = float(dqk) ** -0.5
    C, n, m = C0, n0, m0
    hs = []
    for c in range(Tp // L):
        sl = slice(c * L, (c + 1) * L)
        h, C, n, m = mlstm_chunk_step(qh[:, :, sl], kh[:, :, sl], vh[:, :, sl], ic[..., sl],
                                      lf[..., sl], C, n, m, inv)
        hs.append(h)
    return _lanes(torch.cat(hs, 2), q.dtype), C, n, m


def mlstm_fused_bwd_ref(q, k, v, i_c, logf, C0, n0, m0, dh, dC_T, dn_T, dm_T,
                        chunk: int, T: int):
    """Plain K9b: the chunk loop once forward for each chunk's entry state,
    then in reverse through ``mlstm_chunk_bwd_ref``."""
    qh, kh, vh, ic, lf, valid = _masked_inputs(q, k, v, i_c, logf, T)
    dhh = torch.where(valid[:, None], _heads(dh, i_c.shape[1]), 0.0)
    Tp, dqk = qh.shape[2], qh.shape[3]
    L = min(chunk, Tp)
    NC = Tp // L
    inv = float(dqk) ** -0.5
    chunks = [slice(c * L, (c + 1) * L) for c in range(NC)]
    entry = [(C0, n0, m0)]
    for sl in chunks[:-1]:
        entry.append(mlstm_chunk_step(qh[:, :, sl], kh[:, :, sl], vh[:, :, sl], ic[..., sl],
                                      lf[..., sl], *entry[-1], inv)[1:])
    dC, dn, dm = dC_T, dn_T, dm_T
    grads = [None] * NC
    for c in range(NC - 1, -1, -1):
        sl = chunks[c]
        dq, dk, dv, dic, dlf, dC, dn, dm = mlstm_chunk_bwd_ref(
            qh[:, :, sl], kh[:, :, sl], vh[:, :, sl], ic[..., sl], lf[..., sl], *entry[c],
            dhh[:, :, sl], dC, dn, dm, inv)
        grads[c] = (dq, dk, dv, dic, dlf)
    dq, dk, dv, dic, dlf = (torch.cat(x, 2 if x[0].ndim == 4 else -1) for x in zip(*grads))
    mask3 = valid[:, None]
    dq, dk, dv = (torch.where(mask3, x, 0.0) for x in (dq, dk, dv))
    return (_lanes(dq, q.dtype), _lanes(dk, k.dtype), _lanes(dv, v.dtype),
            torch.where(valid, dic, 0.0), torch.where(valid, dlf, 0.0), dC, dn, dm)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
# The kernels take any chunk and width within three limits of the card.  Their
# grids put the B·H heads and the chunks on the y and z axes (MAX_GRID_YZ
# blocks), and they take their sizes as int32 arguments.  Each block keeps its
# chunk's gate rows, fields of max(L, 256) floats, in shared memory beside fixed
# tiles, as the launchers of ops/csrc/mlstm_chunk.cuh (launch_fwd) and
# mlstm_fused.cu (launch_bwd) size them; an H100 block takes 227 KB, of which
# 2 KB are left to the kernels' static arrays.
SMEM_FLOATS = (227 * 1024 - 2048) // 4
_STAGE = {64: 9216, 128: 13824, 256: 23040}    # stage_floats(N) of mlstm_chunk.cuh
_TILE = 64 * 68                                 # a 64 x 64 operand tile (kTile * kQP)


def _smem_terms(dqk: int, dv: int, bwd: bool):
    """(floats a row of the chunk, fixed floats) of the dynamic shared memory
    of each launch that could be the largest."""
    nv = 64 if dv <= 64 else 128                 # fwd_out's and bwd_dv's columns a block
    terms = [(2, _STAGE[nv] + _TILE + 9 * 64),   # fwd_out (out_smem_bytes)
             (1, _STAGE[64] + 256)]              # state, fwd_exit
    if bwd:
        dq = 64 if dqk <= 64 else 128 if dqk <= 128 else 256
        kept = 2 + (dqk > 256)                   # kKeptG, and a third tile over slabs
        terms += [(5, _STAGE[dq] + kept * _TILE + 12 * 64),   # bwd_rows (tiles_smem_bytes)
                  (5, _STAGE[nv] + _TILE + 12 * 64),          # bwd_dv
                  (7, 0)]                                     # bwd_chain
    return terms


def max_chunk(dqk: int, dv: int, bwd: bool) -> int:
    """The largest chunk whose blocks fit an H100's shared memory: the
    forward's launches, and with ``bwd`` K9b's too."""
    return min((SMEM_FLOATS - fixed) // per for per, fixed in _smem_terms(dqk, dv, bwd))


def check_launch(BH: int, NC: int, L: int, dqk: int, dv: int, bwd: bool, *sizes: int) -> None:
    """Raise ValueError where the mLSTM kernels cannot launch a call: more
    than ``MAX_GRID_YZ`` heads (B·H) or chunks, a size at or above 2³¹, or a
    chunk of L rows above ``max_chunk``."""
    if BH > MAX_GRID_YZ or NC > MAX_GRID_YZ or max(BH, *sizes) >= 2 ** 31:
        raise ValueError(f"the mLSTM kernels' grids take at most {MAX_GRID_YZ} heads (B·H) and "
                         f"{MAX_GRID_YZ} chunks, and int32 sizes (below 2^31); got B·H = {BH}, "
                         f"{NC} chunks, sizes {sizes}")
    most = max_chunk(dqk, dv, bwd)
    if L > most:
        raise ValueError(f"the mLSTM {'backward' if bwd else 'forward'} at dqk {dqk}, dv {dv} "
                         f"takes a chunk of at most {most} rows: its blocks keep the chunk's "
                         f"gate rows in shared memory, 227 KB a block on the H100; got {L}")


def _check(q, k, v, i_c, logf, C0, n0, m0, chunk: int, T: int, bwd: bool = False):
    """Shapes (B, Tp, H, dqk, dv, L) of a K9a call (K9b's with ``bwd``);
    raises on what the kernels do not take."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, Tp, Gq = q.shape
    H = i_c.shape[1]
    dqk, dv = Gq // H, v.shape[-1] // H
    L = min(chunk, Tp)
    shapes = {"k": (k, (B, Tp, Gq)), "v": (v, (B, Tp, H * dv)), "i_c": (i_c, (B, H, Tp)),
              "logf": (logf, (B, H, Tp)), "C0": (C0, (B, H, dqk, dv)), "n0": (n0, (B, H, dqk)),
              "m0": (m0, (B, H))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} must be {shape} on {q.device}")
        if name not in ("k", "v") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if Gq != H * dqk or Tp % L or not 0 < T <= Tp or Tp - T >= L:
        raise ValueError(f"bad geometry: q {tuple(q.shape)}, H={H}, chunk {L}, T={T}")
    check_launch(B * H, Tp // L, L, dqk, dv, bwd, Tp, dqk, dv)
    return B, Tp, H, dqk, dv, L


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def mlstm_fused_fwd(q, k, v, i_c, logf, C0, n0, m0, chunk: int, T: int):
    """K9a: (h (B, Tp, H·dv) in q's dtype, C_T, n_T, m_T f32).  On CUDA
    tensors this launches ``mlstm_fused_fwd`` and counts it in
    ``mlstm_fused_fwd.launches``; on CPU tensors it runs the plain version."""
    if not q.is_cuda:
        return mlstm_fused_fwd_ref(q, k, v, i_c, logf, C0, n0, m0, chunk, T)
    B, Tp, H, dqk, dv, L = _check(q, k, v, i_c, logf, C0, n0, m0, chunk, T)
    from statecatcher_tpu_torch.ops._kernels import library

    dev = q.device
    ins = [x.contiguous() for x in (q, k, v, i_c, logf, C0, n0, m0)]
    h = torch.empty((B, Tp, H * dv), dtype=q.dtype, device=dev)
    C_T = torch.empty_like(ins[5])
    n_T = torch.empty_like(ins[6])
    m_T = torch.empty_like(ins[7])
    lib = library("mlstm_fused")
    # per (b, h): each chunk's entry state (NC·(dqk·dv + dqk) floats) and the
    # per-row and per-chunk gate terms
    work = torch.empty(lib.mlstm_fused_fwd_work(B, H, Tp, dqk, dv, L), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.mlstm_fused_fwd(
            _DTYPE_CODE[q.dtype], *_ptrs(*ins, h, C_T, n_T, m_T, work), B, H, Tp, T, dqk, dv, L,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"mlstm_fused_fwd launch failed: cudaError {err}")
    mlstm_fused_fwd.launches += 1
    return h, C_T, n_T, m_T


mlstm_fused_fwd.launches = 0


def mlstm_fused_bwd(q, k, v, i_c, logf, C0, n0, m0, dh, dC_T, dn_T, dm_T, chunk: int,
                    T: int):
    """K9b: (dq, dk, dv in their inputs' dtypes, dĩ, dlogf (B, H, Tp), dC0,
    dn0, dm0 f32).  On CUDA tensors this launches ``mlstm_fused_bwd`` and
    counts it in ``mlstm_fused_bwd.launches``; on CPU tensors it runs the
    plain version."""
    if not q.is_cuda:
        return mlstm_fused_bwd_ref(q, k, v, i_c, logf, C0, n0, m0, dh, dC_T, dn_T, dm_T,
                                   chunk, T)
    B, Tp, H, dqk, dv, L = _check(q, k, v, i_c, logf, C0, n0, m0, chunk, T, bwd=True)
    if dh.shape != (B, Tp, H * dv) or dh.dtype != q.dtype:
        raise ValueError(f"dh {tuple(dh.shape)} {dh.dtype} must be {(B, Tp, H * dv)} {q.dtype}")
    from statecatcher_tpu_torch.ops._kernels import library

    dev = q.device
    ins = [x.contiguous() for x in (q, k, v, i_c, logf, C0, n0, m0, dh)]
    cots = [x.to(torch.float32).contiguous() for x in (dC_T, dn_T, dm_T)]
    dq, dk, dv_ = (torch.empty_like(x) for x in ins[:3])
    dic, dlf = torch.empty_like(ins[3]), torch.empty_like(ins[4])
    dC0, dn0, dm0 = (torch.empty_like(x) for x in ins[5:8])
    lib = library("mlstm_fused")
    # per (b, h): each chunk's entry state and exit adjoints (NC·(dqk·dv +
    # dqk) floats each), per-row and per-chunk gate terms, dg's partial sums
    work = torch.empty(lib.mlstm_fused_bwd_work(B, H, Tp, dqk, dv, L), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.mlstm_fused_bwd(
            _DTYPE_CODE[q.dtype], *_ptrs(*ins, *cots, dq, dk, dv_, dic, dlf, dC0, dn0, dm0, work),
            B, H, Tp, T, dqk, dv, L, _stream(dev))
    if err != 0:
        raise RuntimeError(f"mlstm_fused_bwd launch failed: cudaError {err}")
    mlstm_fused_bwd.launches += 1
    return dq, dk, dv_, dic, dlf, dC0, dn0, dm0


mlstm_fused_bwd.launches = 0


class _MLSTMFused(torch.autograd.Function):
    """K9a forward, K9b backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, i_c, logf, C0, n0, m0, chunk, T):
        out = mlstm_fused_fwd(q, k, v, i_c, logf, C0, n0, m0, chunk, T)
        ctx.save_for_backward(q, k, v, i_c, logf, C0, n0, m0)
        ctx.chunk, ctx.T = chunk, T
        return out

    @staticmethod
    def backward(ctx, dh, dC_T, dn_T, dm_T):
        # unused outputs arrive as zeros (autograd materialises them)
        saved = ctx.saved_tensors
        grads = mlstm_fused_bwd(*saved, dh.to(saved[0].dtype), dC_T, dn_T, dm_T,
                                ctx.chunk, ctx.T)
        return (*grads, None, None)


def mlstm_fused(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size: int,
                gate_soft_cap: float = 15.0):
    """Layer-facing entry: lane-major q, k (B, T, H·dqk) and v (B, T, H·dv)
    straight from the projections, raw gates (B, T, H), carry (C0, n0, m0).
    Returns (h (B, T, H·dv) in q's dtype, C_T, n_T, m_T f32), differentiable
    in every input: K9a/K9b on CUDA tensors, their plain versions on CPU
    tensors."""
    T = q.shape[1]
    L = min(chunk_size, max(8, T))
    pad = (-T) % L
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        i_raw, f_raw = (F.pad(x, (0, 0, 0, pad)) for x in (i_raw, f_raw))
    cdt = torch.promote_types(i_raw.dtype, torch.float32)
    i_c = soft_cap(i_raw.to(cdt), gate_soft_cap).transpose(1, 2)      # (B, H, Tp)
    logf = F.logsigmoid(soft_cap(f_raw.to(cdt), gate_soft_cap)).transpose(1, 2)
    sdt = torch.promote_types(C0.dtype, torch.float32)
    h, C_T, n_T, m_T = _MLSTMFused.apply(q, k, v, i_c.contiguous(), logf.contiguous(),
                                         C0.to(sdt), n0.to(sdt), m0.to(sdt), L, T)
    return (h[:, :T] if pad else h), C_T, n_T, m_T
