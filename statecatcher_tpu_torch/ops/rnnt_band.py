"""Banded (pruned) RNN-T: the joint and the lattice restricted to a diagonal
band of the (t, u) plane.  K8a (forward) and K8b (backward), and the banded
lattice.

Port of ``statecatcher_tpu/ops/rnnt_band.py``.  Per utterance and time block
of ``time_block`` frames, u is restricted to a window of Wp label positions
starting at ``band_offsets`` (8-aligned, non-decreasing, covering each
utterance's corner (t_len − 1, u_len)); the loss is the log-sum over the
in-band monotone paths, and equals the exact one when the band is at least
U + 1.  ``time_block`` is part of the function here (one band start per
block, and Wp depends on it), not a tiling.

Replaces the TPU kernels ``_fwd_kernel`` (:80, launched by
``_banded_fwd_impl``, :157) and ``_bwd_kernel`` (:100, launched by
``_banded_core_bwd``, :206) with the kernels of ``ops/csrc/rnnt_band.cu``
(K6's kernels over the band's rows, ``ops/csrc/rnnt_joint_core.cuh``):

  forward   per row (b, t, w) at u = o[b, t // time_block] + w:
            joint = tanh(enc_t + pred_u), logits = joint·K + bias;
            blank = logits[blank_id] − lse, emit = logits[label_u] − lse
            (B, Tp, Wp) f32; frames t ≥ T read enc as 0, positions u ≥ U+1
            pred as 0, positions u ≥ U select no label (emit = −lse).  The
            per-row lse is kept for the backward.
  backward  K6's d_logits, d_joint, d_enc, d_K and d_bias over the band's
            rows; d_pred sums each window's rows back at their u, over the
            overlapping windows of neighbouring blocks, in a fixed order.

The banded lattice is an XLA scan with autodiff in the JAX package
(``rnnt_nll_banded``, :319), no TPU kernel; here it runs in the port's own
kernels ``rnnt_band_alpha`` and ``rnnt_band_beta`` of
``ops/csrc/rnnt_lattice.cu`` (an anti-diagonal wavefront, one warp a batch
row, ``ops/csrc/rnnt_wavefront.cuh``): α forward, β and the in-band
occupancies backward, as K7 does for the exact lattice.

With bf16 projections the joint, K, the bias and d_logits entering the
logits or a product are rounded to bf16 (the JAX kernel's bf16 matmul over
its padded kernel matrix, whose row J holds the bias); the emit logit uses
the f32 joint, K and bias.

Bounds on the card: the joint as K6 at R = B·Tp·Wp rows (operations); the
lattice by its bytes, though its chain of anti-diagonals sets its time.
Each wrapper runs its plain version only for tensors on the CPU; on the
card it launches its kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from statecatcher_tpu_torch.ops.rnnt_joint import (
    _PLAIN_CHUNK,
    _check_err,
    _kernel_args,
    _plain_inputs,
    bwd_plan,
    fwd_operands,
    plain_logits,
)
from statecatcher_tpu_torch.ops.rnnt_lattice import NEG, chain_scan

_MAX_WP = 1024          # rnnt_wavefront.cuh: at most 32 window cells a lane
_SENTINEL = 1e30        # the NLL of a row whose band never holds its corner


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def band_width(band: int, u1: int, time_block: int) -> int:
    """The realised window width Wp of a requested ``band`` at U+1 = ``u1``:
    room for the in-block drift of the diagonal, 8-aligned."""
    return _round_up(min(band + 8 + time_block, u1 + 8), 8)


def band_offsets(t_lens: torch.Tensor, u_lens: torch.Tensor, Tp: int, U1p: int, Wp: int,
                 time_block: int) -> torch.Tensor:
    """Per-(utterance, time block) band starts (B, Tp // time_block) int32:
    8-aligned, clipped, non-decreasing, covering each corner; the same
    integers as the JAX package's (float32 slope and centre, round half to
    even)."""
    nblocks = Tp // time_block
    dev = t_lens.device
    t_lens, u_lens = t_lens.to(torch.int64), u_lens.to(torch.int64)
    # the band is centred on the diagonal at each block's END
    tb_end = ((torch.arange(nblocks, device=dev) + 1) * time_block).to(torch.float32)
    slope = u_lens.to(torch.float32) / torch.clamp(t_lens.to(torch.float32), min=1.0)
    center = tb_end[None, :] * slope[:, None]
    o = torch.clamp(torch.round(center - Wp / 2), 0.0, float(U1p - Wp))
    o = (o.to(torch.int64) // 8) * 8
    # the last block of each utterance must hold u_len
    blk = torch.arange(nblocks, device=dev)[None, :]
    last_blk = (torch.clamp(t_lens - 1, min=0) // time_block)[:, None]
    lo_req = torch.clamp(((u_lens - Wp + 8) // 8) * 8, 0, U1p - Wp)[:, None]
    hi_req = torch.clamp((u_lens // 8) * 8, 0, U1p - Wp)[:, None]
    o = torch.where(blk == last_blk, torch.minimum(torch.maximum(o, lo_req), hi_req), o)
    # every path starts at (0, 0); the offsets never decrease; frozen past
    # the last frame, so the last α row keeps its coordinates
    o[:, 0] = 0
    o = torch.cummax(o, dim=1).values
    o = torch.where(blk > last_blk, torch.gather(o, 1, last_blk), o)
    return o.to(torch.int32)


# --------------------------------------------------------------------------- #
# The banded joint: plain versions
# --------------------------------------------------------------------------- #
def _window(pred, labels, o, Wp, V):
    """Each (b, block)'s window: the index of its positions (B, nblk, Wp),
    its prediction rows (B, nblk, Wp, J), zero past U+1, and its labels
    (B, nblk, Wp), −1 where a position selects no column."""
    B, U1, J = pred.shape
    nblk = o.shape[1]
    idx = o.to(torch.int64)[:, :, None] + torch.arange(Wp, device=pred.device)
    U1p = max(_round_up(max(U1, Wp), 8), int(idx.max()) + 1)
    flat = idx.reshape(B, -1)
    predw = torch.gather(F.pad(pred, (0, 0, 0, U1p - U1)), 1, flat[:, :, None].expand(-1, -1, J))
    lab = F.pad(labels.to(torch.int64), (0, U1p - labels.shape[1]), value=-1)
    lab = torch.where((lab >= 0) & (lab < V), lab, -1)
    labw = torch.gather(lab, 1, flat)
    return idx, predw.reshape(B, nblk, Wp, J), labw.reshape(B, nblk, Wp), U1p


def _block_chunks(nblk: int, time_block: int):
    step = max(1, _PLAIN_CHUNK // time_block)
    for k0 in range(0, nblk, step):
        yield k0, min(nblk, k0 + step)


def joint_blank_emit_banded_ref(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp: int,
                                time_block: int = 8, blank_id: int = 0, matmul=torch.matmul):
    """Plain K8a: (blank, emit, lse), each (B, Tp, Wp), in f32 (f64 for f64
    inputs); per chunk of blocks, tanh, matmul, logsumexp and gathers.
    ``matmul`` takes the logits' contraction, as in K6a's plain version."""
    cdt, bf, enc, pred, K, bias, Km, bias_m = _plain_inputs(enc_p, pred_p, join_kernel, join_bias)
    B, T, J = enc.shape
    V = K.shape[1]
    nblk, Tb = o.shape[1], time_block
    _, predw, labw, _ = _window(pred, labels, o, Wp, V)
    has = labw >= 0
    lab0 = labw.clamp(min=0)
    k_lab = K.t()[lab0] * has[..., None].to(cdt)                 # (B, nblk, Wp, J)
    b_lab = bias[lab0] * has.to(cdt)
    encb = F.pad(enc, (0, 0, 0, nblk * Tb - T)).reshape(B, nblk, Tb, 1, J)
    blank, emit, lse = (torch.empty((B, nblk, Tb, Wp), dtype=cdt, device=enc.device)
                        for _ in range(3))
    for k0, k1 in _block_chunks(nblk, Tb):
        joint = torch.tanh(encb[:, k0:k1] + predw[:, k0:k1, None])  # (B, nb, Tb, Wp, J)
        _, logits = plain_logits(joint, Km, bias_m, bf, matmul)
        ls = torch.logsumexp(logits, dim=-1)
        lse[:, k0:k1] = ls
        blank[:, k0:k1] = logits[..., blank_id] - ls
        emit[:, k0:k1] = ((joint * k_lab[:, k0:k1, None]).sum(-1) + b_lab[:, k0:k1, None] - ls)
    return tuple(x.reshape(B, nblk * Tb, Wp) for x in (blank, emit, lse))


def joint_blank_emit_banded_bwd_ref(enc_p, pred_p, join_kernel, join_bias, labels, o, lse,
                                    g_blank, g_emit, time_block: int = 8, blank_id: int = 0,
                                    matmul=torch.matmul):
    """Plain K8b: (d_enc (B, T, J), d_pred (B, U+1, J), d_kernel (J, V),
    d_bias (V,)) in f32 (f64 for f64 inputs), from the forward's lse and the
    cotangents of the banded blank and emit (B, Tp, Wp).  ``matmul`` takes
    its three contractions, as in K6b's plain version."""
    cdt, bf, enc, pred, K, _, Km, bias_m = _plain_inputs(enc_p, pred_p, join_kernel, join_bias)
    B, T, J = enc.shape
    U1, V = pred.shape[1], K.shape[1]
    nblk, Tb, Wp = o.shape[1], time_block, lse.shape[2]
    dev = enc.device
    idx, predw, labw, U1p = _window(pred, labels, o, Wp, V)
    lab0 = labw.clamp(min=0)
    encb = F.pad(enc, (0, 0, 0, nblk * Tb - T)).reshape(B, nblk, Tb, 1, J)
    rows = lambda x: x.to(cdt).reshape(B, nblk, Tb, Wp)
    lse, g_blank, g_emit = rows(lse), rows(g_blank), rows(g_emit)
    g_onehot = g_emit * (labw >= 0)[:, :, None]              # no column: no one-hot term
    d_enc = torch.empty((B, nblk, Tb, J), dtype=cdt, device=dev)
    d_predw = torch.empty((B, nblk, Wp, J), dtype=cdt, device=dev)
    d_k = torch.zeros((J, V), dtype=cdt, device=dev)
    d_b = torch.zeros((V,), dtype=cdt, device=dev)
    for k0, k1 in _block_chunks(nblk, Tb):
        joint = torch.tanh(encb[:, k0:k1] + predw[:, k0:k1, None])  # (B, nb, Tb, Wp, J)
        jm, logits = plain_logits(joint, Km, bias_m, bf, matmul)
        gb, ge = g_blank[:, k0:k1], g_emit[:, k0:k1]
        dlog = -(gb + ge)[..., None] * torch.exp(logits - lse[:, k0:k1, ..., None])
        dlog[..., blank_id] += gb
        sel = lab0[:, k0:k1, None, :, None].expand(-1, -1, Tb, -1, 1)
        dlog.scatter_add_(4, sel, g_onehot[:, k0:k1, ..., None])
        if bf:
            dlog = dlog.to(torch.bfloat16).to(cdt)
        dj = matmul(dlog, Km.t()) * (1.0 - joint * joint)
        d_enc[:, k0:k1] = dj.sum(3)
        d_predw[:, k0:k1] = dj.sum(2)
        d_k += matmul(jm.reshape(-1, J).t(), dlog.reshape(-1, V))
        d_b += dlog.reshape(-1, V).sum(0)
    d_pred = torch.zeros((B, U1p, J), dtype=cdt, device=dev).scatter_add_(
        1, idx.reshape(B, -1, 1).expand(-1, -1, J), d_predw.reshape(B, -1, J))
    return d_enc.reshape(B, nblk * Tb, J)[:, :T], d_pred[:, :U1], d_k, d_b


# --------------------------------------------------------------------------- #
# The banded joint: kernel wrappers
# --------------------------------------------------------------------------- #
def _band_args(o, B, T, Wp, time_block, dev):
    """Check the band's geometry; return o as contiguous int32 and Tp."""
    if o.ndim != 2 or o.shape[0] != B or o.device != dev:
        raise ValueError(f"o {tuple(o.shape)} on {o.device} must be (B={B}, nblocks) on {dev}")
    Tp = o.shape[1] * time_block
    if time_block <= 0 or time_block % 8 or Tp < T or Wp <= 0 or Wp % 8 or Wp > _MAX_WP:
        raise ValueError(f"unsupported band: time_block {time_block} (a multiple of 8), "
                         f"{o.shape[1]} blocks for T={T}, Wp={Wp} (a multiple of 8, at most "
                         f"{_MAX_WP})")
    return o.to(torch.int32).contiguous(), Tp


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def rnnt_band_fwd(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp: int,
                  time_block: int = 8, blank_id: int = 0):
    """K8a on CUDA tensors: (blank, emit, lse), each (B, Tp, Wp) f32,
    counted in ``rnnt_band_fwd.launches`` (K's operand form and the forward,
    one launch); the plain version on CPU tensors."""
    if not enc_p.is_cuda:
        return joint_blank_emit_banded_ref(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp,
                                           time_block, blank_id)
    args, (B, T, U1, J, V, bf) = _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels,
                                              blank_id)
    dev = enc_p.device
    o32, Tp = _band_args(o, B, T, Wp, time_block, dev)
    from statecatcher_tpu_torch.ops._kernels import library

    ops = fwd_operands("rnnt_band", args, J, V, bf)
    blank, emit, lse = (torch.empty((B, Tp, Wp), dtype=torch.float32, device=dev)
                        for _ in range(3))
    with torch.cuda.device(dev):
        err = library("rnnt_band").rnnt_band_fwd(
            *(a.data_ptr() for a in ops), o32.data_ptr(), blank.data_ptr(), emit.data_ptr(),
            lse.data_ptr(), B, T, U1, J, V, Tp, Wp, time_block, blank_id, int(bf), _stream(dev))
    _check_err("rnnt_band_fwd", err)
    rnnt_band_fwd.launches += 1
    return blank, emit, lse


rnnt_band_fwd.launches = 0


def rnnt_band_bwd(enc_p, pred_p, join_kernel, join_bias, labels, o, lse, g_blank, g_emit,
                  time_block: int = 8, blank_id: int = 0):
    """K8b on CUDA tensors: (d_enc (B, T, J), d_pred (B, U+1, J), d_kernel,
    d_bias) f32 from the forward's lse and the cotangents of the banded
    blank and emit, counted in ``rnnt_band_bwd.launches`` (its three
    kernels are one launch of K8b); the plain version on CPU tensors."""
    if not enc_p.is_cuda:
        return joint_blank_emit_banded_bwd_ref(enc_p, pred_p, join_kernel, join_bias, labels, o,
                                               lse, g_blank, g_emit, time_block, blank_id)
    args, (B, T, U1, J, V, bf) = _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels,
                                              blank_id)
    dev = enc_p.device
    Wp = lse.shape[-1]
    o32, Tp = _band_args(o, B, T, Wp, time_block, dev)
    for name, t in (("lse", lse), ("g_blank", g_blank), ("g_emit", g_emit)):
        if t.shape != (B, Tp, Wp):
            raise ValueError(f"{name} {tuple(t.shape)} must be (B, Tp, Wp) = {(B, Tp, Wp)}")
    from statecatcher_tpu_torch.ops._kernels import library

    f32 = lambda t: t.to(torch.float32).contiguous()
    rows = (f32(lse), f32(g_blank), f32(g_emit))
    lay = bwd_plan("rnnt_band", dev, B, Tp, Wp, J, V, 8, bf)  # rnnt_band.cu: 8 × 16 patches
    nsplit = lay["nsplit"]
    d_enc_part = torch.empty((B, Tp, lay["n_grp"], J), dtype=torch.float32, device=dev)
    d_pred_part = torch.empty((B, lay["n_t"], Wp, J), dtype=torch.float32, device=dev)
    dk_part = torch.empty((nsplit, J, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((nsplit, V), dtype=torch.float32, device=dev)
    d_pred = torch.empty((B, U1, J), dtype=torch.float32, device=dev)
    rec = torch.empty((6, lay["rec_rows"]), dtype=torch.int32, device=dev)
    kop = torch.empty(lay["kop_words"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library("rnnt_band").rnnt_band_bwd(
            *(a.data_ptr() for a in args), o32.data_ptr(), *(r.data_ptr() for r in rows),
            d_enc_part.data_ptr(), d_pred_part.data_ptr(), dk_part.data_ptr(),
            db_part.data_ptr(), d_pred.data_ptr(), rec.data_ptr(), kop.data_ptr(), B, T, U1, J,
            V, Tp, Wp, time_block, blank_id, int(bf), nsplit, _stream(dev))
    _check_err("rnnt_band_bwd", err)
    rnnt_band_bwd.launches += 1
    return d_enc_part.sum(2)[:, :T], d_pred, dk_part.sum(0), db_part.sum(0)


rnnt_band_bwd.launches = 0


class _BandedJoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_p, pred_p, join_kernel, join_bias, labels, o, Wp, time_block, blank_id):
        blank, emit, lse = rnnt_band_fwd(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp,
                                         time_block, blank_id)
        ctx.save_for_backward(enc_p, pred_p, join_kernel, join_bias, labels, o, lse)
        ctx.cfg = (time_block, blank_id)
        return blank, emit

    @staticmethod
    def backward(ctx, g_blank, g_emit):
        enc_p, pred_p, join_kernel, join_bias, labels, o, lse = ctx.saved_tensors
        if g_blank is None:
            g_blank = torch.zeros_like(lse)
        if g_emit is None:
            g_emit = torch.zeros_like(lse)
        d_enc, d_pred, d_k, d_b = rnnt_band_bwd(enc_p, pred_p, join_kernel, join_bias, labels, o,
                                                lse, g_blank, g_emit, *ctx.cfg)
        return (d_enc.to(enc_p.dtype), d_pred.to(pred_p.dtype), d_k.to(join_kernel.dtype),
                d_b.to(join_bias.dtype), None, None, None, None, None)


def joint_blank_emit_banded(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp: int,
                            blank_id: int = 0, time_block: int = 8):
    """Banded fused joint: (blank_b, emit_b), each (B, Tp, Wp) f32, where
    row w of time block k is u = o[b, k] + w; differentiable with respect to
    enc_p, pred_p, join_kernel and join_bias.  K8a/K8b on CUDA tensors, their
    plain versions on CPU tensors."""
    return _BandedJoint.apply(enc_p, pred_p, join_kernel, join_bias, labels, o, Wp, time_block,
                              blank_id)


# --------------------------------------------------------------------------- #
# The banded lattice
# --------------------------------------------------------------------------- #
def _frames(o, Tp, time_block):
    """(B, Tp) band start of every frame, int64."""
    return o.to(torch.int64)[:, torch.arange(Tp, device=o.device) // time_block]


def _last_frame(t_lens, Tp):
    """(B,) index of the last frame the lattice runs: frame 0 always runs."""
    return torch.clamp(t_lens.to(torch.int64), 1, Tp) - 1


def _corner(o, t_lens, u_lens, Tp, Wp, time_block):
    """(t_last, w* clipped into the window, covered): the corner's frame and
    window column, and whether the band holds it."""
    t_last = _last_frame(t_lens, Tp)
    o_fin = torch.gather(_frames(o, Tp, time_block), 1, t_last[:, None])[:, 0]
    w_raw = u_lens.to(torch.int64) - o_fin
    return t_last, torch.clamp(w_raw, 0, Wp - 1), (w_raw >= 0) & (w_raw < Wp)


def rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, time_block: int = 8):
    """Plain banded α (B, Tp, Wp) in f32 (f64 for f64 inputs): the frame loop
    with the window shift and the log-step chain scan; frames past the last
    repeat it."""
    cdt = torch.promote_types(blank_b.dtype, torch.float32)
    bl, em = blank_b.to(cdt), emit_b.to(cdt)
    B, Tp, Wp = bl.shape
    dev = bl.device
    o_t = _frames(o, Tp, time_block)
    lane = torch.arange(Wp, device=dev)[None, :]
    first = torch.full((B, 1), NEG, dtype=cdt, device=dev)
    carry = torch.cat([torch.zeros_like(first), first.expand(B, Wp - 1)], dim=1)
    live = (_last_frame(t_lens, Tp) + 1).to(dev)[:, None]
    rows = []
    for t in range(Tp):
        base = carry
        if t > 0:
            src = lane + (o_t[:, t] - o_t[:, t - 1])[:, None]
            base = torch.gather(carry + bl[:, t - 1], 1, src.clamp(max=Wp - 1))
            base = torch.where(src < Wp, base, NEG)
        x = chain_scan(torch.cat([first, em[:, t, :-1]], dim=1), base)
        carry = torch.where(t < live, x, carry)
        rows.append(carry)
    return torch.stack(rows, dim=1)


def rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, time_block: int = 8):
    """Plain banded β (B, Tp, Wp) in f32 (f64 for f64 inputs), walking time
    backwards from the virtual base (0 at the corner's column, −1e30
    elsewhere, all −1e30 when the band misses the corner), which frames past
    the last hold."""
    cdt = torch.promote_types(blank_b.dtype, torch.float32)
    bl, em = blank_b.to(cdt), emit_b.to(cdt)
    B, Tp, Wp = bl.shape
    dev = bl.device
    o_t = _frames(o, Tp, time_block)
    t_last = _last_frame(t_lens, Tp).to(dev)
    w_star = u_lens.to(dev).to(torch.int64) - torch.gather(o_t, 1, t_last[:, None])[:, 0]
    lane = torch.arange(Wp, device=dev)[None, :]
    carry = torch.where(lane == w_star[:, None], 0.0, NEG).to(cdt)
    last = torch.full((B, 1), NEG, dtype=cdt, device=dev)
    out = torch.empty((B, Tp, Wp), dtype=cdt, device=dev)
    for t in range(Tp - 1, -1, -1):
        nb = carry
        if t + 1 < Tp:
            src = lane - (o_t[:, t + 1] - o_t[:, t])[:, None]
            nb = torch.where(src >= 0, torch.gather(carry, 1, src.clamp(min=0)), NEG)
        x = chain_scan(torch.cat([em[:, t, :-1], last], dim=1), bl[:, t] + nb, reverse=True)
        carry = torch.where(t <= t_last[:, None], x, carry)
        out[:, t] = carry
    return out


def _lattice_args(blank_b, emit_b, o, lens, time_block):
    if blank_b.dtype != torch.float32 or emit_b.dtype != torch.float32:
        raise TypeError(f"blank and emit must be float32, got {blank_b.dtype}, {emit_b.dtype}")
    if blank_b.ndim != 3 or emit_b.shape != blank_b.shape:
        raise ValueError(f"blank {tuple(blank_b.shape)} and emit {tuple(emit_b.shape)} must "
                         "both be (B, Tp, Wp)")
    if not (blank_b.is_contiguous() and emit_b.is_contiguous()):
        raise ValueError("blank and emit must be contiguous")
    B, Tp, Wp = blank_b.shape
    dev = blank_b.device
    o32, _ = _band_args(o, B, Tp, Wp, time_block, dev)
    if o.shape[1] * time_block != Tp:
        raise ValueError(f"o has {o.shape[1]} blocks of {time_block} frames for Tp={Tp}")
    for t in lens:
        if t.shape != (B,) or t.device != dev:
            raise ValueError(f"lengths {tuple(t.shape)} on {t.device} must be ({B},) on {dev}")
    return (B, Tp, Wp), o32, [t.to(torch.int32).contiguous() for t in lens]


def _launch_lattice(fn_name, blank_b, emit_b, o, lens, time_block):
    (B, Tp, Wp), o32, lens32 = _lattice_args(blank_b, emit_b, o, lens, time_block)
    from statecatcher_tpu_torch.ops._kernels import library

    # the kernel copies whole table rows 16 bytes at a time
    blank_b, emit_b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (blank_b, emit_b))

    dev = blank_b.device
    out = torch.empty((B, Tp, Wp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(library("rnnt_lattice"), fn_name)(
            blank_b.data_ptr(), emit_b.data_ptr(), o32.data_ptr(),
            *(t.data_ptr() for t in lens32), out.data_ptr(), B, Tp, Wp, time_block,
            _stream(dev))
    _check_err(fn_name, err)
    return out


def rnnt_band_alpha(blank_b, emit_b, o, t_lens, time_block: int = 8):
    """Banded α (B, Tp, Wp): on CUDA tensors the kernel ``rnnt_band_alpha``,
    counted in ``rnnt_band_alpha.launches``; on CPU tensors the plain
    version."""
    if not blank_b.is_cuda:
        return rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, time_block)
    out = _launch_lattice("rnnt_band_alpha", blank_b, emit_b, o, [t_lens], time_block)
    rnnt_band_alpha.launches += 1
    return out


rnnt_band_alpha.launches = 0


def rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, time_block: int = 8):
    """Banded β (B, Tp, Wp): on CUDA tensors the kernel ``rnnt_band_beta``,
    counted in ``rnnt_band_beta.launches``; on CPU tensors the plain
    version."""
    if not blank_b.is_cuda:
        return rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, time_block)
    out = _launch_lattice("rnnt_band_beta", blank_b, emit_b, o, [t_lens, u_lens], time_block)
    rnnt_band_beta.launches += 1
    return out


rnnt_band_beta.launches = 0


def band_nll_from_alpha(alpha, blank_b, o, t_lens, u_lens, time_block: int = 8):
    """(B,) NLL −(α + blank) at the corner (t_last, w*), or 1e30 for a row
    whose band never holds its corner."""
    B, Tp, Wp = alpha.shape
    t_last, w_star, covered = _corner(o, t_lens, u_lens, Tp, Wp, time_block)
    rows = torch.arange(B, device=alpha.device)
    nll = -(alpha[rows, t_last, w_star] + blank_b[rows, t_last, w_star])
    return torch.where(covered, nll, torch.full_like(nll, _SENTINEL))


def frame_log_z(log_blank_path: torch.Tensor) -> torch.Tensor:
    """(B, Tp, 1) log Z_t from the log path weights through each blank edge
    (α + blank + β of the next frame): every path leaves each frame up to
    its last by exactly one blank edge, so each frame's blank weights sum to
    Z.  The banded occupancies divide by Z_t, not by the forward's single Z:
    in float32 at NLLs ~1e4, α's and β's Z differ by up to 4e-2 in log
    (measured on the card), which would scale every occupancy by as much,
    differently in the kernels and their plain versions.  With Z_t each
    frame's blank occupancies sum to one, as the JAX package's autodiff
    through its scan keeps each step normalised."""
    return torch.logsumexp(log_blank_path, dim=2, keepdim=True)


def band_occupancy_grads(blank_b, emit_b, o, t_lens, u_lens, alpha, beta, nll, g,
                         time_block: int = 8):
    """(∂/∂blank_b, ∂/∂emit_b) of Σ g·nll from the banded α and β: the
    in-band edge occupancies, each frame's normalised by its own Z_t
    (``rnnt_lattice.frame_log_z``), exponents clipped to ±80, zero on frames
    past the last and on rows whose band misses the corner."""
    B, Tp, Wp = blank_b.shape
    dev, cdt = alpha.device, alpha.dtype
    t_last, w_star, covered = _corner(o, t_lens, u_lens, Tp, Wp, time_block)
    o_t = _frames(o, Tp, time_block)
    lane = torch.arange(Wp, device=dev)
    # β of frame t+1 moved into frame t's window (the virtual base past Tp)
    base = torch.where(covered[:, None] & (lane[None] == w_star[:, None]), 0.0, NEG).to(cdt)
    beta_next = torch.cat([beta[:, 1:], base[:, None]], dim=1)
    step = torch.cat([o_t[:, 1:] - o_t[:, :-1], torch.zeros_like(o_t[:, :1])], dim=1)
    src = lane[None, None, :] - step[:, :, None]
    beta_next = torch.where(src >= 0, torch.gather(beta_next, 2, src.clamp(min=0)), NEG)
    path_blank = alpha + blank_b + beta_next
    log_z = frame_log_z(path_blank)
    keep = ((torch.arange(Tp, device=dev)[None, :, None] <= t_last[:, None, None])
            & covered[:, None, None])
    zero = torch.zeros((), dtype=cdt, device=dev)
    occ_blank = torch.exp(torch.clamp(path_blank - log_z, -80.0, 80.0))
    occ_emit = torch.exp(torch.clamp(alpha[..., :-1] + emit_b[..., :-1] + beta[..., 1:] - log_z,
                                     -80.0, 80.0))
    occ_emit = F.pad(occ_emit, (0, 1))                      # emit(t, Wp − 1) leads nowhere
    gs = -g.to(cdt)[:, None, None]
    return (torch.where(keep, occ_blank, zero) * gs, torch.where(keep, occ_emit, zero) * gs)


class _BandLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_b, emit_b, o, t_lens, u_lens, time_block):
        bl, em = blank_b.contiguous(), emit_b.contiguous()
        alpha = rnnt_band_alpha(bl, em, o, t_lens, time_block)
        nll = band_nll_from_alpha(alpha, bl.to(alpha.dtype), o, t_lens, u_lens, time_block)
        ctx.save_for_backward(bl, em, o, t_lens, u_lens, alpha, nll)
        ctx.time_block = time_block
        return nll

    @staticmethod
    def backward(ctx, g):
        bl, em, o, t_lens, u_lens, alpha, nll = ctx.saved_tensors
        tb = ctx.time_block
        beta = rnnt_band_beta(bl, em, o, t_lens, u_lens, tb)
        g_blank, g_emit = band_occupancy_grads(bl.to(alpha.dtype), em.to(alpha.dtype), o, t_lens,
                                               u_lens, alpha, beta, nll, g, tb)
        return g_blank.to(bl.dtype), g_emit.to(em.dtype), None, None, None, None


def rnnt_nll_banded(blank_b, emit_b, o, t_lens, u_lens, time_block: int = 8):
    """Per-utterance NLL (B,) over the in-band paths of the banded tables
    (B, Tp, Wp) with band starts ``o`` (B, Tp // time_block); 1e30 for a row
    whose band never holds its corner.  The banded α kernel forward, β and
    the occupancies backward (their plain versions on the CPU)."""
    return _BandLattice.apply(blank_b, emit_b, o, t_lens, u_lens, time_block)


def rnnt_loss_banded(enc_proj, pred_proj, join_kernel, join_bias, labels, t_lens, u_lens,
                     blank_id: int = 0, row_valid=None, time_block: int = 8, band: int = 48,
                     return_per: bool = False):
    """Banded transducer loss: the mean over valid rows of the in-band NLL.
    ``band`` is the requested width in u (realised as ``band_width``).  A row
    whose band prunes every path (NLL ≥ 1e29) is zeroed and left out of the
    mean, as the JAX package does."""
    B, T, _ = enc_proj.shape
    U1 = pred_proj.shape[1]
    Wp = band_width(band, U1, time_block)
    Tp = _round_up(T, time_block)
    U1p = _round_up(max(U1, Wp), 8)
    o = band_offsets(t_lens, u_lens, Tp, U1p, Wp, time_block)
    blank_b, emit_b = joint_blank_emit_banded(enc_proj, pred_proj, join_kernel, join_bias, labels,
                                              o, Wp, blank_id=blank_id, time_block=time_block)
    per = rnnt_nll_banded(blank_b, emit_b, o, t_lens, u_lens, time_block)
    ok = per < 1e29
    per = torch.where(ok, per, torch.zeros_like(per))      # where, not ×: NaN·0 = NaN
    finite = ok.to(per.dtype)
    valid = finite if row_valid is None else row_valid.to(per.dtype) * finite
    loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return (loss, per) if return_per else loss
