"""Fused RNN-T joint → (blank, emit) log-probs: K6a forward, K6b backward.

Replaces the TPU kernels of ``statecatcher_tpu/ops/rnnt_pallas.py``:
``_fwd_kernel`` (:72, launched by ``_core_fwd_impl``, :155) and
``_bwd_kernel`` (:92, launched by ``_core_bwd``, :196), with the kernels of
``ops/csrc/rnnt_joint.cu``.  The transducer loss only reads two slices of the
joint distribution, so the (B, T, U+1, V) logits never reach device memory:

  forward   joint = tanh(enc_t + pred_u); logits = joint·K + bias;
            blank = logits[blank_id] − lse, emit = logits[label_u] − lse;
            the per-row lse (B, T, U+1) is kept for the backward (the TPU
            kernel recomputed it: it is small)
  backward  d_logits = g_b·δ_blank + g_e·onehot(label) − (g_b + g_e)·softmax;
            d_joint = d_logits·Kᵀ ⊙ (1 − joint²), summed over u (d_enc) and
            over t (d_pred); d_K = Σ jointᵀ·d_logits and d_bias = Σ d_logits.
            The kernels write partial sums (d_enc and d_pred per patch of
            16 frames × 8 label positions, d_K and d_bias per row split)
            and this wrapper adds them up: deterministic, no atomics

With bf16 enc/pred the joint, K, the bias and d_logits entering the logits or
a product are rounded to bf16 and the sums are f32 (the JAX kernel's bf16
matmul with f32 accumulation over its padded kernel matrix, whose row J holds
the bias); the emit logit uses the f32 joint, K and bias (the JAX kernel's
gathered emit column, which ``emit_columns`` gathers here for the forward
kernel).  Outputs are float32 (float64 in the plain version for float64
inputs); gradients come back in the inputs' dtypes.

Bounds on the card (operations; see the source): at B=32, T=1598, U=48,
J=64, V=1024 the forward is 3.3e11 flops of contraction, the backward three
times that (the logits once more, d_joint, d_K); the kernels of both take
them on the tensor cores (3xTF32 for f32 inputs, bf16 for bf16 inputs).
Above J = 128 the kernels take the same function as tiled products over
chunks of rows (``wide_chunk_rows``), K's operand form and the chunk's
joint, logits or d_logits and d_joint in a scratch this wrapper allocates
(``wide_scratch_words``); J has no other limit.

``joint_blank_emit_ref`` and ``joint_blank_emit_bwd_ref`` are the plain
versions: per time chunk, tanh, matmul, logsumexp and gathers (backward:
softmax, the three products, sums).  Each wrapper runs its plain version only
for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import functools

import torch

from statecatcher_tpu_torch.ops.rnnt_lattice import rnnt_nll_dp_pallas

_NARROW_J = 128         # rnnt_joint_core.cuh's J ≤ 64 and J ≤ 128 instances; above, tiled products
_WIDE_ROWS = 65536      # its kWideRows: rows of a chunk of the tiled products
_PLAIN_CHUNK = 16       # frames per chunk of the plain versions
_PATCH_ROWS = 128       # rnnt_joint_core.cuh's kRT: rows of a backward patch
_DK_ROWS = 64           # its kDR: rows per tile of the d_K kernel
_DK_COLS = 128          # its kVS: vocab columns per block of the d_K kernel
_MAX_GRID_YZ = 65535    # CUDA's limit on a grid's y and z


def _plain_inputs(enc_p, pred_p, join_kernel, join_bias):
    """(compute dtype, bf16?, enc, pred, K, bias, and K and bias as the logits
    see them: rounded to bf16 under bf16 inputs)."""
    cdt = torch.promote_types(enc_p.dtype, torch.float32)
    bf = enc_p.dtype == torch.bfloat16
    K, bias = join_kernel.to(cdt), join_bias.to(cdt)
    rnd = lambda x: x.to(torch.bfloat16).to(cdt) if bf else x
    return cdt, bf, enc_p.to(cdt), pred_p.to(cdt), K, bias, rnd(K), rnd(bias)


def plain_logits(joint, Km, bias_m, bf, matmul=torch.matmul):
    """The joint's matmul operand (bf16-rounded under bf16) and its logits."""
    jm = joint.to(torch.bfloat16).to(joint.dtype) if bf else joint
    return jm, matmul(jm, Km) + bias_m


def _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1, matmul=torch.matmul):
    """The chunk's f32 joint, its matmul operand and its logits."""
    joint = torch.tanh(enc[:, t0:t1, None, :] + pred[:, None, :, :])
    return (joint, *plain_logits(joint, Km, bias_m, bf, matmul))


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def joint_blank_emit_ref(enc_p: torch.Tensor, pred_p: torch.Tensor, join_kernel: torch.Tensor,
                         join_bias: torch.Tensor, labels: torch.Tensor, blank_id: int = 0,
                         matmul=torch.matmul):
    """Plain K6a: (blank (B, T, U+1), emit (B, T, U), lse (B, T, U+1)).
    ``matmul`` takes the logits' contraction (the tests pass an emulation of
    the kernel's products)."""
    cdt, bf, enc, pred, K, bias, Km, bias_m = _plain_inputs(enc_p, pred_p, join_kernel, join_bias)
    B, T, _ = enc.shape
    U1 = pred.shape[1]
    U = U1 - 1
    lab = labels.to(torch.int64)
    k_lab = K.t()[lab]                                       # (B, U, J): K[:, label_u]
    b_lab = bias[lab]                                        # (B, U)
    blank = torch.empty((B, T, U1), dtype=cdt, device=enc.device)
    emit = torch.empty((B, T, U), dtype=cdt, device=enc.device)
    lse = torch.empty((B, T, U1), dtype=cdt, device=enc.device)
    for t0 in range(0, T, _PLAIN_CHUNK):
        t1 = min(T, t0 + _PLAIN_CHUNK)
        joint, _, logits = _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1, matmul)
        ls = torch.logsumexp(logits, dim=-1)
        lse[:, t0:t1] = ls
        blank[:, t0:t1] = logits[..., blank_id] - ls
        emit[:, t0:t1] = ((joint[:, :, :U] * k_lab[:, None]).sum(-1) + b_lab[:, None]
                          - ls[:, :, :U])
    return blank, emit, lse


def joint_blank_emit_bwd_ref(enc_p, pred_p, join_kernel, join_bias, labels, lse, g_blank,
                             g_emit, blank_id: int = 0, matmul=torch.matmul):
    """Plain K6b: (d_enc (B, T, J), d_pred (B, U+1, J), d_kernel (J, V),
    d_bias (V,)) in f32 (f64 for f64 inputs).  ``matmul`` takes its three
    contractions (the tests pass an emulation of the kernels' products)."""
    cdt, bf, enc, pred, K, _, Km, bias_m = _plain_inputs(enc_p, pred_p, join_kernel, join_bias)
    B, T, J = enc.shape
    U1 = pred.shape[1]
    U = U1 - 1
    V = K.shape[1]
    dev = enc.device
    lab = torch.cat([labels.to(torch.int64), torch.zeros((B, 1), dtype=torch.int64, device=dev)],
                    dim=1)                                   # u = U: g_e is 0 there
    d_enc = torch.empty((B, T, J), dtype=cdt, device=dev)
    d_pred = torch.zeros((B, U1, J), dtype=cdt, device=dev)
    d_k = torch.zeros((J, V), dtype=cdt, device=dev)
    d_b = torch.zeros((V,), dtype=cdt, device=dev)
    for t0 in range(0, T, _PLAIN_CHUNK):
        t1 = min(T, t0 + _PLAIN_CHUNK)
        joint, jm, logits = _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1, matmul)
        gb = g_blank[:, t0:t1].to(cdt)
        ge = torch.cat([g_emit[:, t0:t1].to(cdt),
                        torch.zeros((B, t1 - t0, 1), dtype=cdt, device=dev)], dim=2)
        dlog = -(gb + ge)[..., None] * torch.exp(logits - lse[:, t0:t1, :, None].to(cdt))
        dlog[..., blank_id] += gb
        dlog.scatter_add_(3, lab[:, None, :, None].expand(B, t1 - t0, U1, 1), ge[..., None])
        if bf:
            dlog = dlog.to(torch.bfloat16).to(cdt)
        dj = matmul(dlog, Km.t()) * (1.0 - joint * joint)
        d_enc[:, t0:t1] = dj.sum(2)
        d_pred += dj.sum(1)
        d_k += matmul(jm.reshape(-1, J).t(), dlog.reshape(-1, V))
        d_b += dlog.reshape(-1, V).sum(0)
    return d_enc, d_pred, d_k, d_b


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels, blank_id):
    """Check the kernels' inputs; return them as contiguous f32 / int32 and
    (B, T, U1, J, V, bf)."""
    if enc_p.ndim != 3 or pred_p.ndim != 3 or enc_p.shape[0] != pred_p.shape[0] \
            or enc_p.shape[2] != pred_p.shape[2]:
        raise ValueError(f"enc {tuple(enc_p.shape)} and pred {tuple(pred_p.shape)} must be "
                         "(B, T, J) and (B, U+1, J)")
    B, T, J = enc_p.shape
    U1 = pred_p.shape[1]
    if join_kernel.ndim != 2 or join_kernel.shape[0] != J:
        raise ValueError(f"join_kernel {tuple(join_kernel.shape)} must be ({J}, V)")
    V = join_kernel.shape[1]
    if join_bias.shape != (V,) or labels.shape != (B, U1 - 1):
        raise ValueError(f"join_bias {tuple(join_bias.shape)} or labels {tuple(labels.shape)} "
                         f"do not fit V={V}, B={B}, U={U1 - 1}")
    if min(B, T, U1, J, V) == 0:
        raise ValueError(f"unsupported joint shape B={B}, T={T}, U+1={U1}, J={J}, V={V}")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} outside the vocab of {V}")
    if enc_p.dtype not in (torch.float32, torch.bfloat16) or pred_p.dtype != enc_p.dtype:
        raise TypeError(f"enc and pred must both be float32 or bfloat16, got {enc_p.dtype}, "
                        f"{pred_p.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    for name, t in (("pred", pred_p), ("join_kernel", join_kernel), ("join_bias", join_bias),
                    ("labels", labels)):
        if t.device != enc_p.device:
            raise ValueError(f"{name} is on {t.device}, enc on {enc_p.device}")
    bf = enc_p.dtype == torch.bfloat16
    f32 = lambda t: t.to(torch.float32).contiguous()
    return ((f32(enc_p), f32(pred_p), f32(join_kernel), f32(join_bias),
             labels.to(torch.int32).contiguous()), (B, T, U1, J, V, bf))


def wide_chunk_rows(B: int, TT: int, W: int, patch_frames: int) -> int:
    """Rows of the largest chunk of the tiled products (J > 128; the
    source's ``WideChunks``): whole patch rows of ``patch_frames`` frames of
    one batch row, as many as fit in ``_WIDE_ROWS`` rows, one at least."""
    rows = patch_frames * W
    return min(B * TT * W, max(1, _WIDE_ROWS // rows) * rows)


def wide_scratch_words(B: int, TT: int, W: int, patch_frames: int, J: int, V: int,
                       backward: bool) -> int:
    """32-bit words of the tiled products' scratch (the source's
    ``WideScratch``, each region sized as f32): K's operand form (J × Vp),
    then a chunk's joint (rows × JW), logits or d_logits (rows × Vp) and,
    backward, d_joint (rows × J); JW = J + 1 and Vp = V rounded up to 8."""
    rows = wide_chunk_rows(B, TT, W, patch_frames)
    JW, Vp = -(-(J + 1) // 8) * 8, -(-V // 8) * 8
    return J * Vp + rows * (JW + Vp + (J if backward else 0))


def bwd_layout(B: int, TT: int, W: int, V: int, patch_frames: int, n_sm: int,
               blocks_per_sm: int, J: int = _NARROW_J) -> dict:
    """Grids and scratch sizes of the backward's rows and d_K kernels over
    B·TT·W rows.  The rows kernel: patches of ``patch_frames`` (PT) frames × 128/PT
    positions (PU), grid (ceil(W/PU), ceil(TT/PT), B), d_enc partials per
    group of 8 positions (``n_grp`` of them per frame) and d_pred partials
    per row of patches (``n_t``).  The d_K kernel: grid (ceil(V/128),
    ``nsplit``), the row splits chosen so that the grid is one wave of
    ``blocks_per_sm`` resident blocks on each of ``n_sm`` SMs, and never
    more splits than 64-row tiles; it reads the rows' records (offsets,
    label, cotangents, lse) from a (6, ``rec_rows``) int32 scratch, the rows
    padded to whole tiles.

    Above J = 128 the tiled products write the same partials.  Their d_K
    product: per chunk of ``chunk_rows`` rows (``wide_chunk_rows``) a grid
    (ceil(V/128), ceil((J+1)/64), ``nsplit``), the splits sized as above
    against the chunk's 64-row tiles; no row records (``rec_rows`` 0); a
    scratch of ``kop_words`` (``wide_scratch_words``)."""
    PU = _PATCH_ROWS // patch_frames
    n_w, n_t = -(-W // PU), -(-TT // patch_frames)
    n_vs = -(-V // _DK_COLS)
    lay = {"rows_grid": (n_w, n_t, B), "n_grp": n_w * PU // 8, "n_t": n_t}
    if J > _NARROW_J:
        chunk = wide_chunk_rows(B, TT, W, patch_frames)
        n_jt = -(-(J + 1) // _DK_ROWS)
        nsplit = max(1, min(-(-chunk // _DK_ROWS), blocks_per_sm * n_sm // (n_vs * n_jt)))
        return {**lay, "dk_grid": (n_vs, n_jt, nsplit), "nsplit": nsplit, "rec_rows": 0,
                "chunk_rows": chunk,
                "kop_words": wide_scratch_words(B, TT, W, patch_frames, J, V, True)}
    n_tiles = -(-(B * TT * W) // _DK_ROWS)
    nsplit = max(1, min(n_tiles, blocks_per_sm * n_sm // n_vs))
    return {**lay, "dk_grid": (n_vs, nsplit), "nsplit": nsplit, "rec_rows": n_tiles * _DK_ROWS}


def emit_columns(join_kernel: torch.Tensor, join_bias: torch.Tensor, labels: torch.Tensor):
    """The emit logit's f32 operands at each label, gathered outside the
    forward kernel as the JAX kernels gather ``ke`` outside their Pallas
    body: (ke (B, U, J) = K[:, label], be (B, U) = bias[label]), both 0
    where a label lies outside [0, V) and so selects no column."""
    V = join_kernel.shape[1]
    lab = labels.to(torch.int64)
    ok = (lab >= 0) & (lab < V)
    idx = torch.where(ok, lab, 0)
    ke = torch.where(ok[..., None], join_kernel.to(torch.float32).t()[idx], 0.0)
    be = torch.where(ok, join_bias.to(torch.float32)[idx], 0.0)
    return ke.contiguous(), be.contiguous()


@functools.cache
def _joint_sizes(lib_name: str, device_index: int, J: int, V: int, bf: bool) -> tuple[int, int]:
    """(blocks of the d_K kernel resident on one SM, 32-bit words of K's
    operand form, which the forward and the backward both take as scratch)
    at this J, V and dtype, from the library; above J = 128, (the d_K
    product's blocks, 0)."""
    import ctypes

    from statecatcher_tpu_torch.ops._kernels import library

    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        err = getattr(library(lib_name), f"{lib_name}_sizes")(J, V, int(bf), out)
    _check_err(f"{lib_name}_sizes", err)
    if out[0] <= 0:
        raise RuntimeError(f"{lib_name}: the d_K kernel cannot be resident at J={J}")
    return out[0], out[1]


def bwd_plan(lib_name: str, dev: torch.device, B: int, TT: int, W: int, J: int, V: int,
             patch_frames: int, bf: bool) -> dict:
    """``bwd_layout`` on this card (its SM count and the d_K kernel's
    occupancy at this J and dtype), with ``kop_words``, the size of K's
    operand form (above J = 128: the tiled products' scratch)."""
    per_sm, kop_words = _joint_sizes(lib_name, dev.index, J, V, bf)
    lay = bwd_layout(B, TT, W, V, patch_frames,
                     torch.cuda.get_device_properties(dev).multi_processor_count, per_sm, J)
    if max(lay["rows_grid"][1:]) > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or {TT} frames too large for the patch grid "
                         f"{lay['rows_grid']} (y and z at most {_MAX_GRID_YZ})")
    return {"kop_words": kop_words, **lay}             # above J = 128 the layout's own


def _check_err(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def fwd_operands(lib_name: str, args, J: int, V: int, bf: bool, TT: int, W: int,
                 patch_frames: int) -> list[torch.Tensor]:
    """The forward kernel's operands from ``_kernel_args``' tensors over B·TT·W
    rows: enc, pred, K, bias, the gathered emit columns (``emit_columns``)
    and the scratch of K's operand form (above J = 128: the tiled products'
    scratch)."""
    enc, pred, K, bias, labels = args
    words = (_joint_sizes(lib_name, enc.device.index, J, V, bf)[1] if J <= _NARROW_J
             else wide_scratch_words(enc.shape[0], TT, W, patch_frames, J, V, False))
    kop = torch.empty(words, dtype=torch.int32, device=enc.device)
    return [enc, pred, K, bias, *emit_columns(K, bias, labels), kop]


def rnnt_joint_fwd(enc_p, pred_p, join_kernel, join_bias, labels, blank_id: int = 0):
    """K6a on CUDA tensors: (blank (B, T, U+1), emit (B, T, U), lse
    (B, T, U+1)) f32, counted in ``rnnt_joint_fwd.launches`` (its two
    kernels, K's operand form and the forward, are one launch of K6a); the
    plain version on CPU tensors."""
    if not enc_p.is_cuda:
        return joint_blank_emit_ref(enc_p, pred_p, join_kernel, join_bias, labels, blank_id)
    args, (B, T, U1, J, V, bf) = _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels,
                                              blank_id)
    from statecatcher_tpu_torch.ops._kernels import library

    dev = enc_p.device
    ops = fwd_operands("rnnt_joint", args, J, V, bf, T, U1, 16)  # rnnt_joint.cu: 16 × 8 patches
    blank = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    emit = torch.empty((B, T, U1 - 1), dtype=torch.float32, device=dev)
    lse = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library("rnnt_joint").rnnt_joint_fwd(
            *(a.data_ptr() for a in ops), blank.data_ptr(), emit.data_ptr(), lse.data_ptr(),
            B, T, U1, J, V, blank_id, int(bf), torch.cuda.current_stream(dev).cuda_stream)
    _check_err("rnnt_joint_fwd", err)
    rnnt_joint_fwd.launches += 1
    return blank, emit, lse


rnnt_joint_fwd.launches = 0


def rnnt_joint_bwd(enc_p, pred_p, join_kernel, join_bias, labels, lse, g_blank, g_emit,
                   blank_id: int = 0):
    """K6b on CUDA tensors: (d_enc, d_pred, d_kernel, d_bias) f32 from the
    forward's lse and the cotangents of blank and emit, counted in
    ``rnnt_joint_bwd.launches`` (its two kernels are one launch of K6b);
    the plain version on CPU tensors."""
    if not enc_p.is_cuda:
        return joint_blank_emit_bwd_ref(enc_p, pred_p, join_kernel, join_bias, labels, lse,
                                        g_blank, g_emit, blank_id)
    args, (B, T, U1, J, V, bf) = _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels,
                                              blank_id)
    if lse.shape != (B, T, U1) or g_blank.shape != (B, T, U1) or g_emit.shape != (B, T, U1 - 1):
        raise ValueError("lse, g_blank and g_emit must be (B, T, U+1), (B, T, U+1), (B, T, U)")
    from statecatcher_tpu_torch.ops._kernels import library

    dev = enc_p.device
    f32 = lambda t: t.to(torch.float32).contiguous()
    rows = (f32(lse), f32(g_blank), f32(g_emit))
    lay = bwd_plan("rnnt_joint", dev, B, T, U1, J, V, 16, bf)  # rnnt_joint.cu: 16 × 8 patches
    nsplit = lay["nsplit"]
    d_enc_part = torch.empty((B, T, lay["n_grp"], J), dtype=torch.float32, device=dev)
    d_pred_part = torch.empty((B, lay["n_t"], U1, J), dtype=torch.float32, device=dev)
    dk_part = torch.empty((nsplit, J, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((nsplit, V), dtype=torch.float32, device=dev)
    rec = torch.empty((6, lay["rec_rows"]), dtype=torch.int32, device=dev)
    kop = torch.empty(lay["kop_words"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library("rnnt_joint").rnnt_joint_bwd(
            *(a.data_ptr() for a in args), *(r.data_ptr() for r in rows), d_enc_part.data_ptr(),
            d_pred_part.data_ptr(), dk_part.data_ptr(), db_part.data_ptr(), rec.data_ptr(),
            kop.data_ptr(), B, T, U1, J, V, blank_id, int(bf), nsplit,
            torch.cuda.current_stream(dev).cuda_stream)
    _check_err("rnnt_joint_bwd", err)
    rnnt_joint_bwd.launches += 1
    return d_enc_part.sum(2), d_pred_part.sum(1), dk_part.sum(0), db_part.sum(0)


rnnt_joint_bwd.launches = 0


# --------------------------------------------------------------------------- #
# The differentiable joint and the loss
# --------------------------------------------------------------------------- #
class _JointBlankEmit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc_p, pred_p, join_kernel, join_bias, labels, blank_id):
        blank, emit, lse = rnnt_joint_fwd(enc_p, pred_p, join_kernel, join_bias, labels, blank_id)
        ctx.save_for_backward(enc_p, pred_p, join_kernel, join_bias, labels, lse)
        ctx.blank_id = blank_id
        return blank, emit

    @staticmethod
    def backward(ctx, g_blank, g_emit):
        enc_p, pred_p, join_kernel, join_bias, labels, lse = ctx.saved_tensors
        B, T, _ = enc_p.shape
        U1 = pred_p.shape[1]
        if g_blank is None:
            g_blank = torch.zeros((B, T, U1), dtype=lse.dtype, device=lse.device)
        if g_emit is None:
            g_emit = torch.zeros((B, T, U1 - 1), dtype=lse.dtype, device=lse.device)
        d_enc, d_pred, d_k, d_b = rnnt_joint_bwd(enc_p, pred_p, join_kernel, join_bias, labels,
                                                 lse, g_blank, g_emit, ctx.blank_id)
        return (d_enc.to(enc_p.dtype), d_pred.to(pred_p.dtype), d_k.to(join_kernel.dtype),
                d_b.to(join_bias.dtype), None, None)


def joint_blank_emit(enc_p: torch.Tensor, pred_p: torch.Tensor, join_kernel: torch.Tensor,
                     join_bias: torch.Tensor, labels: torch.Tensor, blank_id: int = 0):
    """Fused joint: (blank_lp (B, T, U+1), emit_lp (B, T, U)), float32,
    differentiable with respect to enc_p, pred_p, join_kernel and join_bias.
    K6a/K6b on CUDA tensors, their plain versions on CPU tensors.  (The JAX
    function's ``time_block`` is its TPU tiling; nothing here takes it.)"""
    return _JointBlankEmit.apply(enc_p, pred_p, join_kernel, join_bias, labels, blank_id)


def rnnt_loss_pallas(enc_proj: torch.Tensor, pred_proj: torch.Tensor, join_kernel: torch.Tensor,
                     join_bias: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                     u_lens: torch.Tensor, blank_id: int = 0, row_valid=None,
                     return_per: bool = False):
    """Transducer loss through the fused joint (K6) and the lattice (K7):
    the mean over valid rows of the per-utterance NLL (as
    ``ops/rnnt.py:rnnt_loss_fused``)."""
    blank_lp, emit_lp = joint_blank_emit(enc_proj, pred_proj, join_kernel, join_bias, labels,
                                         blank_id=blank_id)
    per = rnnt_nll_dp_pallas(blank_lp, emit_lp, t_lens, u_lens)
    if row_valid is None:
        loss = per.mean()
    else:
        valid = row_valid.to(per.dtype)
        loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return (loss, per) if return_per else loss
