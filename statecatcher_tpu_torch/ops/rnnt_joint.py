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
gathered emit column).  Outputs are float32 (float64 in the plain version for
float64 inputs); gradients come back in the inputs' dtypes.

Bounds on the card (operations; see the source): at B=32, T=1598, U=48,
J=64, V=1024 the forward is 3.3e11 flops of contraction, the backward three
times that (the logits once more, d_joint, d_K).

``joint_blank_emit_ref`` and ``joint_blank_emit_bwd_ref`` are the plain
versions: per time chunk, tanh, matmul, logsumexp and gathers (backward:
softmax, the three products, sums).  Each wrapper runs its plain version only
for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch

from statecatcher_tpu_torch.ops.rnnt_lattice import rnnt_nll_dp_pallas

_MAX_J = 128            # rnnt_joint.cu instantiates J ≤ 64 and J ≤ 128
_PLAIN_CHUNK = 16       # frames per chunk of the plain versions


def _plain_inputs(enc_p, pred_p, join_kernel, join_bias):
    """(compute dtype, bf16?, enc, pred, K, bias, and K and bias as the logits
    see them: rounded to bf16 under bf16 inputs)."""
    cdt = torch.promote_types(enc_p.dtype, torch.float32)
    bf = enc_p.dtype == torch.bfloat16
    K, bias = join_kernel.to(cdt), join_bias.to(cdt)
    rnd = lambda x: x.to(torch.bfloat16).to(cdt) if bf else x
    return cdt, bf, enc_p.to(cdt), pred_p.to(cdt), K, bias, rnd(K), rnd(bias)


def plain_logits(joint, Km, bias_m, bf):
    """The joint's matmul operand (bf16-rounded under bf16) and its logits."""
    jm = joint.to(torch.bfloat16).to(joint.dtype) if bf else joint
    return jm, jm @ Km + bias_m


def _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1):
    """The chunk's f32 joint, its matmul operand and its logits."""
    joint = torch.tanh(enc[:, t0:t1, None, :] + pred[:, None, :, :])
    return (joint, *plain_logits(joint, Km, bias_m, bf))


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def joint_blank_emit_ref(enc_p: torch.Tensor, pred_p: torch.Tensor, join_kernel: torch.Tensor,
                         join_bias: torch.Tensor, labels: torch.Tensor, blank_id: int = 0):
    """Plain K6a: (blank (B, T, U+1), emit (B, T, U), lse (B, T, U+1))."""
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
        joint, _, logits = _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1)
        ls = torch.logsumexp(logits, dim=-1)
        lse[:, t0:t1] = ls
        blank[:, t0:t1] = logits[..., blank_id] - ls
        emit[:, t0:t1] = ((joint[:, :, :U] * k_lab[:, None]).sum(-1) + b_lab[:, None]
                          - ls[:, :, :U])
    return blank, emit, lse


def joint_blank_emit_bwd_ref(enc_p, pred_p, join_kernel, join_bias, labels, lse, g_blank,
                             g_emit, blank_id: int = 0):
    """Plain K6b: (d_enc (B, T, J), d_pred (B, U+1, J), d_kernel (J, V),
    d_bias (V,)) in f32 (f64 for f64 inputs)."""
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
        joint, jm, logits = _plain_chunk(enc, pred, Km, bias_m, bf, t0, t1)
        gb = g_blank[:, t0:t1].to(cdt)
        ge = torch.cat([g_emit[:, t0:t1].to(cdt),
                        torch.zeros((B, t1 - t0, 1), dtype=cdt, device=dev)], dim=2)
        dlog = -(gb + ge)[..., None] * torch.exp(logits - lse[:, t0:t1, :, None].to(cdt))
        dlog[..., blank_id] += gb
        dlog.scatter_add_(3, lab[:, None, :, None].expand(B, t1 - t0, U1, 1), ge[..., None])
        if bf:
            dlog = dlog.to(torch.bfloat16).to(cdt)
        dj = (dlog @ Km.t()) * (1.0 - joint * joint)
        d_enc[:, t0:t1] = dj.sum(2)
        d_pred += dj.sum(1)
        d_k += jm.reshape(-1, J).t() @ dlog.reshape(-1, V)
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
    if min(B, T, U1, J, V) == 0 or J > _MAX_J:
        raise ValueError(f"unsupported joint shape B={B}, T={T}, U+1={U1}, J={J}, V={V} "
                         f"(J at most {_MAX_J})")
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


def _check_err(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def rnnt_joint_fwd(enc_p, pred_p, join_kernel, join_bias, labels, blank_id: int = 0):
    """K6a on CUDA tensors: (blank (B, T, U+1), emit (B, T, U), lse
    (B, T, U+1)) f32, counted in ``rnnt_joint_fwd.launches``; the plain
    version on CPU tensors."""
    if not enc_p.is_cuda:
        return joint_blank_emit_ref(enc_p, pred_p, join_kernel, join_bias, labels, blank_id)
    args, (B, T, U1, J, V, bf) = _kernel_args(enc_p, pred_p, join_kernel, join_bias, labels,
                                              blank_id)
    from statecatcher_tpu_torch.ops._kernels import library

    dev = enc_p.device
    blank = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    emit = torch.empty((B, T, U1 - 1), dtype=torch.float32, device=dev)
    lse = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library("rnnt_joint").rnnt_joint_fwd(
            *(a.data_ptr() for a in args), blank.data_ptr(), emit.data_ptr(), lse.data_ptr(),
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
    n_u, n_t = -(-U1 // 8), -(-T // 16)                      # rnnt_joint.cu's kPU, kPT
    if n_t > 65535 or B > 65535:
        raise ValueError(f"B={B} or T={T} too large for the patch grid (B, T/16 ≤ 65535)")
    n_vt = -(-V // 64)                                       # its kVT
    n_tiles = -(-(B * T * U1) // 128)                        # its kRT
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = max(1, min(n_tiles, n_sm // n_vt))
    d_enc_part = torch.empty((B, T, n_u, J), dtype=torch.float32, device=dev)
    d_pred_part = torch.empty((B, n_t, U1, J), dtype=torch.float32, device=dev)
    dk_part = torch.empty((nsplit, J, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((nsplit, V), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library("rnnt_joint").rnnt_joint_bwd(
            *(a.data_ptr() for a in args), *(r.data_ptr() for r in rows), d_enc_part.data_ptr(),
            d_pred_part.data_ptr(), dk_part.data_ptr(), db_part.data_ptr(), B, T, U1, J, V,
            blank_id, int(bf), nsplit, torch.cuda.current_stream(dev).cuda_stream)
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
