"""Fused lane-major LucyRNN cell: forward (K1) and backward (K2).

Replaces two TPU kernels of ``statecatcher_tpu/ops/lucy_fused_lm.py``:

  * K1, ``_fwd_kernel`` (:156, launched by ``_fused_lm_fwd_impl``, :196) →
    ``ops/csrc/lucy_fused_lm_fwd.cu``: lane-major gates (B, T, 7·D) with the
    bias unapplied, h0 and s0 (B, D) → h_all and s_all (B, T, D) in the
    gates' dtype, all math in f32.
  * K2, ``_bwd_kernel`` (:248, launched by ``_fused_lm_bwd_impl``, :364) →
    ``ops/csrc/lucy_fused_lm_bwd.cu``: the reverse adjoints λ_h and λ_s with
    the closed-form gate-chain adjoint → d_gates (B, T, 7·D) in the gates'
    dtype, dh0 and ds0 (B, D) f32, d_bias (7·D) f32 summed over B and T.

``lucy_cell_fused_lm`` is a ``torch.autograd.Function`` over the two, as the
JAX package's ``custom_vjp`` is: the forward saves ``gates, bias, h0, s0,
h_all, s_all`` and the backward returns ``(d_gates, d_bias, dh0, ds0)`` in
the dtypes of the inputs.

Bounds on the card (bytes both; see the sources): K1 moves 9 planes of
B·T·D, 0.281 ms at (B=32, T=1598, D=512) f32; K2 moves 18, 0.563 ms.  Both
give a block one batch row and a tile of columns and walk time in tiles of
a few steps: a ring of shared-memory stages filled by ``cp.async`` tiles
ahead, the state-free gate chain computed for a whole tile by most warps
while one thread per column walks the previous tile's recurrence
(``ops/csrc/lucy_tile.cuh`` holds what the two share).

``lucy_cell_fused_lm_ref`` and ``lucy_cell_fused_lm_bwd_ref`` are the plain
versions (f32 math, f64 for f64 gates).  Each wrapper runs its plain version
only for tensors on the CPU; on the card it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from statecatcher_tpu_torch.ops.lucy_gates import EPS, lucy_gate_coeffs
from statecatcher_tpu_torch.ops.scan import linear_scan_seq

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def lucy_cell_fused_lm_ref(gates: torch.Tensor, bias: torch.Tensor,
                           h0: torch.Tensor, s0: torch.Tensor):
    """Plain PyTorch version of the fused cell: (h_all, s_all) in the gates'
    dtype, computed in float32 (float64 for float64 gates)."""
    cdt = torch.promote_types(gates.dtype, torch.float32)
    a_s, b_s, a_h, bh_c, h_pre_n = lucy_gate_coeffs(gates.to(cdt), None, bias.to(cdt))
    s_all = linear_scan_seq(a_s, b_s, s0.to(cdt))
    c = torch.tanh(h_pre_n + s_all)
    h_all = linear_scan_seq(a_h, bh_c * c, h0.to(cdt))
    return h_all.to(gates.dtype), s_all.to(gates.dtype)


def _gate_chain_res(g7):
    """Biased gates → scan coefficients and the residuals of the closed-form
    adjoint, in the rsqrt form of the JAX kernel (``_gate_chain_res``)."""
    r, z, k, v, h_pre, decay, alpha = g7
    i_rz = torch.rsqrt((r * r + z * z) * 0.5 + EPS)
    q_kv = (k * k + v * v) * 0.5 + EPS
    i_kv = torch.rsqrt(q_kv)
    inv_qe = 1.0 / (q_kv + EPS)
    i_d = torch.rsqrt(decay * decay + EPS)
    i_a = torch.rsqrt(alpha * alpha + EPS)
    i_p = torch.rsqrt(h_pre * h_pre + EPS)
    z_n = torch.sigmoid(z * i_rz)
    d_n = torch.sigmoid(decay * i_d)
    a_n = torch.sigmoid(alpha * i_a)
    F = (i_kv * i_kv) * inv_qe                       # 1/(q·(q+ε))
    kv = (k * v) * F
    coeffs = (d_n, a_n * kv, z_n, 1.0 - z_n, h_pre * i_p)
    return coeffs, (g7, i_rz, q_kv, F, i_d, i_a, i_p, z_n, d_n, a_n, kv)


def _gate_chain_bwd(res, cot):
    """Closed-form adjoint of ``_gate_chain_res`` (JAX ``_gate_chain_bwd``):
    cotangents of (a_s, b_s, a_h, bh_c, h_pre_n) → those of the 7 gates."""
    (r, z, k, v, _h_pre, _decay, _alpha), i_rz, q_kv, F, i_d, i_a, i_p, \
        z_n, d_n, a_n, kv = res
    ca, cb, cah, cbh, cp = cot
    d_decay = ca * (d_n * (1.0 - d_n)) * (EPS * i_d * i_d * i_d)
    c_kv = cb * a_n
    d_alpha = (cb * kv) * (a_n * (1.0 - a_n)) * (EPS * i_a * i_a * i_a)
    g = (cah - cbh) * (z_n * (1.0 - z_n))
    i_rz3 = (i_rz * i_rz) * i_rz
    d_z = g * (i_rz - (0.5 * (z * z)) * i_rz3)
    d_r = g * ((-0.5) * (z * r) * i_rz3)
    d_h_pre = cp * (EPS * i_p * i_p * i_p)
    tF = (2.0 * q_kv + EPS) * F
    d_k = (c_kv * v) * F * (1.0 - (k * k) * tF)
    d_v = (c_kv * k) * F * (1.0 - (v * v) * tF)
    return (d_r, d_z, d_k, d_v, d_h_pre, d_decay, d_alpha)


def lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, g_s):
    """Plain PyTorch version of K2: the cotangents ``g_h``, ``g_s`` of
    (h_all, s_all) (either may be None for zero) → (d_gates in the gates'
    dtype, dh0, ds0, d_bias), the last three in f32 (f64 for f64 gates).

    The gate chain is recomputed for all steps at once; the two adjoint
    recurrences λ_t = g_t + a_{t+1}·λ_{t+1} run as one reverse-time loop;
    the closed-form chain adjoint is applied to every step at once."""
    cdt = torch.promote_types(gates.dtype, torch.float32)
    B, T, G7 = gates.shape
    D = G7 // 7
    g = gates.to(cdt) + bias.to(cdt)
    g7 = tuple(g[..., i * D:(i + 1) * D] for i in range(7))
    (a_s, _b_s, a_h, bh_c, h_pre_n), res = _gate_chain_res(g7)
    s_al, h_al = s_all.to(cdt), h_all.to(cdt)
    s_prev = torch.cat([s0.to(cdt)[:, None], s_al[:, :-1]], dim=1)
    h_prev = torch.cat([h0.to(cdt)[:, None], h_al[:, :-1]], dim=1)
    c = torch.tanh(h_pre_n + s_al)
    zeros = torch.zeros((B, T, D), dtype=cdt, device=gates.device)
    gh = zeros if g_h is None else g_h.to(cdt)
    gs = zeros if g_s is None else g_s.to(cdt)
    dpre_w = bh_c * (1.0 - c * c)                      # ∂c-path weight of λ_h

    lam_h = torch.empty_like(zeros)
    lam_s = torch.empty_like(zeros)
    lh = ls = None
    for t in range(T - 1, -1, -1):
        if lh is None:
            lh = gh[:, t]
            ls = gs[:, t] + lh * dpre_w[:, t]
        else:
            lh = gh[:, t] + a_h[:, t + 1] * lh
            ls = (gs[:, t] + lh * dpre_w[:, t]) + a_s[:, t + 1] * ls
        lam_h[:, t] = lh
        lam_s[:, t] = ls

    d_pre = lam_h * dpre_w
    cot = (lam_s * s_prev, lam_s, lam_h * h_prev, lam_h * c, d_pre)
    dg = torch.cat(_gate_chain_bwd(res, cot), dim=-1)
    dh0 = lam_h[:, 0] * a_h[:, 0]
    ds0 = lam_s[:, 0] * a_s[:, 0]
    return dg.to(gates.dtype), dh0, ds0, dg.sum(dim=(0, 1))


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_cell_args(gates, bias, h0, s0):
    """Shape/dtype/device/contiguity checks shared by K1 and K2 → (B, T, D)."""
    if gates.dtype not in _DTYPE_CODE:
        raise TypeError(f"gates must be float32 or bfloat16, got {gates.dtype}")
    if gates.ndim != 3 or gates.shape[-1] % 7:
        raise ValueError(f"gates must be (B, T, 7·D), got {tuple(gates.shape)}")
    B, T, G7 = gates.shape
    D = G7 // 7
    if min(B, T, D) == 0:
        raise ValueError(f"unsupported gates shape {tuple(gates.shape)}")
    if bias.shape != (G7,) or h0.shape != (B, D) or s0.shape != (B, D):
        raise ValueError(
            f"bias {tuple(bias.shape)}, h0 {tuple(h0.shape)}, s0 "
            f"{tuple(s0.shape)} do not fit gates {tuple(gates.shape)}")
    for name, t in (("bias", bias), ("h0", h0), ("s0", s0)):
        if t.device != gates.device:
            raise ValueError(f"{name} is on {t.device}, gates on {gates.device}")
    if not gates.is_contiguous():
        raise ValueError("gates must be contiguous")
    return B, T, D


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_kernel(gates, bias, h0, s0):
    """Launch K1 (``lucy_fused_lm_fwd``) on the current stream."""
    B, T, D = _check_cell_args(gates, bias, h0, s0)
    dev = gates.device
    bias32, h32, s32 = (t.to(torch.float32).contiguous() for t in (bias, h0, s0))

    from statecatcher_tpu_torch.ops._kernels import library

    fn = library("lucy_fused_lm_fwd").lucy_fused_lm_fwd
    h_all = torch.empty((B, T, D), dtype=gates.dtype, device=dev)
    s_all = torch.empty((B, T, D), dtype=gates.dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(_DTYPE_CODE[gates.dtype], gates.data_ptr(), bias32.data_ptr(),
                 h32.data_ptr(), s32.data_ptr(), h_all.data_ptr(),
                 s_all.data_ptr(), B, T, D, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lucy_fused_lm_fwd launch failed: cudaError {err}")
    lucy_cell_fused_lm.launches += 1
    return h_all, s_all


def _bwd_kernel(gates, bias, h0, s0, h_all, s_all, g_h, g_s):
    """Launch K2 (``lucy_fused_lm_bwd``) on the current stream.  A None
    ``g_s`` (the model path: the carry is not in the loss) goes to the
    kernel as a null pointer; a None ``g_h`` is materialised as zeros."""
    B, T, D = _check_cell_args(gates, bias, h0, s0)
    dev = gates.device
    if g_h is None:
        g_h = torch.zeros_like(h_all)
    for name, t in (("h_all", h_all), ("s_all", s_all), ("g_h", g_h), ("g_s", g_s)):
        if t is None:
            continue
        if t.shape != (B, T, D) or t.dtype != gates.dtype or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"fit gates {tuple(gates.shape)} {gates.dtype}")
    h_all, s_all, g_h = (t.contiguous() for t in (h_all, s_all, g_h))
    g_s = None if g_s is None else g_s.contiguous()
    bias32, h32, s32 = (t.to(torch.float32).contiguous() for t in (bias, h0, s0))

    from statecatcher_tpu_torch.ops._kernels import library

    fn = library("lucy_fused_lm_bwd").lucy_fused_lm_bwd
    d_gates = torch.empty_like(gates)
    dh0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    dbias_part = torch.empty((B, 7 * D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(_DTYPE_CODE[gates.dtype], gates.data_ptr(), bias32.data_ptr(),
                 h32.data_ptr(), s32.data_ptr(), h_all.data_ptr(), s_all.data_ptr(),
                 g_h.data_ptr(), None if g_s is None else g_s.data_ptr(),
                 d_gates.data_ptr(), dh0.data_ptr(), ds0.data_ptr(),
                 dbias_part.data_ptr(), B, T, D, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lucy_fused_lm_bwd launch failed: cudaError {err}")
    lucy_cell_fused_lm_bwd.launches += 1
    # per-b partial sums of d_bias, summed over B here (deterministic)
    return d_gates, dh0, ds0, dbias_part.sum(dim=0)


def lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, g_s):
    """K2: cotangents of (h_all, s_all) → (d_gates, dh0, ds0, d_bias).

    On CUDA tensors this launches ``lucy_fused_lm_bwd`` and counts it in
    ``lucy_cell_fused_lm_bwd.launches``; on CPU tensors it runs the plain
    version."""
    if not gates.is_cuda:
        return lucy_cell_fused_lm_bwd_ref(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
    return _bwd_kernel(gates, bias, h0, s0, h_all, s_all, g_h, g_s)


lucy_cell_fused_lm_bwd.launches = 0


class _FusedCell(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, gates, bias, h0, s0):
        if gates.is_cuda:
            h_all, s_all = _fwd_kernel(gates, bias, h0, s0)
        else:
            h_all, s_all = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
        ctx.save_for_backward(gates, bias, h0, s0, h_all, s_all)
        ctx.set_materialize_grads(False)
        return h_all, s_all

    @staticmethod
    def backward(ctx, g_h, g_s):
        gates, bias, h0, s0, h_all, s_all = ctx.saved_tensors
        if g_h is None and g_s is None:
            return None, None, None, None
        dg, dh0, ds0, d_bias = lucy_cell_fused_lm_bwd(
            gates, bias, h0, s0, h_all, s_all, g_h, g_s)
        return dg, d_bias.to(bias.dtype), dh0.to(h0.dtype), ds0.to(s0.dtype)


def lucy_cell_fused_lm(gates: torch.Tensor, bias: torch.Tensor,
                       h0: torch.Tensor, s0: torch.Tensor):
    """Fused 7-gate cell: gates (B, T, 7D) f32/bf16 unbiased, bias (7D), h0,
    s0 (B, D) → (h_all, s_all) (B, T, D) in the gates' dtype, differentiable
    in all four inputs.

    On CUDA tensors the forward launches ``lucy_fused_lm_fwd`` on the current
    stream (counted in ``lucy_cell_fused_lm.launches``) and the backward
    ``lucy_fused_lm_bwd``; on CPU tensors both run their plain versions.
    """
    return _FusedCell.apply(gates, bias, h0, s0)


lucy_cell_fused_lm.launches = 0
