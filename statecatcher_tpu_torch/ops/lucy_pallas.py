"""The LucyRNN cell's scans: the first-order linear scan
s_t = a_t·s_{t−1} + b_t with its adjoint (K5a, K5b), the fused masked cell
(K12) and the dual scan (K11).

Replaces four TPU kernels of ``statecatcher_tpu/ops/lucy_pallas.py``:

  * K5a, ``_scan_kernel`` (:35, launched by ``_linear_scan_pallas_fwd_impl``,
    :79) → ``linear_scan_fwd`` of ``ops/csrc/linear_scan.cu``: a, b
    (B, T, D) and s0 (B, D) → s (B, T, D) in a's dtype;
  * K5b, ``_rev_scan_kernel`` (:118, launched by
    ``_linear_scan_pallas_rev_impl``, :174) → ``linear_scan_rev``: a and the
    cotangent g (B, T, D) → λ_t = g_t + a_{t+1}·λ_{t+1} (λ past T−1 is 0) in
    a's dtype;
  * K12, ``_fused_cell_kernel`` (:319, launched by ``_fused_cell_fwd_impl``,
    :390) → ``lucy_fused_cell_fwd`` of ``ops/csrc/lucy_cell_scan.cu``: gates
    (B, T, 7, D) with the bias already added, h0, s0 and an optional frame
    mask (B, T) → h_all, s_all (B, T, D) in the gates' dtype: the gate chain
    of ``ops/lucy_gates.py``, the s-scan, tanh and the h-scan in one pass;
  * K11, ``_dual_scan_kernel`` (:527, launched by ``_dual_scan_fwd_impl``,
    :568) → ``lucy_dual_scan_fwd``: the planes a_s, b_s, a_h, h_pre_n
    (B, T, D), h0, s0 → h_all, s_all in a_s's dtype: the s-scan, tanh and
    the h-scan with the offset (1 − a_h)·c.

All carry the state in float32 whatever the inputs' dtype and round only
what they write (under bf16, s, h and λ are rounded on output), as the TPU
kernels' float32 carry does.  ``linear_scan_pallas`` is a
``torch.autograd.Function`` over K5a/K5b, as the JAX package's
``custom_vjp`` is: da = λ·s_{t−1}, db = λ, ds0 = λ_0·a_0.  ``lucy_fused_cell``
and ``lucy_dual_scan`` are autograd Functions whose forward is K12 or K11
and whose backward transcribes the JAX package's ``_fused_bwd`` (:467) and
``_dual_bwd`` (:623): two reverse scans through K5b, the rest in torch (for
K12, the gate chain recomputed in float32 and differentiated by autograd).

Bounds on the card (bytes; see the sources), at (B=32, T=1598, D=512) f32:
K5a and K5b read two planes of B·T·D and write one, 0.094 ms; K12 reads 7
and writes 2, 0.281 ms; K11 reads 4 and writes 2, 0.188 ms.

``linear_scan_ref`` (``ops/scan.py:linear_scan_seq`` in float32),
``linear_scan_rev_ref``, ``lucy_fused_cell_ref`` and ``lucy_dual_scan_ref``
are the plain versions.  Each wrapper runs its plain version only for
tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
from statecatcher_tpu_torch.ops.scan import linear_scan_seq

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Plain K5a: the sequential scan in float32 (float64 for float64
    inputs), written in a's dtype."""
    cdt = torch.promote_types(a.dtype, torch.float32)
    return linear_scan_seq(a.to(cdt), b.to(cdt), s0.to(cdt)).to(a.dtype)


def linear_scan_rev_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain K5b: λ_t = g_t + a_{t+1}·λ_{t+1}, walking time backwards in
    float32 (float64 for float64 inputs), written in a's dtype."""
    cdt = torch.promote_types(a.dtype, torch.float32)
    a_, g_ = a.to(cdt), g.to(cdt)
    out = torch.empty_like(g_)
    lam = None
    for t in range(a.shape[1] - 1, -1, -1):
        lam = g_[:, t] if lam is None else g_[:, t] + a_[:, t + 1] * lam
        out[:, t] = lam
    return out.to(a.dtype)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check(a: torch.Tensor, others) -> tuple[int, int, int]:
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"the scan takes float32 or bfloat16, got {a.dtype}")
    if a.ndim != 3 or min(a.shape) == 0 or max(a.shape) > 2**31 - 1:
        raise ValueError(f"a must be a non-empty (B, T, D) of int32 sizes, got {tuple(a.shape)}")
    for name, t in others:
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not fit a "
                             f"{tuple(a.shape)} {a.dtype} on {a.device}")
    return a.shape


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def linear_scan_fwd(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """K5a: s (B, T, D) in a's dtype.  On CUDA tensors this launches
    ``linear_scan_fwd`` and counts it in ``linear_scan_fwd.launches``; on CPU
    tensors it runs the plain version."""
    if not a.is_cuda:
        return linear_scan_ref(a, b, s0)
    B, T, D = _check(a, [("b", b)])
    if s0.shape != (B, D) or s0.device != a.device:
        raise ValueError(f"s0 {tuple(s0.shape)} on {s0.device} must be ({B}, {D}) on {a.device}")
    from statecatcher_tpu_torch.ops._kernels import library

    dev = a.device
    a, b, s0 = a.contiguous(), b.contiguous(), s0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        err = library("linear_scan").linear_scan_fwd(
            _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), s0.data_ptr(), out.data_ptr(),
            B, T, D, _stream(dev))
    if err != 0:
        raise RuntimeError(f"linear_scan_fwd launch failed: cudaError {err}")
    linear_scan_fwd.launches += 1
    return out


linear_scan_fwd.launches = 0


def linear_scan_rev(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5b: λ (B, T, D) in a's dtype.  On CUDA tensors this launches
    ``linear_scan_rev`` and counts it in ``linear_scan_rev.launches``; on CPU
    tensors it runs the plain version."""
    if not a.is_cuda:
        return linear_scan_rev_ref(a, g)
    B, T, D = _check(a, [("g", g)])
    from statecatcher_tpu_torch.ops._kernels import library

    dev = a.device
    a, g = a.contiguous(), g.contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        err = library("linear_scan").linear_scan_rev(
            _DTYPE_CODE[a.dtype], a.data_ptr(), g.data_ptr(), out.data_ptr(), B, T, D,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"linear_scan_rev launch failed: cudaError {err}")
    linear_scan_rev.launches += 1
    return out


linear_scan_rev.launches = 0


class _LinearScan(torch.autograd.Function):
    """K5a forward, K5b backward (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, a, b, s0):
        s = linear_scan_fwd(a, b, s0)
        ctx.save_for_backward(a, s, s0)
        ctx.b_dtype = b.dtype
        return s

    @staticmethod
    def backward(ctx, g):
        a, s, s0 = ctx.saved_tensors
        lam = linear_scan_rev(a, g.to(a.dtype))
        dt = torch.promote_types(s0.dtype, s.dtype)
        s_prev = torch.cat([s0[:, None].to(dt), s[:, :-1].to(dt)], dim=1)
        return ((lam * s_prev).to(a.dtype), lam.to(ctx.b_dtype),
                (lam[:, 0] * a[:, 0]).to(s0.dtype))


def linear_scan_pallas(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """s_t = a_t·s_{t−1} + b_t over axis 1: a, b (B, T, D) float32 or
    bfloat16 (float64 on the CPU), s0 (B, D) → s (B, T, D) in a's dtype,
    differentiable in all three.  K5a forward and K5b backward on CUDA
    tensors, their plain versions on CPU tensors."""
    return _LinearScan.apply(a, b, s0)


# --------------------------------------------------------------------------- #
# K12 and K11: plain versions
# --------------------------------------------------------------------------- #
def _lane_major(gates: torch.Tensor) -> torch.Tensor:
    """(B, T, 7, D) gates → the same memory viewed as (B, T, 7·D)."""
    B, T, G, D = gates.shape
    return gates.reshape(B, T, G * D)


def lucy_fused_cell_ref(gates: torch.Tensor, h0: torch.Tensor, s0: torch.Tensor,
                        frame_mask: Optional[torch.Tensor] = None):
    """Plain K12: gates (B, T, 7, D) with the bias added → (h_all, s_all) in
    the gates' dtype, computed in float32 (float64 for float64 gates)."""
    cdt = torch.promote_types(gates.dtype, torch.float32)
    a_s, b_s, a_h, bh_c, h_pre_n = lucy_gate_coeffs(_lane_major(gates.to(cdt)), frame_mask)
    s_all = linear_scan_seq(a_s, b_s, s0.to(cdt))
    c = torch.tanh(h_pre_n + s_all)
    h_all = linear_scan_seq(a_h, bh_c * c, h0.to(cdt))
    return h_all.to(gates.dtype), s_all.to(gates.dtype)


def lucy_dual_scan_ref(a_s, b_s, a_h, h_pre, h0, s0):
    """Plain K11: the s-scan, c = tanh(h_pre + s), the h-scan with offset
    (1 − a_h)·c → (h_all, s_all) in a_s's dtype, computed in float32
    (float64 for float64 planes)."""
    cdt = torch.promote_types(a_s.dtype, torch.float32)
    s_all = linear_scan_seq(a_s.to(cdt), b_s.to(cdt), s0.to(cdt))
    a_h = a_h.to(cdt)
    c = torch.tanh(h_pre.to(cdt) + s_all)
    h_all = linear_scan_seq(a_h, (1.0 - a_h) * c, h0.to(cdt))
    return h_all.to(a_s.dtype), s_all.to(a_s.dtype)


# --------------------------------------------------------------------------- #
# K12 and K11: kernel launchers
# --------------------------------------------------------------------------- #
def _check_carry(h0, s0, B, D, dev):
    for name, t in (("h0", h0), ("s0", s0)):
        if t.shape != (B, D) or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} must be ({B}, {D}) on {dev}")
    return h0.to(torch.float32).contiguous(), s0.to(torch.float32).contiguous()


def _fused_cell_kernel(gates, h0, s0, frame_mask):
    """Launch K12 (``lucy_fused_cell_fwd``) on the current stream."""
    if gates.dtype not in _DTYPE_CODE:
        raise TypeError(f"gates must be float32 or bfloat16, got {gates.dtype}")
    if gates.ndim != 4 or gates.shape[2] != 7 or min(gates.shape) == 0:
        raise ValueError(f"gates must be a non-empty (B, T, 7, D), got {tuple(gates.shape)}")
    B, T, _, D = gates.shape
    if not gates.is_contiguous():
        raise ValueError("gates must be contiguous")
    dev = gates.device
    h32, s32 = _check_carry(h0, s0, B, D, dev)
    if frame_mask is not None:
        if frame_mask.dtype != torch.bool or frame_mask.shape != (B, T) or frame_mask.device != dev:
            raise ValueError(f"frame_mask {tuple(frame_mask.shape)} {frame_mask.dtype} on "
                             f"{frame_mask.device} must be bool ({B}, {T}) on {dev}")
        frame_mask = frame_mask.contiguous()
    from statecatcher_tpu_torch.ops._kernels import library

    h_all = torch.empty((B, T, D), dtype=gates.dtype, device=dev)
    s_all = torch.empty_like(h_all)
    with torch.cuda.device(dev):
        err = library("lucy_cell_scan").lucy_fused_cell_fwd(
            _DTYPE_CODE[gates.dtype], gates.data_ptr(),
            None if frame_mask is None else frame_mask.data_ptr(), h32.data_ptr(),
            s32.data_ptr(), h_all.data_ptr(), s_all.data_ptr(), B, T, D, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lucy_fused_cell_fwd launch failed: cudaError {err}")
    lucy_fused_cell.launches += 1
    return h_all, s_all


def _dual_scan_kernel(a_s, b_s, a_h, h_pre, h0, s0):
    """Launch K11 (``lucy_dual_scan_fwd``) on the current stream."""
    B, T, D = _check(a_s, [("b_s", b_s), ("a_h", a_h), ("h_pre", h_pre)])
    dev = a_s.device
    h32, s32 = _check_carry(h0, s0, B, D, dev)
    planes = [x.contiguous() for x in (a_s, b_s, a_h, h_pre)]
    from statecatcher_tpu_torch.ops._kernels import library

    h_all = torch.empty_like(planes[0])
    s_all = torch.empty_like(planes[0])
    with torch.cuda.device(dev):
        err = library("lucy_cell_scan").lucy_dual_scan_fwd(
            _DTYPE_CODE[a_s.dtype], *(x.data_ptr() for x in planes), h32.data_ptr(),
            s32.data_ptr(), h_all.data_ptr(), s_all.data_ptr(), B, T, D, _stream(dev))
    if err != 0:
        raise RuntimeError(f"lucy_dual_scan_fwd launch failed: cudaError {err}")
    lucy_dual_scan.launches += 1
    return h_all, s_all


# --------------------------------------------------------------------------- #
# K12 and K11: autograd Functions
# --------------------------------------------------------------------------- #
def _prev(x0, x_all, dt):
    """(x0, x_0 … x_{T−2}): each step's incoming state, in ``dt``."""
    return torch.cat([x0.to(dt)[:, None], x_all.to(dt)[:, :-1]], dim=1)


class _FusedMaskedCell(torch.autograd.Function):
    """K12 forward; backward as the JAX package's ``_fused_bwd``."""

    @staticmethod
    def forward(ctx, gates, h0, s0, frame_mask):
        if gates.is_cuda:
            h_all, s_all = _fused_cell_kernel(gates, h0, s0, frame_mask)
        else:
            h_all, s_all = lucy_fused_cell_ref(gates, h0, s0, frame_mask)
        ctx.save_for_backward(gates, h0, s0, h_all, s_all, frame_mask)
        ctx.set_materialize_grads(False)
        return h_all, s_all

    @staticmethod
    def backward(ctx, g_h, g_s):
        gates, h0, s0, h_all, s_all, frame_mask = ctx.saved_tensors
        if g_h is None and g_s is None:
            return None, None, None, None
        cdt = torch.promote_types(gates.dtype, torch.float32)
        g_h = torch.zeros_like(h_all, dtype=cdt) if g_h is None else g_h.to(cdt)
        g_s = torch.zeros_like(s_all, dtype=cdt) if g_s is None else g_s.to(cdt)
        # the gate chain recomputed in float32, its VJP by autograd
        with torch.enable_grad():
            g32 = gates.detach().to(cdt).requires_grad_()
            coeffs = lucy_gate_coeffs(_lane_major(g32), frame_mask)
        a_s, _, a_h, bh_c, h_pre_n = (x.detach() for x in coeffs)
        c = torch.tanh(h_pre_n + s_all.to(cdt))

        # h-recurrence adjoint: h_t = a_h·h_{t−1} + bh_c·c_t
        lam_h = linear_scan_rev(a_h, g_h)
        d_a_h = lam_h * _prev(h0, h_all, cdt)
        d_bhc = lam_h * c
        d_pre_s = (lam_h * bh_c) * (1.0 - c * c)      # c = tanh(h_pre_n + s)
        dh0 = lam_h[:, 0] * a_h[:, 0]
        # s-recurrence adjoint: the external g_s and the path through c
        lam_s = linear_scan_rev(a_s, g_s + d_pre_s)
        d_a_s = lam_s * _prev(s0, s_all, cdt)
        ds0 = lam_s[:, 0] * a_s[:, 0]
        (d_gates,) = torch.autograd.grad(coeffs, g32, (d_a_s, lam_s, d_a_h, d_bhc, d_pre_s))
        return d_gates.to(gates.dtype), dh0.to(h0.dtype), ds0.to(s0.dtype), None


def lucy_fused_cell(gates: torch.Tensor, h0: torch.Tensor, s0: torch.Tensor,
                    frame_mask: Optional[torch.Tensor] = None):
    """Fused 7-gate cell (K12): gates (B, T, 7, D) float32 or bfloat16
    (float64 on the CPU) with the bias already added, h0, s0 (B, D), an
    optional bool frame mask (B, T) → (h_all, s_all) (B, T, D) in the gates'
    dtype, differentiable in gates, h0 and s0.

    On CUDA tensors the forward launches ``lucy_fused_cell_fwd`` on the
    current stream (counted in ``lucy_fused_cell.launches``) and the backward
    K5b twice; on CPU tensors both run their plain versions."""
    return _FusedMaskedCell.apply(gates, h0, s0, frame_mask)


lucy_fused_cell.launches = 0


class _DualScan(torch.autograd.Function):
    """K11 forward; backward as the JAX package's ``_dual_bwd``."""

    @staticmethod
    def forward(ctx, a_s, b_s, a_h, h_pre, h0, s0):
        if a_s.is_cuda:
            h_all, s_all = _dual_scan_kernel(a_s, b_s, a_h, h_pre, h0, s0)
        else:
            h_all, s_all = lucy_dual_scan_ref(a_s, b_s, a_h, h_pre, h0, s0)
        ctx.save_for_backward(a_s, a_h, h_pre, h0, s0, h_all, s_all)
        ctx.b_dtype = b_s.dtype
        ctx.set_materialize_grads(False)
        return h_all, s_all

    @staticmethod
    def backward(ctx, g_h, g_s):
        a_s, a_h, h_pre, h0, s0, h_all, s_all = ctx.saved_tensors
        if g_h is None and g_s is None:
            return (None,) * 6
        cdt = torch.promote_types(a_s.dtype, torch.float32)
        g_h = torch.zeros_like(h_all, dtype=cdt) if g_h is None else g_h.to(cdt)
        g_s = torch.zeros_like(s_all, dtype=cdt) if g_s is None else g_s.to(cdt)
        a_s32, a_h32 = a_s.to(cdt), a_h.to(cdt)
        c = torch.tanh(h_pre.to(cdt) + s_all.to(cdt))

        # h-recurrence adjoint: h_t = a_h·h_{t−1} + (1 − a_h)·c_t
        lam_h = linear_scan_rev(a_h32, g_h)
        d_a_h = lam_h * (_prev(h0, h_all, cdt) - c)
        d_pre = (lam_h * (1.0 - a_h32)) * (1.0 - c * c)   # c = tanh(h_pre + s)
        dh0 = lam_h[:, 0] * a_h32[:, 0]
        # s-recurrence adjoint: the external g_s and the path through c
        lam_s = linear_scan_rev(a_s32, g_s + d_pre)
        d_a_s = lam_s * _prev(s0, s_all, cdt)
        ds0 = lam_s[:, 0] * a_s32[:, 0]
        return (d_a_s.to(a_s.dtype), lam_s.to(ctx.b_dtype), d_a_h.to(a_h.dtype),
                d_pre.to(h_pre.dtype), dh0.to(h0.dtype), ds0.to(s0.dtype))


def lucy_dual_scan(a_s: torch.Tensor, b_s: torch.Tensor, a_h: torch.Tensor,
                   h_pre: torch.Tensor, h0: torch.Tensor, s0: torch.Tensor):
    """Dual scan (K11): a_s, b_s, a_h, h_pre_n (B, T, D) in one dtype,
    float32 or bfloat16 (float64 on the CPU), h0, s0 (B, D) → (h_all, s_all)
    (B, T, D) in a_s's dtype, differentiable in all six.

    On CUDA tensors the forward launches ``lucy_dual_scan_fwd`` on the
    current stream (counted in ``lucy_dual_scan.launches``) and the backward
    K5b twice; on CPU tensors both run their plain versions."""
    return _DualScan.apply(a_s, b_s, a_h, h_pre, h0, s0)


lucy_dual_scan.launches = 0
