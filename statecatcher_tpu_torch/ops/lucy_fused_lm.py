"""Fused lane-major LucyRNN cell, forward: gate chain + both scans.

Replaces the TPU kernel ``statecatcher_tpu/ops/lucy_fused_lm.py:156
_fwd_kernel`` (launched by ``_fused_lm_fwd_impl``, :196) with the CUDA kernel
``ops/csrc/lucy_fused_lm_fwd.cu``.  The function is the same: lane-major
gates (B, T, 7·D) with the bias unapplied, h0 and s0 (B, D) → h_all and
s_all (B, T, D) in the gates' dtype, all math in f32.

Bound on the card: bytes — 7 gate planes read, 2 planes written.  At the
batched shape (B=32, T=1598, D=512) that is 942.5 MB in f32, 0.281 ms at
3.35 TB/s (471.3 MB, 0.141 ms in bf16); the ~56 operations per element are
0.022 ms at the f32 peak.  The kernel walks time in registers, one thread
per (b, d) column, and writes nothing but h_all and s_all; its limit today
is latency, not bytes (too few threads to cover it — see the source note).

``lucy_cell_fused_lm_ref`` is the plain version: ``ops/lucy_gates.py`` then
two ``ops/scan.py`` sequential scans, in f32 (f64 for f64 gates).  The
wrapper runs it only for tensors on the CPU; on the card it launches the
kernel or raises.  The kernel has no backward yet (the TPU kernel's backward
is K2, ported with training), so a CUDA input that requires grad raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
from statecatcher_tpu_torch.ops.scan import linear_scan_seq

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lucy_cell_fused_lm_ref(gates: torch.Tensor, bias: torch.Tensor,
                           h0: torch.Tensor, s0: torch.Tensor,
                           frame_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused cell: (h_all, s_all) in the gates'
    dtype, computed in float32 (float64 for float64 gates).  ``frame_mask``
    (B, T) holds (h, s) over masked steps; the kernel has no mask input."""
    cdt = torch.promote_types(gates.dtype, torch.float32)
    a_s, b_s, a_h, bh_c, h_pre_n = lucy_gate_coeffs(
        gates.to(cdt), frame_mask, bias.to(cdt))
    s_all = linear_scan_seq(a_s, b_s, s0.to(cdt))
    c = torch.tanh(h_pre_n + s_all)
    h_all = linear_scan_seq(a_h, bh_c * c, h0.to(cdt))
    return h_all.to(gates.dtype), s_all.to(gates.dtype)


def lucy_cell_fused_lm(gates: torch.Tensor, bias: torch.Tensor,
                       h0: torch.Tensor, s0: torch.Tensor):
    """Fused 7-gate cell: gates (B, T, 7D) f32/bf16 unbiased, bias (7D), h0,
    s0 (B, D) → (h_all, s_all) (B, T, D) in the gates' dtype.

    On CUDA tensors this launches ``lucy_fused_lm_fwd`` on the current stream
    and counts it in ``lucy_cell_fused_lm.launches``; on CPU tensors it runs
    the plain version.
    """
    if not gates.is_cuda:
        return lucy_cell_fused_lm_ref(gates, bias, h0, s0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (gates, bias, h0, s0)):
        raise NotImplementedError(
            "lucy_cell_fused_lm has no backward kernel yet (K2, ported with "
            "the training slice); run inference under torch.inference_mode()")
    if gates.dtype not in _DTYPE_CODE:
        raise TypeError(f"gates must be float32 or bfloat16, got {gates.dtype}")
    if gates.ndim != 3 or gates.shape[-1] % 7:
        raise ValueError(f"gates must be (B, T, 7·D), got {tuple(gates.shape)}")
    B, T, G7 = gates.shape
    D = G7 // 7
    if min(B, T, D) == 0 or B > 65535:
        raise ValueError(f"unsupported gates shape {tuple(gates.shape)}")
    if bias.shape != (G7,) or h0.shape != (B, D) or s0.shape != (B, D):
        raise ValueError(
            f"bias {tuple(bias.shape)}, h0 {tuple(h0.shape)}, s0 "
            f"{tuple(s0.shape)} do not fit gates {tuple(gates.shape)}")
    dev = gates.device
    for name, t in (("bias", bias), ("h0", h0), ("s0", s0)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, gates on {dev}")
    if not gates.is_contiguous():
        raise ValueError("gates must be contiguous")
    bias32 = bias.to(torch.float32).contiguous()
    h32 = h0.to(torch.float32).contiguous()
    s32 = s0.to(torch.float32).contiguous()

    from statecatcher_tpu_torch.ops._kernels import library

    fn = library("lucy_fused_lm_fwd").lucy_fused_lm_fwd
    h_all = torch.empty((B, T, D), dtype=gates.dtype, device=dev)
    s_all = torch.empty((B, T, D), dtype=gates.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[gates.dtype], gates.data_ptr(), bias32.data_ptr(),
                 h32.data_ptr(), s32.data_ptr(), h_all.data_ptr(),
                 s_all.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"lucy_fused_lm_fwd launch failed: cudaError {err}")
    lucy_cell_fused_lm.launches += 1
    return h_all, s_all


lucy_cell_fused_lm.launches = 0
