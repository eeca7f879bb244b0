"""The first-order linear scan s_t = a_t·s_{t−1} + b_t with its adjoint:
K5a (forward) and K5b (reverse adjoint scan).

Replaces two TPU kernels of ``statecatcher_tpu/ops/lucy_pallas.py``:

  * K5a, ``_scan_kernel`` (:35, launched by ``_linear_scan_pallas_fwd_impl``,
    :79) → ``linear_scan_fwd`` of ``ops/csrc/linear_scan.cu``: a, b
    (B, T, D) and s0 (B, D) → s (B, T, D) in a's dtype;
  * K5b, ``_rev_scan_kernel`` (:118, launched by
    ``_linear_scan_pallas_rev_impl``, :174) → ``linear_scan_rev``: a and the
    cotangent g (B, T, D) → λ_t = g_t + a_{t+1}·λ_{t+1} (λ past T−1 is 0) in
    a's dtype.

Both carry the state in float32 whatever the inputs' dtype and round only
what they write (under bf16, s and λ are rounded on output), as the TPU
kernels' float32 carry does.  ``linear_scan_pallas`` is a
``torch.autograd.Function`` over the two, as the JAX package's
``custom_vjp`` is: da = λ·s_{t−1}, db = λ, ds0 = λ_0·a_0.

Bound on the card (bytes; see the source): each kernel reads two planes of
B·T·D and writes one, 0.094 ms at (B=32, T=1598, D=512) f32.

``linear_scan_ref`` (``ops/scan.py:linear_scan_seq`` in float32) and
``linear_scan_rev_ref`` are the plain versions.  Each wrapper runs its plain
version only for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch

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
    if a.ndim != 3 or min(a.shape) == 0 or a.shape[0] * a.shape[2] > 2**31 - 1:
        raise ValueError(f"a must be a non-empty (B, T, D), got {tuple(a.shape)}")
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
