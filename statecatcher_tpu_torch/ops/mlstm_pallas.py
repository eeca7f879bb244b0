"""The chunkwise mLSTM forward in the head-major layout: K10.

Replaces the TPU kernel ``_mlstm_kernel`` of
``statecatcher_tpu/ops/mlstm_pallas.py`` (:30, launched by
``_pallas_forward``, :110) → ``mlstm_pallas_fwd`` of
``ops/csrc/mlstm_pallas.cu``.  ``xlstm.kernel_impl="pallas"`` takes it.

The wrapper does what ``_pallas_forward`` does around the kernel: it pads T
to a chunk multiple (the raw input gate with −1e30 and the raw forget gate
with +30, *before* the soft cap: a padded step is ĩ = −15 and logf ≈ −5e-7,
not an exact no-op), scales q by dqk^-½, soft-caps the gates and takes the
log-sigmoid of the forget gate, all in float32.  q, k and v are not copied
to the padded length: the kernels read their rows t ≥ T as 0, which is the
JAX package's zero padding, and write h (B, H, T, dv) in float32.  The
backward is autograd of ``models/xlstm.py:mlstm_chunkwise`` on the saved
inputs (recomputed, as the JAX package's ``_bwd``, :193).

The plain version of K10 is ``mlstm_chunkwise`` itself.  The wrapper runs it
only for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from statecatcher_tpu_torch.ops.mlstm_fused import NEG, check_launch, soft_cap


def _check(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size: int):
    """Shapes (B, H, T, dqk, dv) of a K10 call; raises on what the kernel does
    not take."""
    B, H, T, dqk = q.shape
    dv = v.shape[-1]
    for name, t, shape in (("k", k, (B, H, T, dqk)), ("v", v, (B, H, T, dv)),
                           ("i_raw", i_raw, (B, H, T)), ("f_raw", f_raw, (B, H, T)),
                           ("C0", C0, (B, H, dqk, dv)), ("n0", n0, (B, H, dqk)),
                           ("m0", m0, (B, H))):
        if tuple(t.shape) != shape or t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} must be {shape} "
                             f"float32 on {q.device}")
    if q.dtype != torch.float32:
        raise ValueError(f"K10 takes float32 inputs; got {q.dtype}")
    check_launch(B * H, -(-T // chunk_size), chunk_size, dqk, dv, False, T + chunk_size, dqk, dv)
    return B, H, T, dqk, dv


def mlstm_pallas_fwd(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size: int,
                     gate_soft_cap: float = 15.0):
    """K10: q, k (B, H, T, dqk), v (B, H, T, dv), raw gates (B, H, T), carry
    (C0, n0, m0), all float32 → (h (B, H, T, dv), C_T, n_T, m_T) float32.
    On CUDA tensors this launches ``mlstm_pallas_fwd`` and counts it in
    ``mlstm_pallas_fwd.launches``; on CPU tensors it runs ``mlstm_chunkwise``."""
    if not q.is_cuda:
        from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise

        return mlstm_chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size, gate_soft_cap)
    B, H, T, dqk, dv = _check(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size)
    L = chunk_size
    pad = (-T) % L
    if pad:
        i_raw = F.pad(i_raw, (0, pad), value=NEG)
        f_raw = F.pad(f_raw, (0, pad), value=30.0)
    Tp = T + pad
    from statecatcher_tpu_torch.ops._kernels import library

    dev = q.device
    ins = [x.contiguous() for x in (
        q * dqk ** -0.5, k, v, soft_cap(i_raw, gate_soft_cap),
        F.logsigmoid(soft_cap(f_raw, gate_soft_cap)), C0, n0, m0)]
    h = torch.empty((B, H, T, dv), dtype=torch.float32, device=dev)
    C_T, n_T, m_T = (torch.empty_like(x) for x in ins[5:])
    lib = library("mlstm_pallas")
    # per (b, h): each chunk's entry state and the per-row and per-chunk gate terms
    work = torch.empty(lib.mlstm_pallas_fwd_work(B * H, Tp, dqk, dv, L), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.mlstm_pallas_fwd(
            *[t.data_ptr() for t in (*ins, h, C_T, n_T, m_T, work)], B * H, T, Tp, dqk, dv, L,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_pallas_fwd launch failed: cudaError {err}")
    mlstm_pallas_fwd.launches += 1
    return h, C_T, n_T, m_T


mlstm_pallas_fwd.launches = 0


class _MLSTMPallas(torch.autograd.Function):
    """K10 forward; backward by autograd of ``mlstm_chunkwise`` on the saved
    inputs (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size, gate_soft_cap):
        ctx.save_for_backward(q, k, v, i_raw, f_raw, C0, n0, m0)
        ctx.args = (chunk_size, gate_soft_cap)
        return mlstm_pallas_fwd(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size, gate_soft_cap)

    @staticmethod
    def backward(ctx, *cots):
        from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise

        ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            outs = mlstm_chunkwise(*ins, *ctx.args)
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
        return (*(torch.zeros_like(x) if g is None else g for g, x in zip(grads, ins)),
                None, None)


def mlstm_chunkwise_pallas(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size: int,
                           gate_soft_cap: float = 15.0):
    """Chunkwise mLSTM with the K10 forward: shapes and result as
    ``mlstm_pallas_fwd``, differentiable in every input."""
    return _MLSTMPallas.apply(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size, gate_soft_cap)
