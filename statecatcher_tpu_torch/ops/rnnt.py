"""RNN-T (transducer) loss: the lattice recursion differentiated by autograd.

Port of ``statecatcher_tpu/ops/rnnt.py``.  The lattice

    α(t,u) = logaddexp(α(t−1,u) + blank(t−1,u),  α(t,u−1) + emit(t,u−1))

runs as a loop over the anti-diagonals d = t + u, one vector of torch
operations a diagonal: ``rnnt_lattice.rnnt_alpha_ref``, the plain version of
K7a, differentiated by autograd.  Two front ends:

  * ``rnnt_loss(logits, ...)`` takes dense (B, T, U+1, V) joint logits;
  * ``rnnt_loss_fused(...)`` forms blank/emit from the joiner's projections
    one time chunk at a time under ``torch.utils.checkpoint``, so the
    (B, C, U+1, V) logits exist only per chunk (``jax.checkpoint`` in the
    JAX package).  This is ``train.rnnt_impl="xla"``.

Logits and log-softmax are taken in at least float32 (float64 stays
float64).  Normalisation: the mean over rows (or over valid rows) of the
per-utterance NLL.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from statecatcher_tpu_torch.ops.rnnt_lattice import nll_from_alpha, rnnt_alpha_ref

__all__ = ["blank_emit_from_log_probs", "rnnt_alphas", "rnnt_loss", "rnnt_loss_fused",
           "rnnt_loss_per_example", "rnnt_nll_from_blank_emit"]


def rnnt_alphas(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                t_lens: torch.Tensor) -> torch.Tensor:
    """Forward lattice; returns α at each row's last processed frame,
    (B, U+1).  Frames t ≥ t_len leave α unchanged; frame 0 is always taken,
    as in the JAX package, so a row with t_len = 0 reads it."""
    return rnnt_alpha_ref(blank_lp, emit_lp, torch.clamp(t_lens, min=1))[:, -1]


def rnnt_nll_from_blank_emit(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                             t_lens: torch.Tensor, u_lens: torch.Tensor) -> torch.Tensor:
    """Per-example NLL (B,): −[α(t_len−1, u_len) + blank(t_len−1, u_len)],
    through the plain α (differentiated by autograd)."""
    alpha = rnnt_alpha_ref(blank_lp, emit_lp, torch.clamp(t_lens, min=1))
    return nll_from_alpha(alpha, blank_lp.to(alpha.dtype), t_lens, u_lens)


def blank_emit_from_log_probs(log_probs: torch.Tensor, labels: torch.Tensor,
                              blank_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, U+1, V) log-probs → (blank (B, T, U+1), emit (B, T, U))."""
    B, T, U1, _ = log_probs.shape
    lbl = labels.to(torch.int64)[:, None, :, None].expand(B, T, U1 - 1, 1)
    return log_probs[..., blank_id], torch.gather(log_probs[:, :, :U1 - 1], 3, lbl)[..., 0]


def rnnt_loss_per_example(log_probs, labels, t_lens, u_lens, blank_id: int = 0):
    blank_lp, emit_lp = blank_emit_from_log_probs(log_probs, labels, blank_id)
    return rnnt_nll_from_blank_emit(blank_lp, emit_lp, t_lens, u_lens)


def _reduce(per: torch.Tensor, row_valid) -> torch.Tensor:
    if row_valid is None:
        return per.mean()
    valid = row_valid.to(per.dtype)
    return (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
              u_lens: torch.Tensor, blank_id: int = 0,
              row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense-API transducer loss: log-softmax of the (B, T, U+1, V) logits in
    at least float32, mean over (valid) rows."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    log_probs = torch.log_softmax(logits.to(acc), dim=-1)
    return _reduce(rnnt_loss_per_example(log_probs, labels, t_lens, u_lens, blank_id), row_valid)


def _chunk_blank_emit(enc_chunk, pred_proj, join_kernel, join_bias, labels, blank_id: int):
    """(B, C, J) encoder chunk → (blank (B, C, U+1), emit (B, C, U)): the
    tanh joint and its logits, normalised at the two gathered columns."""
    joint = torch.tanh(enc_chunk[:, :, None, :] + pred_proj[:, None, :, :])
    acc = torch.promote_types(joint.dtype, torch.float32)
    logits = (joint @ join_kernel.to(joint.dtype) + join_bias.to(joint.dtype)).to(acc)
    log_z = torch.logsumexp(logits, dim=-1)
    B, C, U1, _ = logits.shape
    lbl = labels.to(torch.int64)[:, None, :, None].expand(B, C, U1 - 1, 1)
    emit = torch.gather(logits[:, :, :U1 - 1], 3, lbl)[..., 0] - log_z[:, :, :U1 - 1]
    return logits[..., blank_id] - log_z, emit


def rnnt_loss_fused(enc_proj: torch.Tensor, pred_proj: torch.Tensor, join_kernel: torch.Tensor,
                    join_bias: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                    u_lens: torch.Tensor, blank_id: int = 0,
                    row_valid: Optional[torch.Tensor] = None, time_chunk: int = 32,
                    return_per: bool = False):
    """Transducer loss fused with the add-joiner: the joint logits exist only
    inside one recomputed time chunk of ``time_chunk`` frames at a time."""
    T = enc_proj.shape[1]
    blanks, emits = [], []
    for t0 in range(0, T, time_chunk):
        b, e = checkpoint(_chunk_blank_emit, enc_proj[:, t0:t0 + time_chunk], pred_proj,
                          join_kernel, join_bias, labels, blank_id, use_reentrant=False)
        blanks.append(b)
        emits.append(e)
    per = rnnt_nll_from_blank_emit(torch.cat(blanks, dim=1), torch.cat(emits, dim=1),
                                   t_lens, u_lens)
    loss = _reduce(per, row_valid)
    return (loss, per) if return_per else loss
