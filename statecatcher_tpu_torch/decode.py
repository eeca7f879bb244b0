"""CTC greedy decoding.

Port of ``statecatcher_tpu/decode.py:18-47`` (reference decoder.py:3-30
semantics: argmax → collapse repeats → drop blanks → trim to in_lens),
vectorised: the collapse/drop is a boolean keep-mask, and only the dense
(preds, keep) pair goes to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_decode(log_probs: torch.Tensor, in_lens: torch.Tensor,
                      blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) scores, (B,) lengths → (preds (B, T) int32, keep (B, T) bool).

    ``preds[b, t]`` is kept iff it is not blank, differs from the previous
    frame's argmax, and ``t < in_lens[b]``.
    """
    preds = torch.argmax(log_probs, dim=-1).to(torch.int32)
    B, T = preds.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=preds.dtype, device=preds.device),
                      preds[:, :-1]], dim=1)
    t_idx = torch.arange(T, device=preds.device)[None, :]
    keep = (preds != blank_id) & (preds != prev) & (t_idx < in_lens.to(preds.device)[:, None])
    return preds, keep


def keep_to_token_lists(preds, keep) -> list[list[int]]:
    """Host-side: dense (preds, keep) → ragged per-utterance token lists."""
    preds = preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
    keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else np.asarray(keep)
    return [[int(x) for x in row[k]] for row, k in zip(preds, keep)]


def ctc_greedy_decode_to_lists(log_probs: torch.Tensor, in_lens: torch.Tensor,
                               blank_id: int = 0) -> list[list[int]]:
    preds, keep = ctc_greedy_decode(log_probs, in_lens, blank_id)
    return keep_to_token_lists(preds, keep)
