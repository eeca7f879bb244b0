"""First-order linear recurrence  s_t = a_t · s_{t-1} + b_t  over time.

Port of ``statecatcher_tpu/ops/scan.py:linear_scan_seq``: the plain
sequential scan, one step per time index, in the recurrence order of the
reference.  It is the plain version the fused cell kernel is held against;
on the card the recurrence runs inside that kernel (ops/lucy_fused_lm.py).
"""

from __future__ import annotations

import torch


def linear_scan_seq(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D); s0: (B, D) → s: (B, T, D) with s_t = a_t·s_{t−1} + b_t."""
    out = torch.empty_like(b)
    s = s0
    for t in range(b.shape[1]):
        s = a[:, t] * s + b[:, t]
        out[:, t] = s
    return out
