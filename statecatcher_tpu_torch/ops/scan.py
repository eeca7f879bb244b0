"""First-order linear recurrence  s_t = a_t · s_{t-1} + b_t  over time.

Port of ``statecatcher_tpu/ops/scan.py``: ``linear_scan_seq``, the plain
sequential scan, one step per time index, in the recurrence order of the
reference (the plain version the cell and scan kernels are held against),
and ``linear_scan``, which dispatches on ``impl`` as the JAX function does.
Every scan algorithm there computes the same recurrence, so here every one
of them is the scan kernel K5 (``ops/lucy_pallas.py``): on the card its CUDA
kernels, on the CPU their plain versions.  "sp" is the sequence-parallel
scan (``ops/scan_sp.py``), whose ranks each run K5 on their time shard.
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


SCAN_IMPLS = ("auto", "assoc", "chunked", "xla-scan", "pallas", "sp")


def linear_scan(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """s_t = a_t·s_{t−1} + b_t for (B, T, D) a, b and (B, D) s0, through K5
    (``linear_scan_pallas``), differentiable.  ``impl`` "sp" is the
    sequence-parallel scan (``ops/scan_sp.py:linear_scan_sp``), which raises
    outside a ``sequence_parallel_scans`` context."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"Unknown scan impl {impl!r}")
    if impl == "sp":
        from statecatcher_tpu_torch.ops.scan_sp import linear_scan_sp

        return linear_scan_sp(a, b, s0)
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_pallas

    return linear_scan_pallas(a, b, s0)
