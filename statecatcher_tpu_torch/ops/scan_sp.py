"""Sequence-parallel linear scan: a segment's time axis split over the ranks
of a model group.

Port of ``statecatcher_tpu/ops/scan_sp.py``.  Each rank scans its time
shard from the zero state (the linear scan K5a on the card, its plain
version on the CPU; K5b in backward) and forms its total affine map
(A_tot, S_tot).  The maps are exchanged with ONE ``all_gather`` (the design
JAX's docstring describes; its code passes them round a ring, whose
arithmetic the local fold repeats step for step), every rank folds the maps
of the ranks before it onto s0 in rank order, and applies the incoming
state to its shard:

    s_in(p) = fold_{j<p} (A_j, S_j) applied to s0     (s ↦ A_j·s + S_j)
    out_t   = S_local_t + A_cum_t · s_in(p)

The exchange's backward sums each map's cotangent over the ranks and hands
it to the rank that owns the map; the cotangent of the replicated s0 is
summed over the group (JAX's ``check_vma=False`` boundary).  Cross-rank
traffic: P·2·B·D values a scan, and in backward the same reduced.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from statecatcher_tpu_torch.parallel.distributed import RankGroup, gather_dim, shard_dim

# the active model group of kernel_impl="sp" scans, set around a train step
_ACTIVE = threading.local()


@contextlib.contextmanager
def sequence_parallel_scans(plan, axis_name: str = "model"):
    """Activate time-sharded scans for ``kernel_impl="sp"`` within the block:
    the time axis is split over ``plan``'s model group, whose ranks hold the
    same rows (a data group's ranks hold different rows, so the sequence
    axis is the model axis).  A 1×1 plan is a one-rank context."""
    if axis_name != "model":
        raise ValueError(f"the sequence axis is the mesh's 'model' axis, not {axis_name!r}")
    prev = getattr(_ACTIVE, "group", None)
    _ACTIVE.group = plan.model
    try:
        yield
    finally:
        _ACTIVE.group = prev


def linear_scan_sp(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """``linear_scan`` impl="sp": a, b (B, T, D) and s0 (B, D), replicated
    over the active group (``sequence_parallel_scans``), → the full scan on
    every rank.  T is padded to a multiple of the group's size with identity
    steps (a = 1, b = 0)."""
    group = getattr(_ACTIVE, "group", None)
    if group is None:
        raise RuntimeError(
            "kernel_impl='sp' needs an active sequence_parallel_scans(mesh) "
            "context — enable mesh.sequence_parallel in the train config, or "
            "wrap the call site")
    B, T, D = a.shape
    pad = (-T) % group.size
    if pad:
        a = torch.cat([a, a.new_ones((B, pad, D))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, D))], dim=1)
    out = linear_scan_time_sharded(shard_dim(a, group, 1), shard_dim(b, group, 1), s0, group)
    return gather_dim(out, group, 1)[:, :T]


def linear_scan_time_sharded(a: torch.Tensor, b: torch.Tensor, s0: torch.Tensor,
                             group: RankGroup) -> torch.Tensor:
    """s_t = a_t·s_{t−1} + b_t with T split over ``group``: a, b are this
    rank's (B, T/P, D) shard (rank p holds steps [p·T/P, (p+1)·T/P)), s0 the
    replicated (B, D) entry state; returns this rank's shard of the scan.
    Differentiable."""
    from statecatcher_tpu_torch.ops.lucy_pallas import linear_scan_pallas

    S_loc = linear_scan_pallas(a, b, torch.zeros_like(s0, dtype=a.dtype))
    A_cum = torch.cumprod(a, dim=1)
    s_in = _Exchange.apply(A_cum[:, -1], S_loc[:, -1], s0.to(a.dtype), group)
    return S_loc + A_cum * s_in[:, None, :]


class _Exchange(torch.autograd.Function):
    """(A_tot, S_tot) of every rank by one all_gather, folded in rank order
    onto s0 up to this rank → its incoming state s_in.  Backward walks the
    fold in reverse for the cotangents of the maps before this rank and of
    s0, and sums them over the group with one all_reduce (every rank makes
    the same collectives, whatever its place): each rank keeps its own
    map's, and s0's is the group's sum."""

    @staticmethod
    def forward(ctx, A_tot, S_tot, s0, group):
        maps = torch.stack(group.all_gather(torch.stack([A_tot, S_tot])))   # (P, 2, B, D)
        ins = [s0]
        for j in range(group.index):
            ins.append(maps[j, 0] * ins[-1] + maps[j, 1])
        ctx.group = group
        ctx.save_for_backward(maps, *ins)
        return ins[-1].clone()

    @staticmethod
    def backward(ctx, g):
        maps, *ins = ctx.saved_tensors
        group = ctx.group
        d_maps = torch.zeros_like(maps)
        for j in reversed(range(group.index)):
            d_maps[j, 0] = g * ins[j]
            d_maps[j, 1] = g
            g = g * maps[j, 0]
        red = group.all_reduce(torch.cat([d_maps.flatten(), g.flatten()]))
        d_maps = red[:maps.numel()].view_as(maps)
        d_s0 = red[maps.numel():].view_as(g)
        return d_maps[group.index, 0], d_maps[group.index, 1], d_s0, None
