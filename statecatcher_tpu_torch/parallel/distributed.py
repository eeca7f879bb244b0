"""Process start-up and cross-rank plumbing for multi-GPU training.

Port of ``statecatcher_tpu/parallel/distributed.py`` over
``torch.distributed``: one process per GPU, started by ``torchrun`` (or by
anything that sets its environment: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), NCCL between cards and
gloo on the CPU.  The backend is the caller's choice; nothing here switches
it.  One process does not drive several local devices on its own, unlike
JAX.

  * ``initialize_distributed`` reads that environment, binds the process to
    its card (``torch.cuda.set_device``) before any launch and joins the
    process group; for one process it is a no-op;
  * ``sync_int`` (K and the token padding U: every rank must agree) and
    ``shared_run_dir`` (rank 0's run directory for every rank);
  * ``gather_rows`` and ``local_rows`` (the counterparts of ``make_global``
    and ``local_rows``): a data rank owns the rows ``d::dp`` of the global
    batch (interleaved: with the local dataset's file striding, global row g
    is the 1-process run's row g, so checkpoints carry over between world
    sizes);
  * ``RankGroup``: a set of ranks and the differentiable collectives the
    tensor- and sequence-parallel layers are built from.  A group whose
    ``pg`` is None is one rank with no process group: every collective is
    the identity there.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from statecatcher_tpu_torch import resolve_device

logger = logging.getLogger("statecatcher.distributed")

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass
class HostTopology:
    process_index: int
    process_count: int
    local_rank: int
    device: torch.device
    backend: Optional[str]            # None for one process


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``"cuda"`` without an index is ``cuda:LOCAL_RANK``;
    an explicit index (several ranks on one card, under gloo) or the CPU is
    kept.  A CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def initialize_distributed(backend: Optional[str] = None, device="cuda") -> HostTopology:
    """Join the process group torchrun's environment describes.

    ``backend`` defaults to "nccl" on a CUDA device and "gloo" on the CPU;
    NCCL refuses two ranks of one communicator on one card, so ranks that
    share a card pass "gloo".  For one process (no ``WORLD_SIZE`` > 1) it
    only resolves the device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1:
        return HostTopology(0, 1, local, dev, None)
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but torchrun's {missing} are not set")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            world_size=world, rank=rank, **kwargs)
    topo = HostTopology(rank, world, local, dev, dist.get_backend())
    logger.info("distributed topology: rank %d/%d (local %d) on %s over %s",
                rank, world, local, dev, topo.backend)
    return topo


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def per_host_batch_size(global_batch: int, shards: int) -> int:
    """Each data rank owns an equal share of the global batch."""
    if global_batch % shards != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {shards} data ranks")
    return global_batch // shards


def _comm_device(pg) -> torch.device:
    """Where a host value goes for a collective of ``pg``: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(pg) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass
class RankGroup:
    """Ranks in group order, this rank's place among them and their process
    group (None: one rank, no process group).  ``stats`` counts the bytes
    this rank sent into each kind of collective."""

    ranks: tuple
    index: int
    pg: object = None
    stats: dict = field(default_factory=lambda: {"all_reduce": 0, "all_gather": 0,
                                                 "broadcast": 0})

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place; returns ``t``."""
        if self.pg is not None:
            self.stats["all_reduce"] += t.numel() * t.element_size()
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                                   "min": dist.ReduceOp.MIN}[op], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape everywhere), in group order."""
        if self.pg is None:
            return [t]
        t = t.contiguous()
        self.stats["all_gather"] += t.numel() * t.element_size()
        out = [torch.empty_like(t) for _ in self.ranks]
        dist.all_gather(out, t, group=self.pg)
        return out

    def broadcast(self, t: torch.Tensor, src_index: int = 0) -> torch.Tensor:
        if self.pg is not None:
            self.stats["broadcast"] += t.numel() * t.element_size()
            dist.broadcast(t, src=self.ranks[src_index], group=self.pg)
        return t

    def barrier(self) -> None:
        if self.pg is not None:
            dist.barrier(group=self.pg)

    def broadcast_object(self, obj, src_index: int = 0):
        """The ``src_index`` rank's picklable ``obj`` on every rank."""
        if self.pg is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src_index], group=self.pg,
                                   device=_comm_device(self.pg))
        return box[0]


def world_group() -> RankGroup:
    """Every rank (one rank without a process group)."""
    if not dist.is_initialized():
        return RankGroup((0,), 0)
    n = dist.get_world_size()
    return RankGroup(tuple(range(n)), dist.get_rank(), dist.group.WORLD)


def psum_scalar(x: torch.Tensor, group: Optional[RankGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (every rank by default)."""
    return (group or world_group()).all_reduce(x.clone())


def sync_int(value: int, reduce: str = "max") -> int:
    """Cross-rank agreement on a host integer (the segment count K, the token
    padding U, ...) over every rank.  No-op for one rank."""
    group = world_group()
    if group.pg is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device(group.pg))
    return int(group.all_reduce(t, reduce).item())


def shared_run_dir(run_dir: str, max_len: int = 512) -> str:
    """Every rank adopts rank 0's run directory.  No-op for one rank."""
    group = world_group()
    if group.pg is None:
        return run_dir
    raw = run_dir.encode("utf-8")[:max_len]
    buf = torch.zeros(max_len, dtype=torch.uint8, device=_comm_device(group.pg))
    buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    group.broadcast(buf)
    out = buf.cpu()
    return bytes(out[out != 0].tolist()).decode("utf-8")


def gather_rows(x: torch.Tensor, data: RankGroup) -> torch.Tensor:
    """The global-B tensor from each data rank's (B/dp, ...) rows: global row
    g is data rank g % dp's local row g // dp."""
    parts = data.all_gather(x)
    if len(parts) == 1:
        return parts[0]
    return torch.stack(parts, dim=1).reshape(-1, *x.shape[1:])


def local_rows(x: torch.Tensor, data: RankGroup) -> torch.Tensor:
    """A data rank's rows ``d::dp`` of a global-B tensor."""
    return x[data.index::data.size]


# --------------------------------------------------------------------------
# Differentiable collectives.  The layers around them are computed alike on
# every rank of the group (replicated), so a replicated value's gradient is
# taken once, not summed over the ranks that hold it.
# --------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward sums the cotangent over the group
    (Megatron's f: a replicated input whose ranks each use a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _GatherDim(torch.autograd.Function):
    """Each rank's chunk concatenated along ``dim``; backward takes this
    rank's chunk (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(group.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.group.index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _ShardDim(torch.autograd.Function):
    """This rank's chunk of a replicated tensor along ``dim``; backward
    gathers every rank's chunk cotangent (the producer is replicated)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.group.all_gather(g.contiguous()), dim=ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def gather_dim(x: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    return _GatherDim.apply(x, group, dim)


def shard_dim(x: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    return _ShardDim.apply(x, group, dim)
