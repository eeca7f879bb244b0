"""The ('data', 'model') layout of ranks for data-, tensor- and
sequence-parallel training.

Port of ``statecatcher_tpu/parallel/mesh.py`` over process groups.  A
``dp × mp`` layout puts rank ``d·mp + m`` at (d, m), as JAX's
``devices.reshape(dp, mp)`` does.  Each rank belongs to one data group
(the ranks of its m: the batch rows are split over them and the gradients
summed) and one model group (the ranks of its d: they train on the same
rows and split the work of each layer).

Tensor parallelism (``model_parallel > 1``): JAX shards the output lanes
of a few Dense kernels contiguously (``P(None, "model")``) and lets GSPMD
move the data; here each sharded leaf has a row layout (``tp_rows``) and
the layers move their data by hand:

  * the LucyRNN's gate projections: a rank owns whole hidden columns, the 7
    gates of its D/mp columns, rows ``{g·D + d}`` of ``GateProj.weight``
    (7D, F) and of its bias.  The gate chain and both scans are elementwise
    in d, so a rank runs its cell on its columns with no collective; the
    cell's input is all-reduced in backward and its output gathered along D
    (``models/lucyrnn.py``);
  * the xLSTM's q, k, v and FFN gate and up projections: JAX's own layout,
    contiguous blocks of n/mp rows.  With H % mp == 0 a rank holds whole
    heads of q, k, v and runs the mLSTM on them; h and the FFN's activation
    are gathered before the replicated layers that follow
    (``models/xlstm.py``).

Every other parameter is replicated: all of the LSTM's and the RWKV's (as
in JAX, no leaf of theirs matches), whose model ranks each run the whole
step on their data group's rows.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from statecatcher_tpu_torch.config import MeshConfig
from statecatcher_tpu_torch.parallel.distributed import (
    RankGroup,
    gather_rows,
    local_rows,
    per_host_batch_size,
)
from statecatcher_tpu_torch.train.optim import global_norm


@dataclass
class MeshPlan:
    data: RankGroup           # the ranks of this rank's m (rows split, gradients summed)
    model: RankGroup          # the ranks of this rank's d (same rows; TP columns or SP time)
    world: RankGroup
    # the model group splits the gate projections' columns (tensor
    # parallelism), or, under kernel_impl="sp", the scans' time axis
    sequence_parallel: bool = False

    @property
    def tensor_parallel(self) -> bool:
        return self.model.size > 1 and not self.sequence_parallel

    @property
    def data_size(self) -> int:
        return self.data.size

    @property
    def model_size(self) -> int:
        return self.model.size

    @property
    def is_primary(self) -> bool:
        return self.world.index == 0

    def local_batch(self, global_batch: int) -> int:
        return per_host_batch_size(global_batch, self.data_size)

    def gather_rows(self, tree: dict) -> dict:
        """A dict of this data rank's (B/dp, ...) tensors → the global-B ones."""
        return {k: gather_rows(v, self.data) for k, v in tree.items()}

    def local_rows(self, tree: dict) -> dict:
        return {k: local_rows(v, self.data) for k, v in tree.items()}

    def is_sharded(self, name: str) -> bool:
        """Whether parameter ``name`` is split over the model group."""
        return self.tensor_parallel and bool(tp_param_spec(name, 1))

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt(Σ g²) over the whole model: the squares of sharded leaves are
        summed over the model group, replicated leaves count once."""
        if not self.tensor_parallel:
            return global_norm(grads)
        zero = next(iter(grads.values())).new_zeros(())
        sq = [g.square().sum() for k, g in grads.items() if self.is_sharded(k)]
        rep = [g.square().sum() for k, g in grads.items() if not self.is_sharded(k)]
        sharded = self.model.all_reduce(torch.stack(sq).sum() if sq else zero.clone())
        return torch.sqrt(sharded + (torch.stack(rep).sum() if rep else zero))


def _group(ranks: list[int], rank: int, pgs: dict) -> RankGroup:
    return RankGroup(tuple(ranks), ranks.index(rank), pgs.get(tuple(ranks)))


def make_mesh_plan(cfg: MeshConfig, world: Optional[int] = None,
                   rank: Optional[int] = None, sequence_parallel: bool = False) -> MeshPlan:
    """Build the ('data', 'model') layout over ``world`` ranks (the process
    group's size by default; one rank without a process group).  With
    ``sequence_parallel`` (``kernel_impl="sp"``) the model group splits the
    scans' time axis and the parameters stay whole; otherwise it is tensor
    parallel.

    JAX's rules: ``data_parallel`` -1 is ``world // mp``; ``dp·mp > world``
    raises.  Every rank must call this in the same order (process groups are
    created collectively); a one-rank group gets no process group."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp > world:
        raise ValueError(f"Mesh {dp}x{mp} needs {dp * mp} devices, have {world}")
    if rank >= dp * mp:
        raise ValueError(f"rank {rank} lies outside the {dp}x{mp} mesh of {world} ranks")
    data_sets = [[d * mp + m for d in range(dp)] for m in range(mp)]
    model_sets = [[d * mp + m for m in range(mp)] for d in range(dp)]
    pgs = {}
    if dist.is_initialized():
        for ranks in data_sets + model_sets:
            if len(ranks) > 1 or world == 1:
                # new_group is collective over the world: every rank makes every group
                pgs[tuple(ranks)] = (dist.group.WORLD if len(ranks) == world
                                     else dist.new_group(ranks))
    d, m = divmod(rank, mp)
    world_pg = dist.group.WORLD if dist.is_initialized() else None
    return MeshPlan(data=_group(data_sets[m], rank, pgs), model=_group(model_sets[d], rank, pgs),
                    world=RankGroup(tuple(range(world)), rank, world_pg),
                    sequence_parallel=sequence_parallel)


# --------------------------------------------------------------------------
# Tensor parallelism
# --------------------------------------------------------------------------

def tp_param_spec(name: str, ndim: int) -> tuple:
    """The tensor-parallel spec of a parameter of the port, by name and rank:
    JAX's decision (``tp_param_spec``: the fused gate projections, the
    xLSTM's q/k/v and FFN up projections) in the port's layout, where a
    Dense weight is (out, in).  ("model", None) shards the output rows,
    ("model",) a bias, () is replicated.  As in JAX, no LSTM leaf matches
    (its ``w_ih`` is a leaf, not a module with a kernel)."""
    shard_out = ("gate_proj" in name or name.endswith("w_ih.kernel")
                 or ".q." in name or ".k." in name or ".v." in name
                 or ".gate." in name or ".up." in name)
    if shard_out and ndim == 2:
        return ("model", None)
    if shard_out and ndim == 1:
        return ("model",)
    return ()


def check_tp_shapes(model: torch.nn.Module, model_parallel: int) -> None:
    """JAX's shape rules for tensor parallelism over ``model_parallel``
    ranks; a ``ValueError`` names the leaf.  Every sharded leaf's rows must
    divide over the ranks (JAX's ``device_put`` refuses such a sharding
    too), and the xLSTM's heads must: a rank holds whole heads, where JAX's
    GSPMD would split one across ranks.  The LSTM and the RWKV shard no
    leaf and always pass."""
    if model_parallel <= 1:
        return
    for name, p in model.named_parameters():
        if tp_param_spec(name, p.ndim):
            _rows_of(name, p.shape[0], model_parallel, 0)
        H = model.cfg.xlstm.num_heads
        if name.endswith("_mlstm.q.weight") and H % model_parallel:
            raise ValueError(f"{name}: its {H} heads do not divide over "
                             f"model_parallel={model_parallel} (a model rank runs whole heads)")


def tp_rows(name: str, n_rows: int, plan: MeshPlan) -> Optional[torch.Tensor]:
    """The rows of parameter ``name`` (``n_rows`` of them in full) that this
    model rank owns, or None when it is replicated."""
    if not plan.is_sharded(name):
        return None
    return _rows_of(name, n_rows, plan.model_size, plan.model.index)


def _rows_of(name: str, n_rows: int, mp: int, m: int) -> torch.Tensor:
    """Model rank m's rows of sharded parameter ``name`` (``n_rows`` in
    full): of a LucyRNN gate projection (7·D, ...) the 7 gates of its D/mp
    hidden columns, ``{g·D + d}``; of the others JAX's contiguous block
    ``[m·n/mp, (m+1)·n/mp)``."""
    if "gate_proj" in name:
        if n_rows % (7 * mp):
            raise ValueError(f"{name}: {n_rows} rows are not 7 gates of hidden columns "
                             f"divisible by model_parallel={mp}")
        D = n_rows // 7
        Dl = D // mp
        cols = torch.arange(m * Dl, (m + 1) * Dl)
        return (torch.arange(7)[:, None] * D + cols[None, :]).reshape(-1)
    if n_rows % mp:
        hint = ""
        if ".gate." in name or ".up." in name:
            hint = (" (d_ff = int(embedding_dim · ffn_proj_factor): the default 2.667 gives "
                    "an odd 1365 at embedding_dim 512, which JAX cannot shard either; 2.666 "
                    "gives 1364)")
        raise ValueError(f"{name}: {n_rows} rows do not divide over model_parallel={mp}{hint}")
    n = n_rows // mp
    return torch.arange(m * n, (m + 1) * n)


def _map_params(tree, fn, names: set):
    """Apply ``fn(name, tensor)`` to every tensor of a nested dict whose key
    is a parameter name in ``names`` (a state dict, or an optimizer state
    whose moments are keyed by parameter name)."""
    if isinstance(tree, dict):
        return {k: (fn(k, v) if k in names and isinstance(v, torch.Tensor)
                    else _map_params(v, fn, names)) for k, v in tree.items()}
    return tree


def shard_params_tp(tree: dict, plan: MeshPlan, names=None) -> dict:
    """A full state dict (or any tree keyed by parameter names) → this model
    rank's shard: the owned rows of every sharded parameter."""
    names = set(tree) if names is None else set(names)

    def cut(name, t):
        rows = tp_rows(name, t.shape[0], plan)
        return t if rows is None else t[rows.to(t.device)].clone()

    return _map_params(tree, cut, names)


def gather_params_tp(tree: dict, plan: MeshPlan, names=None) -> dict:
    """The inverse of ``shard_params_tp``: every model rank's rows put back
    into the full tensors (a collective over the model group)."""
    names = set(tree) if names is None else set(names)

    def join(name, t):
        full_rows = t.shape[0] * plan.model_size
        if tp_rows(name, full_rows, plan) is None:
            return t
        out = t.new_empty((full_rows, *t.shape[1:]))
        for m, part in enumerate(plan.model.all_gather(t)):
            rows = _rows_of(name, full_rows, plan.model_size, m)
            out[rows.to(t.device)] = part
        return out

    return _map_params(tree, join, names)


@torch.no_grad()
def shard_model_tp(model: torch.nn.Module, plan: MeshPlan) -> list[str]:
    """Cut ``model``'s sharded parameters to this model rank's rows, in
    place; returns their names.  Raises ``ValueError`` where JAX's shape
    rules refuse the model (``check_tp_shapes``)."""
    check_tp_shapes(model, plan.model_size)
    done = []
    for name, p in model.named_parameters():
        rows = tp_rows(name, p.shape[0], plan)
        if rows is not None:
            p.data = p.data[rows.to(p.device)].clone()
            done.append(name)
    return done


_TP = threading.local()


@contextlib.contextmanager
def tensor_parallel(plan: MeshPlan):
    """Within the block, run the LucyRNN cells on this model rank's columns
    and the xLSTM's mLSTM and FFN on its heads and FFN columns (read by
    ``models/lucyrnn.py`` and ``models/xlstm.py`` through ``tp_group``); the
    LSTM and the RWKV ignore it."""
    prev = getattr(_TP, "group", None)
    _TP.group = plan.model if plan.tensor_parallel else None
    try:
        yield
    finally:
        _TP.group = prev


def tp_group() -> Optional[RankGroup]:
    """The active tensor-parallel model group, or None."""
    return getattr(_TP, "group", None)


def tp_active() -> bool:
    """True inside ``tensor_parallel`` with more than one model rank."""
    return tp_group() is not None
