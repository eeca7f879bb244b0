"""The port's mesh and process-group plumbing in one process
(statecatcher_tpu_torch/parallel/): ``tp_param_spec`` against the JAX
package's for every parameter of each encoder (the JAX spec of the flax
leaf, in the port's layout: a transposed Dense kernel's spec reversed),
JAX's shape rules for tensor parallelism, ``make_mesh_plan``'s rules and
rank layout, the tensor-parallel rows a model rank owns against the blocks
of JAX's shardings, and ``sync_int``, ``shared_run_dir`` and the row helpers
through a one-rank gloo group."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding

from statecatcher_tpu.parallel.mesh import tp_param_spec as j_tp_param_spec
from statecatcher_tpu_torch.config import Config, MeshConfig
from statecatcher_tpu_torch.convert import _full_mapping
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.parallel.distributed import (
    gather_rows,
    local_rows,
    shared_run_dir,
    sync_int,
    world_group,
)
from statecatcher_tpu_torch.parallel.mesh import (
    check_tp_shapes,
    make_mesh_plan,
    shard_model_tp,
    tp_param_spec,
    tp_rows,
)

ENCODERS = {
    "lstm": ["--model.encoder", "lstm"],
    "lucyrnn": ["--model.encoder", "lucyrnn"],
    "lucyrnn-2tracks": ["--model.encoder", "lucyrnn", "--model.lucyrnn.num_tracks", "2"],
    "native": ["--model.encoder", "lucyrnn", "--model.lucyrnn.variant", "native"],
    "native-unfused": ["--model.encoder", "lucyrnn", "--model.lucyrnn.variant", "native",
                       "--model.lucyrnn.fused_ops", "false"],
    "xlstm": ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "32",
              "--model.xlstm.num_blocks", "2", "--model.xlstm.chunk_size", "16"],
    "rwkv": ["--model.encoder", "rwkv"],
}
TINY = ["--model.hidden_size", "16", "--model.num_layers", "2", "--model.vocab_size", "12"]


@pytest.mark.parametrize("mode", ["ctc", "rnnt"])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_tp_param_spec_matches_jax(encoder, mode):
    cfg = Config().apply_overrides(ENCODERS[encoder] + TINY)
    model = build_speech_model(cfg.model, 80, mode, device="cpu")
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    mapping = _full_mapping(cfg.model, True, mode == "rnnt")
    assert len(mapping) == len(shapes)
    sharded = 0
    for path, key, transposed in mapping:
        ndim = len(shapes[key])
        want = tuple(j_tp_param_spec("/".join(("params",) + path), ndim))
        if transposed and ndim == 2:
            want = want[::-1]
        assert tp_param_spec(key, ndim) == want, (key, path)
        sharded += bool(want)
    # the 7-gate cell's gate projections and the xLSTM's q/k/v and FFN are sharded
    assert (sharded > 0) == (encoder in ("lucyrnn", "lucyrnn-2tracks", "xlstm"))


SHARDED = ("lucyrnn", "lucyrnn-2tracks", "xlstm")
# d_ff = int(32 · 2.5) = 80: the default factor's 85 divides over no mp
FFN = ["--model.xlstm.ffn_proj_factor", "2.5"]


def _tiny(encoder, *extra):
    cfg = Config().apply_overrides(ENCODERS[encoder] + TINY + list(extra))
    return cfg, build_speech_model(cfg.model, 80, "ctc", device="cpu")


def _plan(mp, rank):
    return make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=mp), world=mp, rank=rank)


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_tensor_parallel_encoders(encoder):
    """Every encoder shards under mp=2 (the LSTM, the RWKV and the native
    LucyRNN shard no leaf, as in JAX); what JAX's shape rules refuse raises
    ValueError naming the leaf: the LucyRNN's 16 columns over mp=3, the
    xLSTM's default ``ffn_proj_factor`` (d_ff 85) at mp=2 and its 2 heads
    over mp=4 (a rank runs whole heads)."""
    extra = FFN if encoder == "xlstm" else []
    _, model = _tiny(encoder, *extra)
    check_tp_shapes(model, 1)
    names = shard_model_tp(model, _plan(2, 1))
    assert bool(names) == (encoder in SHARDED)
    _, fresh = _tiny(encoder, *extra)
    if encoder == "xlstm":
        with pytest.raises(ValueError, match=r"block0_mlstm\.q\.weight: its 2 heads"):
            check_tp_shapes(fresh, 4)
        _, odd = _tiny(encoder)
        with pytest.raises(ValueError, match=r"block0_ffn\.gate\.weight: 85 rows"):
            check_tp_shapes(odd, 2)
    elif encoder in SHARDED:
        with pytest.raises(ValueError, match=r"gate_proj\.weight: 112 rows are not 7 gates"):
            check_tp_shapes(fresh, 3)
    else:
        check_tp_shapes(fresh, 3)


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_tp_rows_match_jax_shardings(encoder):
    """The rows model rank m of 2 owns of every sharded leaf, mapped through
    convert.py, are the block JAX's ``NamedSharding`` puts on model index m
    (its output lanes: a Dense kernel's axis 1, a bias's axis 0); every
    other leaf is whole on both.  The LucyRNN's gate projections are the
    exception that ROADMAP.md §3 records: the port's rank owns the 7 gates of
    its hidden columns, JAX's a contiguous 7·D/2 lanes."""
    cfg, model = _tiny(encoder, *(FFN if encoder == "xlstm" else []))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    devices = jax.devices()[:2]
    mesh = Mesh(np.array(devices).reshape(1, 2), ("data", "model"))
    plans = [_plan(2, m) for m in range(2)]
    for path, key, transposed in _full_mapping(cfg.model, True, False):
        shape = shapes[key]
        flax_shape = shape[::-1] if transposed else shape
        spec = j_tp_param_spec("/".join(("params",) + path), len(shape))
        blocks = NamedSharding(mesh, spec).devices_indices_map(flax_shape)
        n = shape[0]
        for m, plan in enumerate(plans):
            idx = blocks[devices[m]]
            jax_rows = list(range(n))[idx[len(shape) - 1 if transposed else 0]]
            rows = tp_rows(key, n, plan)
            if rows is None:
                assert jax_rows == list(range(n)) and all(i == slice(None) for i in idx), key
            elif "gate_proj" in key:
                D = n // 7
                assert jax_rows == list(range(m * n // 2, (m + 1) * n // 2)), key
                assert rows.tolist() == [g * D + d for g in range(7)
                                         for d in range(m * D // 2, (m + 1) * D // 2)], key
            else:
                assert rows.tolist() == jax_rows, key


def test_make_mesh_plan_rules_and_layout():
    # JAX's rules: data_parallel -1 is world // mp; dp·mp > world raises
    plan = make_mesh_plan(MeshConfig(data_parallel=-1, model_parallel=2), world=8, rank=5)
    assert (plan.data_size, plan.model_size) == (4, 2)
    # rank = d·mp + m: rank 5 is (d=2, m=1)
    assert plan.data.ranks == (1, 3, 5, 7) and plan.data.index == 2
    assert plan.model.ranks == (4, 5) and plan.model.index == 1
    assert plan.tensor_parallel and not plan.sequence_parallel
    sp = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=2), world=2, rank=0,
                        sequence_parallel=True)
    assert sp.sequence_parallel and not sp.tensor_parallel
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh_plan(MeshConfig(data_parallel=4, model_parallel=2), world=4, rank=0)
    one = make_mesh_plan(MeshConfig())          # no process group: one rank
    assert one.data_size == one.model_size == 1 and one.data.pg is None
    assert plan.local_batch(32) == 8
    with pytest.raises(ValueError):
        plan.local_batch(30)


def test_tp_rows_are_whole_gate_columns():
    """Model rank m of 2 owns the 7 gates of hidden columns [m·D/2, (m+1)·D/2)."""
    D = 8
    name = "asr.encoder.track0_layer0.gate_proj.weight"
    for m in range(2):
        plan = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=2), world=2, rank=m)
        rows = tp_rows(name, 7 * D, plan).tolist()
        assert rows == [g * D + d for g in range(7) for d in range(m * D // 2, (m + 1) * D // 2)]
        assert tp_rows("asr.encoder.output_proj.weight", 12, plan) is None
    sp = make_mesh_plan(MeshConfig(data_parallel=1, model_parallel=2), world=2, rank=0,
                        sequence_parallel=True)
    assert tp_rows(name, 7 * D, sp) is None       # sequence parallel: parameters whole


@pytest.fixture
def one_rank_gloo():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_in_a_one_rank_gloo_group(one_rank_gloo):
    world = world_group()
    assert world.pg is not None and world.size == 1
    assert sync_int(7, "max") == 7 and sync_int(3, "min") == 3
    assert world.stats["all_reduce"] == 0                 # a fresh group per call
    assert shared_run_dir("models/1700000000") == "models/1700000000"
    plan = make_mesh_plan(MeshConfig())
    assert plan.data.pg is not None and plan.model.pg is not None   # the collectives run
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(gather_rows(x, plan.data), x)
    assert torch.equal(local_rows(x, plan.data), x)
    t = torch.ones(3)
    plan.data.all_reduce(t)
    assert torch.equal(t, torch.ones(3)) and plan.data.stats["all_reduce"] == 12


def test_row_helpers_interleave_data_ranks():
    """Global row g is data rank g % dp's local row g // dp (no collective:
    the gathered parts are put together by hand)."""
    x = torch.arange(8.0)[:, None].repeat(1, 2)
    plans = [make_mesh_plan(MeshConfig(data_parallel=2), world=2, rank=r) for r in range(2)]
    parts = [local_rows(x, p.data) for p in plans]
    assert parts[0][:, 0].tolist() == [0, 2, 4, 6] and parts[1][:, 0].tolist() == [1, 3, 5, 7]
    assert torch.equal(torch.stack(parts, dim=1).reshape(-1, 2), x)
    assert np.array_equal(np.arange(8)[1::2], parts[1][:, 0].numpy())
