"""The port's mesh and process-group plumbing in one process
(statecatcher_tpu_torch/parallel/): ``tp_param_spec`` against the JAX
package's for every parameter of each encoder (the JAX spec of the flax
leaf, in the port's layout: a transposed Dense kernel's spec reversed),
``make_mesh_plan``'s rules and rank layout, the tensor-parallel rows a
model rank owns, and ``sync_int``, ``shared_run_dir`` and the row helpers
through a one-rank gloo group."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

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
    check_tp_supported,
    make_mesh_plan,
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


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_tensor_parallel_encoders(encoder):
    """The 7-gate and native LucyRNN run tensor parallel; the others raise,
    naming ROADMAP.md's multi-GPU section."""
    cfg = Config().apply_overrides(ENCODERS[encoder]).model
    check_tp_supported(cfg, 1)
    if cfg.encoder == "lucyrnn":
        check_tp_supported(cfg, 2)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md, multi-GPU"):
            check_tp_supported(cfg, 2)


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
