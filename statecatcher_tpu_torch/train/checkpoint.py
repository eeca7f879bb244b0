"""Checkpointing of the full training session, written with ``torch.save``.

The JAX package saves with orbax; the port has its own format (loading a
JAX checkpoint is out of scope: parameters cross over with ``convert.py``).
The run-dir layout is the same as ``statecatcher_tpu/train/checkpoint.py``:

    <model_dir>/<unix-ts>/training_config.json
    <model_dir>/<unix-ts>/ckpt/<step>/session.pt    params, optimizer state,
                                                    update count, carry
    <model_dir>/<unix-ts>/ckpt/<step>/meta.json     epoch, global_step, the
                                                    cursor {batches_done,
                                                    seg_idx}, metrics window

Each file is written to a temporary name and renamed, so a killed run leaves
the previous checkpoint whole.  The newest ``max_to_keep`` steps are kept.

Checkpoints do not depend on the mesh.  With a ``mesh_plan``
(``parallel/mesh.py``) every rank takes part in a save: the parameters and
optimizer moments are gathered from the tensor-parallel shards and the carry
from the data ranks' rows into the global batch, and rank 0 writes them.
Every rank restores the whole session and keeps its own shards and rows, so
a run saved on 2 ranks resumes on 1, and the reverse.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import torch

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.parallel.mesh import gather_params_tp, shard_params_tp
from statecatcher_tpu_torch.train.optim import tree_map


def setup_run_dir(cfg: Config) -> str:
    """models/<unix-ts>/ with a config snapshot."""
    run_dir = os.path.join(cfg.train.model_dir, str(int(time.time())))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_config.json"), "w") as f:
        f.write(cfg.to_json())
    return run_dir


def _atomic(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, run_dir: str, max_to_keep: int = 5):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.ckpt_dir, n, "meta.json")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, train_state, meta: dict, carry=None, mesh_plan=None) -> None:
        """Save the train state (``TrainState.state_dict()``), the loop's
        metadata and the carry (a dict of tensors, or None); with
        ``mesh_plan`` every rank calls it and rank 0 writes the whole
        session."""
        if mesh_plan is None:
            state = train_state.state_dict()
        else:
            state, carry = _whole_session(train_state, carry, mesh_plan)
            if not mesh_plan.is_primary:
                mesh_plan.world.barrier()
                return
        d = os.path.join(self.ckpt_dir, str(int(step)))
        os.makedirs(d, exist_ok=True)
        blob = {"state": state,
                "carry": None if carry is None else {k: v.detach().cpu() for k, v in carry.items()}}
        _atomic(os.path.join(d, "session.pt"), lambda p: torch.save(blob, p))

        def write_meta(p):
            with open(p, "w") as f:
                json.dump(meta, f)

        _atomic(os.path.join(d, "meta.json"), write_meta)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)), ignore_errors=True)
        if mesh_plan is not None:
            mesh_plan.world.barrier()

    def restore(self, train_state, carry_template: dict, mesh_plan=None):
        """Load the newest checkpoint into ``train_state`` → (train_state,
        meta, carry), the carry on ``carry_template``'s devices and dtypes
        (None if the checkpoint holds none).  With ``mesh_plan`` the state is
        cut to this rank's shards and the carry to its rows (``carry_template``
        is then this rank's)."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self.run_dir}")
        d = os.path.join(self.ckpt_dir, str(step))
        blob = torch.load(os.path.join(d, "session.pt"), map_location="cpu", weights_only=True)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        state, carry = blob["state"], blob["carry"]
        if mesh_plan is not None:
            names = state["params"].keys()
            state = {**state, "params": shard_params_tp(state["params"], mesh_plan),
                     "opt_state": shard_params_tp(state["opt_state"], mesh_plan, names)}
            if carry is not None:
                carry = mesh_plan.local_rows(carry)
        train_state.load_state_dict(state)
        if carry is not None:
            carry = {k: v.to(carry_template[k].device, carry_template[k].dtype)
                     for k, v in carry.items()}
        return train_state, meta, carry


def _whole_session(train_state, carry, plan) -> tuple[dict, dict]:
    """(state dict, carry) of the whole model and the global batch, on the
    CPU: the tensor-parallel shards and the data ranks' carry rows gathered
    (collectives: every rank calls this)."""
    cpu = lambda t: t.detach().to("cpu", copy=True)
    params = {k: p.detach() for k, p in train_state.params.items()}
    opt = gather_params_tp(train_state.opt_state, plan, params.keys())
    params = gather_params_tp(params, plan)
    if carry is not None:
        carry = plan.gather_rows({k: v.detach() for k, v in carry.items()})
    state = {"params": {k: cpu(v) for k, v in params.items()},
             "opt_state": tree_map(cpu, opt), "step": cpu(train_state.step)}
    return state, carry
