"""One full train step on every rank, in each parallel mode.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
run under torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), one process per rank::

    python -m statecatcher_tpu_torch.parallel.dryrun --inputs in.pt --out out \\
        [--backend gloo] [--device cuda:0] [--time-runs N]

``--inputs`` is a ``torch.save`` dict that the caller writes:

  * ``overrides``: config overrides of the model and the training run;
  * ``params``: the full state dict of the SpeechModel (every rank starts
    from it; tensor-parallel ranks cut their shards from it);
  * ``group``: one segment group of the GLOBAL batch, numpy arrays
    ``audio`` (K, B, S), ``mask`` (K, B, S) or prefix lengths (K, B),
    ``tokens`` (K, B, U), ``tok_lens`` (K, B), ``row_valid`` (K, B),
    ``seg_valid`` (K,); data rank d trains on rows ``d::dp``;
  * ``modes``: ``[(name, overrides), ...]``, each a mesh (and kernel_impl)
    to run the step under, in turn, from the same parameters; a third
    element, a dict, replaces any of the keys of this list for its mode
    (its own ``overrides``, ``params`` and ``group``: another model in the
    same launch) and may set its ``time_runs``;
  * optional ``features`` (K, B, T, F): the frontend's output for
    ``audio``, used in place of the port's frontend (tests give the port and
    the JAX package one frontend, as tests/test_torch_train_step.py does);
  * optional ``forward``: also run the model on segment 0 before the step;
  * optional ``scan``: ``a``, ``b`` (B, T, D), ``s0`` (B, D) and ``w`` (B, T,
    D): instead of the modes, the sequence-parallel scan
    ``linear_scan_time_sharded`` over every rank, loss Σ out·w.

Each rank writes ``<out>.rank<r>.pt``: per mode the stacked per-segment
loss and grad norm, its rows' per-utterance loss, the global-B carry and the
post-update parameters (gathered whole), each kernel's launches on its step,
the bytes all-reduced over the data group per update and those moved over
the model group, and the step's ms per segment (``--time-runs N`` runs it N
more times from the same state and times those).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.frontend import feat_dim
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.ops import launch_counts
from statecatcher_tpu_torch.parallel.distributed import (
    initialize_distributed,
    shutdown_distributed,
    world_group,
)
from statecatcher_tpu_torch.parallel.mesh import (
    gather_params_tp,
    make_mesh_plan,
    shard_model_tp,
)
from statecatcher_tpu_torch.train import step as step_module


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _given_features(group: dict, features: np.ndarray, rows: slice):
    """A ``compute_features`` that returns ``features`` for the audio of each
    segment of ``group`` (this rank's rows, float32 audio), looked up by
    content."""
    table = {}
    for k in range(features.shape[0]):
        a = np.ascontiguousarray(group["audio"][k][rows], np.float32)
        table[a.tobytes()] = torch.from_numpy(np.ascontiguousarray(features[k][rows]))

    def compute(audio, fe):
        return table[np.ascontiguousarray(audio.detach().cpu().numpy()).tobytes()].to(audio.device)

    return compute


def run_mode(inputs: dict, overrides: list, dev, time_runs: int) -> dict:
    """One train step of the global batch over this rank's share of the
    mesh that ``overrides`` describe."""
    cfg = Config().apply_overrides(list(inputs["overrides"]) + list(overrides))
    plan = make_mesh_plan(cfg.mesh, sequence_parallel=cfg.model.lucyrnn.kernel_impl == "sp")
    model = build_speech_model(cfg.model, feat_dim(cfg.frontend), cfg.train.mode, device=dev)
    model.load_state_dict(inputs["params"])
    names = [k for k, _ in model.named_parameters()]
    if plan.tensor_parallel:
        shard_model_tp(model, plan)
    g = inputs["group"]
    rows = slice(plan.data.index, None, plan.data_size)
    K, B = g["tokens"].shape[:2]
    Bl = B // plan.data_size
    host = [np.ascontiguousarray(g[k][:, rows])
            for k in ("audio", "mask", "tokens", "tok_lens", "row_valid")]
    args = [torch.from_numpy(x).to(dev) for x in host]
    seg_valid = np.asarray(g["seg_valid"], bool)
    out = {"plan": (plan.data_size, plan.model_size, plan.sequence_parallel)}

    if inputs.get("features") is not None:
        step_module.compute_features = _given_features(g, inputs["features"], rows)
    carry0 = init_carry(cfg.model, Bl, device=dev)
    if inputs.get("forward"):
        feats, fm, _ = step_module.segment_features(args[0][0], args[1][0], cfg)
        with torch.no_grad(), step_module.mesh_context(cfg, plan):
            logits, st = model(feats, carry0, fm)
        out["forward"] = {"logits": plan.gather_rows({"x": logits})["x"].cpu(),
                          "state": {k: v.cpu() for k, v in plan.gather_rows(st).items()}}

    state = step_module.init_train_state(model, cfg, plan)
    step = step_module.make_segment_scan_step(model, cfg, blank_id=0,
                                              ctc_impl=cfg.train.ctc_impl, mesh_plan=plan)
    start = state.state_dict() if time_runs else None
    before = launch_counts()
    red0 = plan.data.stats["all_reduce"]
    mod0 = sum(plan.model.stats.values())
    _sync(dev)
    t0 = time.perf_counter()
    _, carry, outs = step(state, carry0, *args, seg_valid)
    _sync(dev)
    sec = time.perf_counter() - t0
    out["launches"] = {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}
    n_upd = int(seg_valid.sum())
    out["allreduce_bytes_per_update"] = (plan.data.stats["all_reduce"] - red0) / max(n_upd, 1)
    out["model_group_bytes_per_update"] = (sum(plan.model.stats.values()) - mod0) / max(n_upd, 1)
    out["ms_per_segment_first"] = sec / K * 1e3
    out["loss"] = outs.loss.cpu()
    out["grad_norm"] = outs.grad_norm.cpu()
    out["per_loss"] = outs.per_loss.cpu()
    out["carry"] = {k: v.cpu() for k, v in plan.gather_rows(carry).items()}
    params = {k: p.detach() for k, p in state.params.items()}
    out["params"] = {k: v.cpu() for k, v in gather_params_tp(params, plan, names).items()}
    if time_runs:
        secs = []
        for _ in range(time_runs):
            state.load_state_dict(start)
            _sync(dev)
            t0 = time.perf_counter()
            step(state, init_carry(cfg.model, Bl, device=dev), *args, seg_valid)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        out["ms_per_segment"] = float(np.mean(secs)) / K * 1e3
    return out


def run_scan(inputs: dict, dev) -> dict:
    """The sequence-parallel scan over every rank: this rank's time shard of
    the output and the gradients of a, b (its shard) and s0 (summed)."""
    from statecatcher_tpu_torch.ops.scan_sp import linear_scan_time_sharded

    world = world_group()
    sc = inputs["scan"]
    T = sc["a"].shape[1]
    Tl = T // world.size
    sl = slice(world.index * Tl, (world.index + 1) * Tl)
    a, b, w = (torch.from_numpy(np.ascontiguousarray(sc[k][:, sl])).to(dev) for k in "abw")
    s0 = torch.from_numpy(sc["s0"]).to(dev)
    a.requires_grad_()
    b.requires_grad_()
    s0.requires_grad_()
    out = linear_scan_time_sharded(a, b, s0, world)
    (out * w).sum().backward()
    return {"out": out.detach().cpu(), "da": a.grad.cpu(), "db": b.grad.cpu(),
            "ds0": s0.grad.cpu()}


def launch_ranks(world: int, argv: list, timeout: float, module: str = __name__,
                 env: dict = None, cwd: str = None) -> list:
    """Start ``world`` processes of ``python -m <module> <argv>`` with
    torchrun's environment (a free port on 127.0.0.1) and wait for them; at
    the first rank that fails, or ``timeout`` seconds after the start, kill
    every rank still running.  Returns each rank's (exit code, output); a
    rank that was killed has exit code None."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        e = {**os.environ, **(env or {}), "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        logs.append(tempfile.TemporaryFile())
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=e, cwd=cwd,
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.05)
    finally:
        killed = [p.poll() is None for p in procs]
        for p, k in zip(procs, killed):
            if k:
                p.kill()
            p.wait()
    results = []
    for p, k, log in zip(procs, killed, logs):
        log.seek(0)
        results.append((None if k else p.returncode, log.read().decode("utf-8", "replace")))
        log.close()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--time-runs", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False       # full f32 matmuls, as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    topo = initialize_distributed(args.backend, args.device)
    try:
        inputs = torch.load(args.inputs, weights_only=False)
        if "scan" in inputs:
            result = {"scan": run_scan(inputs, topo.device)}
        else:
            result = {}
            for name, ov, *own in inputs["modes"]:
                mode_inputs = {**inputs, **(own[0] if own else {})}
                result[name] = run_mode(mode_inputs, ov, topo.device,
                                        mode_inputs.get("time_runs", args.time_runs))
        result["topology"] = {"rank": topo.process_index, "world": topo.process_count,
                              "device": str(topo.device), "backend": topo.backend}
        torch.save(result, f"{args.out}.rank{topo.process_index}.pt")
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
