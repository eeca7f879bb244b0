"""Times of the mLSTM kernels (K9a, K9b, K10) and of the xLSTM training paths
that run K9b, for one checkout of the port.  To compare two checkouts on one
card, run it once per checkout, in turns, within one call:

    PYTHONPATH=<checkout A> python tools/mlstm_bwd_ab.py --tag A
    PYTHONPATH=<checkout B> python tools/mlstm_bwd_ab.py --tag B
    PYTHONPATH=<checkout B> python tools/mlstm_bwd_ab.py --tag B
    PYTHONPATH=<checkout A> python tools/mlstm_bwd_ab.py --tag A

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` (so both checkouts run the same
phases, over their own package), times with
CUDA events K9a and K9b at ``chip_smoke.py`` phase 17's three shapes (B=32,
T=1598, 2 heads, dqk=128, dv=256, chunk 128, f32 and bf16; B=64, chunk 256,
bf16; and the extra device memory of one K9b call) and K10 (f32, B=32), then
drives phase 20's xLSTM CTC training group (B=32, K=2, f32: its
kernel-vs-plain update difference; then the kernel path alone twice, the
second run's ms per segment and peak memory) and ``bench.py``'s xLSTM row
(phase 21: B=64, bf16, chunk 256, K=4).  With ``--profile`` it also prints
the device time of each CUDA kernel of one K9b call at each shape
(``torch.profiler``).  It prints the card's name and power limit, the
phases' own log lines, and one JSON line of kernel times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess

import torch


def kernel_group(cs, cfg, dev, K=2, B=32) -> tuple[float, float]:
    """Phase 20's training group on the kernel path alone, run twice from the
    same state: the second run's ms per segment (the first warms the
    process up) and its peak device memory (GiB)."""
    import time

    import numpy as np

    from statecatcher_tpu_torch.models.asr import init_carry

    cfg, state, step, group = cs.train_setup(cfg, dev, K, B)
    opt0 = state.state_dict()
    for _ in range(2):
        state.load_state_dict(opt0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(state, init_carry(cfg.model, B, device=dev), *group, np.ones(K, bool))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    return sec / K * 1e3, torch.cuda.max_memory_allocated() / 2**30


def load_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module: its phases and helpers, over
    whichever ``statecatcher_tpu_torch`` the import path finds first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no training")
    ap.add_argument("--profile", action="store_true", help="K9b's device time by CUDA kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mlstm_bwd_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_bwd, mlstm_fused_fwd
    from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_pallas_fwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 17)
    H, dqk, dv, T = 2, 128, 256, 1598
    out = {}
    with torch.inference_mode():
        for label, B, L, dtype in (("f32", 32, 128, torch.float32),
                                   ("bf16", 32, 128, torch.bfloat16),
                                   ("bench bf16", 64, 256, torch.bfloat16)):
            ins, _ = cs.mlstm_inputs(gen, B, T, H, dqk, dv, L, dtype, dev)
            cots = [torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
                    for x in (ins[2], ins[5], ins[6], ins[7])]
            cots[0][:, T:] = 0
            out["K9a " + label] = cs.cuda_ms(lambda: mlstm_fused_fwd(*ins, L, T), args.reps)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mlstm_fused_bwd(*ins, *cots, L, T)
            torch.cuda.synchronize()
            out["K9b " + label + " MiB"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            out["K9b " + label] = cs.cuda_ms(lambda: mlstm_fused_bwd(*ins, *cots, L, T),
                                             args.reps)
            if args.profile:
                from torch.profiler import ProfilerActivity, profile

                mlstm_fused_bwd(*ins, *cots, L, T)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    mlstm_fused_bwd(*ins, *cots, L, T)
                    torch.cuda.synchronize()
                rows = sorted(((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                               if e.device_time_total > 0), key=lambda kv: -kv[1])
                print(f"[{args.tag}] K9b {label} by kernel (ms): "
                      + "; ".join(f"{k[:60]} {v:.4f}" for k, v in rows), flush=True)
        B, L = 32, 128
        r = lambda *shape: 0.5 * torch.randn(shape, generator=gen, device=dev)
        ins = [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
               2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(),
               0.1 * r(B, H)]
        out["K10 f32"] = cs.cuda_ms(lambda: mlstm_pallas_fwd(*ins, L), args.reps)
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.kernels_only:
        return 0

    xcfg = Config().apply_overrides(cs.XLSTM)
    cs.phase_train_step(xcfg, dev, K=2, path="xlstm ctc")
    ms, peak = kernel_group(cs, xcfg, dev)
    print(f"[{args.tag}] xlstm train group, kernel path, second run: {ms:.1f} ms per segment, "
          f"peak memory {peak:.3f} GiB", flush=True)
    cs.phase_throughput(xcfg.apply_overrides(["--model.xlstm.chunk_size", "256"]), dev, K=4,
                        B=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
