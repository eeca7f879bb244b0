"""Device time by CUDA kernel of the RNN-T joint above J = 128 (the tiled
products of ``rnnt_joint_core.cuh``: K6a and K6b at B=32, T=1598, U=48,
V=1024, J=640 by default), f32 and bf16, one call of each under
``torch.profiler``.  On the card, from the repository's root:

    PYTHONPATH=. python tools/joint_wide_profile.py [--J 640] [--U 48]

It prints the card's name and power limit, then per call its device time and
the kernels that took it (name, ms, launches).
"""

from __future__ import annotations

import argparse
import subprocess
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


def by_kernel(fn) -> dict[str, list]:
    """{CUDA kernel name: [ms, launches]} of one call of ``fn``."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name][0] += ev.device_time_total / 1e3
            out[name][1] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--J", type=int, default=640)
    ap.add_argument("--U", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("joint_wide_profile needs a CUDA card")
    import chip_smoke as cs
    from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_joint_bwd, rnnt_joint_fwd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for dtype in (torch.float32, torch.bfloat16):
        enc, pred, k, b, labels, g_blank, g_emit = cs.joint_inputs(gen, 32, 1598, args.U, args.J,
                                                                   1024, dev, dtype, 0)
        with torch.inference_mode():
            lse = rnnt_joint_fwd(enc, pred, k, b, labels)[2]
            bwd_args = (enc, pred, k, b, labels, lse, g_blank, g_emit)
            rnnt_joint_bwd(*bwd_args)                       # built and warm
            torch.cuda.synchronize()
            for name, fn in (("K6a", lambda: rnnt_joint_fwd(enc, pred, k, b, labels)),
                             ("K6b", lambda: rnnt_joint_bwd(*bwd_args))):
                times = by_kernel(fn)
                print(f"{name} {dtype} (B=32, T=1598, U={args.U}, J={args.J}, V=1024): "
                      f"{sum(v[0] for v in times.values()):.3f} ms on the device")
                for kernel, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:8]:
                    print(f"  {ms:9.3f} ms  {n:4d} launches  {kernel}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
