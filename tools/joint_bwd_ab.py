"""Times of the RNN-T joint's kernels, forward and backward (K6a/K6b,
K8a/K8b), and of the RNN-T training paths that run them, for one checkout of
the port.  To compare two checkouts on one card, run it once per checkout, in
turns, within one call:

    PYTHONPATH=<checkout A> python tools/joint_bwd_ab.py --tag A
    PYTHONPATH=<checkout B> python tools/joint_bwd_ab.py --tag B
    PYTHONPATH=<checkout B> python tools/joint_bwd_ab.py --tag B
    PYTHONPATH=<checkout A> python tools/joint_bwd_ab.py --tag A

Each run imports ``statecatcher_tpu_torch`` and ``chip_smoke`` from the
checkout on ``PYTHONPATH`` (so it builds that checkout's kernels), times the
kernels at the shapes of ``PERF.md`` §6 with CUDA events, then drives, as
``chip_smoke.py`` does, the exact RNN-T training group (B=32, U=48, K=2), the
banded one (U=128, band 32, K=2) and ``bench.py``'s two RNN-T throughput
shapes (B=96, bf16, U=64 and U=128, K=4).  It prints the card's name and
power limit, the phases' own log lines, and one JSON line of kernel times.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no training")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("joint_bwd_ab needs a CUDA card")
    import chip_smoke as cs
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_bwd, rnnt_band_fwd
    from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_joint_bwd, rnnt_joint_fwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    out = {}
    with torch.inference_mode():
        for label, B, T, U, dtype in (("K6 f32", 32, 1598, 48, torch.float32),
                                      ("K6 bf16", 32, 1598, 48, torch.bfloat16),
                                      ("K6 U=128 f32", 8, 400, 128, torch.float32)):
            enc, pred, k, b, labels, g_blank, g_emit = cs.joint_inputs(gen, B, T, U, 64, 1024,
                                                                       dev, dtype, 0)
            _, _, lse = rnnt_joint_fwd(enc, pred, k, b, labels)
            out[label + " fwd"] = cs.cuda_ms(lambda: rnnt_joint_fwd(enc, pred, k, b, labels),
                                             args.reps)
            out[label + " bwd"] = cs.cuda_ms(
                lambda: rnnt_joint_bwd(enc, pred, k, b, labels, lse, g_blank, g_emit), args.reps)
        for label, dtype in (("K8 f32", torch.float32), ("K8 bf16", torch.bfloat16)):
            enc, pred, k, b, labels, _, _, o, Wp, _, g_blank, g_emit = cs.band_problem(
                gen, 32, 1598, 128, 64, 1024, 32, 8, dev, dtype)
            _, _, lse = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, 8)
            out[label + " fwd"] = cs.cuda_ms(
                lambda: rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, 8), args.reps)
            out[label + " bwd"] = cs.cuda_ms(
                lambda: rnnt_band_bwd(enc, pred, k, b, labels, o, lse, g_blank, g_emit, 8),
                args.reps)
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.kernels_only:
        return 0

    cfg = Config().apply_overrides(cs.FLAGSHIP)
    cs.phase_train_step(cfg, dev, K=2, U=48, mode="rnnt")
    cs.phase_train_step(cfg, dev, K=2, U=128, mode="rnnt", path="rnnt banded", degenerate=True)
    for U in (64, 128):
        cs.phase_throughput(cfg, dev, K=4, U=U, mode="rnnt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
