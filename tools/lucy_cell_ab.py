"""Times of the fused LucyRNN cell kernels (K1 forward, K2 backward) and of
the LucyRNN paths that run them (streaming, training, bench.py's rows), for
one checkout of the port.  To compare two checkouts on one card, run it once
per checkout, in turns, within one call:

    PYTHONPATH=<checkout A> python tools/lucy_cell_ab.py --tag A --save DIR
    PYTHONPATH=<checkout B> python tools/lucy_cell_ab.py --tag B --save DIR
    PYTHONPATH=<checkout B> python tools/lucy_cell_ab.py --tag B --save DIR
    PYTHONPATH=<checkout A> python tools/lucy_cell_ab.py --tag A --save DIR

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` (so both checkouts run the same
phases, over their own package).  It times with CUDA events K1 and K2 at
B=32, T=1598, D=512 in f32 and bf16, at bench.py's B=96 bf16, and K1 at the
streaming shape (B=1, T=32, f32; replayed from a CUDA graph, as phase 1
does, and its host time: a call and a device sync, from the host's
clock); then drives phase 3's CTC streams (chunk latency p50/p90), phase 5's
CTC training group (B=32, K=4, f32; the kernel path alone twice, the second
run's ms per segment), phase 6's CTC row (B=96, bf16, K=8) and phase 15's
RNN-T rows (U=64 and U=128, K=4).  With ``--profile`` it also prints the
device time of each CUDA kernel of one K1 and one K2 call at each shape
(``torch.profiler``).  With ``--save DIR`` it writes the f32 outputs of K1
and K2 on fixed inputs (B=4, T=400, D=512) to DIR/<tag>.pt and reports, for
every other tag saved there, whether they are bit for bit equal, and the
largest difference where they are not; it also prints a digest of the f32
outputs at the B=32 timing shape.  It prints the card's name and power
limit, the phases' own log lines and one JSON line of kernel times.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mlstm_bwd_ab import kernel_group, load_chip_smoke  # noqa: E402


def digest(tensors) -> str:
    """SHA-256 prefix of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def host_ms(fn, reps: int = 200) -> float:
    """Mean wall time of one call that ends in a device sync: at a small
    shape, the launch's host cost beside the kernel's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def compare_saved(tag: str, outs: dict, save_dir: str) -> None:
    """Save ``outs`` as DIR/<tag>.pt and compare them with every other tag's."""
    os.makedirs(save_dir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in outs.items()}, os.path.join(save_dir, f"{tag}.pt"))
    for path in sorted(glob.glob(os.path.join(save_dir, "*.pt"))):
        other = os.path.basename(path)[:-3]
        if other == tag:
            continue
        theirs = torch.load(path)
        for name, mine in outs.items():
            a, b = mine.cpu(), theirs[name]
            if torch.equal(a, b):
                verdict = "bit for bit equal"
            else:
                d = (a.double() - b.double()).abs()
                verdict = (f"differ in {int((a != b).sum())} of {a.numel()} elements, max |Δ| "
                           f"{d.max().item():.3e} at scale {b.abs().max().item():.3e}")
            print(f"[{tag}] vs [{other}] {name} f32: {verdict}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no paths")
    ap.add_argument("--profile", action="store_true", help="device time by CUDA kernel")
    ap.add_argument("--save", default=None, help="directory for the bit-for-bit comparison")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lucy_cell_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm, lucy_cell_fused_lm_bwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    out = {}
    with torch.inference_mode():
        if args.save:
            gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, 4, 400, 512, torch.float32, dev)
            h_all, s_all = lucy_cell_fused_lm(gates, bias, h0, s0)
            g_h = torch.randn(h_all.shape, generator=gen, device=dev)
            g_s = 0.1 * torch.randn(h_all.shape, generator=gen, device=dev)
            dg, dh0, ds0, db = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
            compare_saved(args.tag, {"h_all": h_all, "s_all": s_all, "d_gates": dg, "dh0": dh0,
                                     "ds0": ds0, "d_bias": db}, args.save)
        for label, B, T, dtype in (("f32", 32, 1598, torch.float32),
                                   ("bf16", 32, 1598, torch.bfloat16),
                                   ("bench bf16", 96, 1598, torch.bfloat16),
                                   ("streaming f32", 1, 32, torch.float32)):
            gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, B, T, 512, dtype, dev)
            fwd = lambda: lucy_cell_fused_lm(gates, bias, h0, s0)
            h_all, s_all = fwd()
            small = B * T <= 1000
            out["K1 " + label] = cs.cuda_ms(fwd, 200 if small else args.reps, graph=small)
            if args.profile:
                cs.log_by_kernel(f"[{args.tag}] K1 {label}", fwd)
            if small:
                out["K1 " + label + " host"] = host_ms(fwd)
                continue
            g_h = torch.randn(h_all.shape, generator=gen, device=dev).to(dtype)
            bwd = lambda: lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, None)
            out["K2 " + label] = cs.cuda_ms(bwd, args.reps)
            if args.profile:
                cs.log_by_kernel(f"[{args.tag}] K2 {label}", bwd)
            if label == "f32":
                print(f"[{args.tag}] digest of K1's f32 outputs at B=32: {digest(fwd())}, of "
                      f"K2's: {digest(bwd())}", flush=True)
            del gates, h_all, s_all, g_h
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.kernels_only:
        return 0

    cfg = Config().apply_overrides(cs.FLAGSHIP)
    model = cs.build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                                  generator=torch.Generator().manual_seed(cs.SEED))
    cs.randomize_(model, cs.SEED + 1)
    cs.phase_streaming(model.eval(), cfg, dev, tag=f"[{args.tag}] [streaming]")
    del model
    ms, peak = kernel_group(cs, cfg, dev, K=4)
    print(f"[{args.tag}] ctc train group (B=32, K=4, f32), kernel path, second run: {ms:.1f} ms "
          f"per segment, peak memory {peak:.3f} GiB", flush=True)
    cs.phase_throughput(cfg, dev, K=8)
    for U in (64, 128):
        cs.phase_throughput(cfg, dev, K=4, U=U, mode="rnnt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
