"""Times of the LucyRNN cell kernels (K1 forward, K2 backward, the masked
cell K12, the linear scan K5a/K5b, the dual scan K11) and of the LucyRNN
paths that run them (streaming, training, bench.py's rows, the masked and
native segments), for one checkout of the port.  To compare two checkouts on
one card, run it once per checkout, in turns, within one call:

    PYTHONPATH=<checkout A> python tools/lucy_cell_ab.py --tag A --save DIR
    PYTHONPATH=<checkout B> python tools/lucy_cell_ab.py --tag B --save DIR
    PYTHONPATH=<checkout B> python tools/lucy_cell_ab.py --tag B --save DIR
    PYTHONPATH=<checkout A> python tools/lucy_cell_ab.py --tag A --save DIR

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` (so both checkouts run the same
phases, over their own package).  It times with CUDA events, at B=32,
T=1598, D=512 in f32 and bf16: K1 and K2 (also at bench.py's B=96 bf16),
K12 unmasked and masked (``masked_rows``: one partial row), K11 on the
masked gate chain's planes, K5a and K5b; and at the streaming shape (B=1,
T=32, f32; replayed from a CUDA graph, as phase 1 does, and its host time: a
call and a device sync, from the host's clock) K1, K12 unmasked and masked,
and K5a; beside K5a, as a yardstick of what an elementwise pass over the
same bytes takes on the card (not the same function), ``torch.add`` of its
two planes.  Then it drives phase 3's CTC streams (chunk latency p50/p90),
phase 5's CTC training group (B=32, K=4, f32; the kernel path alone twice,
the second run's ms per segment), phase 6's CTC row (B=96, bf16, K=8),
phase 15's RNN-T rows (U=64 and U=128, K=4), phase 12's masked segment and
training group (the split route, K5a/K5b; K=2), phase 24's masked segment,
streams and training group through K12 (K=2), phase 25's masked segment
and training group through K11 (K=2; their backwards run K5b) and phase
26's native segment (K5a).  With ``--profile`` it also prints the device time of each
CUDA kernel of one call of every kernel timed at B=32 (``torch.profiler``).
With ``--sass`` it prints, for each kernel of the libraries of K1, K12/K11
and K5a/K5b (the ring scan's instantiations for K5a, K5b and K11 among
them), its instruction count, the order of its memory and barrier
instructions in the SASS (run-length coded) and a digest of its SASS with
addresses, constant-bank offsets and names taken out (two builds whose
digests agree run the same instructions).  With ``--save DIR`` it writes
the f32 outputs of K1, K2, K12 (unmasked and masked), K11, K5a and K5b on
fixed inputs (B=4, T=400, D=512) to DIR/<tag>.pt and reports, for every
other tag saved there, whether they are bit for bit equal, and the largest
difference where they are not; it also prints a digest of K1's and K2's f32
outputs at the B=32 timing shape.  It prints the card's name and power
limit, the phases' own log lines and one JSON line of kernel times.  With
``--streams N`` it runs only phase 3's and phase 24's streams, N times each
in turns (the chunk latency moves between runs).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
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


# the memory and barrier instructions whose order --sass reports
SASS_ORDER = ("LDGSTS", "LDGDEPBAR", "DEPBAR", "LDG", "STG", "LDS", "STS", "BAR")


def sass_summary(lib: str) -> dict[str, dict]:
    """Per kernel of the built library ``lib`` (``cuobjdump -sass``): its
    instruction count, its memory and barrier instructions in program order,
    run-length coded, and a digest of its instructions with addresses,
    constant-bank offsets and names taken out."""
    from statecatcher_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_kernels._target(lib))], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            kernels[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m:
                kernels[name].append(m.group(1))
    summary = {}
    for name, instrs in kernels.items():
        ops = [i.split()[0] if not i.startswith("@") else i.split()[1] for i in instrs]
        seq = []
        for op in ops:
            base = op.split(".")[0]
            if base in SASS_ORDER:
                if seq and seq[-1][0] == base:
                    seq[-1][1] += 1
                else:
                    seq.append([base, 1])
        norm = "\n".join(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[]", i) for i in instrs)
        summary[name] = {"instructions": len(instrs),
                         "order": " ".join(f"{op}x{n}" if n > 1 else op for op, n in seq),
                         "digest": hashlib.sha256(norm.encode()).hexdigest()[:16]}
    return summary


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


def streams_only(cs, args, dev) -> int:
    """Phase 3's streams (K1) and phase 24's (K12, masked) in turns, each
    ``args.streams`` times: the chunk latency's spread within one run."""
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops.lucy_pallas import lucy_fused_cell

    cfg = Config().apply_overrides(cs.FLAGSHIP)
    kcfg = cfg.apply_overrides(cs.MASKED).apply_overrides(
        ["--model.lucyrnn.kernel_impl", "auto-fused"])
    models = []
    for c in (cfg, kcfg):
        model = cs.build_speech_model(c.model, c.frontend.n_mfcc, "ctc", device=dev,
                                      generator=torch.Generator().manual_seed(cs.SEED))
        cs.randomize_(model, cs.SEED + 1)
        models.append(model.eval())
    for i in range(args.streams):
        cs.phase_streaming(models[0], cfg, dev, tag=f"[{args.tag}] [streaming {i}]")
        cs.phase_streaming(models[1], kcfg, dev, lucy_fused_cell,
                           f"[{args.tag}] [k12 streaming {i}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no paths")
    ap.add_argument("--profile", action="store_true", help="device time by CUDA kernel")
    ap.add_argument("--save", default=None, help="directory for the bit-for-bit comparison")
    ap.add_argument("--sass", action="store_true", help="the kernels' SASS, summarised")
    ap.add_argument("--streams", type=int, default=0,
                    help="only phase 3's and phase 24's streams, each this many times in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lucy_cell_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm, lucy_cell_fused_lm_bwd
    from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
    from statecatcher_tpu_torch.ops.lucy_pallas import (
        linear_scan_fwd,
        linear_scan_rev,
        lucy_dual_scan,
        lucy_fused_cell,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    if args.sass:
        for lib in ("lucy_fused_lm_fwd", "lucy_cell_scan", "linear_scan"):
            for name, s in sass_summary(lib).items():
                print(f"[{args.tag}] SASS {lib} {name}: {s['instructions']} instructions, digest "
                      f"{s['digest']}; memory and barriers in order: {s['order']}", flush=True)
    dev = torch.device("cuda", 0)
    if args.streams:
        return streams_only(cs, args, dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    out = {}
    with torch.inference_mode():
        if args.save:
            gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, 4, 400, 512, torch.float32, dev)
            h_all, s_all = lucy_cell_fused_lm(gates, bias, h0, s0)
            g_h = torch.randn(h_all.shape, generator=gen, device=dev)
            g_s = 0.1 * torch.randn(h_all.shape, generator=gen, device=dev)
            dg, dh0, ds0, db = lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all, g_h, g_s)
            outs = {"h_all": h_all, "s_all": s_all, "d_gates": dg, "dh0": dh0, "ds0": ds0,
                    "d_bias": db}
            g4 = (gates + bias).reshape(4, 400, 7, 512)
            mask = cs.masked_rows(4, 400, dev)
            for tag, m in (("K12", None), ("K12 masked", mask)):
                outs[f"{tag} h_all"], outs[f"{tag} s_all"] = lucy_fused_cell(g4, h0, s0, m)
            planes = [x for i, x in enumerate(lucy_gate_coeffs(gates, mask, bias)) if i != 3]
            outs["K11 h_all"], outs["K11 s_all"] = lucy_dual_scan(*planes, h0, s0)
            outs["K5a"] = linear_scan_fwd(planes[0], planes[1], s0)
            outs["K5b"] = linear_scan_rev(planes[0], g_h)
            compare_saved(args.tag, outs, args.save)
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
        for label, B, T, dtype in (("f32", 32, 1598, torch.float32),
                                   ("bf16", 32, 1598, torch.bfloat16),
                                   ("streaming f32", 1, 32, torch.float32)):
            gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, B, T, 512, torch.float32, dev)
            g4 = (gates + bias).reshape(B, T, 7, 512).to(dtype)
            mask = cs.masked_rows(B, T, dev)
            small = B * T <= 1000
            a_s, b_s, a_h, _, h_pre = (x.to(dtype) for x in lucy_gate_coeffs(gates, mask, bias))
            runs = [("K12 " + label, lambda: lucy_fused_cell(g4, h0, s0, None)),
                    ("K12 masked " + label, lambda: lucy_fused_cell(g4, h0, s0, mask)),
                    ("K5a " + label, lambda: linear_scan_fwd(a_s, b_s, s0))]
            if not small:
                # yardstick, not the same function: an elementwise pass over
                # the same bytes (two planes read, one written)
                runs += [("add (yardstick) " + label, lambda: torch.add(a_s, b_s)),
                         ("K5b " + label, lambda: linear_scan_rev(a_s, b_s)),
                         ("K11 masked " + label,
                          lambda: lucy_dual_scan(a_s, b_s, a_h, h_pre, h0, s0))]
            for name, fn in runs:
                out[name] = cs.cuda_ms(fn, 200 if small else args.reps, graph=small)
                if small:
                    out[name + " host"] = host_ms(fn)
                elif args.profile:
                    cs.log_by_kernel(f"[{args.tag}] {name}", fn)
            del gates, g4, a_s, b_s, a_h, h_pre
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

    masked = cfg.apply_overrides(cs.MASKED)
    kcfg = masked.apply_overrides(["--model.lucyrnn.kernel_impl", "auto-fused"])
    dcfg = masked.apply_overrides(["--model.lucyrnn.kernel_impl", "pallas-dual"])
    ncfg = masked.apply_overrides(cs.NATIVE)
    for c, counters, tag in ((masked, None, "split"), (kcfg, {"K12": lucy_fused_cell}, "k12"),
                             (dcfg, {"K11": lucy_dual_scan}, "dual"),
                             (ncfg, {"K5a": linear_scan_fwd}, "native")):
        model = cs.build_speech_model(c.model, c.frontend.n_mfcc, "ctc", device=dev,
                                      generator=torch.Generator().manual_seed(cs.SEED))
        cs.randomize_(model, cs.SEED + 1)
        _, per_seg = cs.phase_batched(model.eval(), c, dev, counters,
                                      f"[{args.tag}] [{tag} batched masked]")
        print(f"[{args.tag}] {tag} masked segment (B=32, the third): {per_seg[2]:.1f} ms",
              flush=True)
        if tag == "k12":
            cs.phase_streaming(model, c, dev, lucy_fused_cell, f"[{args.tag}] [k12 streaming]")
        del model
        if tag != "native":
            ms, peak = kernel_group(cs, c, dev, K=2)
            print(f"[{args.tag}] {tag} masked ctc train group (B=32, K=2, f32), kernel path, "
                  f"second run: {ms:.1f} ms per segment, peak memory {peak:.3f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
