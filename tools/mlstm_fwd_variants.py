"""Where the mLSTM forward's time goes (K9a, ``launch_fwd`` in
``mlstm_chunk.cuh``): build patched copies of ``mlstm_fused.cu``'s sources,
each with one part of the forward changed or taken out, and time K9a with each
at ``chip_smoke.py`` phase 17's shapes (B=32, T=1598, 2 heads, dqk=128,
dv=256, chunk 128, f32 and bf16; B=64, chunk 256, bf16) on one card:

    PYTHONPATH=. python tools/mlstm_fwd_variants.py [variant ...]

Variants (all by default; "kernel" is the source as it is):

    kernel          as shipped
    nv256           fwd_out over 256 columns of h a block (one block of 255
                    registers per SM; S formed once at dv = 256)
    no slab sums    every product summed straight into its accumulator, not
                    32-deep slab by slab (the tensor cores' accumulator
                    truncates; changes K9b's products too)
    no products     no mma in any product (the operands still staged)
    no exps         E's exps replaced by their arguments

Each variant is built by nvcc under ``build/mlstm_fwd_variants/<name>/``
(ignored by git).  It prints the card's name and power limit, each build's
registers and spills of ``fwd_out_kernel``, and for each variant and shape:
``fwd_out_kernel``'s device time and the sum over all of K9a's kernels (one
call under ``torch.profiler``), K9a's time by CUDA events over 10 calls, and
the outputs' max |Δ| against the plain version (and whether they equal the
shipped kernel's bit for bit).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

CORE = "mlstm_chunk.cuh"
MMA = [("mma_split<kXA, kXB>(part[0][j], a[0], b);",
        "part[0][j][0] += __uint_as_float(a[0][0].hi ^ b[0].lo);"),
       ("mma_split<kXA, kXB>(part[1][j], a[1], b);",
        "part[1][j][0] += __uint_as_float(a[1][0].hi ^ b[1].lo);"),
       ("mma_bf16(part[0][j], a[0], b);", "part[0][j][0] += __uint_as_float(a[0][0] ^ b[0]);"),
       ("mma_bf16(part[1][j], a[1], b);", "part[1][j][0] += __uint_as_float(a[1][1] ^ b[1]);")]

# name -> (old, new) replacements, each of the first occurrence
VARIANTS = {
    "kernel": [],
    "nv256": [("  return launch_fwd<Tin, 128>(p, B, s);\n}",
               "  if (p.dv_ <= 128) return launch_fwd<Tin, 128>(p, B, s);\n"
               "  return launch_fwd<Tin, 256>(p, B, s);\n}"),
              ("__launch_bounds__(kThreads, 2) fwd_out_kernel",
               "__launch_bounds__(kThreads, NV > 128 ? 1 : 2) fwd_out_kernel")],
    "no slab sums": [("    Acc<N> part;\n    zero<N>(part);\n", "    Acc<N>& part = acc;\n"),
                     ("        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];\n",
                      "        for (int e = 0; e < 4; ++e) {}\n")],
    "no products": MMA,
    "no exps": [("x = s <= t && t < L ? p.inv * x * expf(gb[t] + ga[s] - mu[r]) : 0.f;",
                 "x = s <= t && t < L ? p.inv * x * (gb[t] + ga[s] - mu[r]) : 0.f;")],
}
SHAPES = (("f32", 32, 128, torch.float32), ("bf16", 32, 128, torch.bfloat16),
          ("bench bf16", 64, 256, torch.bfloat16))


def build(name: str, kernels) -> ctypes.CDLL:
    """The variant's mlstm_fused library, built from a patched copy of csrc."""
    root = Path(kernels.BUILD_DIR).parent / "mlstm_fwd_variants" / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for f in Path(kernels.CSRC).iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, root / "csrc" / f.name)
    core = root / "csrc" / CORE
    src = core.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name!r}: the source no longer holds {old[:60]!r}")
        src = src.replace(old, new, 1)
    core.write_text(src)
    saved = kernels.CSRC, kernels.BUILD_DIR
    kernels.CSRC, kernels.BUILD_DIR = root / "csrc", root / "kernels"
    try:
        started = kernels._start("mlstm_fused")
        if started is not None:
            kernels._finish("mlstm_fused", started)
        lines = kernels.BUILD_LOG["mlstm_fused"]["ptxas"].splitlines()
        regs = []
        for k, ln in enumerate(lines):
            m = re.search(r"fwd_out_kernelI(f|13__nv_bfloat16)Li(\d+)E", ln)
            if "Compiling entry" in ln and m:
                spill = lines[k + 2].strip().split(",")[1].strip()
                regs.append(f"{'f32' if m[1] == 'f' else 'bf16'}/{m[2]}: "
                            f"{lines[k + 3].split('Used', 1)[1].split(',')[0].strip()}, {spill}")
        print(f"[{name}] fwd_out_kernel builds: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(str(kernels._target("mlstm_fused")))
    finally:
        kernels.CSRC, kernels.BUILD_DIR = saved
    for fn, (restype, argtypes) in kernels.SIGNATURES["mlstm_fused"].items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def kernel_ms(cs, fn) -> tuple[float, float]:
    """(fwd_out_kernel's device time, the sum over all kernels) of one call."""
    rows = cs.device_ms_by_kernel(fn)
    return sum(v for k, v in rows if "fwd_out_kernel" in k), sum(v for _, v in rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("mlstm_fwd_variants needs a CUDA card")
    import chip_smoke as cs
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.mlstm_fused import mlstm_fused_fwd, mlstm_fused_fwd_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["kernel"] + [v for v in args.variants or VARIANTS if v != "kernel"]
    libs = {v: build(v, _kernels) for v in names}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 17)
    H, dqk, dv, T = 2, 128, 256, 1598
    data = {}
    with torch.inference_mode():
        for label, B, L, dtype in SHAPES:
            ins, _ = cs.mlstm_inputs(gen, B, T, H, dqk, dv, L, dtype, dev)
            data[label] = (ins, L, mlstm_fused_fwd_ref(*ins, L, T))
    library = _kernels.library
    try:
        with torch.inference_mode():
            ref = {}
            for v in names:
                _kernels.library = lambda _name, v=v: libs[v]
                for label, (ins, L, plain) in data.items():
                    got = [x.clone() for x in mlstm_fused_fwd(*ins, L, T)]
                    got[0], want = got[0][:, :T], [plain[0][:, :T], *plain[1:]]
                    err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want))
                    same = all(torch.equal(a, b) for a, b in zip(got, ref.get(label, got)))
                    ref.setdefault(label, got)
                    out_ms, all_ms = kernel_ms(cs, lambda: mlstm_fused_fwd(*ins, L, T))
                    ms = cs.cuda_ms(lambda: mlstm_fused_fwd(*ins, L, T), 10)
                    print(f"[{v}] {label}: fwd_out_kernel {out_ms:.4f} ms, all kernels "
                          f"{all_ms:.4f} ms (profiler); K9a {ms:.4f} ms (events); max|Δ| "
                          f"against the plain version {err:.3e}; bit for bit as the kernel's: "
                          f"{same}", flush=True)
    finally:
        _kernels.library = library
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
