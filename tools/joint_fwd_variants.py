"""Where the joint forward's time goes (K6a/K8a, ``joint_fwd_mma_kernel``):
build patched copies of ``rnnt_joint.cu``, each with one part of the kernel
taken out or replaced, and time K6a with each at phase 8's training shape
(B=32, T=1598, U=48, J=64, V=1024), f32 and bf16, on one card:

    PYTHONPATH=. python tools/joint_fwd_variants.py [variant ...]

Variants (all by default; "kernel" is the source as it is):

    kernel           as shipped
    one ring         one K ring, all 8 warps in step (no ping-pong groups)
    no exps          the exps replaced by adds
    no lse           no log-sum-exp at all (the running max only)
    no products      no mma (the B loads kept)
    products only    no log-sum-exp, no A split, no B loads: mma.sync's own rate
    no joint         the joint not formed (its loads and tanh)
    no emit          the emit logit's dot left out

Each variant is built by nvcc under ``build/joint_fwd_variants/<name>/``
(ignored by git), and its outputs are compared with the shipped kernel's bit
for bit ("one ring" computes the same function).  It prints the card's name
and power limit, each build's registers, the kernel's device time under
``torch.profiler`` and the wrapper's time by CUDA events over 10 calls, two
rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

CORE = "rnnt_joint_core.cuh"
NO_LSE = ("""        const float mn = fmaxf(m[mt][h], tmax), m2 = mn * kLog2e;
        float add = 0.0f;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) add += ex2(fmaf(acc[mt][n][2 * h + c], kLog2e, -m2));
        s[mt][h] = fmaf(s[mt][h], ex2(fmaf(m[mt][h], kLog2e, -m2)), add);
        m[mt][h] = mn;""", "        m[mt][h] = fmaxf(m[mt][h], tmax);")
NO_SPLIT = ("for (int e = 0; e < 4; ++e) a[mt][e] = split_tf32(ar[mt][ks][e]);",
            "for (int e = 0; e < 4; ++e) a[mt][e] = Split{__float_as_uint(ar[mt][ks][e]), "
            "__float_as_uint(ar[mt][ks][e]) + 1u};")
NO_B_LOADS = ("const Split b[2] = {{kHi[o], kLo[o]}, {kHi[o + 4 * KS], kLo[o + 4 * KS]}};",
              "const Split b[2] = {{a[0][0].hi + o, a[0][1].lo}, {a[0][2].hi, a[0][3].lo + n}};")
NO_MMA = [("for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][n], a[mt], b);",
           "for (int mt = 0; mt < MT; ++mt) "
           "acc[mt][n][0] += __uint_as_float(b[0].hi ^ b[1].lo ^ a[mt][0].hi);"),
          ("mma_bf16(acc[mt][2 * np], ar[mt][ks], b);",
           "acc[mt][2 * np][0] += __uint_as_float(b[0] ^ ar[mt][ks][0]);"),
          ("mma_bf16(acc[mt][2 * np + 1], ar[mt][ks], b + 2);",
           "acc[mt][2 * np + 1][0] += __uint_as_float(b[2] ^ ar[mt][ks][1]);")]


# name -> (old, new) replacements, each of the first occurrence (the forward
# comes before the backward in the header)
VARIANTS = {
    "kernel": [],
    "one ring": [("static constexpr bool PP = JP == 64;", "static constexpr bool PP = false;")],
    "no exps": [("add += ex2(fmaf(acc[mt][n][2 * h + c], kLog2e, -m2));",
                 "add += acc[mt][n][2 * h + c];")],
    "no lse": [NO_LSE],
    "no products": NO_MMA,
    "products only": [NO_LSE, NO_SPLIT, NO_B_LOADS],
    "no joint": [("  load_joint_rows<NR, JP, JS, QB>(enc, pred, g, s_eo, s_po, jS);\n", "")],
    "no emit": [("for (int i = 0; i < NJ8; ++i) e = fmaf(jS[row * JS + l8 + 8 * i], kv[q][i], e);",
                 "for (int i = 0; i < NJ8; ++i) e += 0.0f;")],
}


def build(name: str, kernels) -> ctypes.CDLL:
    """The variant's rnnt_joint library, built from a patched copy of csrc."""
    root = Path(kernels.BUILD_DIR).parent / "joint_fwd_variants" / name.replace(" ", "_")
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
        started = kernels._start("rnnt_joint")
        if started is not None:
            kernels._finish("rnnt_joint", started)
        lines = kernels.BUILD_LOG["rnnt_joint"]["ptxas"].splitlines()
        regs = [lines[k + 3].split(":", 1)[1].strip() for k, ln in enumerate(lines)
                if "Compiling entry" in ln and "fwd_mma" in ln]
        print(f"[{name}] joint_fwd_mma_kernel builds: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(str(kernels._target("rnnt_joint")))
    finally:
        kernels.CSRC, kernels.BUILD_DIR = saved
    for fn, (restype, argtypes) in kernels.SIGNATURES["rnnt_joint"].items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def kernel_ms(fn) -> float:
    """joint_fwd_mma_kernel's mean device time over 5 calls (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and "joint_fwd_mma" in ev.name) / 5e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("joint_fwd_variants needs a CUDA card")
    import chip_smoke as cs
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_joint_fwd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = ["kernel"] + [v for v in args.variants or VARIANTS if v != "kernel"]
    libs = {v: build(v, _kernels) for v in names}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    data = {dt: cs.joint_inputs(gen, 32, 1598, 48, 64, 1024, dev, dt, 0)[:5]
            for dt in (torch.float32, torch.bfloat16)}
    library = _kernels.library
    try:
        with torch.inference_mode():
            ref = {}
            for v in names:
                _kernels.library = lambda _name, v=v: libs[v]
                outs = {dt: [x.clone() for x in rnnt_joint_fwd(*d)] for dt, d in data.items()}
                ref = ref or outs
                same = all(torch.equal(x, y) for dt in outs for x, y in zip(outs[dt], ref[dt]))
                prof = [kernel_ms(lambda d=d: rnnt_joint_fwd(*d)) for d in data.values()]
                print(f"[{v}] kernel (profiler): f32 {prof[0]:.4f} ms, bf16 {prof[1]:.4f} ms; "
                      f"outputs bit for bit as the kernel's: {same}", flush=True)
            for rnd in range(2):
                for v in names:
                    _kernels.library = lambda _name, v=v: libs[v]
                    ms = [cs.cuda_ms(lambda d=d: rnnt_joint_fwd(*d), 10) for d in data.values()]
                    print(f"[{v}] round {rnd}: rnnt_joint_fwd f32 {ms[0]:.4f} ms, bf16 "
                          f"{ms[1]:.4f} ms", flush=True)
    finally:
        _kernels.library = library
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
