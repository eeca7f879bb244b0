"""Times of the banded RNN-T lattice kernels (``rnnt_band_alpha``,
``rnnt_band_beta``) and of the RNN-T paths that run them, for one checkout of
the port.  To compare two checkouts on one card, run it once per checkout, in
turns, within one call:

    PYTHONPATH=<checkout A> python tools/band_lattice_ab.py --tag A --save DIR
    PYTHONPATH=<checkout B> python tools/band_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout B> python tools/band_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout A> python tools/band_lattice_ab.py --tag A --save DIR

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` and ``profile_train.py`` (so both
checkouts run the same phases and report the same groups, over their own
package).  It times with CUDA events the banded α and β on K8a's f32 tables
at phase 13's shape (B=32, T=1598, U=128, band 32: Wp=48, Tp=1600) and at
bench.py's RNN-T rows (B=96, U=64 and U=128), each beside its chain floor
(``chip_smoke.band_chain_floor``); then runs phase 13 (K8 and the lattice
against their plain versions, the band ≥ U+1 identity), phase 15's RNN-T
rows (B=96, bf16, K=4, U=64 and U=128: audio-s/s) and, with ``--profile``,
``profile_train --mode rnnt --tokens 128`` at B=32 f32 and at B=96 bf16
(device time by kernel and by group).  With ``--save DIR`` it writes K7's
f32 outputs (``rnnt_alpha``, ``rnnt_beta``) and the banded α and β on fixed
inputs to DIR/<tag>.pt and reports, for every other tag saved there,
whether they are bit for bit equal, and the largest difference where they
are not.  With ``--variants`` (this tree's package only) it also builds
copies of ``rnnt_lattice.cu`` patched at exact strings of
``rnnt_wavefront.cuh`` into ``build/band_variants/`` and times each at phase
13's shape, held against the plain versions at phase 13's tolerances.
Prints the card's name and power limit, the phases' own log lines and one
JSON line of kernel times.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lucy_cell_ab import compare_saved  # noqa: E402
from mlstm_bwd_ab import load_chip_smoke  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "rnnt_wavefront.cuh"
# (exact text of rnnt_wavefront.cuh, replacement): what a part of the
# kernel costs, or another choice
VARIANTS = {
    "device loads at Wp 48": [("RNNT_WAVEFRONT_CASE(c == 2, 2, true);",
                               "RNNT_WAVEFRONT_CASE(c == 2, 2, false);")],
    "accurate expf and log1pf": [("return m + __logf(1.0f + __expf(-fabsf(x - y)));",
                                  "return m + log1pf(expf(-fabsf(x - y)));")],
    # each warp alone, the other returning at once (outputs wrong): which
    # one sets the pace
    "consumer alone": [("  if (producer) {\n    // beta's virtual base",
                        "  if (producer) return;\n  if (producer) {\n    // beta's virtual base"),
                       ("    bar_sync(kFull + slot, 64);", "    (void)slot;"),
                       ("    if (c + 2 < n_chunks) bar_arrive(kEmpty + slot, 64);", "")],
    "producer alone": [("      if (c >= 2) bar_sync(kEmpty + slot, 64);", ""),
                       ("      bar_arrive(kFull + slot, 64);", ""),
                       ("  // The consumer.  alpha:", "  return;\n  // The consumer.  alpha:")],
    "producer alone, no frame copies": [
        ("      if (c >= 2) bar_sync(kEmpty + slot, 64);", ""),
        ("      bar_arrive(kFull + slot, 64);", ""),
        ("  // The consumer.  alpha:", "  return;\n  // The consumer.  alpha:"),
        ("        lucy_tile::cp_async_wait<kRingAhead - 1>();", ""),
        ("        ring_copy(d_first + sgn * ((c + kRingAhead + 1) * kChunk - 1));", "")],
    "producer alone, no records": [
        ("      if (c >= 2) bar_sync(kEmpty + slot, 64);", ""),
        ("      bar_arrive(kFull + slot, 64);", ""),
        ("  // The consumer.  alpha:", "  return;\n  // The consumer.  alpha:"),
        ("      for (int j = 0; j < kChunk; ++j) {\n        const int h = j ?",
         "      for (int j = 0; j < 0; ++j) {\n        const int h = j ?")],
    "frame copies 4 chunks ahead": [("constexpr int kRingAhead = 2;", "constexpr int kRingAhead = 4;")],
    "frame copies 6 chunks ahead": [("constexpr int kRingAhead = 2;", "constexpr int kRingAhead = 6;")],
    "producer alone, copies 6 chunks ahead": [
        ("constexpr int kRingAhead = 2;", "constexpr int kRingAhead = 6;"),
        ("      if (c >= 2) bar_sync(kEmpty + slot, 64);", ""),
        ("      bar_arrive(kFull + slot, 64);", ""),
        ("  // The consumer.  alpha:", "  return;\n  // The consumer.  alpha:")],
    "chunks of 4 diagonals": [("return C <= 16 ? 8 : 4;", "return C <= 16 ? 4 : 4;")],
    "chunks of 16 diagonals": [("return C <= 16 ? 8 : 4;", "return C <= 16 ? 16 : 4;")],
}


def load_profile_train():
    """This tree's ``profile_train.py`` as a module, over whichever package
    the import path finds first."""
    spec = importlib.util.spec_from_file_location(
        "profile_train", os.path.join(ROOT, "statecatcher_tpu_torch", "profile_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(name: str, patches: list) -> ctypes.CDLL:
    """``rnnt_lattice.cu`` built against a patched copy of the header.  Exits
    naming a patch whose text is not found."""
    from statecatcher_tpu_torch.ops import _kernels

    slug = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _kernels.BUILD_DIR.parent / "band_variants" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in os.listdir(_kernels.CSRC):
        if src.endswith(".cuh") or src == "rnnt_lattice.cu":
            text = (_kernels.CSRC / src).read_text()
            if src == HEADER:
                for old, new in patches:
                    if old not in text:
                        raise SystemExit(f"{name}: patch text not found in {HEADER}:\n{old}")
                    text = text.replace(old, new, 1)
            (out_dir / src).write_text(text)
    target = out_dir / "rnnt_lattice.so"
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(target),
                           str(out_dir / "rnnt_lattice.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(target))
    for fn_name, (restype, argtypes) in _kernels.SIGNATURES["rnnt_lattice"].items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def band_tables(cs, gen, B, U, dev):
    """K8a's f32 tables at (B, T=1598, U, band 32) and the band's geometry."""
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_fwd

    J, V, T, band, Tb = 64, 1024, 1598, 32, 8
    enc, pred, k, b, labels, t_lens, u_lens, o, Wp, Tp, *_ = cs.band_problem(
        gen, B, T, U, J, V, band, Tb, dev, torch.float32)
    with torch.inference_mode():
        blank_b, emit_b, _ = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb)
    return blank_b, emit_b, o, t_lens, u_lens, Tb


def time_lattice(cs, tables, reps: int) -> dict:
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_alpha, rnnt_band_beta

    blank_b, emit_b, o, t_lens, u_lens, Tb = tables
    with torch.inference_mode():
        ms_a = cs.cuda_ms(lambda: rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb), reps)
        ms_b = cs.cuda_ms(lambda: rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb), reps)
        floor, per_diag, n_diag = cs.band_chain_floor(blank_b, emit_b, o, t_lens, Tb)
    return {"alpha": ms_a, "beta": ms_b, "chain floor": floor, "ns per diagonal": per_diag * 1e6,
            "diagonals": n_diag}


def run_variants(cs, tables, reps: int) -> dict:
    """Each variant's α/β time at phase 13's shape, and whether it holds the
    plain versions at phase 13's tolerances."""
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.rnnt_band import (
        rnnt_band_alpha, rnnt_band_alpha_ref, rnnt_band_beta, rnnt_band_beta_ref)

    blank_b, emit_b, o, t_lens, u_lens, Tb = tables
    with torch.inference_mode():
        refs = (rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, Tb),
                rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, Tb))
    shipped, out = _kernels.library, {}
    for name, patches in VARIANTS.items():
        try:
            lib = build_variant(name, patches)
            _kernels.library = lambda n, lib=lib: lib if n == "rnnt_lattice" else shipped(n)
            res = time_lattice(cs, tables, reps)
            with torch.inference_mode():
                got = (rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb),
                       rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb))
            try:
                errs = [cs.check_lattice(g, r, 2e-5, 1e-5) for g, r in zip(got, refs)]
                res["check"] = f"holds (max |Δ| {max(errs):.3e})"
            except AssertionError as err:
                res["check"] = f"fails: {err}"
        except RuntimeError as err:                  # a variant the card refuses
            res = {"error": str(err)}
        finally:
            _kernels.library = shipped
        out[name] = res
        print(f"[variant] {name}: {res}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no paths")
    ap.add_argument("--profile", action="store_true", help="profile_train's RNN-T segments")
    ap.add_argument("--save", default=None, help="directory for the bit-for-bit comparison")
    ap.add_argument("--variants", action="store_true", help="patched builds of the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("band_lattice_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_alpha, rnnt_band_beta
    from statecatcher_tpu_torch.ops.rnnt_lattice import rnnt_alpha, rnnt_beta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    if args.save:
        blank, emit, t_lens, u_lens = (x.to(dev) for x in exact_inputs(gen, dev))
        tables = band_tables(cs, gen, 4, 128, dev)
        bl, em, o, tl, ul, Tb = tables
        with torch.inference_mode():
            outs = {"K7 rnnt_alpha": rnnt_alpha(blank, emit, t_lens),
                    "K7 rnnt_beta": rnnt_beta(blank, emit, t_lens, u_lens),
                    "band alpha": rnnt_band_alpha(bl, em, o, tl, Tb),
                    "band beta": rnnt_band_beta(bl, em, o, tl, ul, Tb)}
        compare_saved(args.tag, outs, args.save)
    out, at32 = {}, None
    for label, B, U in (("B=32 U=128", 32, 128), ("B=96 U=64", 96, 64), ("B=96 U=128", 96, 128)):
        tables = band_tables(cs, gen, B, U, dev)
        out[label] = time_lattice(cs, tables, args.reps)
        print(f"[{args.tag}] band lattice {label}: {out[label]}", flush=True)
        if B == 32:
            at32 = tables
        else:
            del tables
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.variants:
        print(f"[{args.tag}] variants " + json.dumps(run_variants(cs, at32, args.reps)),
              flush=True)
    del at32
    if args.kernels_only:
        return 0

    cs.phase_band_kernels(dev)
    cfg = Config().apply_overrides(cs.FLAGSHIP)
    for U in (64, 128):
        cs.phase_throughput(cfg, dev, K=4, U=U, mode="rnnt")
    if args.profile:
        pt = load_profile_train()
        for extra in ([], ["--batch", "96", "--dtype", "bfloat16"]):
            sys.argv = ["profile_train", "--mode", "rnnt", "--tokens", "128", *extra]
            print(f"[{args.tag}] profile_train {' '.join(sys.argv[1:])}", flush=True)
            pt.main()
    return 0


def exact_inputs(gen, dev, B=4, T=400, U=128):
    """K7's blank (B, T, U+1) and emit (B, T, U) log-probs, a short row and a
    row with no labels."""
    blank = torch.randn((B, T, U + 1), generator=gen, device=dev) - 1.5
    emit = torch.randn((B, T, U), generator=gen, device=dev) - 1.5
    t_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    u_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
    t_lens[1], u_lens[1], u_lens[2] = T - T // 3, U // 2, 0
    return blank, emit, t_lens, u_lens


if __name__ == "__main__":
    raise SystemExit(main())
