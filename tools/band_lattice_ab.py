"""Times of the RNN-T lattice kernels, banded (``rnnt_band_alpha``,
``rnnt_band_beta``) and exact (K7a ``rnnt_alpha``, K7b ``rnnt_beta``), and of
the RNN-T paths that run them, for one checkout of the port.  To compare two
checkouts on one card, run it once per checkout, in turns, within one call:

    PYTHONPATH=<checkout A> python tools/band_lattice_ab.py --tag A --save DIR
    PYTHONPATH=<checkout B> python tools/band_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout B> python tools/band_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout A> python tools/band_lattice_ab.py --tag A --save DIR

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` and ``profile_train.py`` (so both
checkouts run the same phases and report the same groups, over their own
package).  It times with CUDA events the banded α and β on K8a's f32 tables
at phase 13's shape (B=32, T=1598, U=128, band 32: Wp=48, Tp=1600), at
bench.py's RNN-T rows (B=96, U=64 and U=128) and at a window above the
frame ring's (B=32, U=200, band 128), each beside its chain floor
(``chip_smoke.band_chain_floor``), and K7a/K7b at phase 8's shapes
(``chip_smoke.phase_exact_lattice``: B=32, T=1598, U=48 and U=128, a ragged
shape and U+1 > 1024, each held against the plain versions and beside its
chain floor and byte bound); then runs phase 9 (the exact RNN-T training
group, U=48), phase 13 (K8 and the banded lattice against their plain
versions, the band ≥ U+1 identity), phase 14 (the banded training group),
phase 15's RNN-T rows (B=96, bf16, K=4, U=64 and U=128: audio-s/s) and, with
``--profile``, ``profile_train --mode rnnt`` at U=48 (the exact loss) and at
U=128 (banded), B=32 f32, and at U=128, B=96 bf16 (device time by kernel and
by group).  With ``--save DIR`` it writes K7's f32 outputs and the banded α
and β on fixed inputs (Wp 48, and Wp above 104) to DIR/<tag>.pt and reports, for every other tag saved
there, whether they are bit for bit equal, and the largest difference where
they are not.  With ``--variants`` (this tree's package only) it builds K7
in both forms of its log-sum-exp (form (a), the accurate expf/log1pf; form
(b), the fast __expf/__logf; the shipped one is not rebuilt), runs
``phase_exact_lattice``, phases 9 and 14 and phase 9's float64 witness
(``phase_rnnt_witness``) under each, reporting each phase's update
difference (the witness's distances from float64) or its failure, and times the other builds of
``K7_VARIANTS`` (the exact ring's rows unpadded, no exact ring) at phase 8's
K7 cases.  With ``--band-variants`` it builds copies
of ``rnnt_lattice.cu`` patched at exact strings of ``rnnt_wavefront.cuh``
(each warp alone, no frame copies, chunk sizes, ...) into
``build/band_variants/`` and times each at phase 13's shape, held against
the plain versions at phase 13's tolerances.  Prints the card's name and
power limit, the phases' own log lines and JSON lines of kernel times.
"""

from __future__ import annotations

import argparse
import contextlib
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
# (exact text of rnnt_wavefront.cuh, replacement), or (file, text,
# replacement): what a part of the kernel costs, or another choice
BAND_VARIANTS = {
    "device loads at Wp 48": [("RNNT_WAVEFRONT_CASE(c == 2, 2, true);",
                               "RNNT_WAVEFRONT_CASE(c == 2, 2, false);")],
    "accurate expf and log1pf": [("return m + __logf(1.0f + __expf(-fabsf(x - y)));",
                                  "return m + log1pf(expf(-fabsf(x - y)));")],
    # each warp alone, the other returning at once (outputs wrong): which
    # one sets the pace
    # (the records are never written: no store, so that no garbage offset
    # is stored to)
    "consumer alone": [("  if (producer) {\n    // beta's virtual base",
                        "  if (producer) return;\n  if (producer) {\n    // beta's virtual base"),
                       ("    bar_sync(kFull + slot, 64);", "    (void)slot;"),
                       ("    if (c + 2 < n_chunks) bar_arrive(kEmpty + slot, 64);", ""),
                       ("x, r[i].off >= 0);", "x, false);")],
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
        ("      for (int j = 0; j < kChunk; ++j) {\n        float bl[C], em[C];",
         "      for (int j = 0; j < 0; ++j) {\n        float bl[C], em[C];")],
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
# K7's two forms of the log-sum-exp (the exact walk's lae: the shipped
# accurate one, or the banded kernel's fast one), each with phases 9 and 14
# and phase 9's float64 witness ("train"); other builds of K7 with phase 8's
# K7 cases ("check"), or only timed where their outputs are wrong ("time"):
# name -> (patches, mode)
_NO_RING = ("if (kBand ? Wp <= kRingMaxWp : smem_bytes(c, true, false, Wp, 0) <= 227 * 1024)",
            "if (kBand ? Wp <= kRingMaxWp : false)")
K7_VARIANTS = {
    "K7 form (a): expf/log1pf": ([], "train"),
    "K7 form (b): __expf/__logf": ([("x = lae<kBand>(up, in_rt[i]);", "x = lae<true>(up, in_rt[i]);"),
                                    ("x = lae<kBand>(r[i].bl + up,", "x = lae<true>(r[i].bl + up,")],
                                   "train"),
    "exact ring rows at the tables' own strides": ([("    sb = (Wp + 1) & ~1;", "    sb = Wp;"),
                                                    ("    se = Wp & ~1; ", "    se = Wp - 1;")],
                                                   "check"),
    "no exact ring (the producer's own loads)": ([_NO_RING], "check"),
    "no exact ring, the producer's loads a diagonal at a time": (
        [_NO_RING, ("#pragma unroll(kRing || (!kBand && C <= 8) ? kChunk : 1)",
                    "#pragma unroll(kRing ? kChunk : 1)")], "check"),
    "no frame copies (outputs wrong)": (
        [("        sweep_bl.copy(", "        if (0) sweep_bl.copy("),
         ("        sweep_em.copy(", "        if (0) sweep_em.copy(")], "time"),
    "producer alone (outputs wrong)": (BAND_VARIANTS["producer alone"], "time"),
    "consumer alone (outputs wrong)": (BAND_VARIANTS["consumer alone"], "time"),
}


def load_profile_train():
    """This tree's ``profile_train.py`` as a module, over whichever package
    the import path finds first."""
    spec = importlib.util.spec_from_file_location(
        "profile_train", os.path.join(ROOT, "statecatcher_tpu_torch", "profile_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_sources(name: str, patches: list) -> dict:
    """``rnnt_lattice.cu`` and the headers with ``patches`` applied, by file
    name; None where every patch's replacement is already in place (the
    shipped build).  Exits naming a patch whose text is not found."""
    from statecatcher_tpu_torch.ops import _kernels

    texts = {src: (_kernels.CSRC / src).read_text() for src in os.listdir(_kernels.CSRC)
             if src.endswith(".cuh") or src == "rnnt_lattice.cu"}
    changed = False
    for patch in patches:
        src, old, new = patch if len(patch) == 3 else (HEADER, *patch)
        if old in texts[src]:
            texts[src] = texts[src].replace(old, new, 1)
            changed = True
        elif new not in texts[src]:
            raise SystemExit(f"{name}: patch text not found in {src}:\n{old}")
    return texts if changed else None


def build_variant(name: str, patches: list) -> ctypes.CDLL | None:
    """``rnnt_lattice.cu`` built from patched sources; None for a variant
    that is the shipped build."""
    from statecatcher_tpu_torch.ops import _kernels

    texts = patched_sources(name, patches)
    if texts is None:
        return None
    slug = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _kernels.BUILD_DIR.parent / "band_variants" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    for src, text in texts.items():
        (out_dir / src).write_text(text)
    target = out_dir / "rnnt_lattice.so"
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(target),
                           str(out_dir / "rnnt_lattice.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(f"[variant build] {name}: " + " | ".join(ptxas_summary(proc.stdout + proc.stderr)),
          flush=True)
    lib = ctypes.CDLL(str(target))
    for fn_name, (restype, argtypes) in _kernels.SIGNATURES["rnnt_lattice"].items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


@contextlib.contextmanager
def using(lib):
    """The port's ``rnnt_lattice`` library replaced by ``lib`` (None: the
    shipped one) while the block runs."""
    from statecatcher_tpu_torch.ops import _kernels

    shipped = _kernels.library
    if lib is not None:
        _kernels.library = lambda n: lib if n == "rnnt_lattice" else shipped(n)
    try:
        yield
    finally:
        _kernels.library = shipped


def band_tables(cs, gen, B, U, dev, band=32):
    """K8a's f32 tables at (B, T=1598, U, band) and the band's geometry."""
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_fwd

    J, V, T, Tb = 64, 1024, 1598, 8
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


def run_band_variants(cs, tables, reps: int) -> dict:
    """Each banded variant's α/β time at phase 13's shape, and whether it
    holds the plain versions at phase 13's tolerances."""
    from statecatcher_tpu_torch.ops.rnnt_band import (
        rnnt_band_alpha, rnnt_band_alpha_ref, rnnt_band_beta, rnnt_band_beta_ref)

    blank_b, emit_b, o, t_lens, u_lens, Tb = tables
    with torch.inference_mode():
        refs = (rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, Tb),
                rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, Tb))
    out = {}
    for name, patches in BAND_VARIANTS.items():
        try:
            with using(build_variant(name, patches)):
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
        out[name] = res
        print(f"[variant] {name}: {res}", flush=True)
    return out


def time_exact(cs, dev) -> dict:
    """K7a/K7b's times and chain floor at phase 8's training shape and at
    U=128, with no check (for builds whose outputs are wrong)."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    out = {}
    for label, B, T, U in (("training", 32, 1598, 48), ("U=128", 32, 1598, 128)):
        blank = torch.randn((B, T, U + 1), generator=gen, device=dev) - 1.5
        emit = torch.randn((B, T, U), generator=gen, device=dev) - 1.5
        t_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        u_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            out[f"K7a {label}"] = cs.cuda_ms(lambda: cs.rnnt_alpha(blank, emit, t_lens), 20)
            out[f"K7b {label}"] = cs.cuda_ms(lambda: cs.rnnt_beta(blank, emit, t_lens, u_lens), 20)
            out[f"chain floor {label}"] = cs.exact_chain_floor(blank, emit, t_lens)[0]
    return out


def ptxas_summary(log: str) -> list:
    """The exact wavefront's instances in a ptxas -v log: (name, registers
    and spills)."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "exact_wavefront" in line else None
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name[-40:]}: {line.strip()}")
    return out


def run_k7_variants(cs, cfg, dev) -> dict:
    """K7 in each of K7_VARIANTS: phase 8's K7 cases (times, chain floors,
    the check) and, for the two forms, phase 9's update difference and
    phase 14's, or the failure of each; the "time" builds only timed."""
    phases = {
        "phase 9": lambda: cs.phase_train_step(cfg, dev, K=2, U=48, mode="rnnt"),
        "phase 9 witness": lambda: cs.phase_rnnt_witness(cfg, dev, K=2, U=48),
        "phase 14": lambda: cs.phase_train_step(cfg, dev, K=2, U=128, mode="rnnt",
                                                path="rnnt banded", degenerate=True)}
    out = {}
    for name, (patches, mode) in K7_VARIANTS.items():
        res = {}
        with using(build_variant(name, patches)):
            if mode == "time":
                res["times"] = time_exact(cs, dev)
            else:
                try:
                    res["phase 8"] = {k: {m: v[m] for m in ("ms", "max_abs_err",
                                                            "chain_floor_ms", "unlike")}
                                      for k, v in cs.phase_exact_lattice(dev).items()}
                except AssertionError as err:
                    res["phase 8"] = f"fails: {err}"
            for phase, run in phases.items() if mode == "train" else ():
                try:
                    got = run()
                    res[phase] = ({k: got[k]["dist"] for k in got} if phase.endswith("witness")
                                  else {k: got[k] for k in ("update_rel", "frac_off")})
                except AssertionError as err:
                    res[phase] = f"fails: {err}"
        out[name] = res
        print(f"[K7 variant] {name}: {json.dumps(res)}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels-only", action="store_true", help="time the kernels, no paths")
    ap.add_argument("--profile", action="store_true", help="profile_train's RNN-T segments")
    ap.add_argument("--save", default=None, help="directory for the bit-for-bit comparison")
    ap.add_argument("--variants", action="store_true",
                    help="K7 in both log-sum-exp forms, and other builds of it")
    ap.add_argument("--band-variants", action="store_true",
                    help="patched builds of the banded kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("band_lattice_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels, rnnt_lattice
    if not hasattr(rnnt_lattice, "wavefront_route"):     # a checkout where K7 only scans
        rnnt_lattice.wavefront_route = lambda T, U1: False
    from statecatcher_tpu_torch.ops.rnnt_band import rnnt_band_alpha, rnnt_band_beta
    from statecatcher_tpu_torch.ops.rnnt_lattice import rnnt_alpha, rnnt_beta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = _kernels.build_all()
    if "rnnt_lattice" in builds:
        print(f"[{args.tag}] rnnt_lattice build: "
              + " | ".join(ptxas_summary(builds["rnnt_lattice"]["ptxas"])), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    if args.save:
        blank, emit, t_lens, u_lens = (x.to(dev) for x in exact_inputs(gen, dev))
        with torch.inference_mode():
            outs = {"K7 rnnt_alpha": rnnt_alpha(blank, emit, t_lens),
                    "K7 rnnt_beta": rnnt_beta(blank, emit, t_lens, u_lens)}
            # Wp 48 (the frame ring) and Wp above kRingMaxWp (the producer's
            # own loads)
            for label, U, band in (("", 128, 32), (" Wp>104", 200, 128)):
                bl, em, o, tl, ul, Tb = band_tables(cs, gen, 4, U, dev, band)
                outs[f"band alpha{label}"] = rnnt_band_alpha(bl, em, o, tl, Tb)
                outs[f"band beta{label}"] = rnnt_band_beta(bl, em, o, tl, ul, Tb)
        compare_saved(args.tag, outs, args.save)
    out, at32 = {}, None
    for label, B, U, band in (("B=32 U=128", 32, 128, 32), ("B=96 U=64", 96, 64, 32),
                              ("B=96 U=128", 96, 128, 32), ("B=32 U=200 band 128", 32, 200, 128)):
        tables = band_tables(cs, gen, B, U, dev, band)
        out[label] = time_lattice(cs, tables, args.reps)
        print(f"[{args.tag}] band lattice {label}: {out[label]}", flush=True)
        if label == "B=32 U=128":
            at32 = tables
        else:
            del tables
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.band_variants:
        print(f"[{args.tag}] variants " + json.dumps(run_band_variants(cs, at32, args.reps)),
              flush=True)
    del at32
    exact = {k: {m: v.get(m) for m in ("ms", "max_abs_err", "bound_ms", "chain_floor_ms",
                                       "unlike")}
             for k, v in cs.phase_exact_lattice(dev).items()}
    print(f"[{args.tag}] K7 kernels " + json.dumps(exact), flush=True)
    cfg = Config().apply_overrides(cs.FLAGSHIP)
    if args.variants:
        print(f"[{args.tag}] K7 variants " + json.dumps(run_k7_variants(cs, cfg, dev)),
              flush=True)
    if args.kernels_only:
        return 0

    cs.phase_train_step(cfg, dev, K=2, U=48, mode="rnnt")
    cs.phase_band_kernels(dev)
    cs.phase_train_step(cfg, dev, K=2, U=128, mode="rnnt", path="rnnt banded", degenerate=True)
    for U in (64, 128):
        cs.phase_throughput(cfg, dev, K=4, U=U, mode="rnnt")
    if args.profile:
        pt = load_profile_train()
        for extra in (["--tokens", "48"], ["--tokens", "128"],
                      ["--tokens", "128", "--batch", "96", "--dtype", "bfloat16"]):
            sys.argv = ["profile_train", "--mode", "rnnt", *extra]
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
