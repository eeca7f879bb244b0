"""Times of the CTC lattice kernels K3 (``ctc_alpha``) and K4 (``ctc_beta``)
and of the CTC paths that run them, for one checkout of the port.  To
compare two checkouts on one card, run it once per checkout, in turns,
within one call:

    PYTHONPATH=<checkout A> python tools/ctc_lattice_ab.py --tag A --save DIR
    PYTHONPATH=<checkout B> python tools/ctc_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout B> python tools/ctc_lattice_ab.py --tag B --save DIR
    PYTHONPATH=<checkout A> python tools/ctc_lattice_ab.py --tag A --save DIR

Each run imports ``statecatcher_tpu_torch`` from the checkout on
``PYTHONPATH`` (so it builds that checkout's kernels) and the phases and
helpers of this tree's ``chip_smoke.py`` and ``profile_train.py`` (so both
checkouts run the same phases and report the same groups, over their own
package).  It times with CUDA events K3 and K4 at phase 4's training shape
(B=32, T=1598, U=128: S=257) and at bench.py's B=96, each beside its chain
floor (``chip_smoke.ctc_chain_floor``); then phase 5's CTC training group
(B=32, K=4, f32) on the kernel path alone, run twice from the same state
(the second run's ms per segment), phase 6's CTC row (bench.py's shape at
K=8: audio-s/s) and, with ``--profile``, ``profile_train`` at B=32 f32 and
at B=96 bf16 (device time by kernel and by group).  With ``--save DIR`` it
checks that two calls of K3 and of K4 give the same bits, writes their
outputs on fixed inputs (B=5, T=400, U=128, rows with in_len < T, 0 and
> T) to DIR/<tag>.pt and reports, for every other tag saved there, whether
they are bit for bit equal, and the largest difference where they are not.
With ``--variants`` (this tree's package only) it also builds copies of
``ctc_lattice.cu`` patched at exact strings into
``build/ctc_variants/`` and times each at B=32, held against the plain
versions at phase 4's tolerance.  Prints the card's name and power limit,
the phases' own log lines and one JSON line of kernel times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from band_lattice_ab import load_profile_train  # noqa: E402
from lucy_cell_ab import compare_saved  # noqa: E402
from mlstm_bwd_ab import kernel_group, load_chip_smoke  # noqa: E402

SOURCE = "ctc_lattice.cu"
STATES = "inline int states_per_lane(int S) { return (S + 1023) / 1024; }"
LSE = """  const float ep = expf((c_top || !(a >= m) ? a : b) - m);
  const float eq = expf((c_top ? b : c) - m);
  const float s = (c_top ? ep + eq : 1.0f + ep) + (c_top ? 1.0f : eq);
  const float out = (m + logf(s)) + e;
"""
# lse3 on the MUFU's approximations, exp(mid - m) and exp(low - m) of the
# two smaller terms: ex2.approx.ftz and lg2.approx.ftz, no fix-ups
FAST_LSE = """  const float lo = fminf(a, b), hi = fmaxf(a, b);
  const float mid = fmaxf(lo, fminf(hi, c)), low = fminf(lo, c);
  float e_mid, e_low, l2;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e_mid) : "f"((mid - m) * 1.44269504f));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e_low) : "f"((low - m) * 1.44269504f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l2) : "f"((1.0f + e_low) + e_mid));
  const float out = fmaf(l2, 0.693147182f, m) + e;
"""
# (exact text of ctc_lattice.cu, replacement; every occurrence): the design
# candidates, and what a part of the kernel costs
VARIANTS = {
    "5 warps (C = 2)": [(STATES, STATES.replace("return", "return S <= 2048 ? 2 :"))],
    "3 warps (C = 3)": [(STATES, STATES.replace("return", "return S <= 3072 ? 3 :"))],
    "one warp a row (C = 9)": [
        (STATES, STATES.replace("return", "return S <= 288 ? 9 :")),
        ("  CTC_LATTICE_CASE(4);\n", "  CTC_LATTICE_CASE(4);\n  CTC_LATTICE_CASE(9);\n"),
        ("__launch_bounds__(32 * kMaxWarps)", "__launch_bounds__(C >= 9 ? 32 : 32 * kMaxWarps)")],
    "chunks of 4 frames": [("return C <= 2 ? 8 : 4;", "return C <= 2 ? 4 : 4;")],
    "chunks of 16 frames": [("return C <= 2 ? 8 : 4;", "return C <= 2 ? 16 : 4;")],
    "three exps (exp(0) computed too)": [
        (LSE, "  const float s = (expf(a - m) + expf(b - m)) + expf(c - m);\n"
              "  const float out = (m + logf(s)) + e;\n")],
    "fast MUFU exps and log (not the plain version's bits)": [(LSE, FAST_LSE)],
    "4 emit stages (not 6)": [("return C == 1 ? 6 : 3;", "return C == 1 ? 4 : 3;")],
    "at most 10 warps (up to 96 registers, not 64)": [
        ("__launch_bounds__(32 * kMaxWarps)", "__launch_bounds__(C == 1 ? 320 : 32 * kMaxWarps)")],
    "the shipped source again": [],
    "hand-off waits blocking at the chunk's start": [
        ("const bool up_done = !has_up || mbar_test(&full[up * NS + slot], par);",
         "const bool up_done = !has_up || (mbar_wait(&full[up * NS + slot], par), true);"),
        ("c < NS || mbar_test(&empty[warp * NS + slot], par ^ 1u);",
         "c < NS || (mbar_wait(&empty[warp * NS + slot], par ^ 1u), true);")],
    # parts taken away (outputs wrong): where a frame's time goes
    "warps alone, no hand-off waits": [
        ("      if (!up_done) mbar_wait(&full[up * NS + slot], par);\n", ""),
        ("      if (!slot_free) mbar_wait(&empty[warp * NS + slot], par ^ 1u);\n", "")],
    "emit not waited for": [
        ("    lucy_tile::cp_async_wait<NE - 2>();             // this chunk's emit has landed\n",
         "")],
    "no stores in the walk": [
        ("      for (int i = 0; i < C; ++i) store_if(op + i, v[i], in[i]);\n",
         "      for (int i = 0; i < C; ++i) (void)op;\n")],
    "no emit copies": [
        ("      for (int i = 0; i < C; ++i) ev[f][i] = r[(f * C + i) * 32 + lane];",
         "      for (int i = 0; i < C; ++i) ev[f][i] = 0.0f * (r == nullptr);"),
        ("    copy_chunk(c + NE - 1);                         // into the stage chunk c - 1 read\n",
         ""),
        ("  for (int c = 0; c < NE - 1; ++c) copy_chunk(c);\n", "")],
}


def build_variant(name: str, patches: list) -> ctypes.CDLL:
    """``ctc_lattice.cu`` patched and built.  Exits naming a patch whose text
    is not found."""
    from statecatcher_tpu_torch.ops import _kernels

    slug = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _kernels.BUILD_DIR.parent / "ctc_variants" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in os.listdir(_kernels.CSRC):
        if src.endswith(".cuh") or src == SOURCE:
            text = (_kernels.CSRC / src).read_text()
            if src == SOURCE:
                for old, new in patches:
                    if old not in text:
                        raise SystemExit(f"{name}: patch text not found in {SOURCE}:\n{old}")
                    text = text.replace(old, new)
            (out_dir / src).write_text(text)
    target = out_dir / "ctc_lattice.so"
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(target),
                           str(out_dir / SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(target))
    for fn_name, (restype, argtypes) in _kernels.SIGNATURES["ctc_lattice"].items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def lattice_args(cs, gen, B, dev, T=1598, U=128, V=1024):
    """Phase 4's emit (B, T, 2U+1), allow_skip and lengths (row 1 shorter,
    row 2 without labels)."""
    from statecatcher_tpu_torch.ops.ctc_lattice import emit_log_probs, expand_labels, skip_allowed

    lp, labels, in_lens, label_lens = cs.lattice_inputs(gen, B, T, U, V, dev)
    ext = expand_labels(labels, 0)
    return emit_log_probs(lp, ext).contiguous(), skip_allowed(ext, 0), in_lens, label_lens


def time_lattice(cs, args, reps: int) -> dict:
    from statecatcher_tpu_torch.ops.ctc_lattice import ctc_alpha, ctc_beta

    emit, skip, in_lens, label_lens = args
    with torch.inference_mode():
        ms_a = cs.cuda_ms(lambda: ctc_alpha(emit, skip, in_lens), reps)
        ms_b = cs.cuda_ms(lambda: ctc_beta(emit, skip, in_lens, label_lens), reps)
        floor, per_frame, frames = cs.ctc_chain_floor(emit, skip, in_lens)
    return {"alpha": ms_a, "beta": ms_b, "chain floor": floor, "ns per frame": per_frame * 1e6,
            "frames": frames}


def run_variants(cs, args, reps: int) -> dict:
    """Each variant's K3/K4 time at B=32, and whether it holds the plain
    versions at phase 4's tolerance."""
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.ctc_lattice import ctc_alpha, ctc_alpha_ref, ctc_beta, ctc_beta_ref

    emit, skip, in_lens, label_lens = args
    with torch.inference_mode():
        refs = (ctc_alpha_ref(emit, skip, in_lens), ctc_beta_ref(emit, skip, in_lens, label_lens))
    shipped, out = _kernels.library, {}
    for name, patches in VARIANTS.items():
        try:
            lib = build_variant(name, patches)
            _kernels.library = lambda n, lib=lib: lib if n == "ctc_lattice" else shipped(n)
            res = time_lattice(cs, args, reps)
            with torch.inference_mode():
                got = (ctc_alpha(emit, skip, in_lens), ctc_beta(emit, skip, in_lens, label_lens))
            try:
                errs = [cs.check_lattice(g, r, 2e-5) for g, r in zip(got, refs)]
                res["check"] = f"holds (max |Δ| {max(errs):.3e})"
            except AssertionError as err:
                res["check"] = f"fails: {err}"
            res["values unlike the plain version's"] = sum(int((g != r).sum())
                                                           for g, r in zip(got, refs))
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
    ap.add_argument("--profile", action="store_true", help="profile_train's CTC segments")
    ap.add_argument("--save", default=None, help="directory for the bit-for-bit comparison")
    ap.add_argument("--variants", action="store_true", help="patched builds of the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ctc_lattice_ab needs a CUDA card")
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.ctc_lattice import ctc_alpha, ctc_beta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{args.tag}] {smi}; {_kernels.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    if args.save:
        emit, skip, in_lens, label_lens = lattice_args(cs, gen, 5, dev, T=400)
        in_lens[3], in_lens[4] = 0, 407
        with torch.inference_mode():
            outs = {"K3 ctc_alpha": ctc_alpha(emit, skip, in_lens),
                    "K4 ctc_beta": ctc_beta(emit, skip, in_lens, label_lens)}
            again = (ctc_alpha(emit, skip, in_lens), ctc_beta(emit, skip, in_lens, label_lens))
        for (name, first), second in zip(outs.items(), again):
            same = "the same bits" if torch.equal(first, second) else "DIFFERENT bits"
            print(f"[{args.tag}] {name}: two calls give {same}", flush=True)
        compare_saved(args.tag, outs, args.save)
    out, at32 = {}, None
    for label, B in (("B=32", 32), ("B=96", 96)):
        lat = lattice_args(cs, gen, B, dev)
        out[label] = time_lattice(cs, lat, args.reps)
        print(f"[{args.tag}] K3/K4 {label}, T=1598, U=128: {out[label]}", flush=True)
        if B == 32:
            at32 = lat
        del lat
    print(f"[{args.tag}] kernels " + json.dumps(out), flush=True)
    if args.variants:
        print(f"[{args.tag}] variants " + json.dumps(run_variants(cs, at32, args.reps)),
              flush=True)
    del at32
    if args.kernels_only:
        return 0

    cfg = Config().apply_overrides(cs.FLAGSHIP)
    ms, peak = kernel_group(cs, cfg, dev, K=4)
    print(f"[{args.tag}] ctc train group (B=32, K=4, f32), kernel path, second run: {ms:.1f} ms "
          f"per segment, peak memory {peak:.3f} GiB", flush=True)
    cs.phase_throughput(cfg, dev, K=8)
    if args.profile:
        pt = load_profile_train()
        for extra in ([], ["--batch", "96", "--dtype", "bfloat16"]):
            sys.argv = ["profile_train", *extra]
            print(f"[{args.tag}] profile_train {' '.join(sys.argv[1:])}", flush=True)
            pt.main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
