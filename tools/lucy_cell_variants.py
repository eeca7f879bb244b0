"""Tile sizes and parts of the LucyRNN cell kernels (K1, K2, the masked cell
K12, the linear scan K5a/K5b and the dual scan K11), timed on one card.

    PYTHONPATH=. python tools/lucy_cell_variants.py [variant ...]
    PYTHONPATH=<parent checkout> python tools/lucy_cell_variants.py "parent: ..."

Builds ``lucy_fused_lm_fwd.cu``, ``lucy_fused_lm_bwd.cu``,
``lucy_cell_scan.cu`` and ``linear_scan.cu`` once per variant from copies
patched at exact source strings (other tile constants; the "no ..."
variants take one part of a kernel's work away: where the time goes) into
``build/lucy_variants/``, prints each build's registers and spills, and
times through the port's wrappers (CUDA events), at B=32, T=1598, D=512 in
f32 and bf16: K1 and K2 (also at bench.py's B=96 bf16) for the "k1"/"k2"
variants, K5a and K5b for the "k5a"/"k5b" ones (the two share the ring's
geometry, ``ScanTile``), K11 for the "k11" ones, K12 unmasked and masked
for the "k12" ones, and all of them for "shipped"; and at the streaming
shape (B=1, T=32, f32: the device time replayed from a CUDA graph, and for
K1 the host time of a call and a device sync) K1, K5a and K12.  Each variant's outputs are held bit for bit against the shipped
build's (the per-element arithmetic does not depend on the tiling; d_bias's
order of sums does).  An edit of the kernels' bodies updates the patches:
the tool exits naming one it no longer finds.  The sources are those of
the package on ``PYTHONPATH``: the "parent: ..." variants (not run by
default) patch the one-thread-per-column K1 that the tiled design replaced.
Prints the card's name and power limit, one line per variant and shape,
and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

FWD, BWD, TILE = "lucy_fused_lm_fwd.cu", "lucy_fused_lm_bwd.cu", "lucy_tile.cuh"
CELL, SCAN = "lucy_cell_scan.cu", "linear_scan.cu"
LIBS = ("lucy_fused_lm_fwd", "lucy_fused_lm_bwd", "lucy_cell_scan", "linear_scan")
# Patches that take one part of a kernel's work away (the rest unchanged):
# where the time goes.  Each is (source, exact text, replacement).
K1_NO_WALK = (FWD, """    s = decay_n * s + alpha_kv;
    const float c = tanhf(h_pre_n + s);
    h = z_n * h + (1.0f - z_n) * c;""",
              "    s = decay_n + alpha_kv;\n    h = z_n + h_pre_n;")
K1_NO_CHAIN = (FWD, """    const float rms_rz = sqrtf((r * r + z * z) / 2.0f + kEps);
    const float rms_kv2 = (kk * kk + v * v) / 2.0f + kEps;
    const float rms_kv = sqrtf(rms_kv2);
    const float z_n = sigmoid_f32(z / rms_rz);
    const float decay_n = sigmoid_f32(decay / sqrtf(decay * decay + kEps));
    const float alpha_n = sigmoid_f32(alpha / sqrtf(alpha * alpha + kEps));
    const float h_pre_n = h_pre / sqrtf(h_pre * h_pre + kEps);
    const float kv = (kk / rms_kv) * (v / rms_kv) / (rms_kv2 + kEps);""",
               "    const float z_n = z + r, decay_n = decay, alpha_n = alpha, "
               "h_pre_n = h_pre, kv = kk * v;")
# K1's tiles and loads are the cell forward's of lucy_tile.cuh (K12 shares
# them; only K1 is timed here)
K1_NO_LOADS = (TILE, """    if (j < nT) {
      const int t0 = j * TC;
      copy_rows""", """    if (false) {
      const int t0 = j * TC;
      copy_rows""")
K2_NO_WALK = (BWD, """            lam_h = gh[t] + a_h_next * lam_h;
            d_pre = lam_h * w[t];
            lam_s = (gs[t] + d_pre) + a_s_next * lam_s;""",
              "            lam_h = gh[t] + w[t];\n            d_pre = lam_h;\n"
              "            lam_s = gs[t] + d_pre;")
K2_NO_PASS2_MATH = [
    (BWD, """          const float i_rz = rsqrtf((r * r + z * z) * 0.5f + kEps);
          const float q_kv = (kk * kk + v * v) * 0.5f + kEps;
          const float i_kv = rsqrtf(q_kv);
          const float inv_qe = 1.0f / (q_kv + kEps);
          const float i_d = rsqrtf(decay * decay + kEps);
          const float i_a = rsqrtf(alpha * alpha + kEps);
          const float i_p = rsqrtf(h_pre * h_pre + kEps);
          const float z_n = cf[(1""",
     """          const float i_rz = r, q_kv = kk, i_kv = v, inv_qe = z, i_d = decay,
                      i_a = alpha, i_p = h_pre;
          const float z_n = cf[(1"""),
    (BWD, """          const float a_n = sigmoid_f32(alpha * i_a);
          const float F = (i_kv * i_kv) * inv_qe;
          const float kv = (kk * v) * F;

          const float lh""", """          const float a_n = i_a, F = i_kv + inv_qe, kv = kk * v;

          const float lh"""),
    (BWD, """          out[5] = ca * (d_n * (1.0f - d_n)) * (kEps * i_d * i_d * i_d);
          const float c_kv = cb * a_n;
          out[6] = (cb * kv) * (a_n * (1.0f - a_n)) * (kEps * i_a * i_a * i_a);
          const float gz = (cah - cbh) * (z_n * (1.0f - z_n));
          const float i_rz3 = (i_rz * i_rz) * i_rz;
          out[1] = gz * (i_rz - (0.5f * (z * z)) * i_rz3);
          out[0] = gz * ((-0.5f) * (z * r) * i_rz3);
          out[4] = cp * (kEps * i_p * i_p * i_p);
          const float tF = (2.0f * q_kv + kEps) * F;
          out[2] = (c_kv * v) * F * (1.0f - (kk * kk) * tF);
          out[3] = (c_kv * kk) * F * (1.0f - (v * v) * tF);""",
     """          out[0] = ca + i_rz; out[1] = cb + q_kv; out[2] = cah + z_n; out[3] = cbh + d_n;
          out[4] = cp + i_p; out[5] = i_d + a_n; out[6] = F + kv;"""),
]
K2_NO_LOADS = (BWD, """    if (j < nT) {
      const int t0 = tile_t0(j);
      copy_rows""", """    if (false) {
      const int t0 = tile_t0(j);
      copy_rows""")



def const(src: str, name: str, old: str, new: str) -> tuple[str, str, str]:
    """A patch of one tile constant of a kernel's parameter struct."""
    return (src, f"  static constexpr int {name} = {old};",
            f"  static constexpr int {name} = {new};")


# The ring scans' walks taken away (each step copies an input): K5a, K5b
# and K11
K5A_NO_WALK = (SCAN, "    c[0] = __fadd_rn(__fmul_rn(x(0), c[0]), x(1));",
               "    c[0] = x(0);")
K5B_NO_WALK = (SCAN, "    c[0] = __fadd_rn(x(1), __fmul_rn(c[1], c[0]));",
               "    c[0] = x(1);")
K11_NO_WALK = (CELL, "    MaskedCellChain<false>::step(x(0), x(1), x(2), x(3), c[0], c[1]);",
               "    c[0] = x(1);\n    c[1] = x(3);")
# a ring of 32 columns a block in bf16 too (one walking warp, twice the blocks)
K5_DT32 = const(SCAN, "DT", "128 / static_cast<int>(sizeof(Tx))", "32")
K11_DT32 = const(CELL, "DT", "128 / static_cast<int>(sizeof(P))", "32")


# The ring scan's loads of more than two planes (lucy_tile.cuh) in one pass
# over all planes' rows, a row's plane by a chain of compares, in place of a
# pass a plane (timed for K11, four planes in); and K5a's and K5b's two
# planes loaded a pass a plane
RING_ONE_PASS = (TILE, """#pragma unroll
        for (int i = 0; i < NI; ++i)
          copy_rows<Tx, DT, VB>(
              stages + (j % S) * P::kStageElems + i * TC * DT, TC,
              [&](int r) -> const Tx* {
                return t0 + r < T ? in[i] + static_cast<size_t>(t0 + r) * D : nullptr;
              },
              d0, D, x0, ct, P::kCopy);""", """        static_assert(NI == 4, "four planes");
        copy_rows<Tx, DT, VB>(
            stages + (j % S) * P::kStageElems, NI * TC,
            [&](int r) -> const Tx* {
              const int t = t0 + (r < TC ? r : r < 2 * TC ? r - TC : r < 3 * TC ? r - 2 * TC
                                                                             : r - 3 * TC);
              return t < T ? (r < TC ? in[0] : r < 2 * TC ? in[1] : r < 3 * TC ? in[2] : in[3]) +
                                 static_cast<size_t>(t) * D
                           : nullptr;
            },
            d0, D, x0, ct, P::kCopy);""")
RING_PLANE_PASSES = (TILE, "      if constexpr (NI == 2) {", "      if constexpr (false) {")


# The one-thread-per-column K1 that this design replaced (run with that
# tree's package on PYTHONPATH): its prefetched bf16 gates converted to f32
# where they are used, a step later, instead of where they are loaded.
PARENT_CONVERT_AT_USE = [
    (FWD, """    float nxt[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t + 1 < T) {
      const G* gn = g + static_cast<size_t>(t + 1) * row;
#pragma unroll
      for (int i = 0; i < 7; ++i) nxt[i] = to_f32(gn[static_cast<size_t>(i) * D]);
    }""", """    G nxt[7] = {};
    if (t + 1 < T) {
      const G* gn = g + static_cast<size_t>(t + 1) * row;
#pragma unroll
      for (int i = 0; i < 7; ++i) nxt[i] = gn[static_cast<size_t>(i) * D];
    }"""),
    (FWD, "    for (int i = 0; i < 7; ++i) cur[i] = nxt[i];",
     "    for (int i = 0; i < 7; ++i) cur[i] = to_f32(nxt[i]);"),
]

# name -> patches; "shipped" builds the sources as they are
VARIANTS = {
    "shipped": [],
    "k1 no walk": [K1_NO_WALK],
    "k1 no chain": [K1_NO_CHAIN],
    "k1 8 chain warps, tc 8 f32 / 16 bf16, 4 stages": [
        const(TILE, "kChainWarps", "12", "8"), const(TILE, "S", "3", "4"),
        const(TILE, "TC", "12", "sizeof(G) == 4 ? 8 : 16")],
    "k1 16 chain warps, tc 8 f32 / 16 bf16": [
        const(TILE, "kChainWarps", "12", "16"), const(TILE, "TC", "12", "sizeof(G) == 4 ? 8 : 16")],
    "k2 no walk": [K2_NO_WALK],
    "k2 no pass 2 math": K2_NO_PASS2_MATH,
    "k2 no loads": [K2_NO_LOADS],
    "k2 tc 8 in f32": [const(BWD, "TC", "sizeof(G) == 4 ? 4 : 8", "8")],
    "k2 4 stages": [const(BWD, "S", "5", "4")],
    "k5a no walk": [K5A_NO_WALK],
    "k5b no walk": [K5B_NO_WALK],
    "k5a tc 16": [const(SCAN, "TC", "32", "16")],
    "k5a tc 64": [const(SCAN, "TC", "32", "64")],
    "k5a 3 stages": [const(SCAN, "S", "4", "3")],
    "k5a 6 stages": [const(SCAN, "S", "4", "6")],
    "k5a 2 copy warps": [const(SCAN, "kCopy", "128", "64")],
    "k5a 8 copy warps": [const(SCAN, "kCopy", "128", "256")],
    "k5a 64 columns f32 / 128 bf16": [
        const(SCAN, "DT", "128 / static_cast<int>(sizeof(Tx))", "256 / static_cast<int>(sizeof(Tx))")],
    "k5a 32 columns bf16": [K5_DT32],
    "k11 no walk": [K11_NO_WALK],
    "k11 tc 16": [const(CELL, "TC", "32", "16")],
    "k11 tc 24": [const(CELL, "TC", "32", "24")],
    "k11 3 stages": [const(CELL, "S", "4", "3")],
    "k11 tc 16, 3 stages": [const(CELL, "TC", "32", "16"), const(CELL, "S", "4", "3")],
    "k11 2 copy warps": [const(CELL, "kCopy", "128", "64")],
    "k11 8 copy warps": [const(CELL, "kCopy", "128", "256")],
    "k11 32 columns bf16": [K11_DT32],
    "k11 32 columns bf16, no walk": [K11_DT32, K11_NO_WALK],
    "k11 one pass": [RING_ONE_PASS],
    "k5a a pass a plane": [RING_PLANE_PASSES],
    "parent: bf16 gates converted at use": PARENT_CONVERT_AT_USE,
}
SHAPES = (("f32", 32, torch.float32), ("bf16", 32, torch.bfloat16),
          ("bench bf16", 96, torch.bfloat16))


def family(name: str) -> set[str]:
    """The kernels a variant times: all for "shipped", else its prefix's."""
    if name == "shipped":
        return {"K1", "K2", "K5a", "K5b", "K12", "K11"}
    head = name.split()[0]
    if head == "parent:":
        return {"K1", "K2"}
    return {"k1": {"K1", "K2"}, "k2": {"K1", "K2"}, "k5a": {"K5a", "K5b"},
            "k5b": {"K5a", "K5b"}, "k12": {"K12"}, "k11": {"K11"}}[head]


def build(name: str, patches: list) -> dict[str, ctypes.CDLL]:
    """The libraries of the kernels the variant times, built from patched
    copies of the sources.  Exits naming a patch whose text is not found."""
    from statecatcher_tpu_torch.ops import _kernels

    slug = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _kernels.BUILD_DIR.parent / "lucy_variants" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in (FWD, BWD, TILE, CELL, SCAN):
        if not (_kernels.CSRC / src).exists():           # a tree without the header
            continue
        text = (_kernels.CSRC / src).read_text()
        for file, old, new in patches:
            if file == src:
                if old not in text:
                    raise SystemExit(f"{name}: patch text not found in {src}:\n{old}")
                text = text.replace(old, new, 1)
        (out_dir / src).write_text(text)
    libs, procs = {}, {}
    wanted = {"K1": LIBS[:2], "K2": LIBS[:2], "K12": LIBS[2:3], "K11": LIBS[2:3],
              "K5a": LIBS[3:], "K5b": LIBS[3:]}
    for lib in sorted({lib for k in family(name) for lib in wanted[k]}):
        target = out_dir / f"{lib}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(target),
               str(out_dir / f"{lib}.cu")]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), target)
    logs = {lib: proc.communicate()[0] for lib, (proc, _) in procs.items()}
    for lib, (proc, target) in procs.items():
        log = logs[lib]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed for {lib}.cu:\n{log}")
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name} {lib}: " + " | ".join(usage), flush=True)
        cdll = ctypes.CDLL(str(target))
        for fn_name, (restype, argtypes) in _kernels.SIGNATURES[lib].items():
            fn = getattr(cdll, fn_name)
            fn.restype, fn.argtypes = restype, argtypes
        libs[lib] = cdll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("lucy_cell_variants needs a CUDA card")
    names = sys.argv[1:] or [n for n in VARIANTS if not n.startswith("parent:")]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lucy_cell_ab import host_ms
    from mlstm_bwd_ab import load_chip_smoke

    cs = load_chip_smoke()
    from statecatcher_tpu_torch.ops import _kernels
    from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm, lucy_cell_fused_lm_bwd
    from statecatcher_tpu_torch.ops.lucy_pallas import (
        linear_scan_fwd,
        linear_scan_rev,
        lucy_dual_scan,
        lucy_fused_cell,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shipped = _kernels.library
    dev = torch.device("cuda", 0)
    inputs = {}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 12)
    for label, B, dtype in SHAPES:
        gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, B, 1598, 512, dtype, dev)
        g_h = torch.randn((B, 1598, 512), generator=gen, device=dev).to(dtype)
        inputs[label] = (gates, bias, h0, s0, g_h)
    streaming = cs.conditioned_cell_inputs(gen, 1, 32, 512, torch.float32, dev)
    # K5a, K5b, K11 and K12: the masked gate chain's planes and the gates with
    # the bias added, at B=32 in f32 and bf16 and at the streaming shape
    cell = {}
    for label, B, T, dtype in (("f32", 32, 1598, torch.float32),
                               ("bf16", 32, 1598, torch.bfloat16),
                               ("streaming f32", 1, 32, torch.float32)):
        gates, bias, h0, s0 = cs.conditioned_cell_inputs(gen, B, T, 512, torch.float32, dev)
        mask = cs.masked_rows(B, T, dev)
        planes = [x.to(dtype) for i, x in enumerate(cs.lucy_gate_coeffs(gates, mask, bias))
                  if i != 3]
        cell[label] = ((gates + bias).reshape(B, T, 7, 512).to(dtype), h0, s0, mask, planes)
        del gates
    want, results = {}, {}
    for name in ["shipped"] + [n for n in names if n != "shipped"]:
        kernels = family(name)
        try:
            libs = build(name, VARIANTS[name])
            _kernels.library = lambda lib, libs=libs: libs.get(lib) or shipped(lib)
            for label, _B, _dtype in SHAPES if "K1" in kernels else ():
                gates, bias, h0, s0, g_h = inputs[label]
                with torch.inference_mode():
                    fwd = lambda: lucy_cell_fused_lm(gates, bias, h0, s0)
                    h_all, s_all = fwd()
                    bwd = lambda: lucy_cell_fused_lm_bwd(gates, bias, h0, s0, h_all, s_all,
                                                          g_h, None)
                    outs = (h_all, s_all, *bwd())
                    if name == "shipped":
                        want[label] = [x.clone() for x in outs]
                    # d_bias's sums run in an order set by the tile geometry
                    same = [torch.equal(a, b) for a, b in zip(outs, want[label])]
                    k1, k2 = cs.cuda_ms(fwd, 20), cs.cuda_ms(bwd, 20)
                verdict = ("bit for bit the shipped build" if all(same) else
                           "bit for bit but d_bias" if all(same[:-1]) else "DIFFER")
                results[f"{name} | {label}"] = {"K1": k1, "K2": k2, "outputs": verdict}
                print(f"[variant] {name} | {label}: K1 {k1:.4f} ms, K2 {k2:.4f} ms, outputs "
                      f"{verdict}", flush=True)
            if "K1" in kernels:
                with torch.inference_mode():
                    fwd = lambda: lucy_cell_fused_lm(*streaming)
                    k1, host = cs.cuda_ms(fwd, 200, graph=True), host_ms(fwd)
                results[f"{name} | streaming f32"] = {"K1": k1, "K1 host": host}
                print(f"[variant] {name} | streaming f32: K1 {k1:.4f} ms on the card, {host:.4f} "
                      f"ms a call on the host's clock", flush=True)
            for label, (g4, h0, s0, mask, (a_s, b_s, a_h, h_pre)) in cell.items():
                small = label.startswith("streaming")
                runs = []
                if "K5a" in kernels:
                    runs.append(("K5a", lambda: (linear_scan_fwd(a_s, b_s, s0),)))
                if "K5b" in kernels and not small:
                    runs.append(("K5b", lambda: (linear_scan_rev(a_s, b_s),)))
                if "K11" in kernels and not small:
                    runs.append(("K11", lambda: lucy_dual_scan(a_s, b_s, a_h, h_pre, h0, s0)))
                if "K12" in kernels:
                    runs += [("K12", lambda: lucy_fused_cell(g4, h0, s0, None)),
                             ("K12 masked", lambda: lucy_fused_cell(g4, h0, s0, mask))]
                for kname, fn in runs:
                    with torch.inference_mode():
                        outs = fn()
                        if name == "shipped":
                            want[f"{kname} {label}"] = [x.clone() for x in outs]
                        same = all(torch.equal(a, b)
                                   for a, b in zip(outs, want[f"{kname} {label}"]))
                        ms = cs.cuda_ms(fn, 200 if small else 20, graph=small)
                    verdict = "bit for bit the shipped build" if same else "DIFFER"
                    results[f"{name} | {kname} {label}"] = {kname: ms, "outputs": verdict}
                    print(f"[variant] {name} | {label}: {kname} {ms:.4f} ms, outputs {verdict}",
                          flush=True)
        except RuntimeError as err:                  # a variant the card refuses
            print(f"[variant] {name}: {err}", flush=True)
        finally:
            _kernels.library = shipped
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
