"""Tile sizes and parts of the fused LucyRNN cell kernels (K1, K2), timed on
one card.

    PYTHONPATH=. python tools/lucy_cell_variants.py [variant ...]
    PYTHONPATH=<parent checkout> python tools/lucy_cell_variants.py "parent: ..."

Builds ``lucy_fused_lm_fwd.cu`` and ``lucy_fused_lm_bwd.cu`` once per variant
from copies patched at exact source strings (other tile constants; the "no
..." variants take one part of a kernel's work away: where the time goes)
into ``build/lucy_variants/``, and times K1 and K2 through the port's
wrappers (CUDA events) at B=32, T=1598, D=512 in f32 and bf16 and at
bench.py's B=96 bf16, and K1 at the streaming shape (B=1, T=32, f32: the
device time replayed from a CUDA graph, and the host time of a call and a
device sync).  Each variant's outputs are held bit for bit against the
shipped build's (the per-element arithmetic does not depend on the tiling;
d_bias's order of sums does).  An edit of the kernels' bodies updates the
patches: the tool exits naming one it no longer finds.  The sources are
those of the package on ``PYTHONPATH``: the "parent: ..." variants (not run
by default) patch the one-thread-per-column K1 that the tiled design
replaced.  Prints the card's name and power limit, one line per variant and
shape, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

FWD, BWD = "lucy_fused_lm_fwd.cu", "lucy_fused_lm_bwd.cu"
# Patches that take one part of a kernel's work away (the rest unchanged):
# where the time goes.  Each is (source, exact text, replacement).
K1_NO_WALK = (FWD, """            s = decay_n[u] * s + alpha_kv[u];
            const float c = tanhf(h_pre_n[u] + s);
            h = z_n[u] * h + (1.0f - z_n[u]) * c;""",
              "            s = decay_n[u] + alpha_kv[u];\n            h = z_n[u] + h_pre_n[u];")
K1_NO_CHAIN = (FWD, """          const float rms_rz = sqrtf((r * r + z * z) / 2.0f + kEps);
          const float rms_kv2 = (kk * kk + v * v) / 2.0f + kEps;
          const float rms_kv = sqrtf(rms_kv2);
          const float z_n = sigmoid_f32(z / rms_rz);
          const float decay_n = sigmoid_f32(decay / sqrtf(decay * decay + kEps));
          const float alpha_n = sigmoid_f32(alpha / sqrtf(alpha * alpha + kEps));
          const float h_pre_n = h_pre / sqrtf(h_pre * h_pre + kEps);
          const float kv = (kk / rms_kv) * (v / rms_kv) / (rms_kv2 + kEps);""",
               "          const float z_n = z + r, decay_n = decay, alpha_n = alpha, "
               "h_pre_n = h_pre, kv = kk * v;")
K1_NO_LOADS = (FWD, """    if (j < nT) {
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
        const(FWD, "kChainWarps", "12", "8"), const(FWD, "S", "3", "4"),
        const(FWD, "TC", "12", "sizeof(G) == 4 ? 8 : 16")],
    "k1 16 chain warps, tc 8 f32 / 16 bf16": [
        const(FWD, "kChainWarps", "12", "16"), const(FWD, "TC", "12", "sizeof(G) == 4 ? 8 : 16")],
    "k2 no walk": [K2_NO_WALK],
    "k2 no pass 2 math": K2_NO_PASS2_MATH,
    "k2 no loads": [K2_NO_LOADS],
    "k2 tc 8 in f32": [const(BWD, "TC", "sizeof(G) == 4 ? 4 : 8", "8")],
    "k2 4 stages": [const(BWD, "S", "5", "4")],
    "parent: bf16 gates converted at use": PARENT_CONVERT_AT_USE,
}
SHAPES = (("f32", 32, torch.float32), ("bf16", 32, torch.bfloat16),
          ("bench bf16", 96, torch.bfloat16))


def build(name: str, patches: list) -> dict[str, ctypes.CDLL]:
    """The variant's two libraries, built from patched copies of the sources.
    Exits naming a patch whose text is not found."""
    from statecatcher_tpu_torch.ops import _kernels

    slug = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _kernels.BUILD_DIR.parent / "lucy_variants" / slug
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in (FWD, BWD, "lucy_tile.cuh"):
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
    for lib in ("lucy_fused_lm_fwd", "lucy_fused_lm_bwd"):
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
    want, results = {}, {}
    for name in ["shipped"] + [n for n in names if n != "shipped"]:
        try:
            libs = build(name, VARIANTS[name])
            _kernels.library = lambda lib, libs=libs: libs.get(lib) or shipped(lib)
            for label, _B, _dtype in SHAPES:
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
            with torch.inference_mode():
                fwd = lambda: lucy_cell_fused_lm(*streaming)
                k1, host = cs.cuda_ms(fwd, 200, graph=True), host_ms(fwd)
            results[f"{name} | streaming f32"] = {"K1": k1, "K1 host": host}
            print(f"[variant] {name} | streaming f32: K1 {k1:.4f} ms on the card, {host:.4f} ms "
                  f"a call on the host's clock", flush=True)
        except RuntimeError as err:                  # a variant the card refuses
            print(f"[variant] {name}: {err}", flush=True)
        finally:
            _kernels.library = shipped
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
