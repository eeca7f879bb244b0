#!/usr/bin/env python3
"""Smoke run of the PyTorch port (statecatcher_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

It builds every CUDA kernel of the serving path from ``statecatcher_tpu_torch/
ops/csrc`` and drives the flagship LucyRNN-CTC model (4 × 512, vocab 1024,
80 MFCC, float32, seeded random weights) through the port's entry points:

  0. the card's facts, the kernel build (time, ``ptxas -v`` registers/spills);
  1. kernel: ``lucy_cell_fused_lm`` against its plain version on the card at
     the batched shape (f32 and bf16) and the streaming shape, with times
     (CUDA events) beside the byte bound;
  2. batched: ``SpeechModel`` over 3 carried 16 s segments at B=32 (the last
     one with a partial sample mask through ``compute_frame_mask``), the
     kernel path held against the plain path on the card;
  3. streaming: ``StreamingRecognizer`` on three ~10 s streams fed in random
     pieces, held against an offline one-shot decode of the same frames;
  4. the ``kernels`` JSON line, with each kernel's launch count on the main
     path (phases 2 and 3; each counter is set to 0 just before a phase and
     read just after it, so comparison launches are not counted).

Every check raises; nothing is caught.  Without a card (or outside the
repository) it exits non-zero before printing any result.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
from statecatcher_tpu_torch.frontend import compute_features, compute_frame_mask, num_frames
from statecatcher_tpu_torch.models import lucyrnn
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.ops import _kernels
from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm, lucy_cell_fused_lm_ref
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import levenshtein, randomize_, synth_audio

SEED = 0
FLAGSHIP = ["--model.encoder", "lucyrnn"]        # config defaults: 4 × 512, vocab 1024, mfcc 80, f32
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
F32_OPS_PER_S = 67e12                            # H100 SXM, float32 outside the tensor cores
# Operations per (b, t, d) element of the fused cell, counted from the kernel
# source: 7 bias adds, rms_rz 6, rms_kv² 5, its sqrt 1, z 5, decay 8,
# alpha 8, h_pre 4, kv 5, s-step 3, tanh 2, h-step 4 (sqrt, divide, exp,
# tanh one each).
CELL_OPS_PER_ELEMENT = 58


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.  With
    ``graph`` the calls are captured in one CUDA graph and replayed, so a
    kernel shorter than its Python wrapper's host time is timed without the
    host's gaps between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()                                             # warm the graph
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for _ in range(reps):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cell_bound_ms(B: int, T: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the fused cell: each input read once, each output
    written once, against its operations at the f32 peak."""
    es = torch.finfo(dtype).bits // 8
    nbytes = B * T * 7 * D * es + 7 * D * 4 + 2 * B * D * 4 + 2 * B * T * D * es
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = CELL_OPS_PER_ELEMENT * B * T * D / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cell_inputs(gen: torch.Generator, B: int, T: int, D: int, dtype, dev):
    gates = torch.randn((B, T, 7 * D), generator=gen, device=dev).to(dtype)
    bias = 0.3 * torch.randn(7 * D, generator=gen, device=dev)
    h0 = 0.1 * torch.randn((B, D), generator=gen, device=dev)
    s0 = 0.1 * torch.randn((B, D), generator=gen, device=dev)
    return gates, bias, h0, s0


def check_cell(h, s, h_ref, s_ref, h_atol, h_rtol, s_abs, s_rel) -> float:
    """Raise unless |Δh| ≤ h_atol + h_rtol·|h_ref| and |Δs| ≤ s_abs·max|s_ref|
    + s_rel·|s_ref| everywhere (s is unbounded: kv = k·v/(q(q+ε)) reaches
    ~1e5 where k and v are both near 0, so it is held to its own scale).
    Returns the largest absolute error over both outputs."""
    h, s, h_ref, s_ref = (x.float() for x in (h, s, h_ref, s_ref))
    dh, ds = (h - h_ref).abs(), (s - s_ref).abs()
    bad_h = int((dh > h_atol + h_rtol * h_ref.abs()).sum())
    bad_s = int((ds > s_abs * s_ref.abs().max() + s_rel * s_ref.abs()).sum())
    if bad_h or bad_s or not (torch.isfinite(h).all() and torch.isfinite(s).all()):
        raise AssertionError(
            f"kernel disagrees with its plain version: {bad_h} h and {bad_s} s elements "
            f"off (max |Δh| {dh.max().item():.3e}, max |Δs| {ds.max().item():.3e} at "
            f"scale {s_ref.abs().max().item():.3e})")
    return max(dh.max().item(), ds.max().item())


def phase_kernel(dev) -> dict:
    """Phase 1: the kernel against its plain version, and its times."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    cases = [("batched f32", 32, 1598, 512, torch.float32),
             ("batched bf16", 32, 1598, 512, torch.bfloat16),
             ("streaming f32", 1, 32, 512, torch.float32)]
    for label, B, T, D, dtype in cases:
        gates, bias, h0, s0 = cell_inputs(gen, B, T, D, dtype, dev)
        with torch.inference_mode():
            h, s = lucy_cell_fused_lm(gates, bias, h0, s0)
            torch.cuda.synchronize()
            h_ref, s_ref = lucy_cell_fused_lm_ref(gates, bias, h0, s0)
            if dtype == torch.float32:
                # f32 round-off of the two versions' gate chains, as on the CPU
                err = check_cell(h, s, h_ref, s_ref, 2e-5, 0.0, 1e-6, 1e-4)
            else:
                # both compute in f32 from the same bf16 gates and round to
                # bf16: at most a bf16 step of values that differ by round-off
                err = check_cell(h, s, h_ref, s_ref, 2e-2, 2e-2, 1e-3, 1e-2)
            small = B * T <= 1000
            ms = cuda_ms(lambda: lucy_cell_fused_lm(gates, bias, h0, s0),
                         200 if small else 50, graph=small)
            plain_ms = cuda_ms(lambda: lucy_cell_fused_lm_ref(gates, bias, h0, s0),
                               20 if small else 2, warmup=1, graph=small)
        bound, bound_by = cell_bound_ms(B, T, D, dtype)
        log(f"[kernel] {label} (B={B}, T={T}, D={D}): max|Δ| {err:.3e}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound:.4f} ms ({bound_by}, "
            f"{bound / ms:.1%} of it)  library_ms: none")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}
    return out


@contextlib.contextmanager
def plain_cell():
    """Send the model's cell to its plain version on the card, so the kernel
    path can be held against the plain path on the same inputs."""
    kernel = lucyrnn.lucy_cell_fused_lm
    lucyrnn.lucy_cell_fused_lm = lucy_cell_fused_lm_ref
    try:
        yield
    finally:
        lucyrnn.lucy_cell_fused_lm = kernel


def run_segments(model, cfg, audio, masks):
    """Features → model → log-softmax over carried segments; returns per
    segment (log-probs, carry, seconds, frame mask or None)."""
    out, carry = [], None
    for x, m in zip(audio, masks):
        t0 = time.perf_counter()
        feats = compute_features(x, cfg.frontend)
        fmask = None
        if m is not None:
            fmask, _ = compute_frame_mask(m, feats.shape[1], cfg.model.stack_order)
        logits, carry = model(feats, carry, fmask)
        lp = torch.log_softmax(logits.float(), dim=-1)
        torch.cuda.synchronize()
        out.append((lp, carry, time.perf_counter() - t0, fmask))
    return out


def phase_batched(model, cfg, dev) -> int:
    """Phase 2: 3 carried 16 s segments at B=32, kernel path vs plain path."""
    B, S = 32, 16 * 16000
    rng = np.random.default_rng(SEED + 2)
    audio = [torch.from_numpy(synth_audio(rng, B, S)).to(dev) for _ in range(3)]
    lens = rng.integers(S // 4, S, B)
    lens[0] = S
    last_mask = torch.arange(S, device=dev)[None, :] < torch.from_numpy(lens).to(dev)[:, None]
    masks = [None, None, last_mask]
    T = num_frames(S, cfg.frontend)
    with torch.inference_mode():
        run_segments(model, cfg, audio, masks)                    # warm-up, masked path too
        lucy_cell_fused_lm.launches = 0
        kern = run_segments(model, cfg, audio, masks)
        launches = lucy_cell_fused_lm.launches
        with plain_cell():
            plain = run_segments(model, cfg, audio, masks)
    if launches == 0:
        raise AssertionError("the batched path launched no fused-cell kernel")
    agree = total = 0
    for k, ((lp, carry, sec, fmask), (lp_p, carry_p, sec_p, _)) in enumerate(zip(kern, plain)):
        if lp.shape != (B, T, cfg.model.vocab_size) or not torch.isfinite(lp).all():
            raise AssertionError(f"segment {k}: log-probs {tuple(lp.shape)} not finite/expected")
        d_lp = (lp - lp_p).abs().max().item()
        scale = lp_p.abs().max().item()
        if d_lp > 1e-3 * scale:
            raise AssertionError(f"segment {k}: max|Δ log-probs| {d_lp:.3e} > 1e-3·{scale:.3e}")
        for name in ("h", "s"):
            dc = (carry[name] - carry_p[name]).abs().max().item()
            cs = carry_p[name].abs().max().item()
            if dc > 1e-3 * cs or not torch.isfinite(carry[name]).all():
                raise AssertionError(f"segment {k}: carry {name} max|Δ| {dc:.3e} > 1e-3·{cs:.3e}")
        valid = torch.ones(B, T, dtype=torch.bool, device=dev) if fmask is None else fmask
        same = (lp.argmax(-1) == lp_p.argmax(-1)) & valid
        agree += int(same.sum())
        total += int(valid.sum())
        log(f"[batched] segment {k}: {sec * 1e3:.1f} ms kernel path, {sec_p * 1e3:.1f} ms "
            f"plain path; max|Δ log-probs| {d_lp:.3e} (scale {scale:.3e})")
    if agree < 0.999 * total:
        raise AssertionError(f"greedy frames agree on {agree}/{total} < 99.9%")
    per_seg = [r[2] * 1e3 for r in kern]
    log(f"[batched] B={B}, 3 × 16 s segments: {per_seg[0]:.1f} / {per_seg[1]:.1f} / "
        f"{per_seg[2]:.1f} ms per segment ({B * 16 / (sum(per_seg) / 3e3):.0f} audio-s/s); "
        f"greedy frames agree {agree}/{total}; fused-cell launches {launches}")
    return launches


def phase_streaming(model, cfg, dev) -> int:
    """Phase 3: three ~10 s streams through StreamingRecognizer vs offline."""
    rng = np.random.default_rng(SEED + 3)
    streams = [synth_audio(rng, 1, 160000 + int(rng.integers(0, 8000)))[0] for _ in range(3)]
    warm = StreamingRecognizer(model, cfg, chunk_frames=32, device=dev)
    warm.accept_waveform(streams[0][:16000])                   # warm-up, not counted

    latencies, results = [], []
    lucy_cell_fused_lm.launches = 0
    for audio in streams:
        rec = StreamingRecognizer(model, cfg, chunk_frames=32, device=dev)
        step = rec._step_chunk

        def timed(chunk, step=step):
            t0 = time.perf_counter()
            preds = step(chunk)                                 # ends in a host copy
            latencies.append(time.perf_counter() - t0)
            return preds

        rec._step_chunk = timed
        pos = 0
        while pos < len(audio):
            n = int(rng.integers(100, 8000))
            rec.accept_waveform(audio[pos:pos + n])
            pos += n
        rec.finish()
        results.append(rec.tokens)
    launches = lucy_cell_fused_lm.launches
    if launches == 0:
        raise AssertionError("the streaming path launched no fused-cell kernel")

    for k, (audio, toks) in enumerate(zip(streams, results)):
        with torch.inference_mode():
            feats = compute_features(torch.from_numpy(audio[None]).to(dev), cfg.frontend)
            logits, _ = model(feats, None, None)
            lp = torch.log_softmax(logits.float(), dim=-1)
        want = ctc_greedy_decode_to_lists(lp, torch.tensor([lp.shape[1]]))[0]
        dist = levenshtein(toks, want)
        log(f"[streaming] stream {k}: {len(audio) / 16000:.2f} s, {len(toks)} tokens "
            f"streamed, {len(want)} offline, edit distance {dist}")
        if not want or dist > 0.01 * len(want):
            raise AssertionError(f"stream {k}: edit distance {dist} > 1% of {len(want)}")
    lat = np.asarray(latencies) * 1e3
    log(f"[streaming] {len(lat)} chunks of 32 frames (320 ms): latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms; "
        f"fused-cell launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs one CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)                                                   # name, power limit
    log(f"torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    # full f32 matmuls (the JAX package uses Precision.HIGHEST); the frontend
    # refuses TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    builds = _kernels.build_all()
    log(f"[build] {len(_kernels.SIGNATURES)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    for lib, info in builds.items():
        usage = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {lib}: nvcc {info['seconds']:.1f} s; " + " | ".join(usage))

    k1 = phase_kernel(dev)

    cfg = Config().apply_overrides(FLAGSHIP)
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    model.eval()
    m = cfg.model
    log(f"[model] SpeechModel lucyrnn {m.num_layers} × {m.hidden_size}, vocab "
        f"{m.vocab_size}, {cfg.frontend.kind} {cfg.frontend.n_mfcc}, {m.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    n_batched = phase_batched(model, cfg, dev)
    n_stream = phase_streaming(model, cfg, dev)

    main_shape = k1["batched f32"]
    log(f"[kernels] lucy_cell_fused_lm launches: batched {n_batched}, streaming {n_stream}")
    log(json.dumps({"kernels": [{
        "name": "lucy_cell_fused_lm",
        "route": "cuda",
        "source": "statecatcher_tpu_torch/ops/csrc/lucy_fused_lm_fwd.cu",
        "replaces": "statecatcher_tpu/ops/lucy_fused_lm.py:156",
        "launches": n_batched + n_stream,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
