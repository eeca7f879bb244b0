#!/usr/bin/env python3
"""Smoke run of the PyTorch port (statecatcher_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

It builds every CUDA kernel of the port from ``statecatcher_tpu_torch/ops/
csrc`` (one nvcc per source, all started together) and drives the flagship
LucyRNN-CTC model (4 × 512, vocab 1024, 80 MFCC, float32, seeded random
weights) through the port's entry points:

  0. the card's facts, the kernel builds (time, ``ptxas -v`` registers/spills);
  1. kernel K1: ``lucy_cell_fused_lm`` against its plain version at the
     batched shape (f32 and bf16) and the streaming shape, with times (CUDA
     events) beside the byte bound;
  2. batched: ``SpeechModel`` over 3 carried 16 s segments at B=32, the
     kernel path held against the plain path on the card;
  3. streaming: ``StreamingRecognizer`` on three ~10 s streams, held against
     an offline one-shot decode of the same frames;
  4. kernels K2, K3, K4: the cell's backward and the CTC α/β lattice against
     their plain versions at the training shapes (and a ragged shape, and
     one with S > 1024 states), with times, bounds, plain times and, for the
     lattice, ``F.ctc_loss`` as the library yardstick;
  5. train step: ``make_segment_scan_step`` over one group of 4 carried 16 s
     segments at B=32 (U=128, a partial sample mask, a row_valid=False row),
     the kernel path held against the plain path;
  6. throughput at bench.py's shape (B=96, K=24, 16 s, bf16): one warm and
     one timed group (printed only, not a benchmark);
  7. CLI: ``python -m statecatcher_tpu_torch.cli`` trains a few dispatches on
     a generated WAV+VTT fixture and writes a checkpoint; a second run
     resumes from its cursor;
  8. the ``kernels`` JSON line: each kernel's launches on the main path
     (phases 2, 3 and 5; each counter is set to 0 just before a phase and
     read just after it, so comparison launches are not counted).

Every check raises; nothing is caught.  Without a card (or outside the
repository) it exits non-zero before printing any result.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import shutil
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
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.ops import _kernels, ctc_lattice, lucy_fused_lm
from statecatcher_tpu_torch.ops.ctc_lattice import (
    ctc_alpha,
    ctc_alpha_ref,
    ctc_beta,
    ctc_beta_ref,
    ctc_nll_pallas,
    emit_log_probs,
    expand_labels,
    nll_from_alpha,
    skip_allowed,
)
from statecatcher_tpu_torch.ops.lucy_fused_lm import (
    lucy_cell_fused_lm,
    lucy_cell_fused_lm_bwd,
    lucy_cell_fused_lm_bwd_ref,
    lucy_cell_fused_lm_ref,
)
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import levenshtein, randomize_, synth_audio
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

SEED = 0
FLAGSHIP = ["--model.encoder", "lucyrnn"]        # config defaults: 4 × 512, vocab 1024, mfcc 80, f32
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
F32_OPS_PER_S = 67e12                            # H100 SXM, float32 outside the tensor cores
# Operations per (b, t, d) element of the fused cell, counted from the kernel
# source: 7 bias adds, rms_rz 6, rms_kv² 5, its sqrt 1, z 5, decay 8,
# alpha 8, h_pre 4, kv 5, s-step 3, tanh 2, h-step 4 (sqrt, divide, exp,
# tanh one each).
CELL_OPS_PER_ELEMENT = 58
# K2 per (b, t, d): the chain recomputed in rsqrt form (~50, five rsqrt and
# three sigmoids), tanh and the two adjoint steps (~10), the closed-form
# chain adjoint (~65), the d_bias sums (7): ~132 counted from the source.
CELL_BWD_OPS_PER_ELEMENT = 132
# K3/K4 per (b, t, s): three exp, one log and ~12 adds/compares/selects.
LATTICE_OPS_PER_STATE = 16
REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")                 # ignored by git


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


def bytes_bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the f32
    peak, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conditioned_cell_inputs(gen, B, T, D, dtype, dev):
    """``cell_inputs`` with the k and v biases offset by ±2 and h_pre by ±1,
    as ``testing.randomize_`` does for the model: away from the gate chain's
    singular points (k = v = 0, h_pre = 0), where its derivatives blow up
    and round-off would be amplified without bound."""
    gates, bias, h0, s0 = cell_inputs(gen, B, T, D, dtype, dev)
    sign = lambda n: torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    bias[2 * D:4 * D] += 2.0 * sign(2 * D)
    bias[4 * D:5 * D] += sign(D)
    return gates, bias, h0, s0


def check_grads(got, want, names, rtol, scale_tol) -> float:
    """Raise unless every |Δ| ≤ rtol·|want| + scale_tol·max|want|; returns the
    largest absolute error."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        bad = int((d > rtol * b.abs() + scale_tol * b.abs().max()).sum())
        if bad or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: {bad} elements off (max |Δ| {d.max().item():.3e} at "
                                 f"scale {b.abs().max().item():.3e})")
        worst = max(worst, d.max().item())
    return worst


def phase_cell_bwd(dev) -> dict:
    """Phase 4a: K2 against its plain version; the batched shapes with the
    model path's null g_s, and a ragged shape with a real g_s."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {}
    cases = [("batched f32", 32, 1598, 512, torch.float32, False),
             ("batched bf16", 32, 1598, 512, torch.bfloat16, False),
             ("ragged f32 with g_s", 3, 45, 100, torch.float32, True)]
    names = ("d_gates", "dh0", "ds0", "d_bias")
    for label, B, T, D, dtype, with_gs in cases:
        gates, bias, h0, s0 = conditioned_cell_inputs(gen, B, T, D, dtype, dev)
        with torch.inference_mode():
            h_all, s_all = lucy_cell_fused_lm(gates, bias, h0, s0)
            g_h = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
            g_s = 0.1 * torch.randn((B, T, D), generator=gen, device=dev).to(dtype) if with_gs else None
            args = (gates, bias, h0, s0, h_all, s_all, g_h, g_s)
            got = lucy_cell_fused_lm_bwd(*args)
            torch.cuda.synchronize()
            want = lucy_cell_fused_lm_bwd_ref(*args)
            if dtype == torch.float32:
                # f32 round-off of two operation orders over T recurrence steps
                err = check_grads(got, want, names, 1e-4, 1e-6)
            else:
                # bf16 d_gates: a bf16 rounding step of values that differ by
                # f32 round-off; the f32 sums dh0, ds0, d_bias to 1e-3
                err = check_grads(got[:1], want[:1], names[:1], 2e-2, 1e-3)
                err = max(err, check_grads(got[1:], want[1:], names[1:], 1e-3, 1e-4))
            small = B * T <= 1000
            ms = cuda_ms(lambda: lucy_cell_fused_lm_bwd(*args), 200 if small else 20, graph=small)
            plain_ms = cuda_ms(lambda: lucy_cell_fused_lm_bwd_ref(*args), 2, warmup=1)
        es = torch.finfo(dtype).bits // 8
        planes = 7 + 2 + 1 + (1 if with_gs else 0) + 7
        nbytes = planes * B * T * D * es + 7 * D * 4 + 2 * B * D * 4 * 2 + B * 7 * D * 4
        bound, bound_by = bytes_bound_ms(nbytes, CELL_BWD_OPS_PER_ELEMENT * B * T * D)
        log(f"[K2] {label} (B={B}, T={T}, D={D}, {planes} planes): max|Δ| {err:.3e}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound:.4f} ms ({bound_by}, "
            f"{bound / ms:.1%} of it)  library_ms: none")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}
    return out


def lattice_inputs(gen, B, T, U, V, dev):
    """Log-probs, labels and lengths: row 1 has a shorter input, row 2 no
    labels (padded with blank, as the training loop pads)."""
    lp = torch.log_softmax(torch.randn((B, T, V), generator=gen, device=dev), dim=-1)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev, dtype=torch.int32)
    in_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    label_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
    in_lens[1] = T - T // 7
    label_lens[1] = U - U // 4
    label_lens[2] = 0
    labels[2] = 0
    return lp, labels, in_lens, label_lens


def check_lattice(got, want, atol) -> float:
    """Raise unless the dead states (≤ −1e29) agree and every live value is
    within ``atol`` + 2e-6 of its size; returns the largest live error."""
    live = want > -1e29
    if not torch.equal(live, got > -1e29):
        raise AssertionError("lattice kernel and plain version disagree on dead states")
    d = (got - want)[live].abs()
    bad = int((d > atol + 2e-6 * want[live].abs()).sum())
    if bad:
        raise AssertionError(f"lattice: {bad} values off, max |Δ| {d.max().item():.3e}")
    return d.max().item()


def phase_lattice(dev) -> dict:
    """Phase 4b: K3 and K4 against their plain versions, and F.ctc_loss."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}
    for label, B, T, U, V in (("training", 32, 1598, 128, 1024), ("S>1024", 3, 700, 600, 64)):
        lp, labels, in_lens, label_lens = lattice_inputs(gen, B, T, U, V, dev)
        ext = expand_labels(labels, 0)
        skip = skip_allowed(ext, 0)
        emit = emit_log_probs(lp, ext).contiguous()
        S = emit.shape[2]
        with torch.inference_mode():
            a, b = ctc_alpha(emit, skip, in_lens), ctc_beta(emit, skip, in_lens, label_lens)
            torch.cuda.synchronize()
            a_ref, b_ref = ctc_alpha_ref(emit, skip, in_lens), ctc_beta_ref(emit, skip, in_lens,
                                                                             label_lens)
            # f32 log-sum-exp chains of up to T steps, in two operation orders
            err_a, err_b = check_lattice(a, a_ref, 2e-5), check_lattice(b, b_ref, 2e-5)
            ms_a = cuda_ms(lambda: ctc_alpha(emit, skip, in_lens), 20)
            ms_b = cuda_ms(lambda: ctc_beta(emit, skip, in_lens, label_lens), 20)
            plain_a = cuda_ms(lambda: ctc_alpha_ref(emit, skip, in_lens), 2, warmup=1)
            plain_b = cuda_ms(lambda: ctc_beta_ref(emit, skip, in_lens, label_lens), 2, warmup=1)
            # the library's CTC on the same inputs: forward, and the NLL check
            lp_tb = lp.transpose(0, 1)
            lib = lambda: F.ctc_loss(lp_tb, labels, in_lens, label_lens, blank=0,
                                     reduction="none", zero_infinity=True)
            ours = lambda: nll_from_alpha(ctc_alpha(emit_log_probs(lp, ext).contiguous(), skip,
                                                    in_lens), in_lens, label_lens)
            d_nll = (ours() - lib()).abs().max().item()
            lib_fwd, ours_fwd = cuda_ms(lib, 10), cuda_ms(ours, 10)

        def fwd_bwd(fn):
            x = lp.detach().requires_grad_()
            return lambda: fn(x).sum().backward()

        lib_fb = cuda_ms(fwd_bwd(lambda x: F.ctc_loss(x.transpose(0, 1), labels, in_lens,
                                                      label_lens, blank=0, reduction="none",
                                                      zero_infinity=True)), 10)
        ours_fb = cuda_ms(fwd_bwd(lambda x: ctc_nll_pallas(x, in_lens, labels, label_lens)), 10)
        nbytes = 2 * B * T * S * 4 + B * S + 2 * B * 4
        bound, bound_by = bytes_bound_ms(nbytes, LATTICE_OPS_PER_STATE * B * T * S)
        log(f"[K3/K4] {label} (B={B}, T={T}, U={U}, S={S}): α max|Δ| {err_a:.3e}, β max|Δ| "
            f"{err_b:.3e}; K3 {ms_a:.4f} ms, K4 {ms_b:.4f} ms (plain {plain_a:.2f} / "
            f"{plain_b:.2f} ms), bound {bound:.4f} ms each ({bound_by})")
        log(f"[K3/K4] {label}: NLL forward (gather + K3 + read-out) {ours_fwd:.4f} ms vs "
            f"F.ctc_loss {lib_fwd:.4f} ms (max |Δ nll| {d_nll:.3e}); forward+backward (+ K4 + γ "
            f"+ scatter) {ours_fb:.4f} ms vs F.ctc_loss {lib_fb:.4f} ms")
        if d_nll > 1e-3 * (1.0 + U):
            raise AssertionError(f"NLL differs from F.ctc_loss by {d_nll:.3e}")
        out[label] = {
            "alpha": {"max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": lib_fwd},
            "beta": {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_fb},
        }
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel of the training path (K1, K2, K3, K4) to its plain
    version on the card, so the kernel path can be held against the plain
    path on the same inputs."""
    saved = (lucy_fused_lm._fwd_kernel, lucy_fused_lm._bwd_kernel,
             ctc_lattice.ctc_alpha, ctc_lattice.ctc_beta)
    lucy_fused_lm._fwd_kernel = lambda g, b, h, s: lucy_cell_fused_lm_ref(g, b, h, s)
    lucy_fused_lm._bwd_kernel = lucy_cell_fused_lm_bwd_ref
    ctc_lattice.ctc_alpha, ctc_lattice.ctc_beta = ctc_alpha_ref, ctc_beta_ref
    try:
        yield
    finally:
        (lucy_fused_lm._fwd_kernel, lucy_fused_lm._bwd_kernel,
         ctc_lattice.ctc_alpha, ctc_lattice.ctc_beta) = saved


def train_group(rng, K, B, S, U, V, dev, int16=True):
    """One segment group as the training loop ships it: int16 audio, prefix
    lengths (one partial), U random tokens per row, the last row invalid."""
    audio = np.stack([synth_audio(rng, B, S) for _ in range(K)])
    if int16:
        audio = np.clip(np.rint(audio * 32767.0), -32768, 32767).astype(np.int16)
    lens = np.full((K, B), S, np.int32)
    lens[-1, 0] = S // 2                                      # one partial sample mask
    tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
    tok_lens = np.full((K, B), U, np.int32)
    row_valid = np.ones((K, B), bool)
    row_valid[:, B - 1] = False
    return [torch.from_numpy(x).to(dev) for x in (audio, lens, tokens, tok_lens, row_valid)]


def snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


def phase_train_step(cfg, dev, K=4, B=32, S=16 * 16000, U=128) -> dict:
    """Phase 5: one group of K=4 carried 16 s segments at B=32 through
    ``make_segment_scan_step``, kernel path against plain path.

    The learning rate is 1e-6 here: at the default 3e-4, Adam's first,
    sign-like steps turn f32 round-off in near-zero gradient components into
    lr-sized parameter differences between the two paths, and the later
    segments' grad norms then differ by up to 2 % (measured on the card)."""
    cfg = cfg.apply_overrides(["--train.optim.lr", "1e-6"])
    V = cfg.model.vocab_size
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1, gate_weight_scale=0.1)        # gate inputs near their biases
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    group = train_group(np.random.default_rng(SEED + 6), K, B, S, U, V, dev)
    seg_valid = np.ones(K, bool)
    p0, opt0 = snapshot(state), state.state_dict()

    counters = (lucy_cell_fused_lm, lucy_cell_fused_lm_bwd, ctc_alpha, ctc_beta)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, carry, outs = step(state, init_carry(cfg.model, B, device=dev), *group, seg_valid)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    p_kernel = snapshot(state)

    state.load_state_dict(opt0)
    with plain_kernels():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, carry_p, outs_p = step(state, init_carry(cfg.model, B, device=dev), *group, seg_valid)
        torch.cuda.synchronize()
        sec_p = time.perf_counter() - t0
    p_plain = snapshot(state)

    loss, loss_p = outs.loss.cpu().numpy(), outs_p.loss.cpu().numpy()
    gn, gn_p = outs.grad_norm.cpu().numpy(), outs_p.grad_norm.cpu().numpy()
    if not (np.isfinite(loss).all() and np.isfinite(gn).all()):
        raise AssertionError(f"non-finite loss {loss} or grad norm {gn}")
    # f32 round-off of two operation orders, carried through up to K updates:
    # losses to 1e-4, grad norms to 1e-3 (relative)
    d_loss = np.abs(loss - loss_p) / np.abs(loss_p)
    d_gn = np.abs(gn - gn_p) / np.abs(gn_p)
    if d_loss.max() > 1e-4 or d_gn.max() > 1e-3:
        raise AssertionError(f"kernel vs plain: loss rel {d_loss}, grad norm rel {d_gn}")
    for name in ("h", "s"):
        dc = (carry[name] - carry_p[name]).abs().max().item()
        cs = carry_p[name].abs().max().item()
        if dc > 1e-3 * cs or not torch.isfinite(carry[name]).all():
            raise AssertionError(f"carry {name}: max|Δ| {dc:.3e} > 1e-3·{cs:.3e}")
    # parameters after K Adam updates.  Adam moves every parameter by ~lr per
    # update whatever its gradient's size, so a component whose gradient is
    # near zero takes the sign of its round-off and may differ by 2·lr per
    # update between the paths.  Held: the updates agree as a whole (their
    # difference under 1 % of their norm), and at most 0.1 % of the elements
    # differ by more than 0.1·lr·K.
    lr = cfg.train.optim.lr
    flat = lambda d: torch.cat([v.flatten().float() for v in d.values()])
    p0_, pk, pp = flat(p0), flat(p_kernel), flat(p_plain)
    worst_dp = (pk - pp).abs().max().item()
    rel_upd = ((pk - pp).norm() / (pk - p0_).norm()).item()
    frac_off = ((pk - pp).abs() > 0.1 * lr * K).float().mean().item()
    moved = (pk - p0_).abs().max().item()
    if rel_upd > 1e-2 or frac_off > 1e-3:
        raise AssertionError(f"parameters: updates differ by {rel_upd:.3e} of their norm, "
                             f"{frac_off:.3e} of elements by more than 0.1·lr·K")
    log(f"[train] K={K} × {S / 16000:g} s at B={B}, U={U}: kernel path {sec:.3f} s ({sec / K * 1e3:.1f} ms "
        f"per segment, {K * B * S / 16000 / sec:.0f} audio-s/s), plain path {sec_p:.3f} s; losses "
        f"{np.array2string(loss, precision=5)} vs {np.array2string(loss_p, precision=5)} (max rel "
        f"{d_loss.max():.2e}); grad norms max rel {d_gn.max():.2e}; params moved up to {moved:.3e}; "
        f"kernel vs plain: updates differ by {rel_upd:.2e} of their norm, max|Δ| {worst_dp:.3e}, "
        f"{frac_off:.2e} of elements beyond 0.1·lr·K")
    log(f"[train] launches on the group: K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
        f"K4 {launches[3]}")
    want = [cfg.model.num_layers * K, cfg.model.num_layers * K, K, K]
    if launches != want:
        raise AssertionError(f"launches K1, K2, K3, K4 = {launches}; want {want}")
    return dict(zip(("K1", "K2", "K3", "K4"), launches))


def phase_throughput(cfg, dev, K=24, B=96, S=16 * 16000, U=128) -> None:
    """Phase 6: bench.py's shape (B=96, K=24, 16 s, bf16, U=128), one warm
    and one timed group on the kernel path."""
    cfg = cfg.apply_overrides(["--model.dtype", "bfloat16"])
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    rng = np.random.default_rng(SEED + 7)
    groups = [train_group(rng, K, B, S, U, cfg.model.vocab_size, dev) for _ in range(2)]
    carry = init_carry(cfg.model, B, device=dev)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for g in groups:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, carry, outs = step(state, carry, *g, np.ones(K, bool))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if not torch.isfinite(outs.loss).all():
        raise AssertionError("throughput run: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[throughput] B={B}, K={K} × {S / 16000:g} s, bf16, U={U}: warm group {secs[0]:.3f} s, timed group "
        f"{secs[1]:.3f} s = {K * B * S / 16000 / secs[1]:.0f} audio-s/s ({secs[1] / K * 1e3:.1f} ms per "
        f"segment); peak memory {peak:.2f} GiB")


def write_cli_fixture(root: str, n: int = 4, seconds: float = 48.0, cue: float = 4.0) -> str:
    """n 16 kHz recordings of ~48 s (tones in noise) with ~4 s VTT cues."""
    from statecatcher_tpu_torch.data.audio import write_wav_bytes

    words = ["hello", "world", "stream", "state", "carry", "segment", "audio", "model"]
    rng = np.random.default_rng(SEED + 8)
    d = os.path.join(root, "data")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        with open(os.path.join(d, f"rec{i}.wav"), "wb") as f:
            f.write(write_wav_bytes(synth_audio(rng, 1, int(seconds * 16000))[0], 16000))
        lines, t = ["WEBVTT", ""], 0.0
        while t + cue <= seconds:
            stamp = lambda x: f"00:{int(x // 60):02d}:{x % 60:06.3f}"
            lines += [f"{stamp(t)} --> {stamp(t + cue)}", " ".join(rng.choice(words, 4)), ""]
            t += cue
        with open(os.path.join(d, f"rec{i}.vtt"), "w") as f:
            f.write("\n".join(lines))
    return d


def run_cli(args: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-m", "statecatcher_tpu_torch.cli", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    losses = summary["loss_history"]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"CLI losses not finite: {losses}")
    return summary


def phase_cli(extra=(), seconds=48.0, target=16) -> None:
    """Phase 7: the CLI trains 2 dispatches on a generated fixture, then a
    second run resumes from the checkpoint's cursor and trains one more."""
    shutil.rmtree(WORK, ignore_errors=True)
    data = write_cli_fixture(WORK, seconds=seconds, cue=target / 4)
    common = ["--model.encoder", "lucyrnn", "--data.source", "local", "--data.local_dir", data,
              "--data.target_duration", str(target), "--data.batch_size", "4",
              "--data.num_workers", "4", "--train.segments_per_dispatch", "1",
              "--train.log_every_n", "2", *extra]
    t0 = time.perf_counter()
    first = run_cli(common + ["--train.steps", "2", "--train.model_dir",
                              os.path.join(WORK, "run1")])
    meta = json.load(open(os.path.join(first["run_dir"], "ckpt", "2", "meta.json")))
    if meta["cursor"] != {"batches_done": 0, "seg_idx": 2}:
        raise AssertionError(f"checkpoint cursor {meta['cursor']}")
    second = run_cli(common + ["--train.steps", "3", "--train.resume_from", first["run_dir"],
                               "--train.model_dir", os.path.join(WORK, "run2")])
    if second["global_step"] != 3 or len(second["loss_history"]) != 1:
        raise AssertionError(f"resumed run: step {second['global_step']}, "
                             f"losses {second['loss_history']}")
    log(f"[cli] 4 recordings × {seconds:g} s, {target} s segments, vocab from the char tokenizer: losses "
        f"{[round(x, 4) for x in first['loss_history']]}, checkpoint cursor {meta['cursor']}; "
        f"resumed at step 2, loss {second['loss_history'][0]:.4f}, global_step 3 "
        f"({time.perf_counter() - t0:.1f} s for both runs)")


def kernel_entry(name, source, replaces, launches, m) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m.get("library_ms")}


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
    k2 = phase_cell_bwd(dev)
    lattice = phase_lattice(dev)
    del model
    n_train = phase_train_step(cfg, dev)
    phase_throughput(cfg, dev)
    phase_cli()

    csrc = "statecatcher_tpu_torch/ops/csrc/"
    log(f"[kernels] launches: K1 batched {n_batched}, streaming {n_stream}, train {n_train['K1']}; "
        f"K2 {n_train['K2']}, K3 {n_train['K3']}, K4 {n_train['K4']} (train)")
    log(json.dumps({"kernels": [
        kernel_entry("lucy_cell_fused_lm", csrc + "lucy_fused_lm_fwd.cu",
                     "statecatcher_tpu/ops/lucy_fused_lm.py:156",
                     n_batched + n_stream + n_train["K1"], k1["batched f32"]),
        kernel_entry("lucy_cell_fused_lm_bwd", csrc + "lucy_fused_lm_bwd.cu",
                     "statecatcher_tpu/ops/lucy_fused_lm.py:248", n_train["K2"],
                     k2["batched f32"]),
        kernel_entry("ctc_alpha", csrc + "ctc_lattice.cu",
                     "statecatcher_tpu/ops/ctc_pallas.py:58", n_train["K3"],
                     lattice["training"]["alpha"]),
        kernel_entry("ctc_beta", csrc + "ctc_lattice.cu",
                     "statecatcher_tpu/ops/ctc_pallas.py:92", n_train["K4"],
                     lattice["training"]["beta"]),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
