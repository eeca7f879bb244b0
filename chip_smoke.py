#!/usr/bin/env python3
"""Smoke run of the PyTorch port (statecatcher_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

It builds every CUDA kernel of the port from ``statecatcher_tpu_torch/ops/
csrc`` (one nvcc per source, all started together) and drives the flagship
LucyRNN (4 × 512, vocab 1024, 80 MFCC, float32, seeded random weights;
RNN-T joiner 64; the 7-gate cell, masked or not, through each of its
kernels, and the 6-gate native variant), the xLSTM, the LSTM of the
config's defaults and the RWKV through the port's entry points, evaluates
and beam-decodes the flagship, and trains the RWKV from the port's HTTP
data plane:

  0. the card's facts, the kernel builds (time, ``ptxas -v`` registers/spills)
     and the tensor-core (HMMA) instructions of the joint's forward and
     backward kernels, of K9a's and K10's forward passes (in both mLSTM
     libraries) and of K9b's, each of which must hold some;
  1. kernel K1: ``lucy_cell_fused_lm`` against its plain version at the
     batched shape (f32 and bf16), the streaming shape, the edges of its
     tiles (T=45 with D=100, T=1) and bench.py's shape (B=96, bf16), with
     times (CUDA events) beside the byte bound;
  2. batched: ``SpeechModel`` over 3 carried 16 s segments at B=32, the
     kernel path held against the plain path on the card;
  3. streaming: ``StreamingRecognizer`` on three ~10 s streams, held against
     an offline one-shot decode of the same frames (chunk latency p50/p90,
     peak device memory);
  4. kernels K2, K3, K4: the cell's backward and the CTC α/β lattice against
     their plain versions at the training shapes (and a ragged shape, K2 at
     bench.py's B=96 bf16, the lattice at bench.py's B=96 and with S > 1024
     states), with times, bounds, plain times and, for the lattice,
     ``F.ctc_loss`` as the library yardstick (forward, and forward and
     backward) and its chain floor (the frames it walks × one frame's
     latency, measured on one row) beside its byte bound;
  5. train step: ``make_segment_scan_step`` over one group of 4 carried 16 s
     segments at B=32 (U=128, a partial sample mask, a row_valid=False row),
     the kernel path held against the plain path;
  6. throughput at bench.py's shape (B=96, 16 s, bf16, U=128) but K=8 of
     its 24 segments: one group run warm, then timed (printed only, not a
     benchmark);
  7. CLI: ``python -m statecatcher_tpu_torch.cli`` trains a few dispatches on
     a generated WAV+VTT fixture and writes a checkpoint; a second run
     resumes from its cursor; then ``python -m statecatcher_tpu_torch.eval``
     on the resumed run (its WER line), and ``evaluate`` with the run's
     tokenizer on random weights over the fixture's recordings cut to 24 s,
     greedy and beam, kernel path (K1) against plain path (hypotheses
     within 2 % edit distance);
  8. kernels K6a, K6b, K7a, K7b: the fused RNN-T joint (forward, backward)
     and the transducer α/β lattice against their plain versions at the
     RNN-T training shape (B=32, T=1598, U=48, J=64, V=1024; f32, and bf16
     enc/pred for K6), a ragged shape (blank_id 5; for K7 with a t_len = 0
     row) and U=128, and K7 at U+1 > 1024 (its scan route), with times,
     bounds and plain times; beside each K6a bound, the exps' time at the
     SFU rate and ``torch.matmul``'s time for the logits alone; beside each
     K7 bound its chain floor (the steps its chain takes, diagonals or, on
     the scan route, frames, × one step's latency, measured on one row);
  9. RNN-T train step: ``make_segment_scan_step`` with ``--train.mode
     rnnt`` over one group of 2 carried 16 s segments at B=32, U=48 (the
     auto band resolves to the exact loss), the kernel path held against
     the plain path; then its float64 witness: each segment's gradient on
     the kernel path, and on the plain path with K7's plain versions in
     either order (the kernels' anti-diagonals; the frames of the TPU
     kernel), against the plain path in float64, the kernel path no further
     from it than the frame order;
 10. RNN-T streaming: ``StreamingRecognizer(decoder="rnnt")`` on three ~10 s
     streams, held against an offline greedy decode of the same frames
     (equal) and of a one-shot encoding (1 % edit distance), with the joiner
     conditioned so that blank ends many frames and the emissions per frame
     vary (checked on the offline decode);
 11. kernels K5a, K5b: the linear scan and its adjoint against their plain
     versions at the cell's shape (B=32, T=1598, D=512), f32 and bf16, bit
     for bit in f32, also at the edges of their ring;
 12. the masked flagship (``mask_state_updates=True``): phase 2's batched
     encode, whose masked segment runs the split cell through K5 (a row
     whose mask ends early carries its last valid frame's state), and one
     CTC training group of K=2 at B=32 through K5, kernel path against plain
     path;
 13. kernels K8a, K8b and the banded α/β lattice against their plain
     versions at the banded training shape (B=32, T=1598, U=128, band 32;
     f32, and bf16 for K8; beside each K8a bound, as in phase 8), the
     lattice also at bench.py's B=96 (U=64 and U=128), with its chain floor
     (the diagonals it walks × one diagonal's latency, measured on one row)
     beside its byte bound, and the identity: with band ≥ U+1 the banded
     loss and its gradients equal the exact K6/K7 loss;
 14. RNN-T train step at U=128 with the default band (32): one group of K=2
     at B=32 with a row_valid=False row and a degenerate row (its band
     prunes every path: masked out, finite gradients), kernel path against
     plain path;
 15. RNN-T throughput at B=96, K=4 × 16 s, bf16, U=64 and U=128 (bench.py's
     RNN-T rows; both under the default band; printed only);
 16. CLI in RNN-T mode: two dispatches; then eval as in phase 7, with the
     RNN-T decoders (rnnt-greedy, rnnt-beam);
 17. kernels K9a, K9b and K10: the fused mLSTM forward and backward and the
     head-major chunkwise forward against their plain versions at the
     xLSTM's shape (B=32, T=1598, 2 heads, dqk=128, dv=256, chunk 128; f32,
     and bf16 q/k/v for K9), K9 at bench.py's xLSTM shape (B=64, chunk
     256, bf16), K9 and K10 at E=2048's heads (dqk=512, dv=1024; f32 and
     bf16) and at chunk 512, and K9a at the streaming shape (B=1, one chunk
     of 32 steps), with times, bounds, plain times and the forward's device
     time by CUDA kernel;
 18. the xLSTM (config defaults: E=512, 2 heads, 3 blocks, chunk 128, FFN
     factor 2.667, vocab 1024, 80 MFCC, float32): phase 2's batched encode,
     kernel path (``kernel_impl="auto"``: K9a) against plain path, and again
     with ``kernel_impl="pallas"`` (K10);
 19. xLSTM streaming against an offline decode, as phase 3;
 20. one xLSTM CTC training group of K=2 at B=32 (U=128; K9a, K9b), kernel
     path against plain path, as phase 5;
 21. xLSTM throughput at bench.py's xLSTM shape (B=64, bf16, chunk 256,
     U=128) at K=4 of its 24 segments (printed only);
 22. CLI with ``--model.encoder xlstm``: two dispatches and a resume; then
     the xLSTM with a chunk and heads wider than 256
     (``phase_xlstm_wide``): at ``--model.xlstm.embedding_dim 2048`` (dqk
     512, dv 1024) the batched encode through K9a and K10, streams and a
     CTC training group, each against its plain path, at
     ``--model.xlstm.chunk_size 512`` the batched encode and a training
     group, and the CLI at E=2048 with a resume;
 23. kernels K12 and K11: the fused masked cell and the dual scan against
     their plain versions at the batched shape (B=32, T=1598, D=512; f32 and
     bf16, unmasked and with one partial row; bit for bit in f32, also at
     the edges of their rings) and K12 at the streaming shape (1, 32, 512),
     with times, byte bounds and plain times; and their
     autograd Functions' gradients (the backward's two K5b scans) against the
     plain versions' at the f32 shape;
 24. the masked flagship through K12 (``kernel_impl="auto-fused"``,
     ``mask_state_updates=True``): phase 12's batched encode, its masked
     segment's time beside phase 12's split path; three streams against the
     offline decode; a CTC training group of K=2 (K12 and K5b per layer, K3,
     K4), kernel path against plain path;
 25. K11 (``kernel_impl="pallas-dual"``, masked): the batched encode and a CTC
     training group of K=1;
 26. the native LucyRNN (``variant="native"``, 4 × 512, vocab 1024, masked;
     its scans through K5): the batched encode, three streams, a CTC
     training group of K=2 and the CLI with a resume;
 27. the LSTM of the config's defaults (no ``--model.encoder``: 512 wide,
     vocab 1024, 80 MFCC, f32; a torch recurrence, no TPU kernel), its depth
     cut to 2 layers: phase 2's batched encode with the segment's time (the
     row whose mask ends early carries its last valid frame's state), a CTC
     training group of K=1 at B=32 (K3/K4 against their plain versions) and
     the CLI with a resume;
 28. ``ctc_beam_search`` (beam 8, top 16, as eval runs it) at B=32, T=1598,
     V=1024 on the flagship's log-probs: the card's live hypotheses against
     the same function's on the CPU, with both times;
 29. the flagship through ``StreamingRecognizer(decoder="beam")``: three
     streams with commits on the way, against the same search and commits
     replayed over the same log-probs (equal tokens) and against one
     offline search (within 2 % edit distance: exact f32 ties are broken by
     hash order, which a commit changes); chunk latency;
 30. the RWKV at the flagship's widths (``--model.encoder rwkv``: 4 × 512,
     vocab 1024, 80 MFCC, f32, ``randomize_`` weights; its WKV is torch, with
     no TPU kernel): phase 2's batched encode (B=32, 3 carried 16 s
     segments), one 16 s segment at B=4 on the card against the same on the
     CPU (and a TF32 control pass that every limit must refuse), three
     streams against an offline decode (as phase 3), and a CTC training
     group of K=4 at B=32, U=128 (K3/K4 against their plain versions, at
     phase 5's tolerances);
 31. the host side through the CLI: the port's fake data server on
     loopback serving phase 7's fixture; a unigram tokenizer trained by
     ``python -m statecatcher_tpu_torch.train_tokenizer`` from its VTTs; the
     CLI training the RWKV from ``--data.source http`` with ``--train.debug``
     and ``--train.profile_dir`` (finite losses, every consumed batch marked
     done, the session ended, the carry checked, a trace written); the
     native library live, its WAV decoder and Viterbi encoder equal to the
     Python ones on the fixture; ``python -m statecatcher_tpu_torch.simulate``
     over the same server;
 32. the ``kernels`` JSON line: each kernel's launches on the main path
     (phases 2, 3, 5, 7, 9, 10, 12, 14, 16, 18, 19, 20, 22's E=2048 and
     chunk-512 runs, 24–27, 29, 30 and 33's ranks; each counter is set to 0
     just before a phase and read just after it, so comparison launches are
     not counted);
 33. multi-GPU training (``parallel/*``, ``ops/scan_sp.py``): world =
     max(2, cards) rank processes of ``python -m
     statecatcher_tpu_torch.parallel.dryrun`` with torchrun's environment
     (NCCL with a card per rank; on one card gloo, every rank on cuda:0),
     the flagship at B=32 global, K=2 × 16 s, U=128, row 31 (one rank's)
     invalid: (a) data parallel over every rank (K1–K4), (b) tensor parallel
     with mp=2 ("pallas": K5a/K5b on each rank's gate columns), (c) sequence
     parallel over 2 ranks ("sp": K5a/K5b on each time shard), each held
     against one process on the card at phase 5's tolerances, with ms per
     segment per rank and the bytes all-reduced per update; (d) the CLI on
     2 ranks with ``--mesh.data_parallel 2`` on phase 7's fixture (two
     dispatches and a checkpoint, against phase 7's losses), a 2-rank resume
     and a 1-process resume from that checkpoint (equal losses).  Every rank
     has a time limit; a rank that fails or runs out of time fails the
     phase.

Every check raises; nothing is caught.  Without a card (or outside the
repository) it exits non-zero before printing any result.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from statecatcher_tpu_torch import debug, native
from statecatcher_tpu_torch import eval as port_eval
from statecatcher_tpu_torch.beam import beam_commit, beam_hypotheses, ctc_beam_search
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
from statecatcher_tpu_torch.frontend import compute_features, compute_frame_mask, num_frames
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise
from statecatcher_tpu_torch.ops import _kernels, rnnt_lattice
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
from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
from statecatcher_tpu_torch.ops.lucy_pallas import (
    linear_scan_fwd,
    linear_scan_ref,
    linear_scan_rev,
    linear_scan_rev_ref,
    lucy_dual_scan,
    lucy_dual_scan_ref,
    lucy_fused_cell,
    lucy_fused_cell_ref,
)
from statecatcher_tpu_torch.ops.mlstm_fused import (
    mlstm_fused_bwd,
    mlstm_fused_bwd_ref,
    mlstm_fused_fwd,
    mlstm_fused_fwd_ref,
    soft_cap,
)
from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_pallas_fwd
from statecatcher_tpu_torch.ops.rnnt_band import (
    band_offsets,
    band_width,
    joint_blank_emit_banded_bwd_ref,
    joint_blank_emit_banded_ref,
    rnnt_band_alpha,
    rnnt_band_alpha_ref,
    rnnt_band_beta,
    rnnt_band_beta_ref,
    rnnt_band_bwd,
    rnnt_band_fwd,
    rnnt_loss_banded,
)
from statecatcher_tpu_torch.ops.rnnt_joint import (
    joint_blank_emit_bwd_ref,
    joint_blank_emit_ref,
    rnnt_joint_bwd,
    rnnt_joint_fwd,
    rnnt_loss_pallas,
)
from statecatcher_tpu_torch.ops.rnnt_lattice import (
    rnnt_alpha,
    rnnt_alpha_ref,
    rnnt_beta,
    rnnt_beta_ref,
)
from statecatcher_tpu_torch.rnnt_decode import rnnt_greedy_decode, rnnt_state_to_lists
from statecatcher_tpu_torch.roofline import (
    H100_PEAK_FLOPS_BF16 as BF16_OPS_PER_S,
    H100_PEAK_FLOPS_F32 as F32_OPS_PER_S,
    H100_PEAK_FLOPS_TF32 as TF32_OPS_PER_S,
    H100_PEAK_HBM_BPS as HBM_BYTES_PER_S,
    train_step_roofline,
)
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import levenshtein, randomize_, synth_audio
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

SEED = 0
FLAGSHIP = ["--model.encoder", "lucyrnn"]        # config defaults: 4 × 512, vocab 1024, mfcc 80, f32
XLSTM = ["--model.encoder", "xlstm"]             # E=512, 2 heads, 3 blocks, chunk 128, f32
# the xLSTM with a chunk and heads wider than 256 (the gate passes take several
# rows a thread, K9b's dq and dk two slabs): E=2048's heads
# (dqk 512, dv 1024) and chunk 512
XLSTM_2048 = XLSTM + ["--model.xlstm.embedding_dim", "2048"]
XLSTM_CHUNK_512 = XLSTM + ["--model.xlstm.chunk_size", "512"]
MASKED = ["--model.lucyrnn.mask_state_updates", "true"]
NATIVE = ["--model.lucyrnn.variant", "native"]
# NeMo Conformer-Transducer's pred_hidden and joint_hidden (conformer_transducer_bpe.yaml,
# model_defaults): above J = 128 the joint's kernels take the tiled products
WIDE_JOINER = ["--model.rnnt_pred_emb_dim", "640", "--model.rnnt_joiner_dim", "640"]
RWKV = ["--model.encoder", "rwkv"]                # 4 × 512, vocab 1024, f32
# the config's default encoder (the LSTM, 4 × 512) cut to 2 layers: its recurrence
# is a torch step a frame and layer, host-bound, so its time goes with depth
LSTM = ["--model.num_layers", "2"]
CARD = ""                                        # nvidia-smi's name, power limit (main)
CLI_LOSSES: dict = {}                            # phase_cli's first runs' losses, by tag
# Operations per (b, t, d) element of the fused cell, counted from the kernel
# source: 7 bias adds, rms_rz 6, rms_kv² 5, its sqrt 1, z 5, decay 8,
# alpha 8, h_pre 4, kv 5, s-step 3, tanh 2, h-step 4 (sqrt, divide, exp,
# tanh one each).
CELL_OPS_PER_ELEMENT = 58
# K2 per (b, t, d): the chain recomputed in rsqrt form (~50, five rsqrt and
# three sigmoids), tanh and the two adjoint steps (~10), the closed-form
# chain adjoint (~65), the d_bias sums (7): ~132 counted from the source.
CELL_BWD_OPS_PER_ELEMENT = 132
# K12 per (b, t, d), counted from its source: K1's chain without the 7 bias
# adds (51), and 7 more for a frame mask (m·a + (1 − m) twice, m·b twice).
K12_OPS_PER_ELEMENT = 51
K12_MASK_OPS_PER_ELEMENT = 7
# K11 per (b, t, d): s-step 2, the tanh and its sum 2, (1 − a_h)·c 2, h-step 2.
K11_OPS_PER_ELEMENT = 8
# K3/K4 per (b, t, s): three exp, one log and ~12 adds/compares/selects.
LATTICE_OPS_PER_STATE = 16
# K7a/K7b per (b, t, u), and the banded lattice per window cell: one
# logaddexp (an exp, a log, ~6 adds, compares and selects): ~10.  The
# wavefront computes each cell once with one such logaddexp, so its
# operations are these; the scan route (U+1 > 1024) does ~5 more a cell in
# its log-step rounds, its design's overhead, not counted here.
RNNT_LATTICE_OPS_PER_STATE = 10
REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")                 # ignored by git


def joint_bound_ms(R: int, V: int, J: int, dtype: torch.dtype, nbytes: float,
                   backward: bool) -> tuple[float, str]:
    """The least time of K6/K8 over R rows and V columns: the larger of the
    bytes over the memory rate and the operations over their rates.  Per
    (row, v) the contractions take 2J (K6a: the logits) or 6J (K6b: the
    logits once more, as they are not saved, d_joint and d_K), at the card's
    fastest rate for the inputs' accuracy: bf16 on the tensor cores, f32 as
    three TF32 products (3xTF32: a third of the TF32 rate); the elementwise
    work (K6a: the bias add and the logsumexp's compare, exp and add, 5;
    K6b: the softmax, d_logits and d_bias, ~10) at the f32 rate outside the
    tensor cores.  The two overlap, so the larger term bounds.  K6b's d_K
    kernel recomputes the logits a second time: its design's cost, not
    counted."""
    per_j, elementwise = (6, 10) if backward else (2, 5)
    contraction_peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S / 3
    t_ops = max(R * V * per_j * J / contraction_peak, R * V * elementwise / F32_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi`` clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.split()[0]) * 1e6


def joint_fwd_yardsticks(tag: str, R: int, V: int, J: int, dtype: torch.dtype, dev) -> None:
    """Two lines beside a K6a/K8a bound.  The exps' time at the SFU rate:
    one exp per (row, v), R·V of them, at 16 a clock on each SM at the
    card's highest clock; under bf16 it is about twice the operations bound,
    which it does not enter (a polynomial exp2 on the FMA pipe could take
    part of it).  And, as a yardstick only, the time of ``torch.matmul`` for
    the same (R × J)·(J × V) logits product in the same dtype: not the same
    function (it writes the R × V logits, which the kernel never stores, and
    takes no log-sum-exp), so not the table's library time."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    sfu_ms = R * V / (16 * n_sm * clock) * 1e3
    log(f"{tag} K6a/K8a exps at the SFU rate: {sfu_ms:.4f} ms ({R * V} exps at 16 a clock × "
        f"{n_sm} SMs × {clock / 1e9:.3f} GHz)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    with torch.inference_mode():
        a = torch.randn((R, J), generator=gen, device=dev).to(dtype)
        k = torch.randn((J, V), generator=gen, device=dev).to(dtype)
        out = torch.empty((R, V), dtype=dtype, device=dev)
        ms = cuda_ms(lambda: torch.matmul(a, k, out=out), 3, warmup=1)
    del a, k, out
    log(f"{tag} yardstick, not the same function: torch.matmul of the ({R} × {J})·({J} × {V}) "
        f"logits in {dtype}, {ms:.4f} ms")


def sass_dumps(libs) -> dict[str, str]:
    """``cuobjdump -sass`` of each built library of ``libs``, all at once."""
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    run = lambda lib: subprocess.run([tool, "-sass", str(_kernels._target(lib))],
                                     capture_output=True, text=True, check=True).stdout
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        return dict(zip(libs, ex.map(run, libs)))


def sass_hmma(out: str, family: str) -> dict[str, int]:
    """HMMA (tensor-core) instructions per kernel of a library's SASS ``out``
    whose name starts with ``family``; each kernel named with its template
    arguments as its mangled name gives them (f32 or bf16 for a type, 0 or 1
    for a bool, an int's value)."""
    words = {"f": "f32", "13__nv_bfloat16": "bf16"}
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            m = re.search(rf"\d({family}[a-z_]*kernel)(I(?:13__nv_bfloat16|f|Lb[01]E|Li\d+E)+E)?",
                          line.split("Function : ")[1])              # the name after its length
            name = None
            if m is not None:
                args = [words.get(a) or a[2:-1] for a in
                        re.findall(r"13__nv_bfloat16|f|Lb[01]E|Li\d+E", m.group(2) or "")]
                name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
                counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


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
             ("streaming f32", 1, 32, 512, torch.float32),
             ("ragged f32", 3, 45, 100, torch.float32),
             ("one step f32", 4, 1, 512, torch.float32),
             ("bench bf16", 96, 1598, 512, torch.bfloat16)]
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


@functools.cache
def batched_audio(B, S) -> tuple:
    """``phase_batched``'s three segments and the last one's row lengths,
    made once a run (every phase that encodes takes the same)."""
    rng = np.random.default_rng(SEED + 2)
    audio = [synth_audio(rng, B, S) for _ in range(3)]
    lens = rng.integers(S // 4, S, B)
    lens[0] = S
    return audio, lens


def phase_batched(model, cfg, dev, counters=None, tag=None) -> dict:
    """Phases 2, 12, 18 and 27: 3 carried 16 s segments at B=32, the last
    with a partial sample mask, kernel path vs plain path.  Under
    ``mask_state_updates`` the masked segment runs the masked cell (the
    split path through K5 unless ``kernel_impl`` names K12 or K11) and a row
    whose mask ends early must carry its last valid frame's state; so must
    the LSTM's, which masks inside its recurrence.  Returns the launches of
    ``counters`` (name → kernel wrapper; by default K1 and K5a, the 7-gate
    LucyRNN's; {} for the LSTM, which has no kernel), each of which must
    launch (the default K5a only when masked), and the kernel path's ms per
    segment."""
    B, S = 32, 16 * 16000
    masked = cfg.model.encoder == "lucyrnn" and cfg.model.lucyrnn.mask_state_updates
    tag = tag or ("[batched masked]" if masked else "[batched]")
    audio, lens = batched_audio(B, S)
    audio = [torch.from_numpy(x).to(dev) for x in audio]
    last_mask = torch.arange(S, device=dev)[None, :] < torch.from_numpy(lens).to(dev)[:, None]
    masks = [None, None, last_mask]
    T = num_frames(S, cfg.frontend)
    optional = set() if counters is not None or masked else {"K5a"}
    if counters is None:
        counters = {"K1": lucy_cell_fused_lm, "K5a": linear_scan_fwd}
    with torch.inference_mode():
        run_segments(model, cfg, audio, masks)                    # warm-up, masked path too
        for c in counters.values():
            c.launches = 0
        kern = run_segments(model, cfg, audio, masks)
        launches = {n: c.launches for n, c in counters.items()}
        with plain_kernels():
            plain = run_segments(model, cfg, audio, masks)
    if any(n == 0 and name not in optional for name, n in launches.items()):
        raise AssertionError(f"the batched path launched {launches}")
    if masked or cfg.model.encoder == "lstm":
        check_last_valid_state(model, cfg, *kern[-1], tag=tag)
    agree = total = 0
    for k, ((lp, carry, sec, fmask), (lp_p, carry_p, sec_p, _)) in enumerate(zip(kern, plain)):
        if lp.shape != (B, T, cfg.model.vocab_size) or not torch.isfinite(lp).all():
            raise AssertionError(f"segment {k}: log-probs {tuple(lp.shape)} not finite/expected")
        d_lp = (lp - lp_p).abs().max().item()
        scale = lp_p.abs().max().item()
        if d_lp > 1e-3 * scale:
            raise AssertionError(f"segment {k}: max|Δ log-probs| {d_lp:.3e} > 1e-3·{scale:.3e}")
        for name in carry:
            dc = (carry[name] - carry_p[name]).abs().max().item()
            cs = carry_p[name].abs().max().item()
            if dc > 1e-3 * cs or not torch.isfinite(carry[name]).all():
                raise AssertionError(f"segment {k}: carry {name} max|Δ| {dc:.3e} > 1e-3·{cs:.3e}")
        valid = torch.ones(B, T, dtype=torch.bool, device=dev) if fmask is None else fmask
        same = (lp.argmax(-1) == lp_p.argmax(-1)) & valid
        agree += int(same.sum())
        total += int(valid.sum())
        log(f"{tag} segment {k}: {sec * 1e3:.1f} ms kernel path, {sec_p * 1e3:.1f} ms "
            f"plain path; max|Δ log-probs| {d_lp:.3e} (scale {scale:.3e})")
    if agree < 0.999 * total:
        raise AssertionError(f"greedy frames agree on {agree}/{total} < 99.9%")
    per_seg = [r[2] * 1e3 for r in kern]
    log(f"{tag} B={B}, 3 × 16 s segments: {per_seg[0]:.1f} / {per_seg[1]:.1f} / "
        f"{per_seg[2]:.1f} ms per segment ({B * 16 / (sum(per_seg) / 3e3):.0f} audio-s/s); "
        f"greedy frames agree {agree}/{total}; launches {launches} ({CARD})")
    return launches, per_seg


def check_last_valid_state(model, cfg, lp, carry, _sec, fmask, tag="[batched masked]"):
    """Under ``mask_state_updates``: the row whose mask ends earliest carries
    the state of its last valid frame.  The last layer's output at frame t
    is h_t, whose projection is frame t's logits, and its carried h is h_T:
    so the logits stay those of the last valid frame past it, and the
    projection of the carried h equals them (within f32 round-off of the
    projection, 1e-5 of their scale).  The carry is (B, tracks, L, D), or
    (B, L, D) for the native variant and the LSTM: track 0's last layer.
    The LSTM outputs zero on a masked frame, so past its last valid frame
    the logits are its classifier's bias."""
    row = int(fmask.sum(1).argmin())
    last = int(fmask[row].sum()) - 1
    if not bool(fmask[row, :last + 1].all()) or last + 1 >= fmask.shape[1]:
        raise AssertionError(f"row {row}: its frame mask is not a prefix ending early")
    lstm = cfg.model.encoder == "lstm"
    with torch.inference_mode():
        L = cfg.model.num_layers
        h_T = carry["h"][row].reshape(-1, L, carry["h"].shape[-1])[0, L - 1]
        proj = model.asr.classifier if lstm else model.asr.encoder.output_proj
        logits = torch.log_softmax(proj(h_T[None]).float(), -1)[0]
        tail = (torch.log_softmax(proj.bias.float(), -1) if lstm else lp[row, last])
    want = lp[row, last]
    scale = want.abs().max().item()
    d_tail = (lp[row, last + 1:] - tail).abs().max().item()
    d_carry = (logits - want).abs().max().item()
    if d_tail > 1e-5 * scale or d_carry > 1e-5 * scale:
        raise AssertionError(f"row {row}: the state moved after its last valid frame {last} "
                             f"(max |Δ| {d_tail:.3e} past it, {d_carry:.3e} from the carry)")
    past = "its classifier's bias" if lstm else f"frame {last}'s"
    log(f"{tag} row {row} ends at frame {last} of {fmask.shape[1]}: its log-probs from its "
        f"carried h equal frame {last}'s, past it {past} (max |Δ| {max(d_tail, d_carry):.2e})")


def phase_streaming(model, cfg, dev, counter=lucy_cell_fused_lm, tag="[streaming]") -> int:
    """Phases 3, 19, 24, 26 and 30: three ~10 s streams through
    StreamingRecognizer vs offline; returns the launches of ``counter`` (the
    encoder's forward kernel: K1, or K9a for the xLSTM; None for the RWKV,
    which has none)."""
    rng = np.random.default_rng(SEED + 3)
    streams = [synth_audio(rng, 1, 160000 + int(rng.integers(0, 8000)))[0] for _ in range(3)]
    warm = StreamingRecognizer(model, cfg, chunk_frames=32, device=dev)
    warm.accept_waveform(streams[0][:16000])                   # warm-up, not counted

    latencies, results = [], []
    if counter is not None:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    launches = 0 if counter is None else counter.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counter is not None and launches == 0:
        raise AssertionError(f"the streaming path launched no {counter.__name__} kernel")

    for k, (audio, toks) in enumerate(zip(streams, results)):
        with torch.inference_mode():
            feats = compute_features(torch.from_numpy(audio[None]).to(dev), cfg.frontend)
            logits, _ = model(feats, None, None)
            lp = torch.log_softmax(logits.float(), dim=-1)
        want = ctc_greedy_decode_to_lists(lp, torch.tensor([lp.shape[1]]))[0]
        dist = levenshtein(toks, want)
        log(f"{tag} stream {k}: {len(audio) / 16000:.2f} s, {len(toks)} tokens "
            f"streamed, {len(want)} offline, edit distance {dist}")
        if not want or dist > 0.01 * len(want):
            raise AssertionError(f"stream {k}: edit distance {dist} > 1% of {len(want)}")
    lat = np.asarray(latencies) * 1e3
    log(f"{tag} {len(lat)} chunks of 32 frames (320 ms): latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms; peak device "
        f"memory {peak:.3f} GiB; "
        + ("no kernel" if counter is None else f"{counter.__name__} launches {launches}")
        + (f" ({CARD})" if counter is None else ""))
    return launches


def bytes_bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    inputs' peak (f32 by default), and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
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
    """Phase 4a: K2 against its plain version; the batched shapes and
    bench.py's with the model path's null g_s, and a ragged shape with a
    real g_s."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = {}
    cases = [("batched f32", 32, 1598, 512, torch.float32, False),
             ("batched bf16", 32, 1598, 512, torch.bfloat16, False),
             ("ragged f32 with g_s", 3, 45, 100, torch.float32, True),
             ("bench bf16", 96, 1598, 512, torch.bfloat16, False)]
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


def check_lattice(got, want, atol, rtol=2e-6) -> float:
    """Raise unless the dead states (≤ −1e29) agree and every live value is
    within ``atol`` + ``rtol`` of its size; returns the largest live error."""
    live = want > -1e29
    if not torch.equal(live, got > -1e29):
        raise AssertionError("lattice kernel and plain version disagree on dead states")
    d = (got - want)[live].abs()
    bad = int((d > atol + rtol * want[live].abs()).sum())
    if bad:
        raise AssertionError(f"lattice: {bad} values off, max |Δ| {d.max().item():.3e}")
    return d.max().item()


def ctc_chain_floor(emit, skip, in_lens) -> tuple[float, float, int]:
    """K3's chain floor: the most frames any row walks times the latency of
    one frame, measured on row 0 alone (one block on the card) as the slope
    between its whole walk and half of it.  Returns (floor ms, ms per frame,
    frames)."""
    T = emit.shape[1]
    one, sk = emit[:1].contiguous(), skip[:1].contiguous()
    full = torch.full((1,), T, dtype=torch.int32, device=emit.device)
    ms_full, ms_half = (cuda_ms(lambda n=n: ctc_alpha(one, sk, n), 20) for n in (full, full // 2))
    per_frame = (ms_full - ms_half) / (T - T // 2)
    frames = int(torch.clamp(in_lens, 0, T).max())
    return frames * per_frame, per_frame, frames


def phase_lattice(dev) -> dict:
    """Phase 4b: K3 and K4 against their plain versions at the training
    shape, bench.py's B=96 and S > 1024, and F.ctc_loss."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}
    for label, B, T, U, V in (("training", 32, 1598, 128, 1024),
                              ("bench B=96", 96, 1598, 128, 1024), ("S>1024", 3, 700, 600, 64)):
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
            # f32 log-sum-exp chains of up to T steps; the kernels take the
            # plain versions' operations in their order, so no value should
            # differ (the count is printed), but the tolerance stays
            err_a, err_b = check_lattice(a, a_ref, 2e-5), check_lattice(b, b_ref, 2e-5)
            n_unlike = int((a != a_ref).sum()) + int((b != b_ref).sum())
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
            floor, per_frame, frames = ctc_chain_floor(emit, skip, in_lens)

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
            f"{err_b:.3e} ({n_unlike} values unlike the plain versions'); K3 {ms_a:.4f} ms, K4 "
            f"{ms_b:.4f} ms (plain {plain_a:.2f} / {plain_b:.2f} ms), bound {bound:.4f} ms each "
            f"({bound_by}); chain floor {floor:.4f} ms ({frames} frames × {per_frame * 1e6:.1f} "
            f"ns, measured on one row)")
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


# (module, attribute, plain version) of every kernel wrapper of the model and
# training paths: K1, K2, K3, K4, K5a, K5b, K6a, K6b, K7a, K7b, K8a, K8b,
# banded α, β, K9a, K9b, K10, K12, K11
# every kernel slot and its plain version (``debug.kernel_slots``);
# ``plain_kernels`` routes the model and training paths to the plain versions
PLAIN = debug.kernel_slots()
plain_kernels = debug.kernel_interpret_mode


@functools.cache
def group_arrays(seed, K, B, S, U, V, degenerate=False) -> tuple:
    """``train_group``'s host arrays from ``seed``, made once a run: the
    phases ask for the same groups again, and making 16 s of audio a row
    takes the host ~0.5 s for 32 rows."""
    rng = np.random.default_rng(seed)
    audio = np.stack([synth_audio(rng, B, S) for _ in range(K)])
    audio = np.clip(np.rint(audio * 32767.0), -32768, 32767).astype(np.int16)
    lens = np.full((K, B), S, np.int32)
    lens[-1, 0] = S // 2                                      # one partial sample mask
    if degenerate:
        lens[:, 1] = 800
    tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
    tok_lens = np.full((K, B), U, np.int32)
    row_valid = np.ones((K, B), bool)
    row_valid[:, B - 1] = False
    return audio, lens, tokens, tok_lens, row_valid


def train_group(seed, K, B, S, U, V, dev, degenerate=False):
    """One segment group as the training loop ships it: int16 audio, prefix
    lengths (one partial), U random tokens per row, the last row invalid.
    With ``degenerate``, row 1 holds 50 ms of audio (5 frames) for its U
    tokens: a banded loss whose band is narrower than U prunes all its
    paths."""
    return [torch.tensor(x, device=dev)
            for x in group_arrays(seed, K, B, S, U, V, degenerate)]


def snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


# the kernels a training path's step launches: name → (counter, launches per
# segment and layer, or 0 for once per segment)
TRAIN_KERNELS = {
    "ctc": {"K1": (lucy_cell_fused_lm, 1), "K2": (lucy_cell_fused_lm_bwd, 1),
            "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "ctc masked": {"K5a": (linear_scan_fwd, 2), "K5b": (linear_scan_rev, 2),
                   "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "rnnt": {"K1": (lucy_cell_fused_lm, 1), "K2": (lucy_cell_fused_lm_bwd, 1),
             "K6a": (rnnt_joint_fwd, 0), "K6b": (rnnt_joint_bwd, 0),
             "K7a": (rnnt_alpha, 0), "K7b": (rnnt_beta, 0)},
    "rnnt banded": {"K1": (lucy_cell_fused_lm, 1), "K2": (lucy_cell_fused_lm_bwd, 1),
                    "K8a": (rnnt_band_fwd, 0), "K8b": (rnnt_band_bwd, 0),
                    "band α": (rnnt_band_alpha, 0), "band β": (rnnt_band_beta, 0)},
    "rnnt J=640": {"K1": (lucy_cell_fused_lm, 1), "K2": (lucy_cell_fused_lm_bwd, 1),
                   "K6a": (rnnt_joint_fwd, 0), "K6b": (rnnt_joint_bwd, 0),
                   "K7a": (rnnt_alpha, 0), "K7b": (rnnt_beta, 0)},
    "rnnt banded J=640": {"K1": (lucy_cell_fused_lm, 1), "K2": (lucy_cell_fused_lm_bwd, 1),
                          "K8a": (rnnt_band_fwd, 0), "K8b": (rnnt_band_bwd, 0),
                          "band α": (rnnt_band_alpha, 0), "band β": (rnnt_band_beta, 0)},
    "xlstm ctc": {"K9a": (mlstm_fused_fwd, 1), "K9b": (mlstm_fused_bwd, 1),
                  "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "xlstm E=2048 ctc": {"K9a": (mlstm_fused_fwd, 1), "K9b": (mlstm_fused_bwd, 1),
                         "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "xlstm chunk 512 ctc": {"K9a": (mlstm_fused_fwd, 1), "K9b": (mlstm_fused_bwd, 1),
                            "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "ctc k12": {"K12": (lucy_fused_cell, 1), "K5b": (linear_scan_rev, 2),
                "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "ctc dual": {"K11": (lucy_dual_scan, 1), "K5b": (linear_scan_rev, 2),
                 "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "native ctc": {"K5a": (linear_scan_fwd, 2), "K5b": (linear_scan_rev, 2),
                   "K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "lstm ctc": {"K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
    "rwkv ctc": {"K3": (ctc_alpha, 0), "K4": (ctc_beta, 0)},
}


def n_layers(cfg) -> int:
    """Recurrent layers of the encoder: LucyRNN layers or xLSTM blocks."""
    return cfg.model.xlstm.num_blocks if cfg.model.encoder == "xlstm" else cfg.model.num_layers


def train_setup(cfg, dev, K, B=32, S=16 * 16000, U=128, mode="ctc", degenerate=False):
    """phase_train_step's set-up: ``cfg`` at lr 1e-6 in ``mode``, its model
    with random weights (gate projections ×0.1), the train state, the
    segment-scan step and one group of K segments (``train_group``).  Returns
    (cfg, state, step, group)."""
    cfg = cfg.apply_overrides(["--train.optim.lr", "1e-6", "--train.mode", mode])
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, mode, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1, gate_weight_scale=0.1)        # gate inputs near their biases
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    group = train_group(SEED + 6, K, B, S, U, cfg.model.vocab_size, dev, degenerate=degenerate)
    return cfg, state, step, group


def phase_train_step(cfg, dev, K=4, B=32, S=16 * 16000, U=128, mode="ctc", path=None,
                     degenerate=False) -> dict:
    """Phases 5, 9, 12, 14, 20, 24–26 and 27: one group of K carried 16 s segments at B=32
    through ``make_segment_scan_step`` in ``mode`` ("ctc" or "rnnt"), kernel
    path against plain path; ``path`` names the kernels it must launch
    (``TRAIN_KERNELS``; the mode by default).  With ``degenerate``, row 1's
    band prunes all its paths: its loss must be masked out (0) and every
    gradient finite.

    The learning rate is 1e-6 here: at the default 3e-4, Adam's first,
    sign-like steps turn f32 round-off in near-zero gradient components into
    lr-sized parameter differences between the two paths, and the later
    segments' grad norms then differ by up to 2 % (measured on the card).

    Returns each kernel's launches on the kernel path's run, and the update
    difference: ``update_rel`` (of the update's norm) and ``frac_off`` (the
    share of elements beyond 0.1·lr·K)."""
    path = path or mode
    tag = f"[{'train' if path == 'ctc' else path + ' train'}]"
    cfg, state, step, group = train_setup(cfg, dev, K, B, S, U, mode, degenerate)
    seg_valid = np.ones(K, bool)
    p0, opt0 = snapshot(state), state.state_dict()

    counters = [c for c, _ in TRAIN_KERNELS[path].values()]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, carry, outs = step(state, init_carry(cfg.model, B, device=dev), *group, seg_valid)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
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
    if degenerate:
        per = outs.per_loss.cpu().numpy()
        if (per[:, 1] != 0).any() or (per[:, 0] <= 0).any():
            raise AssertionError(f"the degenerate row is not masked out: per-row losses {per[:, :2]}")
    # f32 round-off of two operation orders, carried through up to K updates:
    # losses to 1e-4, grad norms to 1e-3 (relative)
    d_loss = np.abs(loss - loss_p) / np.abs(loss_p)
    d_gn = np.abs(gn - gn_p) / np.abs(gn_p)
    if d_loss.max() > 1e-4 or d_gn.max() > 1e-3:
        raise AssertionError(f"kernel vs plain: loss rel {d_loss}, grad norm rel {d_gn}")
    for name in carry:
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
    # the parameters that carry the difference, by share of its squared norm
    sq = {k: (p_kernel[k].float() - p_plain[k].float()).square().sum().item() for k in p0}
    top = ", ".join(f"{k} {v / max(sum(sq.values()), 1e-30):.0%}"
                    for k, v in sorted(sq.items(), key=lambda kv: -kv[1])[:3])
    if rel_upd > 1e-2 or frac_off > 1e-3:
        raise AssertionError(f"parameters: updates differ by {rel_upd:.3e} of their norm, "
                             f"{frac_off:.3e} of elements by more than 0.1·lr·K (most in {top})")
    log(f"{tag} K={K} × {S / 16000:g} s at B={B}, U={U}: kernel path {sec:.3f} s ({sec / K * 1e3:.1f} ms "
        f"per segment, {K * B * S / 16000 / sec:.0f} audio-s/s, peak memory {peak:.2f} GiB), "
        f"plain path {sec_p:.3f} s; losses "
        f"{np.array2string(loss, precision=5)} vs {np.array2string(loss_p, precision=5)} (max rel "
        f"{d_loss.max():.2e}); grad norms max rel {d_gn.max():.2e}; params moved up to {moved:.3e}; "
        f"kernel vs plain: updates differ by {rel_upd:.2e} of their norm, max|Δ| {worst_dp:.3e}, "
        f"{frac_off:.2e} of elements beyond 0.1·lr·K; the difference is most in {top} ({CARD})")
    names = list(TRAIN_KERNELS[path])
    log(f"{tag} launches on the group: " + ", ".join(f"{n} {c}" for n, c in zip(names, launches)))
    want = [(n_layers(cfg) * per_layer if per_layer else 1) * K
            for _, per_layer in TRAIN_KERNELS[path].values()]
    if launches != want:
        raise AssertionError(f"launches {names} = {launches}; want {want}")
    return {**dict(zip(names, launches)), "update_rel": rel_upd, "frac_off": frac_off}


def gradients_of(state, step, cfg, B, group, K) -> list[torch.Tensor]:
    """Each segment's gradient (every parameter's, flattened, float64) as
    ``step`` hands it to the optimizer over ``group``."""
    got, apply = [], state.apply_gradients

    def capture(grads, ok=None):
        got.append(torch.cat([g.detach().double().flatten() for g in grads.values()]))
        apply(grads, ok)

    state.apply_gradients = capture
    try:
        step(state, init_carry(cfg.model, B, device=group[0].device), *group, np.ones(K, bool))
    finally:
        del state.apply_gradients
    return got


def with_weights(cfg, params, mode, dev) -> tuple:
    """A train state carrying ``params`` (cast to ``cfg``'s parameter dtype)
    and the segment-scan step of ``cfg``'s model in ``mode``."""
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, mode, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    state = init_train_state(model, cfg)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
    return state, make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)


# A witness's reference for each dtype a training group runs in: the
# overrides of the plain path it is held to, its name, and the distance
# (of the reference gradient's norm) below which the kernel path passes
WITNESS = {"bfloat16": (["--model.dtype", "float32"], "f32", 1e-3),
           "float32": (["--model.dtype", "float64", "--model.param_dtype", "float64"],
                       "float64", 1e-4)}


def phase_train_witness(cfg, dev, path, dtype, K=1, B=32) -> dict:
    """``phase_train_step``'s group in ``dtype`` on the kernel path and on
    the plain path, each segment's gradient held against the plain path's
    in a wider dtype with the same weights (``WITNESS``), as phase 9's
    witness.  In bf16 the two paths differ by bf16 steps, not by f32
    round-off; in f32 at chunk 512 their sums over 512 rows differ enough
    that Adam's sign-like first step (±lr whatever a gradient's size) puts
    their updates near phase 20's 1 % of each other (1.01e-2 and 8.6e-3
    in two runs), so the wider reference decides.  Fails if a gradient
    is not finite, if the kernel path's gradient is further from the
    reference than twice the plain path's distance or the floor, or if a
    kernel of ``path`` (``TRAIN_KERNELS``) was not launched as often as
    phase_train_step wants.  Returns the launches."""
    over, ref, floor = WITNESS[dtype]
    tag = f"[{path} train {dtype}]"
    cfg, state, step, group = train_setup(cfg.apply_overrides(["--model.dtype", dtype]),
                                          dev, K, B)
    opt0 = state.state_dict()
    counters = [c for c, _ in TRAIN_KERNELS[path].values()]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gradients_of(state, step, cfg, B, group, K)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    state.load_state_dict(opt0)
    with plain_kernels():
        plain = gradients_of(state, step, cfg, B, group, K)
    del state, step
    cfg_ref = cfg.apply_overrides(over)
    with plain_kernels():
        want = gradients_of(*with_weights(cfg_ref, opt0["params"], "ctc", dev), cfg_ref, B,
                            group, K)
    dist = lambda gs: [((g - w).norm() / w.norm()).item() for g, w in zip(gs, want)]
    d_k, d_p = dist(got), dist(plain)
    log(f"{tag} K={K} × 16 s at B={B}: kernel path {sec:.3f} s; gradients against the plain "
        f"path in {ref}, by segment: kernel path {', '.join(f'{x:.3e}' for x in d_k)}, plain "
        f"path {', '.join(f'{x:.3e}' for x in d_p)} of its norm apart ({CARD})")
    if not all(torch.isfinite(g).all() for g in got) or any(
            a > max(2 * b, floor) for a, b in zip(d_k, d_p)):
        raise AssertionError(f"{tag} the kernel path's gradient is {d_k} of the {ref} "
                             f"gradient's norm from it, the plain path's {d_p}")
    names = list(TRAIN_KERNELS[path])
    log(f"{tag} launches on the group: " + ", ".join(f"{n} {c}" for n, c in zip(names, launches)))
    want_n = [(n_layers(cfg) * per_layer if per_layer else 1) * K
              for _, per_layer in TRAIN_KERNELS[path].values()]
    if launches != want_n:
        raise AssertionError(f"{tag} launches {names} = {launches}; want {want_n}")
    return dict(zip(names, launches))


@contextlib.contextmanager
def frame_order():
    """K7's plain versions in the frame order (the TPU kernel's log-step
    scans) while the block runs, inside ``plain_kernels``."""
    saved = rnnt_lattice.rnnt_alpha, rnnt_lattice.rnnt_beta
    rnnt_lattice.rnnt_alpha = lambda *a: rnnt_alpha_ref(*a, order="frames")
    rnnt_lattice.rnnt_beta = lambda *a: rnnt_beta_ref(*a, order="frames")
    try:
        yield
    finally:
        rnnt_lattice.rnnt_alpha, rnnt_lattice.rnnt_beta = saved


def phase_rnnt_witness(cfg, dev, K=2, B=32, S=16 * 16000, U=48) -> dict:
    """Phase 9's float64 witness: phase 9's group (``train_setup``) on the
    kernel path, and on the plain path with K7's plain versions in either
    order ("diagonals", the kernels' walk; "frames", the TPU kernel's
    log-step scans), each segment's f32 gradient against the plain path's
    with the model in float64 (the same weights).  The exact loss's
    occupancies divide by one Z a row, so f32 round-off of α against β at
    T = 1598 scales a row's gradient (the frame order's by 0.5–2.6 % on
    average): the two orders cannot be held to each other, but each can be
    held to float64.  Fails if the kernel path is further from it than the
    frame order.  Returns, by run, each segment's distance (of the float64
    gradient's norm) and grad norm's relative difference."""
    cfg, state, step, group = train_setup(cfg, dev, K, B, S, U, "rnnt")
    opt0 = state.state_dict()
    runs = {}
    for name, plain, frames in (("kernels", False, False), ("plain, diagonals", True, False),
                                ("plain, frames", True, True)):
        state.load_state_dict(opt0)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_kernels())
            if frames:
                stack.enter_context(frame_order())
            runs[name] = gradients_of(state, step, cfg, B, group, K)
    cfg64 = cfg.apply_overrides(["--model.dtype", "float64", "--model.param_dtype", "float64"])
    want = {}
    for frames in (False, True):
        with plain_kernels(), (frame_order() if frames else contextlib.nullcontext()):
            want[frames] = gradients_of(*with_weights(cfg64, opt0["params"], "rnnt", dev), cfg64,
                                        B, group, K)
    # in float64 the two orders agree: the witness ran in float64
    gap = max(((a - b).norm() / b.norm()).item() for a, b in zip(want[False], want[True]))
    if gap > 1e-6:
        raise AssertionError(f"the float64 witness's two orders are {gap:.3e} apart")
    want = want[False]
    out = {}
    for name, got in runs.items():
        dist = [((g - w).norm() / w.norm()).item() for g, w in zip(got, want)]
        d_gn = [abs(g.norm().item() - w.norm().item()) / w.norm().item() for g, w in zip(got, want)]
        out[name] = {"dist": dist, "grad_norm_rel": d_gn}
        log(f"[rnnt train witness] {name} (f32) against the plain path in float64 (its two "
            f"orders {gap:.1e} apart): gradients "
            f"{', '.join(f'{x:.3e}' for x in dist)} of its norm apart by segment, grad norms "
            f"{', '.join(f'{x:.3e}' for x in d_gn)}")
    worse = [k for k, (a, b) in enumerate(zip(out["kernels"]["dist"], out["plain, frames"]["dist"]))
             if a > b]
    if worse:
        raise AssertionError(f"the kernel path's gradient is further from float64 than the frame "
                             f"order's in segments {worse}: {out}")
    return out


def phase_throughput(cfg, dev, K, B=96, S=16 * 16000, U=128, mode="ctc") -> None:
    """Phases 6, 15 and 21: bench.py's shapes (16 s, bf16; LucyRNN B=96, CTC
    U=128, RNN-T U=64 and U=128, both under the default band 32; xLSTM B=64,
    chunk 256, CTC U=128) at K segments, one group run warm and then timed on
    the kernel path; beside the rate, the row's roofline (``roofline.py``, the
    config carrying the row's B and 16 s segments, as bench.py's): its mfu,
    its share of the speed of light, which must stay below 100 % (at or above
    it the count leaves out work), and its FLOPs, bytes and bound."""
    cfg = cfg.apply_overrides(["--model.dtype", "bfloat16", "--train.mode", mode,
                               "--data.batch_size", str(B),
                               "--data.target_duration", f"{S / 16000:g}"])
    rl = train_step_roofline(cfg, cfg.frontend.n_mfcc, U, mode)
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, mode, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    groups = [train_group(SEED + 7, K, B, S, U, cfg.model.vocab_size, dev)] * 2
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
    rate = K * B * S / 16000 / secs[1]
    log(f"[throughput] {cfg.model.encoder} {mode} B={B}, K={K} × {S / 16000:g} s, bf16, U={U}: warm group {secs[0]:.3f} s, timed group "
        f"{secs[1]:.3f} s = {rate:.1f} audio-s/s ({secs[1] / K * 1e3:.1f} ms per "
        f"segment); peak memory {peak:.2f} GiB; mfu {rl.mfu(rate):.6f}, pct_speed_of_light "
        f"{100 * rl.pct_sol(rate):.2f} (roofline: {rl.flops_per_audio_sec:.6e} FLOPs and "
        f"{rl.bytes_per_audio_sec:.6e} bytes an audio-second, sol_audio_sec_per_sec "
        f"{rl.sol_audio_sec_per_sec:.1f})")
    if rl.pct_sol(rate) >= 1.0:
        raise AssertionError(f"throughput run at {100 * rl.pct_sol(rate):.2f} % of its speed of "
                             f"light: the roofline leaves out work")


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


def phase_cli(extra=(), seconds=48.0, target=16, encoder="lucyrnn", tag=None) -> tuple:
    """Phases 7, 22, 26 and 27: the CLI trains 2 dispatches on a generated
    fixture, then a second run resumes from the checkpoint's cursor and
    trains one more.  ``encoder=None`` passes no ``--model.encoder`` (the
    config's default, the LSTM).  Returns (the resumed run's directory, the
    CLI's model and data overrides)."""
    shutil.rmtree(WORK, ignore_errors=True)
    data = write_cli_fixture(WORK, seconds=seconds, cue=target / 4)
    common = [*(["--model.encoder", encoder] if encoder else []),
              "--data.source", "local", "--data.local_dir", data,
              "--data.target_duration", str(target), "--data.batch_size", "4",
              "--data.num_workers", "4", "--train.segments_per_dispatch", "1",
              "--train.log_every_n", "2", *extra]
    t0 = time.perf_counter()
    first = run_cli(common + ["--train.steps", "2", "--train.model_dir",
                              os.path.join(WORK, "run1")])
    CLI_LOSSES[tag or encoder] = first["loss_history"]
    meta = json.load(open(os.path.join(first["run_dir"], "ckpt", "2", "meta.json")))
    if meta["cursor"] != {"batches_done": 0, "seg_idx": 2}:
        raise AssertionError(f"checkpoint cursor {meta['cursor']}")
    second = run_cli(common + ["--train.steps", "3", "--train.resume_from", first["run_dir"],
                               "--train.model_dir", os.path.join(WORK, "run2")])
    if second["global_step"] != 3 or len(second["loss_history"]) != 1:
        raise AssertionError(f"resumed run: step {second['global_step']}, "
                             f"losses {second['loss_history']}")
    log(f"{tag or '[cli ' + encoder + ']'} 4 recordings × {seconds:g} s, {target} s segments, vocab from the char tokenizer: losses "
        f"{[round(x, 4) for x in first['loss_history']]}, checkpoint cursor {meta['cursor']}; "
        f"resumed at step 2, loss {second['loss_history'][0]:.4f}, global_step 3 "
        f"({time.perf_counter() - t0:.1f} s for both runs)")
    return second["run_dir"], common


def joint_inputs(gen, B, T, U, J, V, dev, dtype, blank_id):
    """Projections as the joiner gives them (O(1)), a kernel with O(1)
    logits, labels that avoid the blank, and cotangents of the lattice's
    size (occupancies ≤ 1)."""
    enc = torch.randn((B, T, J), generator=gen, device=dev).to(dtype)
    pred = torch.randn((B, U + 1, J), generator=gen, device=dev).to(dtype)
    k = torch.randn((J, V), generator=gen, device=dev) / J ** 0.5
    b = 0.1 * torch.randn(V, generator=gen, device=dev)
    labels = torch.randint(0, V - 1, (B, U), generator=gen, device=dev, dtype=torch.int32)
    labels += (labels >= blank_id).to(torch.int32)
    g_blank = torch.rand((B, T, U + 1), generator=gen, device=dev) / (U + 1)
    g_emit = torch.rand((B, T, U), generator=gen, device=dev) / (U + 1)
    return enc, pred, k, b, labels, g_blank, g_emit


def check_close(got, want, names, rtol, atol) -> float:
    """Raise unless every |Δ| ≤ atol + rtol·|want|; returns the largest."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        d = (a.float() - b.float()).abs()
        bad = int((d > atol + rtol * b.float().abs()).sum())
        if bad or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: {bad} elements off, max |Δ| {d.max().item():.3e}")
        worst = max(worst, d.max().item())
    return worst


def phase_rnnt_kernels(dev) -> dict:
    """Phase 8: K6a/K6b and K7a/K7b (``phase_exact_lattice``) against their
    plain versions, with times, bounds and plain times; K6 also at J = 640
    (the tiled products; f32 and bf16 at the training shape) and at a
    ragged J = 200."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    joint_cases = [("training f32", 32, 1598, 48, 64, 1024, 0, torch.float32),
                   ("training bf16", 32, 1598, 48, 64, 1024, 0, torch.bfloat16),
                   ("ragged f32", 3, 45, 11, 40, 150, 5, torch.float32),
                   ("U=128 f32", 8, 400, 128, 64, 1024, 0, torch.float32),
                   ("J=640 training f32", 32, 1598, 48, 640, 1024, 0, torch.float32),
                   ("J=640 training bf16", 32, 1598, 48, 640, 1024, 0, torch.bfloat16),
                   ("J=200 ragged f32", 3, 45, 11, 200, 150, 5, torch.float32)]
    for label, B, T, U, J, V, blank_id, dtype in joint_cases:
        enc, pred, k, b, labels, g_blank, g_emit = joint_inputs(gen, B, T, U, J, V, dev, dtype,
                                                                blank_id)
        with torch.inference_mode():
            fwd = rnnt_joint_fwd(enc, pred, k, b, labels, blank_id)
            torch.cuda.synchronize()
            fwd_ref = joint_blank_emit_ref(enc, pred, k, b, labels, blank_id)
            lse = fwd_ref[2]
            bwd_args = (enc, pred, k, b, labels, lse, g_blank, g_emit, blank_id)
            bwd = rnnt_joint_bwd(*bwd_args)
            torch.cuda.synchronize()
            bwd_ref = joint_blank_emit_bwd_ref(*bwd_args)
            if dtype == torch.float32:
                # f32 contractions of J terms in two orders: 1e-5; gradients
                # are f32 sums over up to B·T·(U+1) = 2.5M rows in two orders,
                # whose round-off grows like √rows ulps of the sum's scale:
                # 1e-4 relative plus 1e-4 of each output's largest value
                err_f = check_close(fwd, fwd_ref, ("blank", "emit", "lse"), 1e-5, 1e-5)
                err_b = check_grads(bwd, bwd_ref, ("d_enc", "d_pred", "d_kernel", "d_bias"),
                                    1e-4, 1e-4)
            else:
                # the same bf16-rounded operands; a value whose f32 round-off
                # straddles a bf16 rounding boundary rounds one step apart
                err_f = check_close(fwd, fwd_ref, ("blank", "emit", "lse"), 2e-3, 2e-3)
                err_b = check_grads(bwd, bwd_ref, ("d_enc", "d_pred", "d_kernel", "d_bias"),
                                    1e-2, 1e-3)
            small = B * T * (U + 1) < 100_000
            ms_f = cuda_ms(lambda: rnnt_joint_fwd(enc, pred, k, b, labels, blank_id),
                           100 if small else 5, graph=small)
            ms_b = cuda_ms(lambda: rnnt_joint_bwd(*bwd_args), 100 if small else 3)
            plain_f = cuda_ms(lambda: joint_blank_emit_ref(enc, pred, k, b, labels, blank_id), 2,
                              warmup=1)
            plain_b = cuda_ms(lambda: joint_blank_emit_bwd_ref(*bwd_args), 2, warmup=1)
        R, es = B * T * (U + 1), torch.finfo(dtype).bits // 8
        inputs = (B * T + B * (U + 1)) * J * es + (J + 1) * V * 4 + B * U * 4
        bound_f, by_f = joint_bound_ms(R, V, J, dtype, inputs + (3 * R - B * T) * 4, False)
        bound_b, by_b = joint_bound_ms(R, V, J, dtype, inputs + (3 * R - B * T) * 4
                                       + (B * T + B * (U + 1)) * J * 4 + (J + 1) * V * 4, True)
        log(f"[K6] {label} (B={B}, T={T}, U={U}, J={J}, V={V}, blank {blank_id}): fwd max|Δ| "
            f"{err_f:.3e}, bwd max|Δ| {err_b:.3e}; K6a {ms_f:.4f} ms (plain {plain_f:.2f}, bound "
            f"{bound_f:.4f} ms {by_f}, {bound_f / ms_f:.1%} of it); K6b {ms_b:.4f} ms (plain "
            f"{plain_b:.2f}, bound {bound_b:.4f} ms {by_b}, {bound_b / ms_b:.1%}); library_ms: none")
        if J <= 128:
            joint_fwd_yardsticks(f"[K6] {label}:", R, V, J, dtype, dev)
        out["K6a " + label] = {"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f,
                               "bound_ms": bound_f, "bound_by": by_f}
        out["K6b " + label] = {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
                               "bound_ms": bound_b, "bound_by": by_b}

    out.update(phase_exact_lattice(dev, gen))
    return out


def exact_chain_floor(blank, emit, t_lens) -> tuple[float | None, float | None, int, str]:
    """K7a's chain floor: the most steps any row's chain takes times the
    latency of one step, measured on row 0 alone (one block on the card) as
    the slope between its whole walk and half of it, each timed over a CUDA
    graph of 100 calls.  A step is an anti-diagonal on the wavefront
    (t_len − 1 + U+1 of them) and a frame on the scan route (t_len).
    Returns (floor ms, ms per step, steps, "diagonals" or "frames"); the
    floor and the step are None where the slope is not positive (a walk too
    short for its halving to show)."""
    T, U1 = blank.shape[1], blank.shape[2]
    one = (blank[:1].contiguous(), emit[:1].contiguous())
    full = torch.full((1,), T, dtype=torch.int32, device=blank.device)
    ms_full, ms_half = (cuda_ms(lambda n=n: rnnt_alpha(*one, n), 100, graph=True)
                        for n in (full, full // 2))
    per_step = (ms_full - ms_half) / (T - T // 2)
    t_max = int(torch.clamp(t_lens, 0, T).max())
    wave = rnnt_lattice.wavefront_route(T, U1)
    n_steps, unit = (t_max - 1 + U1, "diagonals") if wave else (t_max, "frames")
    if per_step <= 0:
        return None, None, n_steps, unit
    return n_steps * per_step, per_step, n_steps, unit


def phase_exact_lattice(dev, gen=None) -> dict:
    """Phase 8's K7a/K7b: against their plain versions at the RNN-T training
    shape (B=32, T=1598, U=48), a ragged shape with a t_len = 0 row, U=128
    (five cells a lane) and U+1 > 1024 (the scan route), with times, the
    byte bound, plain times, the chain floor and the count of live values
    unlike the plain versions'."""
    gen = gen or torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    for label, B, T, U in (("training", 32, 1598, 48), ("ragged", 4, 45, 11),
                           ("U=128", 32, 1598, 128), ("U+1 > 1024", 4, 400, 1100)):
        blank = torch.log_softmax(torch.randn((B, T, U + 1, 2), generator=gen, device=dev), -1)[..., 0]
        emit = torch.log_softmax(torch.randn((B, T, U, 2), generator=gen, device=dev), -1)[..., 0]
        blank, emit = blank.contiguous(), emit.contiguous()
        t_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        u_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
        t_lens[1] = T - T // 7
        u_lens[1] = U - U // 4
        u_lens[2] = 0
        if label == "ragged":
            t_lens[3] = 0                       # no frame: the start state and the base
        with torch.inference_mode():
            a, bt = rnnt_alpha(blank, emit, t_lens), rnnt_beta(blank, emit, t_lens, u_lens)
            torch.cuda.synchronize()
            a_ref, b_ref = rnnt_alpha_ref(blank, emit, t_lens), rnnt_beta_ref(blank, emit, t_lens,
                                                                                u_lens)
            # the plain versions take the wavefront's operations (no live
            # value unlike theirs with the accurate log-sum-exp); the scan
            # route rounds f32 chains of values ~T·log 2 in another order,
            # whose round-off grows like √T ulps of them
            err_a = check_lattice(a, a_ref, 2e-5, 1e-5)
            err_b = check_lattice(bt, b_ref, 2e-5, 1e-5)
            n_unlike = sum(int((x != y)[y > -1e29].sum()) for x, y in ((a, a_ref), (bt, b_ref)))
            ms_a = cuda_ms(lambda: rnnt_alpha(blank, emit, t_lens), 20)
            ms_b = cuda_ms(lambda: rnnt_beta(blank, emit, t_lens, u_lens), 20)
            plain_a = cuda_ms(lambda: rnnt_alpha_ref(blank, emit, t_lens), 2, warmup=1)
            plain_b = cuda_ms(lambda: rnnt_beta_ref(blank, emit, t_lens, u_lens), 2, warmup=1)
            floor, per_step, n_steps, unit = exact_chain_floor(blank, emit, t_lens)
        U1 = U + 1
        nbytes = B * T * (2 * U1 + U) * 4 + 2 * B * 4
        bound, bound_by = bytes_bound_ms(nbytes, RNNT_LATTICE_OPS_PER_STATE * B * T * U1)
        route = "wavefront" if rnnt_lattice.wavefront_route(T, U1) else "scan"
        chain = (f"{floor:.4f} ms ({n_steps} {unit} × {per_step * 1e6:.1f} ns, measured on one row)"
                 if floor is not None else f"not measured ({n_steps} {unit}: too short a walk)")
        log(f"[K7] {label} (B={B}, T={T}, U={U}; the {route} route): α max|Δ| {err_a:.3e}, β "
            f"max|Δ| {err_b:.3e} ({n_unlike} live values unlike the plain versions'); K7a "
            f"{ms_a:.4f} ms, K7b {ms_b:.4f} ms (plain {plain_a:.2f} / "
            f"{plain_b:.2f} ms), bound {bound:.4f} ms each ({bound_by}); chain floor {chain}; "
            f"library_ms: none")
        for name, err, ms, plain in (("K7a", err_a, ms_a, plain_a), ("K7b", err_b, ms_b, plain_b)):
            out[f"{name} {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                      "bound_ms": bound, "bound_by": bound_by,
                                      "chain_floor_ms": floor, "unlike": n_unlike}
    return out


def check_equal_or_bf16_step(got, want, name) -> float:
    """f32: raise unless ``got`` is ``want`` bit for bit (the kernel and the
    plain version do the same operations, each rounded once, in the same
    order); bf16: unless every |Δ| ≤ one bf16 step of |want| (both round the
    same f32 carry once, which may differ by f32 round-off).  Returns the
    largest |Δ|."""
    if got.dtype == torch.float32:
        if not torch.equal(got, want):
            d = (got - want).abs()
            raise AssertionError(f"{name}: f32 differs from its plain version in "
                                 f"{int((got != want).sum())} elements, max |Δ| "
                                 f"{d.max().item():.3e}")
        return 0.0
    return check_close([got], [want], [name], 2.0 ** -7, 1e-6)


def offset_copy(x):
    """A copy of x whose storage starts one element past its allocation, so
    that its rows no longer start on 16 bytes (a kernel's narrower copy
    units)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


# The ring's edges (K5a, K5b and K11: tiles of 32 steps, 4 stages, 32 f32 /
# 64 bf16 columns a block; K12: tiles of 12 steps, 3 stages, 64 columns):
# (B, T, D, dtype, inputs offset by one element)
K5A_EDGES = [(2, 1, 512, torch.float32, False), (2, 33, 100, torch.float32, False),
             (2, 129, 520, torch.float32, False), (1, 32, 512, torch.float32, True),
             (2, 31, 101, torch.bfloat16, False), (2, 65, 520, torch.bfloat16, True)]
K5B_EDGES = [(2, 1, 512, torch.float32, False), (2, 33, 100, torch.float32, False),
             (2, 127, 520, torch.float32, False), (1, 32, 512, torch.float32, True),
             (2, 31, 101, torch.bfloat16, False), (2, 129, 520, torch.bfloat16, True)]
K11_EDGES = [(2, 1, 512, torch.float32, False), (2, 33, 100, torch.float32, False),
             (2, 127, 520, torch.float32, False), (1, 32, 512, torch.float32, True),
             (2, 31, 101, torch.bfloat16, False), (2, 129, 520, torch.bfloat16, True)]
K12_EDGES = [(2, 1, 512, torch.float32, False), (2, 13, 100, torch.float32, False),
             (2, 37, 520, torch.float32, False), (1, 32, 512, torch.float32, True),
             (2, 11, 101, torch.bfloat16, False), (2, 37, 520, torch.bfloat16, True)]


def phase_scan_kernels(dev) -> dict:
    """Phase 11: K5a and K5b against their plain versions at the flagship's
    cell shape (B=32, T=1598, D=512), f32 and bf16, with times, the byte
    bound (two planes read, one written) and plain times: both bit for bit
    in f32 and to one bf16 step in bf16, also at the edges of their ring
    (``K5A_EDGES``, ``K5B_EDGES``), and K5a's time at the streaming shape
    (B=1, T=32, from a CUDA graph)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {}
    B, T, D = 32, 1598, 512
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.sigmoid(torch.randn((B, T, D), generator=gen, device=dev) + 2.0).to(dtype)
        b = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
        g = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
        s0 = torch.randn((B, D), generator=gen, device=dev)
        label = "f32" if dtype == torch.float32 else "bf16"
        with torch.inference_mode():
            for name, fn, ref, args in (("K5a", linear_scan_fwd, linear_scan_ref, (a, b, s0)),
                                        ("K5b", linear_scan_rev, linear_scan_rev_ref, (a, g))):
                got = fn(*args)
                torch.cuda.synchronize()
                want = ref(*args)
                err = check_equal_or_bf16_step(got, want, f"{name} {label}")
                ms = cuda_ms(lambda: fn(*args), 50)
                plain_ms = cuda_ms(lambda: ref(*args), 2, warmup=1)
                es = torch.finfo(dtype).bits // 8
                nbytes = 3 * B * T * D * es + (B * D * 4 if name == "K5a" else 0)
                bound, bound_by = bytes_bound_ms(nbytes, 2 * B * T * D)
                log(f"[K5] {name} {label} (B={B}, T={T}, D={D}): max|Δ| {err:.3e}  kernel "
                    f"{ms:.4f} ms  plain {plain_ms:.2f} ms  bound {bound:.4f} ms ({bound_by}, "
                    f"{bound / ms:.1%} of it)  library_ms: none")
                out[f"{name} {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                          "bound_ms": bound, "bound_by": bound_by}
        del a, b, g
    worst = {"K5a": 0.0, "K5b": 0.0}
    for name, edges in (("K5a", K5A_EDGES), ("K5b", K5B_EDGES)):
        for B, T, D, dtype, offset in edges:
            a = torch.sigmoid(torch.randn((B, T, D), generator=gen, device=dev) + 2.0).to(dtype)
            b = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
            if offset:
                a, b = offset_copy(a), offset_copy(b)
            s0 = torch.randn((B, D), generator=gen, device=dev)
            with torch.inference_mode():
                got = linear_scan_fwd(a, b, s0) if name == "K5a" else linear_scan_rev(a, b)
                torch.cuda.synchronize()
                want = linear_scan_ref(a, b, s0) if name == "K5a" else linear_scan_rev_ref(a, b)
                worst[name] = max(worst[name], check_equal_or_bf16_step(
                    got, want, f"{name} at (B={B}, T={T}, D={D}, {dtype}"
                    f"{', offset' if offset else ''})"))
    a = torch.sigmoid(torch.randn((1, 32, 512), generator=gen, device=dev) + 2.0)
    b = torch.randn((1, 32, 512), generator=gen, device=dev)
    s0 = torch.randn((1, 512), generator=gen, device=dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: linear_scan_fwd(a, b, s0), 200, graph=True)
    log(f"[K5] K5a streaming f32 (B=1, T=32, D=512): kernel {ms:.4f} ms (CUDA graph)")
    for name, edges in (("K5a", K5A_EDGES), ("K5b", K5B_EDGES)):
        log(f"[K5] {name} at the ring's edges ({len(edges)} shapes: T = 1, a tile ± 1, ragged "
            f"and odd D, B = 1, offset inputs): f32 bit for bit, bf16 max|Δ| "
            f"{worst[name]:.3e}")
    return out


def band_problem(gen, B, T, U, J, V, band, Tb, dev, dtype):
    """``joint_inputs`` with ragged lengths (row 1 shorter, row 2 with fewer
    labels), the default band's offsets and cotangents of the banded tables'
    size."""
    enc, pred, k, b, labels, _, _ = joint_inputs(gen, B, T, U, J, V, dev, dtype, 0)
    t_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    u_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
    t_lens[1] = T - T // 7
    u_lens[2] = U - U // 3
    Wp = band_width(band, U + 1, Tb)
    Tp = -(-T // Tb) * Tb
    o = band_offsets(t_lens, u_lens, Tp, -(-max(U + 1, Wp) // 8) * 8, Wp, Tb)
    g_blank = torch.rand((B, Tp, Wp), generator=gen, device=dev) / Wp
    g_emit = torch.rand((B, Tp, Wp), generator=gen, device=dev) / Wp
    return enc, pred, k, b, labels, t_lens, u_lens, o, Wp, Tp, g_blank, g_emit


def band_diagonals(o, t_lens, Tp: int, Wp: int, Tb: int) -> torch.Tensor:
    """(B,) anti-diagonals the wavefront walks in each row: from f(0) to
    f(t_last) + Wp − 1, f(t) = t + o(t)."""
    last = torch.clamp(t_lens.to(torch.int64), 1, Tp) - 1
    rows = torch.arange(o.shape[0], device=o.device)
    o64 = o.to(torch.int64)
    return last + o64[rows, last // Tb] + Wp - o64[:, 0]


def band_chain_floor(blank_b, emit_b, o, t_lens, Tb: int) -> tuple[float, float, int]:
    """The banded α's chain floor: the most diagonals any row walks times the
    latency of one diagonal, measured on row 0 alone (one warp on the card)
    as the slope between its whole walk and half of it.  Returns (floor ms,
    ms per diagonal, diagonals)."""
    _, Tp, Wp = blank_b.shape
    one = (blank_b[:1].contiguous(), emit_b[:1].contiguous(), o[:1].contiguous())
    full = torch.full((1,), Tp, dtype=torch.int32, device=o.device)
    half = full // 2
    n_full, n_half = (int(band_diagonals(one[2], t, Tp, Wp, Tb)[0]) for t in (full, half))
    ms_full, ms_half = (cuda_ms(lambda t=t: rnnt_band_alpha(*one, t, Tb), 20) for t in (full, half))
    per_diag = (ms_full - ms_half) / (n_full - n_half)
    n_diag = int(band_diagonals(o, t_lens, Tp, Wp, Tb).max())
    return n_diag * per_diag, per_diag, n_diag


def band_lattice_bench_shapes(gen, J: int, V: int, dev) -> dict:
    """The banded α/β at bench.py's RNN-T rows (B=96, T=1598, U=64 and
    U=128, band 32) on K8a's f32 tables: held against their plain versions,
    timed beside the byte bound and the chain floor."""
    out = {}
    B, T, band, Tb = 96, 1598, 32, 8
    for U in (64, 128):
        enc, pred, k, b, labels, t_lens, u_lens, o, Wp, Tp, *_ = band_problem(
            gen, B, T, U, J, V, band, Tb, dev, torch.float32)
        with torch.inference_mode():
            blank_b, emit_b, _ = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb)
            del enc, pred
            a = rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb)
            bt = rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb)
            torch.cuda.synchronize()
            err_a = check_lattice(a, rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, Tb), 2e-5,
                                  1e-5)
            err_bt = check_lattice(bt, rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, Tb),
                                   2e-5, 1e-5)
            ms_a = cuda_ms(lambda: rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb), 20)
            ms_bt = cuda_ms(lambda: rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb), 20)
            floor, per_diag, n_diag = band_chain_floor(blank_b, emit_b, o, t_lens, Tb)
        R = B * Tp * Wp
        bound, bound_by = bytes_bound_ms(3 * R * 4 + o.numel() * 4 + 2 * B * 4,
                                         RNNT_LATTICE_OPS_PER_STATE * R)
        log(f"[band lattice] bench.py's shape (B={B}, T={T}, U={U}, band {band}: Tp={Tp}, "
            f"Wp={Wp}): α max|Δ| {err_a:.3e}, β max|Δ| {err_bt:.3e}; α {ms_a:.4f} ms, β "
            f"{ms_bt:.4f} ms, bound {bound:.4f} ms each ({bound_by}); chain floor {floor:.4f} "
            f"ms ({n_diag} diagonals × {per_diag * 1e6:.1f} ns, measured on one row)")
        for name, ms, err in (("alpha", ms_a, err_a), ("beta", ms_bt, err_bt)):
            out[f"band {name} B=96 U={U}"] = {"max_abs_err": err, "ms": ms, "bound_ms": bound,
                                             "bound_by": bound_by, "chain_floor_ms": floor}
    return out


def phase_band_kernels(dev) -> dict:
    """Phase 13: K8a/K8b and the banded lattice against their plain versions
    at the banded training shape (B=32, T=1598, U=128, band 32: Wp=48,
    Tp=1600; J=64, V=1024; f32, and bf16 for K8), with times, bounds and
    plain times; K8 also at J = 640 (the tiled products; f32 and bf16 at
    the training shape) and at a ragged J = 200; the banded lattice also at
    bench.py's B=96 (U=64 and 128), with its chain floor beside its byte
    bound; and the identity: with band ≥ U+1 the banded loss and its
    gradients equal the exact loss through K6/K7."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out = {}
    Tb = 8
    cases = [("f32", 32, 1598, 128, 64, 1024, 32, torch.float32),
             ("bf16", 32, 1598, 128, 64, 1024, 32, torch.bfloat16),
             ("J=640 f32", 32, 1598, 128, 640, 1024, 32, torch.float32),
             ("J=640 bf16", 32, 1598, 128, 640, 1024, 32, torch.bfloat16),
             ("J=200 ragged f32", 3, 45, 40, 200, 150, 8, torch.float32)]
    for label, B, T, U, J, V, band, dtype in cases:
        enc, pred, k, b, labels, t_lens, u_lens, o, Wp, Tp, g_blank, g_emit = band_problem(
            gen, B, T, U, J, V, band, Tb, dev, dtype)
        with torch.inference_mode():
            fwd = rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb)
            torch.cuda.synchronize()
            fwd_ref = joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp, Tb)
            bwd_args = (enc, pred, k, b, labels, o, fwd_ref[2], g_blank, g_emit, Tb)
            bwd = rnnt_band_bwd(*bwd_args)
            torch.cuda.synchronize()
            bwd_ref = joint_blank_emit_banded_bwd_ref(*bwd_args)
            names = ("d_enc", "d_pred", "d_kernel", "d_bias")
            if dtype == torch.float32:
                # K6's tolerances: f32 contractions in two orders; gradient
                # sums over 2.5M rows
                err_f = check_close(fwd, fwd_ref, ("blank", "emit", "lse"), 1e-5, 1e-5)
                err_b = check_grads(bwd, bwd_ref, names, 1e-4, 1e-4)
            else:
                err_f = check_close(fwd, fwd_ref, ("blank", "emit", "lse"), 2e-3, 2e-3)
                err_b = check_grads(bwd, bwd_ref, names, 1e-2, 1e-3)
            ms_f = cuda_ms(lambda: rnnt_band_fwd(enc, pred, k, b, labels, o, Wp, Tb), 5)
            ms_b = cuda_ms(lambda: rnnt_band_bwd(*bwd_args), 3)
            plain_f = cuda_ms(lambda: joint_blank_emit_banded_ref(enc, pred, k, b, labels, o, Wp,
                                                                  Tb), 2, warmup=1)
            plain_b = cuda_ms(lambda: joint_blank_emit_banded_bwd_ref(*bwd_args), 2, warmup=1)
        R, es = B * Tp * Wp, torch.finfo(dtype).bits // 8
        inputs = (B * T + B * (U + 1)) * J * es + (J + 1) * V * 4 + B * U * 4 + o.numel() * 4
        bound_f, by_f = joint_bound_ms(R, V, J, dtype, inputs + 3 * R * 4, False)
        bound_b, by_b = joint_bound_ms(R, V, J, dtype, inputs + 3 * R * 4
                                       + (B * T + B * (U + 1)) * J * 4 + (J + 1) * V * 4, True)
        log(f"[K8] {label} (B={B}, T={T}, U={U}, band {band}: Wp={Wp}, Tp={Tp}; J={J}, V={V}): "
            f"fwd max|Δ| {err_f:.3e}, bwd max|Δ| {err_b:.3e}; K8a {ms_f:.4f} ms (plain "
            f"{plain_f:.2f}, bound {bound_f:.4f} ms {by_f}, {bound_f / ms_f:.1%} of it); K8b "
            f"{ms_b:.4f} ms (plain {plain_b:.2f}, bound {bound_b:.4f} ms {by_b}, "
            f"{bound_b / ms_b:.1%}); library_ms: none")
        if J <= 128:
            joint_fwd_yardsticks(f"[K8] {label}:", R, V, J, dtype, dev)
        out["K8a " + label] = {"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f,
                               "bound_ms": bound_f, "bound_by": by_f}
        out["K8b " + label] = {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
                               "bound_ms": bound_b, "bound_by": by_b}
        if label != "f32":
            continue
        # the banded lattice on the forward's own tables
        blank_b, emit_b = fwd[0].contiguous(), fwd[1].contiguous()
        with torch.inference_mode():
            a = rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb)
            bt = rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb)
            torch.cuda.synchronize()
            a_ref = rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, Tb)
            b_ref = rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, Tb)
            # as K7: chains of T frames of log-sum-exp scans in two orders
            err_a = check_lattice(a, a_ref, 2e-5, 1e-5)
            err_bt = check_lattice(bt, b_ref, 2e-5, 1e-5)
            ms_a = cuda_ms(lambda: rnnt_band_alpha(blank_b, emit_b, o, t_lens, Tb), 20)
            ms_bt = cuda_ms(lambda: rnnt_band_beta(blank_b, emit_b, o, t_lens, u_lens, Tb), 20)
            plain_a = cuda_ms(lambda: rnnt_band_alpha_ref(blank_b, emit_b, o, t_lens, Tb), 1,
                              warmup=1)
            plain_bt = cuda_ms(lambda: rnnt_band_beta_ref(blank_b, emit_b, o, t_lens, u_lens, Tb),
                               1, warmup=1)
        nbytes = 3 * R * 4 + o.numel() * 4 + 2 * B * 4
        bound, bound_by = bytes_bound_ms(nbytes, RNNT_LATTICE_OPS_PER_STATE * R)
        floor, per_diag, n_diag = band_chain_floor(blank_b, emit_b, o, t_lens, Tb)
        log(f"[band lattice] (B={B}, Tp={Tp}, Wp={Wp}): α max|Δ| {err_a:.3e}, β max|Δ| "
            f"{err_bt:.3e}; α {ms_a:.4f} ms, β {ms_bt:.4f} ms (plain {plain_a:.2f} / "
            f"{plain_bt:.2f} ms), bound {bound:.4f} ms each ({bound_by}); chain floor "
            f"{floor:.4f} ms ({n_diag} diagonals × {per_diag * 1e6:.1f} ns, measured on one "
            f"row); library_ms: none")
        out["band alpha"] = {"max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
                             "bound_ms": bound, "bound_by": bound_by, "chain_floor_ms": floor}
        out["band beta"] = {"max_abs_err": err_bt, "ms": ms_bt, "plain_ms": plain_bt,
                            "bound_ms": bound, "bound_by": bound_by, "chain_floor_ms": floor}
        out.update(band_lattice_bench_shapes(gen, J, V, dev))

    # identity: a band of at least U+1 covers the lattice, so the banded loss
    # is the exact one.  The exact loss's occupancies divide by the forward's
    # single Z (as the JAX kernel's backward does), so each frame's sum to
    # 1 ± δ, δ the drift between its α's and β's f32 round-off; the banded
    # ones divide by each frame's own Z_t.  The gradients agree within δ of
    # their scale, plus the K6 tolerances.
    B, T, U, J, V = 8, 400, 64, 64, 1024
    enc, pred, k, b, labels, t_lens, u_lens, *_ = band_problem(gen, B, T, U, J, V, U + 1, Tb, dev,
                                                               torch.float32)
    with torch.inference_mode():
        blank, emit, _ = rnnt_joint_fwd(enc, pred, k, b, labels)
        a, bt = rnnt_alpha(blank, emit, t_lens), rnnt_beta(blank, emit, t_lens, u_lens)
        occ, _ = rnnt_lattice.occupancy_grads(
            blank, emit, t_lens, u_lens, a, bt,
            rnnt_lattice.nll_from_alpha(a, blank, t_lens, u_lens),
            torch.ones_like(t_lens, dtype=torch.float32))
        active = torch.arange(blank.shape[1], device=dev)[None, :] < t_lens[:, None]
        drift = (occ.sum(2) + 1.0)[active].abs().max().item()
    res = []
    for fn in (lambda *xs: rnnt_loss_banded(*xs, band=U + 1), rnnt_loss_pallas):
        xs = [x.clone().requires_grad_() for x in (enc, pred, k, b)]
        loss = fn(*xs, labels, t_lens, u_lens)
        loss.backward()
        res.append((loss.item(), [x.grad for x in xs]))
    d_loss = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    if d_loss > 1e-5:
        raise AssertionError(f"full band vs exact loss: {res[0][0]} vs {res[1][0]}")
    err = check_grads(res[0][1], res[1][1], ("d_enc", "d_pred", "d_kernel", "d_bias"), 1e-4,
                      1e-4 + drift)
    log(f"[K8] band {U + 1} ≥ U+1 (B={B}, T={T}, U={U}): banded loss {res[0][0]:.6f}, exact "
        f"(K6/K7) {res[1][0]:.6f} (rel {d_loss:.2e}); gradients max|Δ| {err:.3e} (the exact "
        f"occupancies' per-frame drift δ {drift:.2e})")
    return out


def rnnt_model(cfg, dev):
    """The flagship in RNN-T mode with randomize_'s weights; the join kernel
    is widened to N(0, 4/J) (randomize_ scales it by the vocab's width, which
    leaves the logits within ~0.1 of each other).  Phase 10 conditions the
    projections and the blank bias further (``condition_joiner``)."""
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "rnnt", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    with torch.no_grad():
        jk = model.joiner.join_kernel
        jk.mul_(2.0 * (jk.shape[1] / jk.shape[0]) ** 0.5 / 0.5)
    return model.eval()


def offline_rnnt(model, enc_p, dev):
    """Offline greedy decode of join-space frames ``enc_p`` (1, T, J): the
    tokens of one call over all frames, and each frame's number of
    emissions from a frame-by-frame decode carrying the state (whose tokens
    must be the same)."""
    with torch.inference_mode():
        tables = [t.float() for t in model.rnnt_decode_tables()]
        T = enc_p.shape[1]
        st = rnnt_greedy_decode(enc_p, *tables, torch.tensor([T], device=dev), blank_id=0,
                                max_out=4 * T)
        one, step, lens = torch.ones(1, dtype=torch.int32, device=dev), None, []
        for t in range(T):
            step = rnnt_greedy_decode(enc_p[:, t:t + 1], *tables, one, blank_id=0, max_out=4 * T,
                                      init_state=step)
            lens.append(step.out_len)
        counts = torch.diff(torch.cat(lens), prepend=torch.zeros(1, dtype=torch.int32,
                                                                   device=dev)).cpu().numpy()
    tokens = rnnt_state_to_lists(st)[0]
    if rnnt_state_to_lists(step)[0] != tokens:
        raise AssertionError("the frame-by-frame offline decode differs from the one-shot one")
    return tokens, counts


def encode_rnnt(model, cfg, audio, dev):
    """``audio``'s frames in the join space, encoded in one shot."""
    with torch.inference_mode():
        feats = compute_features(torch.from_numpy(audio[None]).to(dev), cfg.frontend)
        enc_out, _ = model(feats, None, None)
        return model.rnnt_project_encoder(enc_out).float()


def condition_joiner(model, cfg, streams, dev, share: float = 0.6) -> float:
    """Make the greedy decode of ``streams`` emit varied labels and end a
    share of its frames with blank.  randomize_'s projections leave the join
    space dominated by a constant: one label wins every decision, blank none, and
    each frame emits max_symbols tokens.  Here the encoder projection is
    centred over the streams' frames and scaled to a spread of 3 per unit, the
    predictor's over the vocabulary to a spread of 1, and join_bias[blank] is
    raised to the ``share`` quantile of the best label's margin over blank
    (over the frames × 64 random contexts).  Returns that raise."""
    joiner = model.joiner
    with torch.inference_mode():
        pred_table = model.rnnt_decode_tables()[0].float()
    with torch.no_grad():
        enc_p = torch.cat([encode_rnnt(model, cfg, a, dev)[0] for a in streams])
        for proj, x, spread in ((joiner.enc_proj, enc_p, 3.0), (joiner.pred_proj, pred_table, 1.0)):
            scale = spread / x.std(0)
            proj.bias.copy_((proj.bias - x.mean(0)) * scale)
            proj.weight.mul_(scale[:, None])
    enc_p = torch.cat([encode_rnnt(model, cfg, a, dev)[0] for a in streams])
    with torch.inference_mode():
        pred_table, jk, jb = (t.float() for t in model.rnnt_decode_tables())
        ctx = torch.randperm(pred_table.shape[0], generator=torch.Generator().manual_seed(SEED))
        logits = torch.tanh(enc_p[:, None] + pred_table[ctx[:64].to(dev)][None]) @ jk + jb
        others = logits.clone()
        others[..., 0] = -torch.inf
        margin = others.amax(-1) - logits[..., 0]
        shift = torch.quantile(margin.flatten(), share).item()
    with torch.no_grad():
        joiner.join_bias[0] += shift
    return shift


def phase_rnnt_streaming(model, cfg, dev) -> int:
    """Phase 10: three ~10 s streams through StreamingRecognizer(decoder=
    "rnnt").  The streamed tokens must equal an offline greedy decode of the
    same join-space frames (those the recognizer decoded, chunk by chunk),
    and be within 1 % edit distance of the decode of a one-shot encoding of
    the audio (the chunked encoder's round-off can flip a near-tie).  The
    offline decode must end at least a fifth of its frames with blank at
    once, emit 1 to 3 tokens in at least 1 % of them, and average at most 2
    tokens per frame (of max_symbols 4), so that blank ends frames and the
    emissions per frame vary across chunk and drain boundaries."""
    rng = np.random.default_rng(SEED + 10)
    streams = [synth_audio(rng, 1, 160000 + int(rng.integers(0, 8000)))[0] for _ in range(3)]
    shift = condition_joiner(model, cfg, streams, dev)
    log(f"[rnnt streaming] join_bias[blank] raised by {shift:.3f}")
    warm = StreamingRecognizer(model, cfg, chunk_frames=32, decoder="rnnt", device=dev)
    warm.accept_waveform(streams[0][:16000])                   # warm-up, not counted

    latencies, results, decoded = [], [], []
    lucy_cell_fused_lm.launches = 0
    for audio in streams:
        rec = StreamingRecognizer(model, cfg, chunk_frames=32, decoder="rnnt", device=dev)
        step, advance, frames = rec._step_chunk, rec._advance_rnnt, []

        def timed(chunk, step=step):
            t0 = time.perf_counter()
            step(chunk)
            torch.cuda.synchronize()                            # the decode state is on the card
            latencies.append(time.perf_counter() - t0)

        def kept(enc_p, advance=advance, frames=frames):
            frames.append(enc_p.clone())
            advance(enc_p)

        rec._step_chunk, rec._advance_rnnt = timed, kept
        pos = 0
        while pos < len(audio):
            n = int(rng.integers(100, 8000))
            rec.accept_waveform(audio[pos:pos + n])
            pos += n
        rec.finish()
        results.append(rec.tokens)
        decoded.append(torch.cat(frames, dim=1))
    launches = lucy_cell_fused_lm.launches
    if launches == 0:
        raise AssertionError("the RNN-T streaming path launched no fused-cell kernel")

    for k, (audio, toks, enc_p) in enumerate(zip(streams, results, decoded)):
        want, counts = offline_rnnt(model, enc_p, dev)
        one_shot = encode_rnnt(model, cfg, audio, dev)
        if one_shot.shape != enc_p.shape:
            raise AssertionError(f"stream {k}: {enc_p.shape[1]} frames streamed, "
                                 f"{one_shot.shape[1]} in one shot")
        whole, _ = offline_rnnt(model, one_shot, dev)
        hist = np.bincount(counts, minlength=5)
        dist = levenshtein(toks, whole)
        log(f"[rnnt streaming] stream {k}: {len(audio) / 16000:.2f} s, {len(toks)} tokens "
            f"streamed, {len(want)} offline on the same frames, {len(whole)} on the one-shot "
            f"encoding (edit distance {dist}); frames by emissions 0-4: {hist.tolist()}, "
            f"{len(want) / len(counts):.3f} tokens per frame")
        if not want or toks != want:
            raise AssertionError(f"stream {k}: streamed tokens differ from the offline decode "
                                 f"of the same frames (edit distance {levenshtein(toks, want)})")
        if dist > 0.01 * len(whole):
            raise AssertionError(f"stream {k}: edit distance {dist} to the one-shot decode")
        if hist[0] < 0.2 * len(counts) or hist[1:4].sum() < 0.01 * len(counts) \
                or len(want) > 2 * len(counts):
            raise AssertionError(f"stream {k}: the decode does not exercise blank (frames by "
                                 f"emissions {hist.tolist()})")
    lat = np.asarray(latencies) * 1e3
    log(f"[rnnt streaming] {len(lat)} chunks of 32 frames (320 ms): latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms; "
        f"fused-cell launches {launches}")
    return launches


def phase_cli_rnnt(seconds=48.0, target=16, extra=(), tag="[cli rnnt]") -> tuple:
    """Phase 16: the CLI trains RNN-T for two dispatches on a generated
    fixture (~100 characters per 16 s segment: the default band), with
    ``extra`` overrides.  Returns (the run's directory, the CLI's model and
    data overrides)."""
    shutil.rmtree(WORK, ignore_errors=True)
    data = write_cli_fixture(WORK, seconds=seconds, cue=target / 4)
    t0 = time.perf_counter()
    common = ["--model.encoder", "lucyrnn", "--data.source", "local",
              "--data.local_dir", data, "--data.target_duration", str(target),
              "--data.batch_size", "4", "--data.num_workers", "4",
              "--train.segments_per_dispatch", "1", "--train.log_every_n", "2",
              "--train.mode", "rnnt", *extra]
    summary = run_cli(common + ["--train.steps", "2",
                                "--train.model_dir", os.path.join(WORK, "rnnt")])
    if summary["global_step"] != 2 or len(summary["loss_history"]) != 2:
        raise AssertionError(f"RNN-T CLI run: step {summary['global_step']}, "
                             f"losses {summary['loss_history']}")
    log(f"{tag} 4 recordings × {seconds:g} s, {target} s segments: losses "
        f"{[round(x, 4) for x in summary['loss_history']]} ({time.perf_counter() - t0:.1f} s)")
    return summary["run_dir"], common


def mlstm_ops(B, H, Tp, L, dqk, dv, backward: bool) -> tuple[float, float]:
    """Operations of K9a/K10 (forward) or K9b over B·H heads and Tp/L chunks,
    two per multiply-add, as (the products of two inputs, the products of an
    input and an f32 value): the causal halves of the L × L products (L(L+1)/2
    pairs; forward q·kᵀ of inputs and (S∘E)·v; backward q·kᵀ and dh·vᵀ of
    inputs, Q·k, Qᵀ·q and Wᵀ·dh) and the full L × dqk × dv ones (forward q·C
    and (k·w)ᵀ·v; backward the entry states' (k·w)ᵀ·v, C·dh, dC'·v, dC'ᵀ·k and
    (q·sp/den)ᵀ·dh).  Every product has an input (q, k, v or dh) for an
    operand; the scales can go on the other operand or after the product.
    The exps, the running max and the row sums (O(L²) per chunk) are left
    out."""
    tri, n = L * (L + 1) // 2, B * H * (Tp // L)
    if backward:
        return n * 2 * tri * (dqk + dv), n * (2 * tri * (2 * dqk + dv) + 5 * 2 * L * dqk * dv)
    return n * 2 * tri * dqk, n * (2 * tri * dv + 2 * 2 * L * dqk * dv)


def mlstm_bound_ms(B, H, Tp, L, dqk, dv, dtype, backward: bool) -> tuple[float, str]:
    """The least time of K9a/K10 or K9b: the larger of their bytes over the
    memory rate and their products at the tensor cores' rate for the accuracy
    the contract asks of each, as the joint's (joint_bound_ms).  f32 inputs:
    every product as three TF32 products (3xTF32: a third of the TF32 rate).
    bf16 inputs: the products of two inputs at bf16's rate; those of an input
    and an f32 value as two TF32 products (bf16 is exact in TF32, so the
    input needs no low half: half the TF32 rate)."""
    es = torch.finfo(dtype).bits // 8
    ops_in, ops_mixed = mlstm_ops(B, H, Tp, L, dqk, dv, backward)
    if dtype == torch.bfloat16:
        t_ops = (ops_in / BF16_OPS_PER_S + ops_mixed / (TF32_OPS_PER_S / 2)) * 1e3
    else:
        t_ops = (ops_in + ops_mixed) / (TF32_OPS_PER_S / 3) * 1e3
    t_bytes = mlstm_bytes(B, H, Tp, dqk, dv, es, backward) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlstm_bytes(B, H, Tp, dqk, dv, es, backward: bool) -> int:
    """Each input read once, each output written once: q, k, v (and dh, dq,
    dk, dv) in the model dtype, the gates (and their adjoints), the states."""
    states = B * H * (dqk * dv + dqk + 1) * 4
    lanes = B * Tp * H * (2 * dqk + dv) * es
    plane = B * Tp * H * dv * es                         # h or dh
    if backward:
        return 2 * lanes + plane + 4 * B * H * Tp * 4 + 3 * states
    return lanes + plane + 2 * B * H * Tp * 4 + 2 * states


def mlstm_inputs(gen, B, T, H, dqk, dv, L, dtype, dev):
    """K9's inputs: lane-major q, k, v (unit-half normal) in ``dtype``, the
    soft-capped gates of raw N(0, 1) (input) and N(0.5, 1) (forget) values,
    padded with random rows to the chunk multiple, and a nonzero carry."""
    Tp = -(-T // L) * L
    r = lambda *shape: 0.5 * torch.randn(shape, generator=gen, device=dev)
    q, k, v = (r(B, Tp, H * d).to(dtype) for d in (dqk, dqk, dv))
    i_c = soft_cap(2.0 * r(B, H, Tp), 15.0)
    logf = torch.nn.functional.logsigmoid(soft_cap(2.0 * r(B, H, Tp) + 1.0, 15.0))
    return [q, k, v, i_c, logf, 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(),
            0.1 * r(B, H)], Tp


def check_scaled(got, want, names, tol) -> float:
    """Raise unless each output's max |Δ| ≤ tol · its largest value; returns
    the largest absolute error."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        d = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if d > tol * scale or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: max |Δ| {d:.3e} > {tol:g}·{scale:.3e}")
        worst = max(worst, d)
    return worst


def device_ms_by_kernel(fn) -> list[tuple[str, float]]:
    """Device time (ms) of each CUDA kernel of one call of ``fn``, from
    ``torch.profiler``, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda kv: -kv[1])


def log_by_kernel(tag: str, fn) -> None:
    """Log ``device_ms_by_kernel(fn)``, each kernel by its short name."""
    short = lambda k: re.sub(r"^void |\(.*$", "", k.replace("(anonymous namespace)::", ""))
    rows = [(short(k)[:70], v) for k, v in device_ms_by_kernel(fn)]
    log(f"{tag} by CUDA kernel (ms, torch.profiler): "
        + "; ".join(f"{k} {v:.4f}" for k, v in rows) + f"; sum {sum(v for _, v in rows):.4f}")


def phase_mlstm_kernels(dev) -> dict:
    """Phase 17: K9a/K9b and K10 against their plain versions, with times,
    bounds and plain times, and the forward's device time by CUDA kernel, at
    E=512's heads (dqk 128, dv 256; chunk 128 and bench.py's 256), at
    E=2048's (dqk 512, dv 1024, chunk 128) and at chunk 512;
    K9a also at the streaming shape (B=1, one chunk of 32 steps).  The
    forward within 1e-4 of each output's scale in f32 (f32 sums in other
    orders); the gradients within 1e-3 relative plus 1e-4 of each output's
    largest value (as for K8).  Under bf16 both versions compute in f32 from
    the same bf16 values and round h, dq, dk, dv once: those to 2e-2 of their
    scale (h) and 2e-2 relative plus 1e-3 (gradients), the f32 outputs as in
    f32."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    out = {}
    H, dqk, dv, T = 2, 128, 256, 1598
    fwd_names, bwd_names = ("h", "C_T", "n_T", "m_T"), ("dq", "dk", "dv", "dic", "dlogf",
                                                        "dC0", "dn0", "dm0")
    # the streaming shape: one 32-frame chunk of one stream (L = 32, NC = 1)
    B, Ts, chunk = 1, 32, 128
    ins, Tp = mlstm_inputs(gen, B, Ts, H, dqk, dv, Ts, torch.float32, dev)
    with torch.inference_mode():
        got = list(mlstm_fused_fwd(*ins, chunk, Ts))
        torch.cuda.synchronize()
        err = check_scaled(got, mlstm_fused_fwd_ref(*ins, chunk, Ts), fwd_names, 1e-4)
        ms = cuda_ms(lambda: mlstm_fused_fwd(*ins, chunk, Ts), 20)
        plain_ms = cuda_ms(lambda: mlstm_fused_fwd_ref(*ins, chunk, Ts), 5, warmup=1)
        log_by_kernel(f"[K9a] streaming f32 (B={B}, T={Ts})",
                      lambda: mlstm_fused_fwd(*ins, chunk, Ts))
    bound, by = mlstm_bound_ms(B, H, Tp, Ts, dqk, dv, torch.float32, False)
    log(f"[K9a] streaming f32 (B={B}, T={Ts}, H={H}, dqk={dqk}, dv={dv}, one chunk of {Ts}): "
        f"max|Δ| {err:.3e}; {ms:.4f} ms (plain {plain_ms:.2f}, bound {bound:.5f} ms {by}); "
        f"library_ms: none")
    out["K9a streaming f32"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": by}
    for label, B, L, dtype, dqk, dv in (
            ("f32", 32, 128, torch.float32, 128, 256), ("bf16", 32, 128, torch.bfloat16, 128, 256),
            ("bench bf16", 64, 256, torch.bfloat16, 128, 256),
            ("E=2048 f32", 32, 128, torch.float32, 512, 1024),
            ("E=2048 bf16", 32, 128, torch.bfloat16, 512, 1024),
            ("chunk 512 f32", 32, 512, torch.float32, 128, 256)):
        ins, Tp = mlstm_inputs(gen, B, T, H, dqk, dv, L, dtype, dev)
        f32 = dtype == torch.float32
        with torch.inference_mode():
            got = list(mlstm_fused_fwd(*ins, L, T))
            torch.cuda.synchronize()
            want = list(mlstm_fused_fwd_ref(*ins, L, T))
            got[0], want[0] = got[0][:, :T], want[0][:, :T]
            err_f = check_scaled(got[:1], want[:1], fwd_names[:1], 1e-4 if f32 else 2e-2)
            err_f = max(err_f, check_scaled(got[1:], want[1:], fwd_names[1:], 1e-4))
            cots = [torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
                    for x in (ins[2], ins[5], ins[6], ins[7])]
            cots[0][:, T:] = 0                           # rows past T are not outputs
            bwd = mlstm_fused_bwd(*ins, *cots, L, T)
            torch.cuda.synchronize()
            bwd_ref = mlstm_fused_bwd_ref(*ins, *cots, L, T)
            if f32:
                err_b = check_grads(bwd, bwd_ref, bwd_names, 1e-3, 1e-4)
            else:
                err_b = check_grads(bwd[:3], bwd_ref[:3], bwd_names[:3], 2e-2, 1e-3)
                err_b = max(err_b, check_grads(bwd[3:], bwd_ref[3:], bwd_names[3:], 1e-3, 1e-4))
            ms_f = cuda_ms(lambda: mlstm_fused_fwd(*ins, L, T), 5)
            ms_b = cuda_ms(lambda: mlstm_fused_bwd(*ins, *cots, L, T), 3)
            plain_f = cuda_ms(lambda: mlstm_fused_fwd_ref(*ins, L, T), 2, warmup=1)
            plain_b = cuda_ms(lambda: mlstm_fused_bwd_ref(*ins, *cots, L, T), 2, warmup=1)
            log_by_kernel(f"[K9a] {label}", lambda: mlstm_fused_fwd(*ins, L, T))
        bound_f, by_f = mlstm_bound_ms(B, H, Tp, L, dqk, dv, dtype, False)
        bound_b, by_b = mlstm_bound_ms(B, H, Tp, L, dqk, dv, dtype, True)
        log(f"[K9] {label} (B={B}, T={T}, Tp={Tp}, H={H}, dqk={dqk}, dv={dv}, chunk {L}): fwd "
            f"max|Δ| {err_f:.3e}, bwd max|Δ| {err_b:.3e}; K9a {ms_f:.4f} ms (plain {plain_f:.2f}, "
            f"bound {bound_f:.4f} ms {by_f}, {bound_f / ms_f:.1%} of it); K9b {ms_b:.4f} ms "
            f"(plain {plain_b:.2f}, bound {bound_b:.4f} ms {by_b}, {bound_b / ms_b:.1%}); "
            f"library_ms: none")
        out["K9a " + label] = {"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f,
                               "bound_ms": bound_f, "bound_by": by_f}
        out["K9b " + label] = {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
                               "bound_ms": bound_b, "bound_by": by_b}
        del ins, cots, bwd, bwd_ref, got, want

    # K10: head-major f32 with the raw gates (the wrapper pads, scales q and
    # soft-caps); its plain version is mlstm_chunkwise
    B = 32
    r = lambda *shape: 0.5 * torch.randn(shape, generator=gen, device=dev)
    for label, L, dqk, dv in (("f32", 128, 128, 256), ("E=2048 f32", 128, 512, 1024),
                              ("chunk 512 f32", 512, 128, 256)):
        ins = [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
               2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), (0.1 * r(B, H, dqk)).abs(),
               0.1 * r(B, H)]
        with torch.inference_mode():
            got = mlstm_pallas_fwd(*ins, L)
            torch.cuda.synchronize()
            err = check_scaled(got, mlstm_chunkwise(*ins, L), fwd_names, 1e-4)
            ms = cuda_ms(lambda: mlstm_pallas_fwd(*ins, L), 5)
            plain_ms = cuda_ms(lambda: mlstm_chunkwise(*ins, L), 2, warmup=1)
            log_by_kernel(f"[K10] {label}", lambda: mlstm_pallas_fwd(*ins, L))
        Tp = -(-T // L) * L
        bound, by = mlstm_bound_ms(B, H, Tp, L, dqk, dv, torch.float32, False)
        log(f"[K10] {label} (B={B}, T={T}, H={H}, dqk={dqk}, dv={dv}, chunk {L}): max|Δ| "
            f"{err:.3e}; {ms:.4f} ms (plain {plain_ms:.2f}, bound {bound:.4f} ms {by}, "
            f"{bound / ms:.1%} of it); library_ms: none")
        out["K10 " + label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound, "bound_by": by}
    return out


def phase_xlstm_wide(dev) -> dict:
    """The xLSTM with a chunk and heads wider than 256, through the
    entry points: at E=2048 (2 heads of dqk 512, dv 1024, chunk 128) batched
    encodes through K9a ("auto") and K10 ("pallas") and greedy streams, each
    against its plain path (phases 18 and 19's checks), a CTC training
    group in lockstep with the plain path (phase 20's) and one in bf16 held
    to the plain path in f32 (``phase_train_witness``); at chunk 512 (E=512)
    a batched encode and a training group held to the plain path in
    float64.  Returns the launches of K9a, K9b
    and K10."""
    t0 = time.perf_counter()
    n = {"K9a": 0, "K9b": 0, "K10": 0}
    for over, wide in ((XLSTM_2048, True), (XLSTM_CHUNK_512, False)):
        xcfg = Config().apply_overrides(over)
        x = xcfg.model.xlstm
        name = f"E={x.embedding_dim}" if wide else f"chunk {x.chunk_size}"
        cfgs = [xcfg] + ([xcfg.apply_overrides(["--model.xlstm.kernel_impl", "pallas"])]
                         if wide else [])
        for c in cfgs:
            model = build_speech_model(c.model, c.frontend.n_mfcc, "ctc", device=dev,
                                       generator=torch.Generator().manual_seed(SEED))
            randomize_(model, SEED + 1)
            model.eval()
            if c.model.xlstm.kernel_impl == "pallas":
                n["K10"] += phase_batched(model, c, dev, {"K10": mlstm_pallas_fwd},
                                          f"[xlstm {name} pallas batched]")[0]["K10"]
                continue
            log(f"[model] SpeechModel xlstm E={x.embedding_dim}, {x.num_heads} heads (dqk "
                f"{int(x.embedding_dim * x.qk_dim_factor) // x.num_heads}, dv "
                f"{int(x.embedding_dim * x.v_dim_factor) // x.num_heads}), {x.num_blocks} "
                f"blocks, chunk {x.chunk_size}, {sum(p.numel() for p in model.parameters())} "
                f"parameters")
            n["K9a"] += phase_batched(model, c, dev, {"K9a": mlstm_fused_fwd},
                                      f"[xlstm {name} batched]")[0]["K9a"]
            if wide:
                n["K9a"] += phase_streaming(model, c, dev, mlstm_fused_fwd,
                                            f"[xlstm {name} streaming]")
            del model
        if wide:
            runs = [phase_train_step(xcfg, dev, K=2, path=f"xlstm {name} ctc"),
                    phase_train_witness(xcfg, dev, f"xlstm {name} ctc", "bfloat16")]
        else:
            runs = [phase_train_witness(xcfg, dev, f"xlstm {name} ctc", "float32")]
        for got in runs:
            n["K9a"] += got["K9a"]
            n["K9b"] += got["K9b"]
    log(f"[time] the xLSTM at E=2048 and chunk 512: {time.perf_counter() - t0:.1f} s ({CARD})")
    return n


def masked_rows(B, T, dev):
    """A frame mask with one partial row (row 1 ends at two thirds of T)."""
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    mask[1 % B, (2 * T) // 3:] = False
    return mask


def phase_cell_scan_kernels(dev) -> dict:
    """Phase 23: K12 and K11 against their plain versions at the flagship's
    cell shape (B=32, T=1598, D=512; f32 and bf16, unmasked and with one
    partial row) and K12 at the streaming shape (1, 32, 512), on
    ``conditioned_cell_inputs``; K11 runs on the planes of the (masked) gate
    chain.  K12 bit for bit its plain version in f32, to one bf16 step in
    bf16, also at the edges of its ring (``K12_EDGES``, each unmasked, with
    partial rows, and with a row masked throughout and one whose first frame
    is masked); K11 likewise, on the planes of the gate chain under each of
    those masks (``K11_EDGES``).  Then the gradients of both
    autograd Functions (the backward's two reverse scans through K5b) on
    the card against the same Functions over the plain versions, at the f32
    shape: 1e-4 relative plus 1e-6 of each gradient's scale, K2's f32
    tolerance."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    out = {}
    cases = [("batched f32", 32, 1598, 512, torch.float32, False),
             ("batched f32 masked", 32, 1598, 512, torch.float32, True),
             ("batched bf16", 32, 1598, 512, torch.bfloat16, False),
             ("batched bf16 masked", 32, 1598, 512, torch.bfloat16, True),
             ("streaming f32", 1, 32, 512, torch.float32, False)]
    for label, B, T, D, dtype, masked in cases:
        gates, bias, h0, s0 = conditioned_cell_inputs(gen, B, T, D, torch.float32, dev)
        mask = masked_rows(B, T, dev) if masked else None
        es = torch.finfo(dtype).bits // 8
        small = B * T <= 1000
        g4 = (gates + bias).reshape(B, T, 7, D).to(dtype)
        planes = [x.to(dtype) for i, x in enumerate(lucy_gate_coeffs(gates, mask, bias)) if i != 3]
        runs = [("K12", lucy_fused_cell, lucy_fused_cell_ref, (g4, h0, s0, mask),
                 9 * B * T * D * es + (B * T if masked else 0),
                 K12_OPS_PER_ELEMENT + (K12_MASK_OPS_PER_ELEMENT if masked else 0))]
        if not small:
            runs.append(("K11", lucy_dual_scan, lucy_dual_scan_ref, (*planes, h0, s0),
                         6 * B * T * D * es, K11_OPS_PER_ELEMENT))
        for name, fn, ref, args, nbytes, ops in runs:
            with torch.inference_mode():
                h, s = fn(*args)
                torch.cuda.synchronize()
                h_ref, s_ref = ref(*args)
                err = max(check_equal_or_bf16_step(h, h_ref, f"{name} {label} h"),
                          check_equal_or_bf16_step(s, s_ref, f"{name} {label} s"))
                ms = cuda_ms(lambda: fn(*args), 200 if small else 50, graph=small)
                plain_ms = cuda_ms(lambda: ref(*args), 20 if small else 2, warmup=1, graph=small)
            bound, bound_by = bytes_bound_ms(nbytes + 2 * B * D * 4, ops * B * T * D)
            log(f"[{name}] {label} (B={B}, T={T}, D={D}): max|Δ| {err:.3e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.3f} ms  bound {bound:.4f} ms ({bound_by}, {bound / ms:.1%} of "
                f"it)  library_ms: none")
            out[f"{name} {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound, "bound_by": bound_by}

    worst = {"K12": 0.0, "K11": 0.0}
    for name, edges in (("K12", K12_EDGES), ("K11", K11_EDGES)):
        for B, T, D, dtype, offset in edges:
            gates, bias, h0, s0 = conditioned_cell_inputs(gen, B, T, D, torch.float32, dev)
            g4 = (gates + bias).reshape(B, T, 7, D).to(dtype)
            if offset:
                g4 = offset_copy(g4)
            frozen = torch.ones((B, T), dtype=torch.bool, device=dev)
            frozen[0] = False                                 # masked throughout
            frozen[B - 1, 0] = False                          # first frame masked
            for mask in (None, masked_rows(B, T, dev), frozen):
                if name == "K12":
                    fn, ref, args = lucy_fused_cell, lucy_fused_cell_ref, (g4, h0, s0, mask)
                else:
                    planes = [x.to(dtype) for i, x in
                              enumerate(lucy_gate_coeffs(gates, mask, bias)) if i != 3]
                    if offset:
                        planes = [offset_copy(x) for x in planes]
                    fn, ref, args = lucy_dual_scan, lucy_dual_scan_ref, (*planes, h0, s0)
                with torch.inference_mode():
                    h, s = fn(*args)
                    torch.cuda.synchronize()
                    h_ref, s_ref = ref(*args)
                where = (f"{name} at (B={B}, T={T}, D={D}, {dtype}"
                         f"{', offset' if offset else ''}, "
                         f"{'unmasked' if mask is None else 'masked'})")
                worst[name] = max(worst[name], check_equal_or_bf16_step(h, h_ref, where + " h"),
                                  check_equal_or_bf16_step(s, s_ref, where + " s"))
                if mask is frozen and not (torch.equal(h[0], h0[0].to(dtype).expand(T, D))
                                           and torch.equal(s[0], s0[0].to(dtype).expand(T, D))):
                    raise AssertionError(f"{where}: a row masked throughout left h0, s0")
    for name, edges in (("K12", K12_EDGES), ("K11", K11_EDGES)):
        log(f"[{name}] at the ring's edges ({len(edges)} shapes × unmasked, partial rows, a "
            f"row masked throughout and a first frame masked): f32 bit for bit, bf16 max|Δ| "
            f"{worst[name]:.3e}")

    B, T, D = 32, 1598, 512
    gates, bias, h0, s0 = conditioned_cell_inputs(gen, B, T, D, torch.float32, dev)
    mask = masked_rows(B, T, dev)
    w_h, w_s = (torch.randn((B, T, D), generator=gen, device=dev) for _ in range(2))
    planes = [x for i, x in enumerate(lucy_gate_coeffs(gates, mask, bias)) if i != 3]
    for name, fn, inputs, names in (
            ("K12", lambda g, h, s: lucy_fused_cell(g, h, s, mask),
             ((gates + bias).reshape(B, T, 7, D), h0, s0), ("d_gates", "dh0", "ds0")),
            ("K11", lucy_dual_scan, (*planes, h0, s0),
             ("d_a_s", "d_b_s", "d_a_h", "d_h_pre", "dh0", "ds0"))):
        def grads():
            xs = [x.detach().clone().requires_grad_() for x in inputs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h_all, s_all = fn(*xs)
            ((h_all * w_h).sum() + 0.1 * (s_all * w_s).sum()).backward()
            torch.cuda.synchronize()
            return [x.grad for x in xs], time.perf_counter() - t0

        grads()                                               # warm-up
        got, sec = grads()
        with plain_kernels():
            want, sec_p = grads()
        err = check_grads(got, want, names, 1e-4, 1e-6)
        log(f"[{name}] backward Function at (B={B}, T={T}, D={D}) f32, masked: gradients max|Δ| "
            f"{err:.3e} against the plain versions'; forward+backward {sec * 1e3:.1f} ms (plain "
            f"{sec_p * 1e3:.1f} ms)")
    return out


def phase_eval(run_dir, overrides, decoders, dev, tag) -> int:
    """Phases 7 and 16, after the CLI: eval.py on the run directory it wrote.
    First ``python -m statecatcher_tpu_torch.eval`` as a user runs it (the
    run's newest checkpoint and tokenizer, one batch of the fixture: 4
    recordings × 3 segments; its WER line is printed).  Then, since two or
    three updates leave a LucyRNN's logits within round-off of each other
    (its output projection is zero at init), ``evaluate`` with the run's
    tokenizer on the flagship's ``randomize_`` weights (the RNN-T joiner's
    widened as phase 10's) over the fixture's 4 recordings cut to 24 s (2
    segments each, the decoders' host-bound rounds halved), kernel path
    (K1) against plain path,
    for each of ``decoders``: the same references, and hypotheses whose
    edit distance to the plain path's is at most 2 % of its characters
    (phase 2 holds 99.9 % of greedy frames equal; a beam's choice among
    candidates whose f32 scores tie, or nearly, turns on round-off, and a
    changed choice moves the rest of the hypothesis).  Returns K1's
    launches on the kernel path's evaluations."""
    proc = subprocess.run([sys.executable, "-m", "statecatcher_tpu_torch.eval", "--ckpt", run_dir,
                           "--decoder", decoders[0], "--max-batches", "1", *overrides],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"eval exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    if not re.fullmatch(r"WER: \S+  CER: \S+  \(4 utterances, \d+ segments\)", line):
        raise AssertionError(f"eval printed {line!r}")
    log(f"{tag} python -m statecatcher_tpu_torch.eval --decoder {decoders[0]} on the CLI's "
        f"run: {line}")
    cfg, tok, params = port_eval.load_run(run_dir, Config().apply_overrides(overrides), dev)
    short = write_cli_fixture(os.path.join(WORK, "eval"), seconds=24.0,
                              cue=cfg.data.target_duration / 4)
    cfg = cfg.apply_overrides(["--data.local_dir", short])
    mode = cfg.train.mode
    model = rnnt_model(cfg, dev) if mode == "rnnt" else build_speech_model(
        cfg.model, cfg.frontend.n_mfcc, mode, device=dev)
    if mode != "rnnt":
        randomize_(model, SEED + 1)
    params = model.state_dict()
    del model
    launches = 0
    for decoder in decoders:
        lucy_cell_fused_lm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = port_eval.evaluate(cfg, params, tok, max_batches=1, decoder=decoder, device=dev)
        sec = time.perf_counter() - t0
        n = lucy_cell_fused_lm.launches
        launches += n
        with plain_kernels():
            t0 = time.perf_counter()
            res_p = port_eval.evaluate(cfg, params, tok, max_batches=1, decoder=decoder,
                                       device=dev)
            sec_p = time.perf_counter() - t0
        if n == 0:
            raise AssertionError(f"{tag} {decoder}: evaluation launched no K1")
        if (res.refs != res_p.refs or res.num_segments != res_p.num_segments
                or res.num_utterances != 4):
            raise AssertionError(f"{tag} {decoder}: references or counts differ")
        dist = sum(levenshtein(list(a), list(b)) for a, b in zip(res.hyps, res_p.hyps))
        chars = sum(len(h) for h in res_p.hyps)
        if not chars or dist > 0.02 * chars:
            raise AssertionError(f"{tag} {decoder}: kernel and plain hypotheses {dist} edits "
                                 f"apart over {chars} characters")
        log(f"{tag} evaluate --decoder {decoder} (randomize_ weights, 4 recordings × "
            f"{res.num_segments} × 16 s): "
            f"WER {res.wer:.4f} / {res_p.wer:.4f}, CER {res.cer:.4f} / {res_p.cer:.4f} (kernel / "
            f"plain path); hypotheses {chars} characters, {dist} edits apart "
            f"({'the same' if res.hyps == res_p.hyps else 'not the same'}); {sec:.2f} s kernel "
            f"path, {sec_p:.2f} s plain; K1 launches {n}")
    return launches


def phase_lstm(dev) -> dict:
    """Phase 27: the LSTM at the config's defaults (no ``--model.encoder``:
    512 wide, vocab 1024, 80 MFCC, f32; the recurrence is torch, with no TPU
    kernel) with its depth cut from 4 layers to 2 (``LSTM``): phase 2's
    batched encode (the row whose mask ends early carries
    its last valid frame's state; the output past it is zero), a CTC
    training group of K=1 at B=32 (K3/K4 against their plain versions; one
    segment, ~7 s a path, to make room for the joiner-640 groups), and the
    CLI with no ``--model.encoder``, resumed."""
    cfg = Config().apply_overrides(LSTM)
    m = cfg.model
    if m.encoder != "lstm":
        raise AssertionError(f"the config's default encoder is {m.encoder!r}")
    model = build_speech_model(m, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    log(f"[model] SpeechModel lstm {m.num_layers} × {m.hidden_size}, vocab {m.vocab_size}, "
        f"{cfg.frontend.kind} {cfg.frontend.n_mfcc}, {m.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    _, per_seg = phase_batched(model.eval(), cfg, dev, {}, "[lstm batched]")
    del model
    log(f"[lstm batched] the LSTM's 16 s segment at B=32: {per_seg[0]:.1f}, {per_seg[1]:.1f} "
        f"ms unmasked, {per_seg[2]:.1f} ms masked ({m.num_layers} × 1598 steps in torch)")
    n_train = phase_train_step(cfg, dev, K=1, path="lstm ctc")
    phase_cli(encoder=None, extra=LSTM, tag="[cli lstm default]")
    return n_train


def phase_ctc_beam(model, cfg, dev) -> None:
    """Phase 28: ``ctc_beam_search`` (beam 8, top 16, as eval runs it; buffers
    of T tokens, which no hypothesis can outgrow) at B=32, T=1598, V=1024 on
    the flagship's log-probs of a 16 s batch, rows of other lengths among
    them: on the card, then the same function on the CPU on the same
    log-probs.  The live hypotheses must be
    the same token lists in the same order, and their scores within 1e-5
    (relative) of the CPU's."""
    B, S = 32, 16 * 16000
    rng = np.random.default_rng(SEED + 11)
    audio = torch.from_numpy(synth_audio(rng, B, S)).to(dev)
    with torch.inference_mode():
        logits, _ = model(compute_features(audio, cfg.frontend))
        lp = torch.log_softmax(logits.float(), dim=-1)
    T = lp.shape[1]
    in_lens = torch.full((B,), T, dtype=torch.int32)
    in_lens[1:6] = torch.tensor([0, 1, T // 3, T // 2, T - 1], dtype=torch.int32)
    kw = dict(beam=8, topk=16, blank_id=0, max_len=T)
    ctc_beam_search(lp[:, :8], in_lens.to(dev), **kw)                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, tot = ctc_beam_search(lp, in_lens.to(dev), **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_c, tot_c = ctc_beam_search(lp.cpu(), in_lens, **kw)
    sec_c = time.perf_counter() - t0
    got, want = beam_hypotheses(st, tot), beam_hypotheses(st_c, tot_c)
    if [[t for _, t in r] for r in got] != [[t for _, t in r] for r in want]:
        bad = [b for b, (g, w) in enumerate(zip(got, want))
               if [t for _, t in g] != [t for _, t in w]]
        raise AssertionError(f"ctc_beam_search: the card's live hypotheses differ from the CPU's "
                             f"in rows {bad}")
    rel = max(abs(a - b) / abs(b) for g, w in zip(got, want) for (a, _), (b, _) in zip(g, w)
              if b != 0)
    if rel > 1e-5:
        raise AssertionError(f"ctc_beam_search: scores {rel:.3e} (relative) from the CPU's")
    lens = [len(r[0][1]) for r in want if r]
    log(f"[ctc beam] B={B}, T={T}, V={lp.shape[-1]}, beam 8, top 16: {sec * 1e3:.1f} ms on the "
        f"card ({sec / T * 1e6:.1f} µs a frame), {sec_c * 1e3:.1f} ms on the CPU; live "
        f"hypotheses the same ({sum(len(r) for r in got)} over {B} rows), scores max rel "
        f"{rel:.2e}; best hypothesis {min(lens)}–{max(lens)} tokens")


def beam_replay(chunks, beam: int, max_out: int, n_full: int):
    """The beam recognizer's decode, written out: ``ctc_beam_search`` over
    each chunk's log-probs with the state carried; after each of the first
    ``n_full`` (full) chunks a commit once the fill bound reaches half the
    buffer (forcing along the best beam to keep half of it free), after the
    flushed rest one once a buffer is half full.  → (tokens, committed
    tokens, forced commits: those that pruned a live beam)."""
    st = tot = None
    committed, fill, forced, resid = [], 0, 0, None
    dev = chunks[0].device
    for i, lp in enumerate(chunks):
        st, tot = ctc_beam_search(lp, torch.tensor([lp.shape[1]], device=dev), beam=beam,
                                  max_len=max_out, init_state=st)
        resid = None
        if i < n_full:
            fill += lp.shape[1]
            due = fill >= max_out // 2
        else:
            due = int(st.lens.max()) >= max_out // 2
        if due:
            live = int((tot > -1e29).sum())
            st, com, best, fill = beam_commit(st, tot, reserve=max_out // 2, return_best=True)
            tot = torch.logaddexp(st.p_b, st.p_nb)
            forced += int((tot > -1e29).sum()) < live
            committed += com[0]
            resid = best[0] if i < n_full else None
    if resid is None:
        hyps = beam_hypotheses(st, tot)[0]
        resid = hyps[0][1] if hyps else []
    return committed + resid, committed, forced


def phase_beam_streaming(model, cfg, dev) -> int:
    """Phase 29: three ~10 s streams through ``StreamingRecognizer(decoder=
    "beam")`` (beam 8, buffers of 512, so what the live beams agree on is
    committed to the host every few chunks).  The streamed and committed
    tokens must equal ``beam_replay``'s on the same log-probs (those the
    recognizer decoded, chunk by chunk).  Against one ``ctc_beam_search``
    over all of them with a buffer that holds them the tokens may differ,
    as JAX's do: a commit re-hashes the residual prefixes, and the order of
    candidates whose f32 scores tie exactly follows their hashes (at scores
    of ~2000 an ulp is 1.2e-4, so ties among the weaker beams occur; a
    forced commit also prunes the beams that disagree with the best one).
    Held: at most 2 % of the tokens apart.  Returns K1's launches."""
    rng = np.random.default_rng(SEED + 12)
    streams = [synth_audio(rng, 1, 160000 + int(rng.integers(0, 8000)))[0] for _ in range(3)]
    warm = StreamingRecognizer(model, cfg, chunk_frames=32, decoder="beam", device=dev)
    warm.accept_waveform(streams[0][:16000])                   # warm-up, not counted
    latencies, runs = [], []
    lucy_cell_fused_lm.launches = 0
    for audio in streams:
        rec = StreamingRecognizer(model, cfg, chunk_frames=32, decoder="beam", device=dev)
        step, advance, frames = rec._step_chunk, rec._advance_beam, []

        def timed(chunk, step=step):
            t0 = time.perf_counter()
            step(chunk)
            torch.cuda.synchronize()                            # the beam state is on the card
            latencies.append(time.perf_counter() - t0)

        def kept(lp, advance=advance, frames=frames):
            frames.append(lp.clone())
            advance(lp)

        rec._step_chunk, rec._advance_beam = timed, kept
        pos = 0
        while pos < len(audio):
            n = int(rng.integers(100, 8000))
            rec.accept_waveform(audio[pos:pos + n])
            pos += n
        n_full = len(frames)
        rec.finish()
        runs.append((rec.tokens, rec.committed_tokens, frames, n_full, rec.max_out))
    launches = lucy_cell_fused_lm.launches
    if launches == 0:
        raise AssertionError("the beam streaming path launched no fused-cell kernel")
    for k, (toks, committed, frames, n_full, max_out) in enumerate(runs):
        want, want_com, forced = beam_replay(frames, 8, max_out, n_full)
        lp = torch.cat(frames, dim=1)
        st, tot = ctc_beam_search(lp, torch.tensor([lp.shape[1]], device=dev), beam=8,
                                  max_len=lp.shape[1] + 1)
        whole = beam_hypotheses(st, tot)[0][0][1]
        dist = levenshtein(toks, whole)
        log(f"[beam streaming] stream {k}: {lp.shape[1]} frames in {len(frames)} chunks, "
            f"{len(toks)} tokens streamed ({len(committed)} committed on the way, {forced} "
            f"commit(s) forced), {len(whole)} in one offline search, edit distance {dist}")
        if toks != want or committed != want_com or not committed:
            raise AssertionError(f"stream {k}: the recognizer's tokens differ from the replay "
                                 f"of its decode ({levenshtein(toks, want)} edits), or nothing "
                                 f"was committed")
        if dist > 0.02 * len(whole):
            raise AssertionError(f"stream {k}: the streamed tokens are {dist} edits from one "
                                 f"offline search over {len(whole)} tokens")
    lat = np.asarray(latencies) * 1e3
    log(f"[beam streaming] {len(lat)} chunks of 32 frames (320 ms): latency p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms; fused-cell "
        f"launches {launches}")
    return launches


def phase_rwkv(dev) -> tuple:
    """Phase 30: the RWKV at the flagship's widths (4 × 512, vocab 1024, 80
    MFCC, f32, ``randomize_`` weights; the WKV is torch ops, parallel in
    time, with no TPU kernel): phase 2's batched encode, one segment on the
    card against the CPU, three streams against an offline decode, and a CTC
    training group of K=4 at B=32, U=128 (K3/K4 against their plain
    versions).  Returns the group's launches and the batched ms per
    segment."""
    cfg = Config().apply_overrides(RWKV)
    m = cfg.model
    model = build_speech_model(m, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    model.eval()
    log(f"[model] SpeechModel rwkv {m.num_layers} × {m.hidden_size}, vocab {m.vocab_size}, "
        f"{cfg.frontend.kind} {cfg.frontend.n_mfcc}, {m.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    _, per_seg = phase_batched(model, cfg, dev, {}, "[rwkv batched]")
    rwkv_card_vs_cpu(model, cfg, dev)
    phase_streaming(model, cfg, dev, None, "[rwkv streaming]")
    del model
    n_train = phase_train_step(cfg, dev, K=4, path="rwkv ctc")
    return n_train, per_seg


# phase 30's card against the CPU: max|Δ| over the CPU's scale.  The log
# numerators hold log(max(±v, 0) + 1e-20) terms, whose log jumps by tens where
# a rounding moves v across 0 (sound readings up to 4.4e-5 over three seeds,
# 7.7e-3 to 1.1e-1 with TF32 matmuls; tools/rwkv_tf32_control.py, PERF.md);
# the others read 1.5e-7 to 3.1e-7 sound and 9.8e-5 to 3.4e-4 with TF32.
RWKV_CARD_VS_CPU = {"log-probs": 1e-5, "last_x_tm": 1e-5, "last_x_cm": 1e-5, "log_den": 1e-5,
                    "log_num_p": 1e-3, "log_num_n": 1e-3}


def rwkv_card_vs_cpu(model, cfg, dev, B=4, S=16 * 16000) -> None:
    """One 16 s segment at B=4 through the RWKV on the card and through a
    copy of it on the CPU, from the same features: log-probs and the five
    carry leaves within ``RWKV_CARD_VS_CPU`` of their scale, 99.9 % of
    greedy frames equal.  A control pass on the card with TF32 matmuls
    (10-bit mantissas) must break every one of those limits, so each tells
    a card path whose f32 GEMMs fell to TF32 from a sound one."""
    import copy

    audio = torch.from_numpy(synth_audio(np.random.default_rng(SEED + 9), B, S)).to(dev)
    cpu = copy.deepcopy(model).cpu()

    def run(m, x):
        logits, carry = m(x)
        return torch.log_softmax(logits.float(), -1).cpu(), {k: v.cpu() for k, v in carry.items()}

    with torch.inference_mode():
        feats = compute_features(audio, cfg.frontend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, carry = run(model, feats)
        sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        lp_c, carry_c = run(cpu, feats.cpu())
        sec_c = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lp_t, carry_t = run(model, feats)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def gaps(lp_x, carry_x) -> dict:
        """max|Δ| over the CPU's scale, for the log-probs and each carry leaf"""
        pairs = [("log-probs", lp_x, lp_c)] + [(k, carry_x[k], carry_c[k]) for k in carry_c]
        out = {}
        for k, x, ref in pairs:
            if not torch.isfinite(x).all():
                raise AssertionError(f"[rwkv card vs cpu] {k} not finite")
            out[k] = (x - ref).abs().max().item() / ref.abs().max().item()
        return out

    sound, control = gaps(lp, carry), gaps(lp_t, carry_t)
    text = ", ".join(f"{k} {sound[k]:.2e} (TF32 {control[k]:.2e}; limit {RWKV_CARD_VS_CPU[k]:g})"
                     for k in sound)
    log(f"[rwkv card vs cpu] B={B}, one {S / 16000:g} s segment, max|Δ|/scale against the CPU: "
        + text)
    over = [k for k, v in sound.items() if v > RWKV_CARD_VS_CPU[k]]
    if over:
        raise AssertionError(f"[rwkv card vs cpu] {over} beyond their limits")
    blind = [k for k, v in control.items() if v <= RWKV_CARD_VS_CPU[k]]
    if blind:
        raise AssertionError(f"[rwkv card vs cpu] the TF32 control stays within the limits of "
                             f"{blind}: they cannot tell it from a sound path")
    same = (lp.argmax(-1) == lp_c.argmax(-1)).double().mean().item()
    if same < 0.999:
        raise AssertionError(f"[rwkv card vs cpu] greedy frames equal on {same:.4%} < 99.9%")
    log(f"[rwkv card vs cpu] greedy frames equal {same:.4%}; {sec * 1e3:.1f} ms on the card, "
        f"{sec_c * 1e3:.1f} ms on the CPU ({CARD})")


def phase_host_side(dev) -> dict:
    """Phase 31: the host side through the CLI (see the module's docstring).
    Returns what the server recorded."""
    from statecatcher_tpu_torch.data.audio import (
        read_wav_bytes,
        resample_linear,
        resampled_count,
        to_mono,
    )
    from statecatcher_tpu_torch.data.fake_server import FakeSpeechDataServer
    from statecatcher_tpu_torch.data.vtt import vtt_to_segments_with_text
    from statecatcher_tpu_torch.tokenizer import load_tokenizer
    from statecatcher_tpu_torch.tokenizer.unigram import _viterbi_segment

    if not native.available():
        raise AssertionError(f"the native library is not live: {native.load_error()}")
    shutil.rmtree(WORK, ignore_errors=True)
    data = write_cli_fixture(WORK, cue=4.0)
    names = sorted(n[:-4] for n in os.listdir(data) if n.endswith(".wav"))
    recs = [(open(os.path.join(data, n + ".wav"), "rb").read(),
             open(os.path.join(data, n + ".vtt")).read()) for n in names]
    # the native WAV decoder against the numpy reader, as read and resampled
    t0 = time.perf_counter()
    for blob, _ in recs:
        for sr in (16000, 8000):
            got = native.decode_wav_native(blob, sr)
            wav, sr0, _ = read_wav_bytes(blob)
            wav = to_mono(wav)
            if sr0 != sr:
                wav = resample_linear(wav, sr0, sr, n_out=resampled_count(len(wav), sr0, sr))
            if got is None or got.shape != wav.shape or not np.array_equal(got, wav):
                raise AssertionError(f"the native WAV decoder differs from the numpy reader at "
                                     f"{sr} Hz")
    t_dec = time.perf_counter() - t0

    prefix = os.path.join(WORK, "tokenizer")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "statecatcher_tpu_torch.train_tokenizer",
                           "--input", data, "--model-prefix", prefix, "--vocab-size", "64"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or proc.stdout.strip() != f"Wrote {prefix}.json":
        raise RuntimeError(f"train_tokenizer exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    t_tok = time.perf_counter() - t0
    tok = load_tokenizer(prefix + ".json")
    if tok._native is None:
        raise AssertionError("the unigram tokenizer did not take the native Viterbi")
    texts = [t for _, vtt in recs for _, _, t in vtt_to_segments_with_text(vtt)]
    for text in texts + ["hello ¤ world"]:
        py = []
        for w in text.split():
            seg = _viterbi_segment("▁" + w, tok._logp, tok._max_len)
            py += [tok._id_of[p] for p in seg] if seg else tok._encode_with_unk("▁" + w)
        if tok.encode(text) != py:
            raise AssertionError(f"native and Python Viterbi differ on {text!r}")

    prof = os.path.join(WORK, "profile")
    with FakeSpeechDataServer(recs) as srv:
        conf = os.path.join(WORK, "data.yaml")
        with open(conf, "w") as f:
            f.write("# the fake data server on loopback\n" + "".join(
                f"{k}: '{v}'\n" for k, v in srv.client_config().items()))
        http = ["--data.source", "http", "--data.config_path", conf,
                "--data.target_duration", "16", "--data.batch_size", "4"]
        t0 = time.perf_counter()
        summary = run_cli([*RWKV, *http, "--train.sp_model", prefix + ".json",
                           "--data.num_workers", "4", "--train.segments_per_dispatch", "2",
                           "--train.steps", "3", "--train.log_every_n", "2",
                           "--train.debug", "true", "--train.profile_dir", prof,
                           "--train.model_dir", os.path.join(WORK, "run")])
        t_cli = time.perf_counter() - t0
        done = list(srv.state.marked_done)
        completed = [m for lvl, m in srv.state.logs if m.startswith("Completed batch")]
        sessions = dict(srv.state.sessions)
        t0 = time.perf_counter()
        sim = subprocess.run([sys.executable, "-m", "statecatcher_tpu_torch.simulate", *http,
                              "--batches", "2"], cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        t_sim = time.perf_counter() - t0
    if summary["global_step"] != 3 or len(summary["loss_history"]) != 3:
        raise AssertionError(f"[cli rwkv http] {summary['global_step']} steps, losses "
                             f"{summary['loss_history']}")
    if not done or len(done) != len(completed) or done != [(0, i) for i in range(len(done))]:
        raise AssertionError(f"[cli rwkv http] batches marked done {done}, completed "
                             f"{completed}")
    if sessions:
        raise AssertionError(f"[cli rwkv http] the session was not ended: {sessions}")
    train_log = open(os.path.join(summary["run_dir"], "train.log")).read()
    if "check_carry passed" not in train_log:
        raise AssertionError("[cli rwkv http] train.debug did not check the carry")
    traces = [n for n in os.listdir(prof) if n.startswith("trace-") and n.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"[cli rwkv http] profile directory holds {os.listdir(prof)}")
    trace_mb = os.path.getsize(os.path.join(prof, traces[0])) / 2**20
    if sim.returncode != 0 or "simulated: {'batches': 2" not in sim.stdout:
        raise RuntimeError(f"simulate exited {sim.returncode}:\n{sim.stdout[-1500:]}"
                           f"\n{sim.stderr[-1500:]}")
    log(f"[host] native library live ({native.library_path().name}): WAV decoder equal to the "
        f"numpy reader on {len(recs)} × 48 s at 16 and 8 kHz ({t_dec * 1e3:.0f} ms for both), "
        f"Viterbi equal on {len(texts) + 1} texts; train_tokenizer: vocab {tok.vocab_size} in "
        f"{t_tok:.1f} s")
    log(f"[cli rwkv http] python -m statecatcher_tpu_torch.cli --model.encoder rwkv "
        f"--data.source http (loopback) --train.debug true --train.profile_dir: losses "
        f"{[round(x, 4) for x in summary['loss_history']]}, batches marked done {done}, "
        f"session ended, check_carry passed, trace {traces[0]} ({trace_mb:.1f} MiB); "
        f"{t_cli:.1f} s; simulate --batches 2 in {t_sim:.1f} s ({CARD})")
    return {"marked_done": done}


# phase 33's kernels: its K1/K2 (data parallel, "auto") and K5a/K5b (tensor
# and sequence parallel, "pallas" and "sp") per segment and layer; the
# xLSTM's K9a/K9b ("auto") or K10 ("pallas") per segment and block on each
# rank's head; K3/K4 per segment, on every rank (the LSTM and the RWKV have
# no kernel but K3/K4)
MULTI_GPU_KERNELS = {"dp": {"lucy_cell_fused_lm": 1, "lucy_cell_fused_lm_bwd": 1,
                            "ctc_alpha": 0, "ctc_beta": 0},
                     "tp": {"linear_scan_fwd": 2, "linear_scan_rev": 2, "ctc_alpha": 0,
                            "ctc_beta": 0},
                     "sp": {"linear_scan_fwd": 2, "linear_scan_rev": 2, "ctc_alpha": 0,
                            "ctc_beta": 0},
                     "xlstm auto": {"mlstm_fused_fwd": 1, "mlstm_fused_bwd": 1, "ctc_alpha": 0,
                                    "ctc_beta": 0},
                     "xlstm pallas": {"mlstm_pallas_fwd": 1, "ctc_alpha": 0, "ctc_beta": 0},
                     "lstm": {"ctc_alpha": 0, "ctc_beta": 0},
                     "rwkv": {"ctc_alpha": 0, "ctc_beta": 0}}
# phase 33's xLSTM: the flagship's widths with d_ff 1364 (the default
# ffn_proj_factor's 1365 divides over no model_parallel: JAX refuses it too)
XLSTM_TP = XLSTM + ["--model.xlstm.ffn_proj_factor", "2.666"]
RANK_TIMEOUT_S = 240.0


def multi_gpu_layout() -> tuple[int, str, str]:
    """(world, backend, --device) of phase 33: one rank per card over NCCL
    with two cards or more; with one card two ranks on cuda:0 over gloo (NCCL
    refuses two ranks of one communicator on one device)."""
    n = torch.cuda.device_count()
    return (n, "nccl", "cuda") if n >= 2 else (2, "gloo", "cuda:0")


def launch(world: int, argv: list, module: str, tag: str) -> list[str]:
    """``world`` rank processes of ``module`` with torchrun's environment;
    every rank must exit 0 within RANK_TIMEOUT_S (a rank out of time is
    killed and fails the phase).  Returns each rank's output."""
    from statecatcher_tpu_torch.parallel.dryrun import launch_ranks

    res = launch_ranks(world, argv, RANK_TIMEOUT_S, module=module, cwd=REPO)
    for r, (rc, out) in enumerate(res):
        if rc != 0:
            raise RuntimeError(f"{tag} rank {r} of {world} exited {rc}:\n{out[-3000:]}")
    return [out for _, out in res]


def multi_gpu_reference(cfg, dev, params, group, K, B):
    """One process on the card over the global batch: (outputs, carry,
    parameters after the update)."""
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev)
    model.load_state_dict(params)
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    args = [torch.from_numpy(np.ascontiguousarray(group[k])).to(dev)
            for k in ("audio", "mask", "tokens", "tok_lens", "row_valid")]
    _, carry, outs = step(state, init_carry(cfg.model, B, device=dev), *args, np.ones(K, bool))
    return outs, {k: v.cpu() for k, v in carry.items()}, snapshot(state)


def check_against_one_process(tag, got, ref, p0, lr, K) -> str:
    """Phase 5's tolerances: losses to 1e-4 and grad norms to 1e-3
    (relative), the carry to 1e-3 of its scale, the updates within 1 % of
    their norm with at most 0.1 % of the elements beyond 0.1·lr·K."""
    outs, carry, params = ref
    loss, loss_r = got["loss"].numpy(), outs.loss.cpu().numpy()
    gn, gn_r = got["grad_norm"].numpy(), outs.grad_norm.cpu().numpy()
    d_loss = np.abs(loss - loss_r) / np.abs(loss_r)
    d_gn = np.abs(gn - gn_r) / np.abs(gn_r)
    if not (np.isfinite(loss).all() and np.isfinite(gn).all()) or d_loss.max() > 1e-4 \
            or d_gn.max() > 1e-3:
        raise AssertionError(f"{tag} vs one process: losses {loss} vs {loss_r}, grad norms "
                             f"{gn} vs {gn_r}")
    for name in carry:
        dc = (got["carry"][name] - carry[name]).abs().max().item()
        if dc > 1e-3 * carry[name].abs().max().item():
            raise AssertionError(f"{tag} carry {name}: max|Δ| {dc:.3e}")
    flat = lambda d: torch.cat([d[k].flatten().float().cpu() for k in sorted(p0)])
    p0_, pg, pr = flat(p0), flat(got["params"]), flat(params)
    rel = ((pg - pr).norm() / (pr - p0_).norm()).item()
    off = ((pg - pr).abs() > 0.1 * lr * K).float().mean().item()
    if rel > 1e-2 or off > 1e-3:
        raise AssertionError(f"{tag} vs one process: updates differ by {rel:.3e} of their "
                             f"norm, {off:.3e} of elements beyond 0.1·lr·K")
    return (f"losses max rel {d_loss.max():.2e}, grad norms {d_gn.max():.2e}, updates differ "
            f"by {rel:.2e} of their norm, {off:.2e} of elements beyond 0.1·lr·K")


def multi_gpu_job(tag, overrides, modes, refs, K, B=32, S=16 * 16000, U=128,
                  time_runs=1) -> dict:
    """One model's modes of phase 33's launch: its random weights (gate
    projections ×0.1, lr 1e-6) and one group of K carried 16 s segments at B
    global (U tokens, row B-1, one rank's row, invalid), ``modes`` [(name,
    overrides)] to run the step under, each later held against one process
    on the card whose model overrides are ``refs[name]``."""
    overrides = overrides + ["--train.optim.lr", "1e-6"]
    cfg = Config().apply_overrides(overrides)
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1, gate_weight_scale=0.1)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    group = {k: v.cpu().numpy() for k, v in zip(
        ("audio", "mask", "tokens", "tok_lens", "row_valid"),
        train_group(SEED + 6, K, B, S, U, cfg.model.vocab_size, "cpu"))}
    group["seg_valid"] = np.ones(K, bool)
    return {"tag": tag, "cfg": cfg, "modes": modes, "refs": refs, "K": K, "B": B,
            "time_runs": time_runs,
            "inputs": {"overrides": overrides, "params": params, "group": group,
                       "time_runs": time_runs}}


def multi_gpu_launch(jobs, world, backend, device, dev, d, launches) -> list:
    """``parallel/dryrun.py`` on ``world`` ranks (torchrun's environment),
    one launch for every mode of ``jobs`` (``multi_gpu_job``); then each mode
    on every rank against one process over the same batch at phase 5's
    tolerances, and each rank's launches of each kernel of
    ``MULTI_GPU_KERNELS[name]`` exactly so often.  Adds the ranks' launches
    to ``launches``; returns each rank's results."""
    stem = os.path.join(d, "dryrun")
    torch.save({"modes": [(name, ov, job["inputs"]) for job in jobs for name, ov in job["modes"]]},
               stem + ".in.pt")
    t0 = time.perf_counter()
    launch(world, ["--inputs", stem + ".in.pt", "--out", stem + ".out", "--backend", backend,
                   "--device", device], "statecatcher_tpu_torch.parallel.dryrun",
           "[multi-gpu dryrun]")
    t_dry = time.perf_counter() - t0
    ranks = [torch.load(f"{stem}.out.rank{r}.pt", weights_only=False) for r in range(world)]
    for job in jobs:
        tag, cfg, K, params = job["tag"], job["cfg"], job["K"], job["inputs"]["params"]
        ref_of: dict = {}
        for name, _ in job["modes"]:
            key = tuple(job["refs"][name])
            if key not in ref_of:
                ref_of[key] = multi_gpu_reference(cfg.apply_overrides(job["refs"][name]), dev,
                                                  params, job["inputs"]["group"], K, job["B"])
            for r, res in enumerate(ranks):
                got = res[name]
                verdict = check_against_one_process(f"{tag} {name} rank {r}", got, ref_of[key],
                                                    params, 1e-6, K)
                want = {k: (n_layers(cfg) * per if per else 1) * K
                        for k, per in MULTI_GPU_KERNELS[name].items()}
                if {k: got["launches"].get(k, 0) for k in want} != want:
                    raise AssertionError(f"{tag} {name} rank {r} launches {got['launches']}; "
                                         f"want {want}")
                for k, n in got["launches"].items():
                    launches[k] = launches.get(k, 0) + n
                dp_, mp_, _ = got["plan"]
                timed = (f"{got['ms_per_segment']:.1f} ms per segment (first run "
                         f"{got['ms_per_segment_first']:.1f})" if job["time_runs"] else
                         f"{got['ms_per_segment_first']:.1f} ms per segment (first run)")
                log(f"{tag} {name}: rank {r} of {dp_}x{mp_} on {res['topology']['device']} "
                    f"over {res['topology']['backend']}: {timed}, "
                    f"{got['allreduce_bytes_per_update'] / 2**20:.2f} MiB all-reduced over the "
                    f"data group per update, {got['model_group_bytes_per_update'] / 2**20:.2f} "
                    f"MiB over the model group; launches {got['launches']}; vs one process: "
                    f"{verdict} ({CARD})")
    n_modes = sum(len(job["modes"]) for job in jobs)
    log(f"[multi-gpu] dryrun of {n_modes} modes of {len(jobs)} models in one launch on {world} "
        f"ranks: {t_dry:.1f} s ({CARD})")
    return ranks


def phase_multi_gpu(dev, K=2, B=32, seconds=48.0, target=16) -> dict:
    """Phase 33: multi-GPU training, one ``multi_gpu_launch`` on max(2,
    cards) ranks (two on cuda:0 over gloo with one card; NCCL, a card a rank,
    with more) in seven modes: the flagship LucyRNN (a) data parallel over every
    rank ("auto": K1/K2), (b) tensor parallel with mp=2 ("pallas": K5a/K5b on
    each rank's columns), (c) sequence parallel over 2 ranks ("sp": K5a/K5b
    on each time shard); (e) the xLSTM at the flagship's widths (E=512, 2
    heads, 3 blocks, d_ff 1364) tensor parallel with mp=2 through "auto"
    (K9a/K9b on each rank's head) and "pallas" (K10 on it); (f) the LSTM (2 ×
    512, phase 27's cut) and the RWKV (4 × 512) tensor parallel with mp=2,
    replicated (one segment each).  Then (d) the CLI on 2 ranks with ``--mesh.data_parallel 2`` on
    phase 7's fixture: two dispatches and a checkpoint (losses against phase
    7's one process), a 2-rank resume from it and a 1-process resume from
    the 2-rank checkpoint (equal losses).  Returns each kernel's launches,
    summed over the ranks of (a)–(f)."""
    t_phase = time.perf_counter()
    world, backend, device = multi_gpu_layout()
    log(f"[multi-gpu] backend {backend}, world {world} rank(s), --device {device}, "
        f"{torch.cuda.device_count()} card(s) ({CARD})")
    d = os.path.join(WORK, "multi_gpu")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    launches: dict = {}
    tp = ["--mesh.data_parallel", str(world // 2), "--mesh.model_parallel", "2"]
    pallas = ["--model.lucyrnn.kernel_impl", "pallas"]
    xpallas = ["--model.xlstm.kernel_impl", "pallas"]
    flagship = multi_gpu_job(
        "[multi-gpu]", FLAGSHIP,
        [("dp", ["--mesh.data_parallel", str(world)]), ("tp", tp + pallas),
         ("sp", tp + ["--model.lucyrnn.kernel_impl", "sp"])],
        {"dp": [], "tp": pallas, "sp": pallas}, K, B=B)
    jobs = [flagship,
            multi_gpu_job("[multi-gpu xlstm]", XLSTM_TP,
                          [("xlstm auto", tp), ("xlstm pallas", tp + xpallas)],
                          {"xlstm auto": [], "xlstm pallas": xpallas}, K, B=B),
            multi_gpu_job("[multi-gpu lstm]", ["--model.encoder", "lstm", *LSTM], [("lstm", tp)],
                          {"lstm": []}, 1, B=B, time_runs=0),
            multi_gpu_job("[multi-gpu rwkv]", RWKV, [("rwkv", tp)], {"rwkv": []}, 1, B=B)]
    ranks = multi_gpu_launch(jobs, world, backend, device, dev, d, launches)
    params, group = flagship["inputs"]["params"], flagship["inputs"]["group"]
    if torch.cuda.device_count() >= 2:
        # data parallel against one rank at the same per-rank batch
        Bl = B // world
        torch.save({"overrides": FLAGSHIP + ["--train.optim.lr", "1e-6"], "params": params,
                    "group": {k: v[:, :Bl] if v.ndim > 1 else v for k, v in group.items()},
                    "modes": [("dp", [])]}, os.path.join(d, "in1.pt"))
        launch(1, ["--inputs", os.path.join(d, "in1.pt"), "--out", os.path.join(d, "out1"),
                   "--device", "cuda", "--time-runs", "1"],
               "statecatcher_tpu_torch.parallel.dryrun", "[multi-gpu one rank]")
        one = torch.load(os.path.join(d, "out1.rank0.pt"), weights_only=False)["dp"]
        dp_ms = [r["dp"]["ms_per_segment"] for r in ranks]
        log(f"[multi-gpu scaling] data parallel, {Bl} rows per rank: 1 rank "
            f"{one['ms_per_segment']:.1f} ms per segment, {world} ranks "
            f"{', '.join(f'{x:.1f}' for x in dp_ms)} ms per segment (the slowest "
            f"{max(dp_ms) / one['ms_per_segment']:.3f}× one rank's) ({CARD})")

    # (d) the CLI over torchrun's environment, on phase 7's fixture
    t0 = time.perf_counter()
    data = write_cli_fixture(d, seconds=seconds, cue=target / 4)
    common = [*FLAGSHIP, "--data.source", "local", "--data.local_dir", data,
              "--data.target_duration", str(target), "--data.batch_size", "4",
              "--data.num_workers", "4", "--train.segments_per_dispatch", "1",
              "--train.log_every_n", "2", "--mesh.data_parallel", "2"]
    cli_dev = ["--device", device, "--backend", backend]

    def cli_ranks(extra, tag):
        outs = launch(2, cli_dev + common + extra, "statecatcher_tpu_torch.cli", tag)
        sums = [ast.literal_eval(o.strip().splitlines()[-1]) for o in outs]
        if sums[0]["loss_history"] != sums[1]["loss_history"] or \
                not np.isfinite(sums[0]["loss_history"]).all():
            raise AssertionError(f"{tag} ranks disagree: {[x['loss_history'] for x in sums]}")
        for x in sums:
            for k, n in x["kernel_launches"].items():
                launches[k] = launches.get(k, 0) + n
        return sums[0]

    first = cli_ranks(["--train.steps", "2", "--train.model_dir", os.path.join(d, "run1")],
                      "[multi-gpu cli]")
    meta = json.load(open(os.path.join(first["run_dir"], "ckpt", "2", "meta.json")))
    if meta["cursor"] != {"batches_done": 0, "seg_idx": 2}:
        raise AssertionError(f"[multi-gpu cli] checkpoint cursor {meta['cursor']}")
    one = CLI_LOSSES["lucyrnn"]
    d_one = np.abs(np.array(first["loss_history"]) - one) / np.abs(one)
    if d_one.max() > 1e-4:
        raise AssertionError(f"[multi-gpu cli] 2 ranks {first['loss_history']} vs phase 7's "
                             f"one process {one}")
    resume = ["--train.steps", "3", "--train.resume_from", first["run_dir"]]
    second = cli_ranks(resume + ["--train.model_dir", os.path.join(d, "run2")],
                       "[multi-gpu cli resume]")
    # one process trains unsharded whatever --mesh says, as the JAX loop does
    single = run_cli(["--device", "cuda:0" if device.startswith("cuda") else device, *common,
                      *resume,
                      "--train.model_dir", os.path.join(d, "run3")])
    for k, n in single["kernel_launches"].items():
        launches[k] = launches.get(k, 0) + n
    a, b = second["loss_history"], single["loss_history"]
    if len(a) != 1 or len(b) != 1 or abs(a[0] - b[0]) > 1e-4 * abs(b[0]):
        raise AssertionError(f"[multi-gpu cli] resumed on 2 ranks {a}, on 1 process {b}")
    log(f"[multi-gpu cli] 2 ranks, --mesh.data_parallel 2: losses "
        f"{[round(x, 4) for x in first['loss_history']]} (phase 7's one process "
        f"{[round(x, 4) for x in one]}, max rel {d_one.max():.2e}), checkpoint cursor "
        f"{meta['cursor']}; resumed on 2 ranks {a[0]:.5f}, on 1 process {b[0]:.5f} "
        f"({time.perf_counter() - t0:.1f} s for the three runs)")
    log(f"[multi-gpu] launches over the ranks of (a)-(f): {launches}")
    log(f"[time] phase 33 (multi-gpu): {time.perf_counter() - t_phase:.1f} s ({CARD})")
    return launches


LAP = [0.0]


def lap(name: str) -> None:
    """Log the seconds since the previous lap: each phase's share of the run."""
    now = time.perf_counter()
    log(f"[time] {name}: {now - LAP[0]:.1f} s")
    LAP[0] = now


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
    global CARD
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)                                                   # name, power limit
    CARD = smi
    log(f"torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    # full f32 matmuls (the JAX package uses Precision.HIGHEST); the frontend
    # refuses TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t_run = t0 = LAP[0] = time.perf_counter()
    builds = _kernels.build_all()
    log(f"[build] {len(_kernels.SIGNATURES)} kernel source(s) in {time.perf_counter() - t0:.1f} s")
    for lib, info in builds.items():
        usage = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {lib}: nvcc {info['seconds']:.1f} s; " + " | ".join(usage))

    sass = sass_dumps(("rnnt_joint", "rnnt_band", "mlstm_fused", "mlstm_pallas"))
    # the joint's forward and backward kernels run on the tensor cores: every
    # J and dtype instance of each
    for lib in ("rnnt_joint", "rnnt_band"):
        hmma = sass_hmma(sass[lib], "joint_")
        log(f"[build] {lib} SASS, HMMA instructions per kernel: "
            + ", ".join(f"{k} {v}" for k, v in sorted(hmma.items())))
        fwd = {k: v for k, v in hmma.items() if "fwd_mma" in k}
        if len(fwd) != 4 or min(fwd.values()) == 0:
            raise AssertionError(f"{lib}: the forward's kernels hold no HMMA: {hmma}")
        bwd = {k: v for k, v in hmma.items() if "bwd_rows_mma" in k or "bwd_dk_mma" in k}
        if len(bwd) != 8 or min(bwd.values()) == 0:
            raise AssertionError(f"{lib}: the backward's kernels hold no HMMA: {hmma}")
        wide = {k: v for k, v in hmma.items() if "wide_gemm" in k}   # J > 128: 4 products × 2
        if len(wide) != 8 or min(wide.values()) == 0:
            raise AssertionError(f"{lib}: the tiled products (J > 128) hold no HMMA: {hmma}")
    # so do the mLSTM's product kernels (the chunk and state products): K9a's
    # and K10's forward passes in both libraries, K9b's in mlstm_fused
    fwd_products = ("state_kernel", "fwd_exit_kernel", "fwd_out_kernel")
    bwd_products = ("state_kernel", "bwd_rows_kernel", "bwd_dk_kernel", "bwd_dv_kernel")
    for lib, products in (("mlstm_fused", fwd_products + bwd_products[1:]),
                          ("mlstm_pallas", fwd_products)):
        hmma = sass_hmma(sass[lib], "")
        log(f"[build] {lib} SASS, HMMA instructions per kernel: "
            + ", ".join(f"{k} {v}" for k, v in sorted(hmma.items())))
        mma = {k: v for k, v in hmma.items() if k.split("<")[0] in products}
        if {k.split("<")[0] for k in mma} != set(products) or min(mma.values()) == 0:
            raise AssertionError(f"{lib}: a product kernel of the mLSTM holds no HMMA: {hmma}")

    lap("builds")
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

    n_batched, _ = phase_batched(model, cfg, dev)
    n_stream = phase_streaming(model, cfg, dev)
    lap("phases 1-3")
    k2 = phase_cell_bwd(dev)
    lattice = phase_lattice(dev)
    del model
    n_train = phase_train_step(cfg, dev)
    lap("phases 4-5")
    phase_throughput(cfg, dev, K=8)
    run_dir, overrides = phase_cli()
    n_eval = phase_eval(run_dir, overrides, ("greedy", "beam"), dev, "[eval ctc]")
    lap("phases 6-7")

    rk = phase_rnnt_kernels(dev)
    n_rtrain = phase_train_step(cfg, dev, K=2, U=48, mode="rnnt")
    phase_rnnt_witness(cfg, dev, K=2, U=48)
    model = rnnt_model(cfg, dev)
    n_rstream = phase_rnnt_streaming(model, cfg, dev)
    del model
    lap("phases 8-10")

    k5 = phase_scan_kernels(dev)
    masked = cfg.apply_overrides(MASKED)
    model = build_speech_model(masked.model, masked.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    n_mbatched, split_ms = phase_batched(model.eval(), masked, dev)
    del model
    n_mtrain = phase_train_step(masked, dev, K=2, path="ctc masked")
    lap("phases 11-12")
    k8 = phase_band_kernels(dev)
    n_btrain = phase_train_step(cfg, dev, K=2, U=128, mode="rnnt", path="rnnt banded",
                                degenerate=True)
    # the joiner 640 wide: K6 and K8 through the tiled products
    wcfg = cfg.apply_overrides(WIDE_JOINER)
    n_jtrain = phase_train_step(wcfg, dev, K=2, U=48, mode="rnnt", path="rnnt J=640")
    n_jbtrain = phase_train_step(wcfg, dev, K=2, U=128, mode="rnnt", path="rnnt banded J=640")
    lap("phases 13-14 (joiner 640 groups included)")
    for U in (64, 128):
        phase_throughput(cfg, dev, K=4, U=U, mode="rnnt")
    run_dir, overrides = phase_cli_rnnt()
    n_reval = phase_eval(run_dir, overrides, ("rnnt-greedy", "rnnt-beam"), dev, "[eval rnnt]")
    lap("phases 15-16")
    phase_cli_rnnt(extra=WIDE_JOINER + ["--train.rnnt_band", "0"], tag="[cli rnnt J=640 exact]")
    phase_cli_rnnt(extra=WIDE_JOINER, tag="[cli rnnt J=640 banded]")
    lap("the joiner-640 CLI runs")

    k9 = phase_mlstm_kernels(dev)
    lap("phase 17")
    xcfg = Config().apply_overrides(XLSTM)
    pcfg = xcfg.apply_overrides(["--model.xlstm.kernel_impl", "pallas"])
    models = {}
    for c in (xcfg, pcfg):
        models[c.model.xlstm.kernel_impl] = build_speech_model(
            c.model, c.frontend.n_mfcc, "ctc", device=dev,
            generator=torch.Generator().manual_seed(SEED))
        randomize_(models[c.model.xlstm.kernel_impl], SEED + 1)
    x = xcfg.model.xlstm
    log(f"[model] SpeechModel xlstm E={x.embedding_dim}, {x.num_heads} heads, {x.num_blocks} "
        f"blocks, chunk {x.chunk_size}, vocab {xcfg.model.vocab_size}, {xcfg.model.dtype}, "
        f"{sum(p.numel() for p in models['auto'].parameters())} parameters")
    n_xbatched, _ = phase_batched(models["auto"].eval(), xcfg, dev, {"K9a": mlstm_fused_fwd},
                                  "[xlstm batched]")
    n_pbatched, _ = phase_batched(models["pallas"].eval(), pcfg, dev, {"K10": mlstm_pallas_fwd},
                                  "[xlstm pallas batched]")
    n_xstream = phase_streaming(models["auto"], xcfg, dev, mlstm_fused_fwd, "[xlstm streaming]")
    del models
    lap("phases 18-19")
    n_xtrain = phase_train_step(xcfg, dev, K=2, path="xlstm ctc")
    phase_throughput(xcfg.apply_overrides(["--model.xlstm.chunk_size", "256"]), dev, K=4, B=64)
    phase_cli(encoder="xlstm")
    lap("phases 20-22")
    n_xwide = phase_xlstm_wide(dev)
    phase_cli(encoder="xlstm", extra=XLSTM_2048[2:], tag="[cli xlstm E=2048]")
    lap("the xLSTM at E=2048 and chunk 512, its CLI runs included")

    k12 = phase_cell_scan_kernels(dev)
    kcfg = masked.apply_overrides(["--model.lucyrnn.kernel_impl", "auto-fused"])
    dcfg = masked.apply_overrides(["--model.lucyrnn.kernel_impl", "pallas-dual"])
    ncfg = masked.apply_overrides(NATIVE)
    kmodel, dmodel, nmodel = (build_speech_model(c.model, c.frontend.n_mfcc, "ctc", device=dev,
                                                 generator=torch.Generator().manual_seed(SEED))
                              for c in (kcfg, dcfg, ncfg))
    for m_ in (kmodel, dmodel, nmodel):
        randomize_(m_, SEED + 1)
        m_.eval()
    n_kbatched, k12_ms = phase_batched(kmodel, kcfg, dev, {"K12": lucy_fused_cell},
                                       "[k12 batched masked]")
    log(f"[k12 batched masked] the masked segment: {k12_ms[2]:.1f} ms through K12, "
        f"{split_ms[2]:.1f} ms through the split path (phase 12 of this run)")
    n_kstream = phase_streaming(kmodel, kcfg, dev, lucy_fused_cell, "[k12 streaming]")
    n_ktrain = phase_train_step(kcfg, dev, K=2, path="ctc k12")
    n_dbatched, _ = phase_batched(dmodel, dcfg, dev, {"K11": lucy_dual_scan},
                                  "[dual batched masked]")
    n_dtrain = phase_train_step(dcfg, dev, K=1, path="ctc dual")
    log(f"[model] SpeechModel lucyrnn native {ncfg.model.num_layers} × "
        f"{ncfg.model.hidden_size}, vocab {ncfg.model.vocab_size}, masked, "
        f"{sum(p.numel() for p in nmodel.parameters())} parameters")
    n_nbatched, _ = phase_batched(nmodel, ncfg, dev, {"K5a": linear_scan_fwd},
                                  "[native batched masked]")
    n_nstream = phase_streaming(nmodel, ncfg, dev, linear_scan_fwd, "[native streaming]")
    del kmodel, dmodel, nmodel
    n_ntrain = phase_train_step(ncfg, dev, K=2, path="native ctc")
    phase_cli(extra=NATIVE, tag="[cli native]")
    lap("phases 23-26")

    n_ltrain = phase_lstm(dev)
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    randomize_(model, SEED + 1)
    model.eval()
    phase_ctc_beam(model, cfg, dev)
    n_bstream = phase_beam_streaming(model, cfg, dev)
    del model
    lap("phases 27-29")

    t0 = time.perf_counter()
    n_wtrain, _ = phase_rwkv(dev)
    log(f"[time] phase 30 (rwkv): {time.perf_counter() - t0:.1f} s ({CARD})")
    t0 = time.perf_counter()
    phase_host_side(dev)
    log(f"[time] phase 31 (host side): {time.perf_counter() - t0:.1f} s ({CARD})")
    n_multi = phase_multi_gpu(dev)
    lap("phases 30-33")

    csrc = "statecatcher_tpu_torch/ops/csrc/"
    n_k1 = (n_batched["K1"] + n_stream + n_train["K1"] + n_rtrain["K1"] + n_rstream
            + n_mbatched["K1"] + n_btrain["K1"] + n_jtrain["K1"] + n_jbtrain["K1"] + n_eval
            + n_reval + n_bstream + n_multi.get("lucy_cell_fused_lm", 0))
    n_k2 = (n_train["K2"] + n_rtrain["K2"] + n_btrain["K2"] + n_jtrain["K2"] + n_jbtrain["K2"]
            + n_multi.get("lucy_cell_fused_lm_bwd", 0))
    n_rnnt = {name: n_rtrain[name] + n_jtrain[name] for name in ("K6a", "K6b", "K7a", "K7b")}
    n_rnnt.update({name: n_btrain[name] + n_jbtrain[name]
                   for name in ("K8a", "K8b", "band α", "band β")})
    n_k5a = (n_mbatched["K5a"] + n_mtrain["K5a"] + n_nbatched["K5a"] + n_nstream
             + n_ntrain["K5a"] + n_multi.get("linear_scan_fwd", 0))
    n_k5b = (n_mtrain["K5b"] + n_ktrain["K5b"] + n_dtrain["K5b"] + n_ntrain["K5b"]
             + n_multi.get("linear_scan_rev", 0))
    n_k3 = (n_train["K3"] + n_mtrain["K3"] + n_xtrain["K3"] + n_ktrain["K3"] + n_dtrain["K3"]
            + n_ntrain["K3"] + n_ltrain["K3"] + n_wtrain["K3"] + n_multi.get("ctc_alpha", 0))
    n_k4 = (n_train["K4"] + n_mtrain["K4"] + n_xtrain["K4"] + n_ktrain["K4"] + n_dtrain["K4"]
            + n_ntrain["K4"] + n_ltrain["K4"] + n_wtrain["K4"] + n_multi.get("ctc_beta", 0))
    n_k12 = n_kbatched["K12"] + n_kstream + n_ktrain["K12"]
    n_k11 = n_dbatched["K11"] + n_dtrain["K11"]
    n_k9a = (n_xbatched["K9a"] + n_xstream + n_xtrain["K9a"] + n_xwide["K9a"]
             + n_multi.get("mlstm_fused_fwd", 0))
    n_k9b = n_xtrain["K9b"] + n_xwide["K9b"] + n_multi.get("mlstm_fused_bwd", 0)
    n_k10 = n_pbatched["K10"] + n_xwide["K10"] + n_multi.get("mlstm_pallas_fwd", 0)
    log(f"[kernels] launches: K1 batched {n_batched['K1']}, streaming {n_stream}, train "
        f"{n_train['K1']}, rnnt train {n_rtrain['K1']}, rnnt streaming {n_rstream}, masked "
        f"batched {n_mbatched['K1']}, banded rnnt train {n_btrain['K1']}, eval ctc {n_eval}, "
        f"eval rnnt {n_reval}, beam streaming {n_bstream}; K2 {n_k2}; K3 {n_k3}, K4 {n_k4} "
        f"(train, masked, xlstm, k12, dual, native, lstm and rwkv train; lstm {n_ltrain['K3']}, "
        f"{n_ltrain['K4']}; rwkv {n_wtrain['K3']}, {n_wtrain['K4']}); K5a {n_k5a} (masked "
        f"batched + train, native batched + streaming + train), K5b {n_k5b} (masked, k12, dual "
        f"and native train); K12 batched {n_kbatched['K12']}, streaming {n_kstream}, train "
        f"{n_ktrain['K12']}; K11 batched {n_dbatched['K11']}, train {n_dtrain['K11']}; "
        f"K6a {n_rtrain['K6a']}, K6b {n_rtrain['K6b']}, K7a {n_rtrain['K7a']}, K7b "
        f"{n_rtrain['K7b']} (rnnt train); K8a {n_btrain['K8a']}, K8b {n_btrain['K8b']}, band α "
        f"{n_btrain['band α']}, band β {n_btrain['band β']} (banded rnnt train); at J=640 "
        f"K6a {n_jtrain['K6a']}, K6b {n_jtrain['K6b']}, K7a {n_jtrain['K7a']}, K7b "
        f"{n_jtrain['K7b']}, K8a {n_jbtrain['K8a']}, K8b {n_jbtrain['K8b']}, band α "
        f"{n_jbtrain['band α']}, band β {n_jbtrain['band β']}; K9a xlstm "
        f"batched {n_xbatched['K9a']}, streaming {n_xstream}, train {n_xtrain['K9a']}; K9b "
        f"{n_xtrain['K9b']} (xlstm train); K10 {n_pbatched['K10']} (xlstm pallas batched); "
        f"at E=2048 and chunk 512 (batched, streaming, train) {n_xwide}; "
        f"K9a {n_k9a}, K9b {n_k9b}, K10 {n_k10} with the multi-GPU ranks'; "
        f"the multi-GPU ranks' (phase 33, in the sums above) {n_multi}")
    entries = [
        ("lucy_cell_fused_lm", "lucy_fused_lm_fwd.cu", "lucy_fused_lm.py:156", n_k1,
         k1["batched f32"]),
        ("lucy_cell_fused_lm_bwd", "lucy_fused_lm_bwd.cu", "lucy_fused_lm.py:248", n_k2,
         k2["batched f32"]),
        ("ctc_alpha", "ctc_lattice.cu", "ctc_pallas.py:58", n_k3, lattice["training"]["alpha"]),
        ("ctc_beta", "ctc_lattice.cu", "ctc_pallas.py:92", n_k4, lattice["training"]["beta"]),
        ("linear_scan_fwd", "linear_scan.cu", "lucy_pallas.py:35", n_k5a, k5["K5a f32"]),
        ("linear_scan_rev", "linear_scan.cu", "lucy_pallas.py:118", n_k5b, k5["K5b f32"]),
        ("rnnt_joint_fwd", "rnnt_joint.cu", "rnnt_pallas.py:72", n_rnnt["K6a"],
         rk["K6a training f32"]),
        ("rnnt_joint_bwd", "rnnt_joint.cu", "rnnt_pallas.py:92", n_rnnt["K6b"],
         rk["K6b training f32"]),
        ("rnnt_alpha", "rnnt_lattice.cu", "rnnt_dp_pallas.py:69", n_rnnt["K7a"],
         rk["K7a training"]),
        ("rnnt_beta", "rnnt_lattice.cu", "rnnt_dp_pallas.py:93", n_rnnt["K7b"],
         rk["K7b training"]),
        ("rnnt_band_fwd", "rnnt_band.cu", "rnnt_band.py:80", n_rnnt["K8a"], k8["K8a f32"]),
        ("rnnt_band_bwd", "rnnt_band.cu", "rnnt_band.py:100", n_rnnt["K8b"], k8["K8b f32"]),
        # the banded lattice is an XLA scan in the JAX package, no TPU kernel
        ("rnnt_band_alpha", "rnnt_lattice.cu", "rnnt_band.py:319", n_rnnt["band α"],
         k8["band alpha"]),
        ("rnnt_band_beta", "rnnt_lattice.cu", "rnnt_band.py:319", n_rnnt["band β"],
         k8["band beta"]),
        ("mlstm_fused_fwd", "mlstm_fused.cu", "mlstm_fused.py:158", n_k9a, k9["K9a f32"]),
        ("mlstm_fused_bwd", "mlstm_fused.cu", "mlstm_fused.py:251", n_k9b, k9["K9b f32"]),
        ("mlstm_pallas_fwd", "mlstm_pallas.cu", "mlstm_pallas.py:30", n_k10, k9["K10 f32"]),
        ("lucy_fused_cell", "lucy_cell_scan.cu", "lucy_pallas.py:319", n_k12,
         k12["K12 batched f32 masked"]),
        ("lucy_dual_scan", "lucy_cell_scan.cu", "lucy_pallas.py:527", n_k11,
         k12["K11 batched f32 masked"]),
    ]
    if any(e[3] <= 0 for e in entries):
        raise AssertionError(f"a kernel of the main path never launched: {entries}")
    log(f"[time] the whole run, builds included: {time.perf_counter() - t_run:.1f} s ({CARD})")
    log(json.dumps({"kernels": [
        kernel_entry(name, csrc + src, "statecatcher_tpu/ops/" + tpu, n, m)
        for name, src, tpu, n, m in entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
