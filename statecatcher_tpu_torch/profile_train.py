"""Where one training segment's device time goes, from a ``torch.profiler``
trace.

    python -m statecatcher_tpu_torch.profile_train [--encoder lucyrnn|xlstm|lstm|rwkv]
        [--mode ctc|rnnt] [--batch 32] [--dtype float32] [--tokens U] [--out DIR]

Builds the flagship LucyRNN (4 × 512, vocab 1024, 80 MFCC) or, with
``--encoder xlstm``, the xLSTM of the config's defaults (E=512, 2 heads, 3
blocks, chunk 128), or with ``--encoder lstm`` the LSTM of the config's
defaults (4 × 512), or with ``--encoder rwkv`` the RWKV at the same widths
(its WKV scans torch ops), in CTC or RNN-T mode (the joiner at the config's 64 ×
64) with seeded random weights on the card and traces one 16 s training
segment of ``make_segment_scan_step``
(U random tokens: 128 for CTC, 48 for RNN-T, where the auto band is the
exact loss; int16 audio as the loop ships it) after a warm-up segment.  It
prints the host wall time, the device's busy time (the sum of its kernels
and copies, which run on one stream) and idle share, the device time by
kernel name, largest first, and the same grouped by the port's kernels
(K1..K4, K6/K8 by kernel, K7, the banded lattice, K9), the GEMMs and
the rest.  With ``--out`` it also writes the chrome trace there.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.profile_serving import _report
from statecatcher_tpu_torch.testing import randomize_, synth_audio
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

# kernel-name fragments → the group they are reported under
GROUPS = (("K1 lucy_fused_lm_fwd", "lucy_fused_lm_fwd"),
          ("K2 lucy_fused_lm_bwd", "lucy_fused_lm_bwd"),
          ("K3 ctc_alpha", "ctc_alpha"),
          ("K4 ctc_beta", "ctc_beta"),
          ("K6a/K8a joint_fwd_mma_kernel", "joint_fwd_mma"),
          ("K6b/K8b joint_bwd_rows_mma_kernel (d_enc, d_pred)", "joint_bwd_rows_mma"),
          ("K6b/K8b joint_bwd_dk_mma_kernel (d_K, d_bias)", "joint_bwd_dk_mma"),
          ("K6/K8 joint_kprep_kernel (forward and backward), joint_bwd_rowrec_kernel",
           "joint_kprep"),
          ("K6/K8 joint_kprep_kernel (forward and backward), joint_bwd_rowrec_kernel",
           "joint_bwd_rowrec"),
          ("K8b band_dpred_kernel", "band_dpred"),
          # the wavefront's kernel; the frame-scan kernels before it
          ("band lattice rnnt_band_alpha/rnnt_band_beta", "band_wavefront"),
          ("band lattice rnnt_band_alpha/rnnt_band_beta", "rnnt_band_alpha"),
          ("band lattice rnnt_band_alpha/rnnt_band_beta", "rnnt_band_beta"),
          # K7's wavefront route (alpha, beta), then its scan route
          ("K7a rnnt_alpha", "exact_wavefront_kernel<false"),
          ("K7b rnnt_beta", "exact_wavefront_kernel<true"),
          ("K7a rnnt_alpha", "rnnt_alpha"),
          ("K7b rnnt_beta", "rnnt_beta"),
          ("K9a fwd_out_kernel (h)", "::fwd_out_kernel"),
          ("K9a fwd_exit_kernel (C_T, n_T)", "::fwd_exit_kernel"),
          ("K9b bwd_rows_kernel (dq, the rows' terms)", "bwd_rows_kernel"),
          ("K9b bwd_dk_kernel", "bwd_dk_kernel"),
          ("K9b bwd_dv_kernel", "bwd_dv_kernel"),
          ("K9a/K9b state/nterm_kernel (entry states; K9b's dC_c)", "::state_kernel"),
          ("K9a/K9b state/nterm_kernel (entry states; K9b's dC_c)", "::nterm_kernel"),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", "::gates_"),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", "::scan_fwd_kernel"),
          ("K9b scan_bwd, chain, fixup", "bwd_scan_bwd"),
          ("K9b scan_bwd, chain, fixup", "bwd_chain_kernel"),
          ("K9b scan_bwd, chain, fixup", "bwd_fixup_kernel"),
          ("GEMMs", "gemm"), ("GEMMs", "cutlass"), ("GEMMs", "xmma"), ("GEMMs", "nvjet"))


def _groups(prof) -> None:
    from torch.autograd import DeviceType

    by: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        group = next((g for g, frag in GROUPS if frag in ev.name.lower()), "other")
        by[group] = by.get(group, 0.0) + ev.time_range.elapsed_us()
    total = sum(by.values())
    for g, us in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"[groups] {us / 1e3:9.3f} ms {us / total:6.1%}  {g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", choices=("lucyrnn", "xlstm", "lstm", "rwkv"), default="lucyrnn")
    ap.add_argument("--mode", choices=("ctc", "rnnt"), default="ctc")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--tokens", type=int, default=None,
                    help="tokens per row (default 128 for ctc, 48 for rnnt)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    cfg = Config().apply_overrides(["--model.encoder", args.encoder, "--model.dtype", args.dtype,
                                    "--train.mode", args.mode])
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, args.mode, device=dev,
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0, ctc_impl=cfg.train.ctc_impl)
    B, S = args.batch, 16 * 16000
    U = args.tokens or (128 if args.mode == "ctc" else 48)
    rng = np.random.default_rng(5)

    def segment():
        audio = np.clip(np.rint(synth_audio(rng, B, S) * 32767.0), -32768, 32767)
        return [torch.from_numpy(x).to(dev) for x in (
            audio.astype(np.int16)[None], np.full((1, B), S, np.int32),
            rng.integers(1, cfg.model.vocab_size, (1, B, U)).astype(np.int32),
            np.full((1, B), U, np.int32), np.ones((1, B), bool))]

    carry = init_carry(cfg.model, B, device=dev)
    state, carry, _ = step(state, carry, *segment(), np.ones(1, bool))        # warm-up
    group = segment()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, carry, *group, np.ones(1, bool))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"{args.encoder} {args.mode} train segment B={B} 16 s U={U} {args.dtype}", prof,
            wall, top=16)
    _groups(prof)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "train_segment.json"))


if __name__ == "__main__":
    main()
