"""Where one training segment's device time goes, from a ``torch.profiler``
trace.

    python -m statecatcher_tpu_torch.profile_train [--encoder lucyrnn|xlstm|lstm|rwkv]
        [--mode ctc|rnnt] [--batch 32] [--dtype float32] [--tokens U] [--out DIR]
        [config overrides, e.g. --model.lucyrnn.kernel_impl pallas-fused]

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
kernel name, largest first, and the same grouped by the port's hand
kernels (``GROUPS``: each of K1–K12 by its CUDA name, and its template
policy where kernels share one), the GEMMs and the rest.  Other arguments
are the CLI's config overrides: ``--model.lucyrnn.mask_state_updates true
--model.lucyrnn.kernel_impl pallas`` trains the masked cell through K5a/K5b,
``pallas-fused`` through K12, ``pallas-dual`` through K11.  With ``--out``
it also writes the chrome trace there.
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

# The port's hand kernels: a CUDA kernel's group is the first entry all of
# whose fragments its lowercased name holds.  Where kernels share a
# template, the fragments name the kernel and its policy type; K12's
# policy, MaskedCellChain, holds K1's, Chain, so K12 comes first.
GROUPS = (("K12 cell_fwd_kernel<MaskedCellChain>", ("cell_fwd_kernel", "maskedcellchain")),
          ("K1 cell_fwd_kernel<Chain>", ("cell_fwd_kernel", "chain")),
          ("K2 lucy_fused_lm_bwd_kernel", ("lucy_fused_lm_bwd_kernel",)),
          ("K5a ring_scan_kernel<FwdScan>", ("ring_scan_kernel", "fwdscan")),
          ("K5b ring_scan_kernel<RevScan>", ("ring_scan_kernel", "revscan")),
          ("K11 ring_scan_kernel<DualScan>", ("ring_scan_kernel", "dualscan")),
          ("K3 ctc_alpha_kernel", ("ctc_alpha_kernel",)),
          ("K4 ctc_beta_kernel", ("ctc_beta_kernel",)),
          ("K6a/K8a joint_fwd_mma_kernel", ("joint_fwd_mma_kernel",)),
          ("K6b/K8b joint_bwd_rows_mma_kernel (d_enc, d_pred)", ("joint_bwd_rows_mma_kernel",)),
          ("K6b/K8b joint_bwd_dk_mma_kernel (d_K, d_bias)", ("joint_bwd_dk_mma_kernel",)),
          ("K6/K8 joint_kprep_kernel (forward and backward), joint_bwd_rowrec_kernel",
           ("joint_kprep_kernel",)),
          ("K6/K8 joint_kprep_kernel (forward and backward), joint_bwd_rowrec_kernel",
           ("joint_bwd_rowrec_kernel",)),
          ("K8b band_dpred_kernel", ("band_dpred_kernel",)),
          # above J = 128: the tiled products (logits, d_logits, d_joint, d_K)
          ("K6/K8 J > 128 joint_wide_gemm_kernel", ("joint_wide_gemm_kernel",)),
          ("K6/K8 J > 128 joint_wide_prep_kernel, joint_wide_joint_kernel (operands)",
           ("joint_wide_prep_kernel",)),
          ("K6/K8 J > 128 joint_wide_prep_kernel, joint_wide_joint_kernel (operands)",
           ("joint_wide_joint_kernel",)),
          ("K6a/K8a J > 128 joint_wide_lse_kernel", ("joint_wide_lse_kernel",)),
          ("K6b/K8b J > 128 joint_wide_denc_kernel, joint_wide_dpred_kernel",
           ("joint_wide_denc_kernel",)),
          ("K6b/K8b J > 128 joint_wide_denc_kernel, joint_wide_dpred_kernel",
           ("joint_wide_dpred_kernel",)),
          ("band lattice band_wavefront_kernel (α, β)", ("band_wavefront_kernel",)),
          # K7's wavefront route, then its frame-scan route (U+1 > 1024)
          ("K7a rnnt_alpha", ("exact_wavefront_kernel<false",)),
          ("K7b rnnt_beta", ("exact_wavefront_kernel<true",)),
          ("K7a rnnt_alpha", ("rnnt_alpha_kernel",)),
          ("K7b rnnt_beta", ("rnnt_beta_kernel",)),
          ("K9a fwd_out_kernel (h)", ("fwd_out_kernel",)),
          ("K9a fwd_exit_kernel (C_T, n_T)", ("fwd_exit_kernel",)),
          ("K9b bwd_rows_kernel (dq, the rows' terms)", ("bwd_rows_kernel",)),
          ("K9b bwd_dk_kernel", ("bwd_dk_kernel",)),
          ("K9b bwd_dv_kernel", ("bwd_dv_kernel",)),
          ("K9a/K9b state/nterm_kernel (entry states; K9b's dC_c)", ("state_kernel",)),
          ("K9a/K9b state/nterm_kernel (entry states; K9b's dC_c)", ("nterm_kernel",)),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", ("gates_kernel",)),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", ("gates_m_kernel",)),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", ("gates_one_kernel",)),
          ("K9a/K9b gates, scan_fwd (the shared passes 1 and 3)", ("scan_fwd_kernel",)),
          ("K9b scan_bwd, chain, fixup", ("bwd_scan_bwd_kernel",)),
          ("K9b scan_bwd, chain, fixup", ("bwd_chain_kernel",)),
          ("K9b scan_bwd, chain, fixup", ("bwd_fixup_kernel",)))
# library kernels (not in ops/csrc), matched after the hand kernels
LIBRARY_GROUPS = (("GEMMs", ("gemm",)), ("GEMMs", ("cutlass",)), ("GEMMs", ("xmma",)),
                  ("GEMMs", ("nvjet",)))


def group_of(kernel: str) -> str:
    """The group a CUDA kernel's (demangled) name is reported under."""
    name = kernel.lower()
    return next((g for g, frags in GROUPS + LIBRARY_GROUPS
                 if all(f in name for f in frags)), "other")


def _groups(prof) -> None:
    from torch.autograd import DeviceType

    by: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        group = group_of(ev.name)
        by[group] = by.get(group, 0.0) + ev.time_range.elapsed_us()
    total = sum(by.values())
    for g, us in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"[groups] {us / 1e3:9.3f} ms {us / total:6.1%}  {g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    ap.add_argument("--encoder", choices=("lucyrnn", "xlstm", "lstm", "rwkv"), default="lucyrnn")
    ap.add_argument("--mode", choices=("ctc", "rnnt"), default="ctc")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--tokens", type=int, default=None,
                    help="tokens per row (default 128 for ctc, 48 for rnnt)")
    ap.add_argument("--out", type=Path, default=None)
    args, overrides = ap.parse_known_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    cfg = Config().apply_overrides(["--model.encoder", args.encoder, "--model.dtype", args.dtype,
                                    "--train.mode", args.mode, *overrides])
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
    _report(f"{args.encoder} {args.mode} train segment B={B} 16 s U={U} {args.dtype}"
            f"{' ' + ' '.join(overrides) if overrides else ''}", prof, wall, top=16)
    _groups(prof)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "train_segment.json"))


if __name__ == "__main__":
    main()
