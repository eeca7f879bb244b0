"""Phase 30's RWKV card-against-CPU check of ``chip_smoke.py`` over several
seeds, with its TF32 control, on one CUDA card.

    python tools/rwkv_tf32_control.py [--seeds 0 1 2]

For each seed it builds the RWKV at the flagship's widths (4 × 512, vocab
1024, 80 MFCC, f32, ``randomize_`` weights), runs one 16 s segment at B=4
on the card, on the CPU and on the card with TF32 matmuls, and prints each
reading (max|Δ| over the CPU's scale, for the log-probs and the five carry
leaves) beside ``chip_smoke.RWKV_CARD_VS_CPU``'s limit, and whether the
check passed.  The readings set those limits.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from statecatcher_tpu_torch.config import Config  # noqa: E402
from statecatcher_tpu_torch.models.speech import build_speech_model  # noqa: E402
from statecatcher_tpu_torch.testing import randomize_  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    chip_smoke.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(chip_smoke.CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    failed = 0
    for seed in args.seeds:
        chip_smoke.SEED = seed
        cfg = Config().apply_overrides(chip_smoke.RWKV)
        model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                                   generator=torch.Generator().manual_seed(seed))
        randomize_(model, seed + 1)
        model.eval()
        print(f"seed {seed}:", flush=True)
        try:
            chip_smoke.rwkv_card_vs_cpu(model, cfg, dev)
        except AssertionError as e:
            failed += 1
            print(f"seed {seed}: check failed: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
