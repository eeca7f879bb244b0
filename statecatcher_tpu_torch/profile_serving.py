"""Where the serving path's device time goes, from a ``torch.profiler`` trace.

    python -m statecatcher_tpu_torch.profile_serving [--encoder lucyrnn|xlstm|lstm]
        [--chunks 30] [--out DIR]

Builds the flagship LucyRNN-CTC (4 × 512, vocab 1024, 80 MFCC, float32), or
with ``--encoder xlstm`` the xLSTM-CTC of the config's defaults, or with
``--encoder lstm`` the LSTM-CTC of the config's defaults (4 × 512), with
seeded random weights on the card and traces two windows after a warm-up:

  * batched: one 16 s segment at B=32 (features → model → log-softmax);
  * streaming: ``--chunks`` 32-frame chunks of ``StreamingRecognizer``.

For each it prints the host wall time, the device's busy time (the sum of
its kernels and copies, which run on one stream and do not overlap) and
idle share, the number of device operations (kernels and copies) and the
device time by kernel name, largest first.  With
``--out`` it also writes each window's chrome trace there.
"""

from __future__ import annotations

import argparse
import collections
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import randomize_, synth_audio


def _report(label: str, prof, wall_s: float, top: int = 12) -> None:
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us()
            by_name[ev.name][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    if busy_us == 0:
        raise RuntimeError(f"{label}: the trace holds no device activity")
    print(f"[{label}] host wall {wall_s * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / (wall_s * 1e6):.1%}, "
          f"{sum(v[1] for v in by_name.values())} device operations")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{label}]   {us / 1e3:9.3f} ms {us / busy_us:6.1%} {n:5d}×  {name[:110]}")


def _traced(label: str, fn, out: Path | None) -> None:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(label, prof, wall)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{label}.json"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", choices=("lucyrnn", "xlstm", "lstm"), default="lucyrnn")
    ap.add_argument("--chunks", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    cfg = Config().apply_overrides(["--model.encoder", args.encoder])
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=dev,
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    rng = np.random.default_rng(5)

    audio = torch.from_numpy(synth_audio(rng, 32, 16 * 16000)).to(dev)

    def batched():
        with torch.inference_mode():
            logits, _ = model(compute_features(audio, cfg.frontend))
            torch.log_softmax(logits, dim=-1)

    batched()                                                  # warm-up
    _traced("batched B=32 16 s", batched, args.out)

    rec = StreamingRecognizer(model, cfg, chunk_frames=32, device=dev)
    stream = synth_audio(rng, 1, rec.chunk_samples * (args.chunks + 4) + rec.lookahead)[0]
    warm = rec.chunk_samples * 4
    rec.accept_waveform(stream[:warm])                         # warm-up: 4 chunks
    _traced(f"streaming {args.chunks} chunks", lambda: rec.accept_waveform(stream[warm:]),
            args.out)


if __name__ == "__main__":
    main()
