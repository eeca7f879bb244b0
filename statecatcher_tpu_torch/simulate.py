"""Data-pipeline simulator: the full L1 dry-run with no model.

Own copy of ``statecatcher_tpu/simulate.py``: it runs on the host only (no
model, no card), over either data source.

Parity with reference simulate.py:8-98 — fetch → preprocess → segment-slice
→ mark-done against a real (or local) data source, printing per-segment
shapes/texts, so the data plane can be validated end-to-end before any
training.  Usage::

    python -m statecatcher_tpu_torch.simulate --data.source local \
        --data.local_dir fixtures/ --data.target_duration 8.0 [--batches 3]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data.pipeline import BatchPipeline, stack_segment_slice


def plot_batch_waveforms(audio, texts, epoch, batch_id, seg_idx, out_dir="plots"):
    """Waveform debug plots (reference dataset.py:268-289): one figure per
    segment slice, one row per batch item with its transcript as title."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    n = len(audio)
    fig, axes = plt.subplots(
        n, 1, figsize=(10, 1.8 * n), squeeze=False, constrained_layout=True
    )
    for row, (ax, waveform, text) in enumerate(zip(axes[:, 0], audio, texts)):
        w = np.asarray(waveform)
        ax.plot(w, linewidth=0.4)
        ax.margins(x=0)
        ax.set_axis_off()
        ax.text(0.0, 1.02, f"[{row}] {text[:80]}",
                transform=ax.transAxes, fontsize=7, va="bottom")
    fname = os.path.join(
        out_dir, f"batch{epoch:04d}_batch{int(batch_id):05d}_segment{seg_idx:05d}.pdf"
    )
    fig.savefig(fname)
    plt.close(fig)
    return fname


def simulate_training_loop(cfg: Config, max_batches: int = 2, verbose: bool = True,
                           debug_spectrograms: bool = False):
    from statecatcher_tpu_torch.train.loop import build_dataset

    ds = build_dataset(cfg)
    ds.start_session(
        batch_size=cfg.data.batch_size, order=cfg.data.order,
        min_duration=cfg.data.min_duration, max_duration=cfg.data.max_duration,
    )
    target_samples = int(cfg.data.batch_samplerate * cfg.data.target_duration)
    pipe = BatchPipeline(ds, target_samples, num_workers=cfg.data.num_workers)
    stats = {"batches": 0, "segments": 0, "audio_seconds": 0.0}
    try:
        for _ in range(max_batches):
            t0 = time.time()
            batch = pipe.next_batch()
            K = batch.num_segments(cfg.data.batch_segment_strategy)
            if verbose:
                print(
                    f"[batch {batch.batch_id} @ epoch {batch.epoch}] "
                    f"{len(batch.audio_items)} items, K={K} "
                    f"(strategy={cfg.data.batch_segment_strategy}), "
                    f"fetch+prep {time.time()-t0:.2f}s"
                )
            for seg_idx in range(K):
                audio, mask, texts = stack_segment_slice(batch, seg_idx, target_samples)
                stats["segments"] += 1
                stats["audio_seconds"] += float(mask.sum()) / cfg.data.batch_samplerate
                if debug_spectrograms:
                    plot_batch_waveforms(audio, texts, batch.epoch, batch.batch_id, seg_idx)
                if verbose:
                    print(
                        f"  seg {seg_idx}: audio{audio.shape} "
                        f"valid={mask.mean():.2f} "
                        f"texts[0]={texts[0][:60]!r}"
                    )
            ds.mark_batch_done(batch.epoch, batch.batch_id)
            stats["batches"] += 1
    finally:
        pipe.stop()
        ds.end_session()
    if verbose:
        print(f"simulated: {stats}")
    return stats


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    max_batches = 2
    if "--batches" in argv:
        i = argv.index("--batches")
        max_batches = int(argv[i + 1])
        del argv[i:i + 2]
    debug_spectrograms = "--debug-spectrograms" in argv
    if debug_spectrograms:
        argv.remove("--debug-spectrograms")
    cfg = Config().apply_overrides(argv)
    simulate_training_loop(cfg, max_batches=max_batches,
                           debug_spectrograms=debug_spectrograms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
