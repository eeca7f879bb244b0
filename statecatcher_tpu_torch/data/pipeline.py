"""Batch prefetch pipeline: fetch → parallel per-item preprocess → queue.

Own copy of ``statecatcher_tpu/data/pipeline.py``; ``GroupBufferPool`` can
hand out page-locked buffers for the host→device copy of a group.

The reference fans per-item download+decode out to a 32-process spawn pool
(reference train.py:24-35,285-293,662-670) and overlaps nothing — the train
loop blocks on each batch.  Here the equivalent is a thread pool (our decode
path is numpy + optional ffmpeg subprocess, both GIL-releasing) plus a
bounded background prefetch queue so host-side data work overlaps device
compute.

Failure discipline parity (SURVEY.md §5 "failure detection"):
  * fetch error → sleep and retry forever (reference train.py:403-406)
  * per-item preprocess error → drop the item (reference train.py:285-293)
  * empty batch after drops → short sleep, refetch (reference train.py:450-453)
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger("statecatcher.data")

FETCH_RETRY_SLEEP = 10.0      # seconds before refetching after a fetch error
EMPTY_RETRY_SLEEP = 1.0       # seconds before refetching an all-dropped batch


@dataclass
class PreparedBatch:
    """One fetched batch, preprocessed: per-recording segment lists."""

    epoch: int
    batch_id: object
    # Per recording i: audio_items[i] is a list of (target_samples,) float32
    # arrays, one per segment; same structure for masks (bool) and texts.
    audio_items: list[list[np.ndarray]] = field(default_factory=list)
    text_items: list[list[str]] = field(default_factory=list)
    mask_items: list[list[np.ndarray]] = field(default_factory=list)
    # Per-segment timing/overlap metadata (chunking.segment_meta) for
    # decode-side boundary dedup; [] per item when the dataset has none.
    meta_items: list[list[dict]] = field(default_factory=list)

    @property
    def num_segments_per_item(self) -> list[int]:
        return [len(a) for a in self.audio_items]

    def num_segments(self, strategy: str) -> int:
        counts = self.num_segments_per_item
        if not counts:
            return 0
        return min(counts) if strategy == "clipping" else max(counts)


class BatchPipeline:
    """Pull batches from a dataset, preprocess items in parallel, prefetch."""

    def __init__(
        self,
        dataset,
        target_samples: int,
        num_workers: int = 16,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.target_samples = target_samples
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None     # what ended the prefetch thread

    # ------------------------------------------------------------------ #
    def _prepare_one(self) -> PreparedBatch:
        while True:
            try:
                epoch, batch_id, batch = self.dataset.fetch_next_batch()
            except Exception as e:
                logger.error(
                    "Data fetch error: %s; sleeping %.1fs before retrying", e,
                    FETCH_RETRY_SLEEP,
                )
                if self._stop.wait(FETCH_RETRY_SLEEP):
                    raise StopIteration
                continue

            futures = [
                self._pool.submit(self._safe_item, item) for item in batch
            ]
            out = PreparedBatch(epoch=epoch, batch_id=batch_id)
            for f in futures:
                result = f.result()
                if result is not None:
                    audios, texts, masks, *rest = result
                    out.audio_items.append(audios)
                    out.text_items.append(texts)
                    out.mask_items.append(masks)
                    out.meta_items.append(rest[0] if rest else [])
            if not out.audio_items:
                logger.error("Batch empty after preprocessing errors; retrying")
                if self._stop.wait(EMPTY_RETRY_SLEEP):
                    raise StopIteration
                continue
            return out

    def next_batch(self) -> PreparedBatch:
        """The next batch, prepared in the caller's thread (no prefetch)."""
        return self._prepare_one()

    def _safe_item(self, item):
        try:
            return self.dataset.load_and_preprocess_batch_item(item, self.target_samples)
        except Exception as e:
            logger.error("Data preprocess error: %s; leaving out batch item", e)
            return None

    # ------------------------------------------------------------------ #
    def start(self):
        def worker():
            try:
                while not self._stop.is_set():
                    try:
                        b = self._prepare_one()
                    except StopIteration:
                        break
                    while not self._stop.is_set():
                        try:
                            self._queue.put(b, timeout=0.25)
                            break
                        except queue.Full:
                            continue
            except Exception as e:          # handed to the consumer by get()
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def get(self) -> PreparedBatch:
        """The next prefetched batch.  Raises, rather than waiting forever,
        once the prefetch thread has ended (stopped, or failed: its error is
        the cause)."""
        while True:
            try:
                return self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    if not self._queue.empty():
                        continue
                    raise RuntimeError("the batch prefetch thread has ended") from self._error

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False, cancel_futures=True)


class GroupBufferPool:
    """Double-buffered reusable host transfer buffers for
    ``assemble_compact_group``.

    Faulting in a fresh multi-GB group buffer costs far more than the
    copies themselves, so buffers are reused across groups, TWO slots per
    (shape, dtype).  With ``pin_memory`` (the group goes to a CUDA card) the
    buffers are page-locked, so the loop's ``non_blocking`` host→device
    copies run asynchronously; ``fence()`` records an event after those
    copies, and ``take`` waits on a slot's event before handing it out again,
    so the host never overwrites a buffer whose copy is still in flight.
    """

    def __init__(self, depth: int = 2, pin_memory: bool = False):
        self.depth = depth
        self.pin_memory = pin_memory
        self._slots: dict = {}
        self._unfenced: list = []

    def _alloc(self, shape, dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.zeros(shape, dtype)
        import torch

        return torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                           pin_memory=True).numpy()

    def take(self, shape, dtype) -> tuple[np.ndarray, bool]:
        """Next buffer for (shape, dtype) → (buffer, is_fresh_zeroed)."""
        key = (tuple(shape), np.dtype(dtype).str)
        ent = self._slots.setdefault(key, {"bufs": [], "events": [], "i": -1})
        if len(ent["bufs"]) < self.depth:
            ent["bufs"].append(self._alloc(shape, dtype))
            ent["events"].append(None)
            ent["i"] = len(ent["bufs"]) - 1
            fresh = True
        else:
            ent["i"] = (ent["i"] + 1) % self.depth
            ev = ent["events"][ent["i"]]
            if ev is not None:
                ev.synchronize()
            fresh = False
        self._unfenced.append((ent, ent["i"]))
        return ent["bufs"][ent["i"]], fresh

    def fence(self):
        """Mark the buffers taken since the last fence as in flight until the
        work queued so far on the current CUDA stream is done."""
        if self.pin_memory and self._unfenced:
            import torch

            ev = torch.cuda.Event()
            ev.record()
            for ent, i in self._unfenced:
                ent["events"][i] = ev
        self._unfenced.clear()


def assemble_compact_group(
    batch: PreparedBatch,
    group_ids: list,
    KG: int,
    B_local: int,
    target_samples: int,
    pool: "GroupBufferPool | None" = None,
) -> tuple[np.ndarray, np.ndarray, list]:
    """Single-pass host_prep assembly for the compact-transfer train loop.

    Writes every decoded segment row DIRECTLY into the final (KG, B, S)
    transfer buffer — the generic ``stack_segment_slice``-per-segment +
    group-level ``np.stack`` path copies the group twice and stacks the
    full (KG, B, S) bool masks only to reduce them to prefix lengths.

    Returns (audio_k, lens_k, texts_per_segment):
      audio_k  (KG, B, S) — int16 when every present row is an int16
               passthrough segment, else float32 on the reference scale
      lens_k   (KG, B) int32 prefix lengths (0 for missing/padded rows)
      texts    list of KG lists of B strings
    """
    S = target_samples
    all_i16 = all(
        a.dtype == np.int16 for aud in batch.audio_items for a in aud
    )
    dtype = np.int16 if all_i16 else np.float32
    if pool is not None:
        audio_k, audio_fresh = pool.take((KG, B_local, S), dtype)
        lens_k, _ = pool.take((KG, B_local), np.int32)
        lens_k.fill(0)
    else:
        audio_k = np.zeros((KG, B_local, S), dtype)
        lens_k = np.zeros((KG, B_local), np.int32)
        audio_fresh = True
    texts: list[list[str]] = [[""] * B_local for _ in range(KG)]
    n_rows = len(batch.audio_items)
    for gi in range(KG):
        si = group_ids[gi] if gi < len(group_ids) else None
        for i in range(B_local):
            present = (
                si is not None and i < n_rows
                and si < len(batch.audio_items[i])
            )
            if present:
                seg = batch.audio_items[i][si]
                if seg.dtype == np.int16 and dtype == np.float32:
                    seg = seg.astype(np.float32) / 32767.0
                # every present segment is exactly S samples
                # (chunks_to_segments pads), so the row is fully overwritten
                audio_k[gi, i, : len(seg)] = seg
                lens_k[gi, i] = int(
                    np.count_nonzero(batch.mask_items[i][si]))
                texts[gi][i] = batch.text_items[i][si]
            elif not audio_fresh:
                audio_k[gi, i].fill(0)      # clear a reused buffer's stale row
    return audio_k, lens_k, texts


def stack_segment_slice(
    batch: PreparedBatch, seg_idx: int, target_samples: int,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Stack segment ``seg_idx`` across recordings, zero-padding missing ones.

    Parity with reference train.py:186-201 (``prepare_batch_data``): items
    with fewer segments contribute silence + empty text under the "padding"
    strategy.  Int16 passthrough rows (``audio.decode_audio_fast``) are
    converted to the reference float32/32767 scale.
    """
    audio_rows, mask_rows, texts = [], [], []
    zeros = np.zeros(target_samples, dtype=np.float32)
    for audios, texts_i, masks in zip(batch.audio_items, batch.text_items, batch.mask_items):
        if seg_idx < len(audios):
            r = audios[seg_idx]
            audio_rows.append(r.astype(np.float32) / 32767.0 if r.dtype == np.int16 else r)
            mask_rows.append(masks[seg_idx])
            texts.append(texts_i[seg_idx])
        else:
            audio_rows.append(zeros)
            mask_rows.append(np.zeros(target_samples, dtype=bool))
            texts.append("")
    return np.stack(audio_rows), np.stack(mask_rows), texts
