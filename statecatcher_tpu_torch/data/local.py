"""File-backed drop-in for SpeechDataset — fixture/local training + tests.

The reference's data plane is pure HTTP (dataset.py), so it has no offline
path and no tests (SURVEY.md §4).  This local dataset replays a directory of
``*.wav`` + ``*.vtt`` pairs through the exact same preprocessing
(decode → cue grouping → fixed-size segments), exposing the same
session/batch protocol surface so the training loop can't tell the difference.
"""

from __future__ import annotations

import os
import random
from typing import Optional

from statecatcher_tpu_torch.data.audio import decode_audio_fast, read_wav_bytes, to_mono
from statecatcher_tpu_torch.data.chunking import preprocess_recording


class LocalSpeechDataset:
    """Same duck-type as ``SpeechDataset`` but backed by local files.

    Batch items are dicts with a ``local_audio_path``/``local_vtt_path``; the
    epoch/batch bookkeeping mirrors the server's contract: a session yields
    ``ceil(N/batch_size)`` batches per epoch and increments ``epoch`` when the
    file list is exhausted.
    """

    def __init__(
        self,
        root: str,
        batch_segment_strategy: str = "clipping",
        batch_samplerate: int = 16000,
        verbose: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.root = root
        self.batch_segment_strategy = batch_segment_strategy
        self.batch_samplerate = batch_samplerate
        self.verbose = verbose
        # Multi-host: each host owns files where (i % shard_count) ==
        # shard_index — the local-data analogue of per-host HTTP sessions.
        self.shard_index = shard_index
        self.shard_count = max(1, shard_count)
        self.session_id: Optional[str] = None
        self._pairs: list[tuple[str, str]] = []
        self._order = "asc"
        self._batch_size = 8
        self._cursor = 0
        self._epoch = 0
        self._batch_counter = 0
        self._rng = random.Random(0)

    def _scan(self):
        pairs = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".wav"):
                stem = name[:-4]
                vtt = os.path.join(self.root, stem + ".vtt")
                if os.path.exists(vtt):
                    pairs.append((os.path.join(self.root, name), vtt))
        if not pairs:
            raise RuntimeError(f"No wav+vtt pairs found under {self.root}")
        if self.shard_count > 1:
            pairs = [p for i, p in enumerate(pairs) if i % self.shard_count == self.shard_index]
        if not pairs:
            raise RuntimeError(
                f"Shard {self.shard_index}/{self.shard_count} owns no files under {self.root}"
            )
        return pairs

    # ------------------------------------------------------------------ #
    # Session protocol (duck-typed to SpeechDataset)
    # ------------------------------------------------------------------ #
    def start_session(self, batch_size=8, order="asc", min_duration=0.0, max_duration=None):
        self._pairs = self._scan()
        if max_duration is not None or min_duration > 0.0:
            kept = []
            for wav_path, vtt_path in self._pairs:
                with open(wav_path, "rb") as f:
                    x, sr, _ = read_wav_bytes(f.read())
                dur = len(to_mono(x)) / sr
                if dur >= min_duration and (max_duration is None or dur <= max_duration):
                    kept.append((wav_path, vtt_path))
            self._pairs = kept or self._pairs
        self._order = order
        self._batch_size = batch_size
        self._cursor = 0
        self._epoch = 0
        self._batch_counter = 0
        self.session_id = "local"
        self._apply_order()

    def _apply_order(self):
        if self._order == "desc":
            self._pairs = list(reversed(sorted(self._pairs)))
        elif self._order == "random":
            self._rng.shuffle(self._pairs)
        else:
            self._pairs = sorted(self._pairs)

    def fetch_next_batch(self):
        if self._cursor >= len(self._pairs):
            self._cursor = 0
            self._epoch += 1
            self._apply_order()
        batch = []
        for wav_path, vtt_path in self._pairs[self._cursor:self._cursor + self._batch_size]:
            batch.append({"local_audio_path": wav_path, "local_vtt_path": vtt_path})
        self._cursor += self._batch_size
        batch_id = self._batch_counter
        self._batch_counter += 1
        return self._epoch, batch_id, batch

    def mark_batch_done(self, epoch, batch_id):
        pass

    def log(self, level, message):
        if self.verbose:
            print(f"[{level}] {message}")

    def end_session(self):
        self.session_id = None

    # ------------------------------------------------------------------ #
    def load_and_preprocess_batch_item(self, item: dict, target_samples: int):
        with open(item["local_audio_path"], "rb") as f:
            audio = decode_audio_fast(f.read(), self.batch_samplerate)
        with open(item["local_vtt_path"], "r") as f:
            vtt_text = f.read()
        return preprocess_recording(audio, vtt_text, self.batch_samplerate, target_samples)
