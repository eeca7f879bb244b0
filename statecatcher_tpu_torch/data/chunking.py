"""VTT-cue grouping and fixed-size segment extraction.

Behavior parity with reference dataset.py:179-262 — the greedy cue grouping
(grow a chunk until adding the next cue would cross ``window_sec``, then keep
or drop that cue by whichever endpoint is closer to the target) and the
trim/zero-pad + boolean-sample-mask conversion.  Segmentation must be
byte-identical to the reference for loss/WER parity, so this module is tested
against hand-computed fixtures.
"""

from __future__ import annotations

import numpy as np

Cue = tuple[float, float, str]
Chunk = tuple[float, float, list[str]]


def group_cues_into_chunks(segments: list[Cue], window_sec: float) -> list[Chunk]:
    """Greedily group VTT cues into chunks of ≈``window_sec`` seconds.

    Same decision rule as reference dataset.py:179-211: a cue that would
    overshoot the window is included iff ``|overshoot − window| <
    |window − undershoot|``; the remainder forms a final chunk.
    """
    chunks: list[Chunk] = []
    pending: list[Cue] = []
    for cue in segments:
        start, end, _ = cue
        if not pending:
            pending = [cue]
            continue
        group_start = pending[0][0]
        dur_without = pending[-1][1] - group_start  # chunk length if closed before this cue
        dur_with = end - group_start                # ... if this cue is kept
        if dur_with < window_sec:
            pending.append(cue)
            continue
        # This cue crosses the window: keep it in the closing chunk iff that
        # lands closer to the target length than stopping short of it.  Either
        # way it also seeds the next chunk (a kept boundary cue is duplicated).
        group_end = pending[-1][1]
        if abs(dur_with - window_sec) < abs(window_sec - dur_without):
            pending.append(cue)
            group_end = end
        chunks.append((group_start, group_end, [t for _, _, t in pending]))
        pending = [cue]
    if pending:
        chunks.append((pending[0][0], pending[-1][1], [t for _, _, t in pending]))
    return chunks


def segment_meta(chunks: list[Chunk], window_sec: float) -> list[dict]:
    """Per-chunk timing/overlap metadata for decode-side boundary dedup.

    The grouping rule duplicates a kept boundary cue into the next chunk
    (reference dataset.py:179-211 — see ``group_cues_into_chunks``), so
    consecutive segments can OVERLAP in audio and repeat that cue's text.
    Training keeps the duplication (byte parity with the reference); decoding
    should not transcribe the same audio twice.  For each chunk::

        start          chunk start time (sec, recording clock)
        end            effective end = min(raw end, start + window) — where the
                       fixed-size trim actually cuts the audio
        overlap_start  next chunk's start, iff it falls inside [start, end)
                       (frames past it are re-decoded in full by the next
                       segment and should be dropped from this one); else None
        dup_first_text the duplicated leading cue's text iff this chunk starts
                       inside the previous chunk's RAW span (drop it once when
                       joining per-recording reference transcripts); else None
    """
    metas: list[dict] = []
    prev_raw_end = None
    prev_texts = None
    for (c_start, c_end, texts) in chunks:
        dup = (
            prev_raw_end is not None
            and c_start < prev_raw_end
            and bool(texts)
            and bool(prev_texts)
            and texts[0] == prev_texts[-1]
        )
        metas.append({
            "start": c_start,
            "end": min(c_end, c_start + window_sec),
            "overlap_start": None,   # filled from the NEXT chunk below
            "dup_first_text": texts[0] if dup else None,
        })
        prev_raw_end = c_end
        prev_texts = texts
    for k in range(len(metas) - 1):
        nxt = metas[k + 1]["start"]
        if metas[k]["start"] < nxt < metas[k]["end"]:
            metas[k]["overlap_start"] = nxt
    return metas


def chunks_to_segments(
    audio: np.ndarray,
    chunks: list[Chunk],
    sample_rate: int,
    target_samples: int,
) -> tuple[list[np.ndarray], list[str], list[np.ndarray]]:
    """Convert chunks → fixed-size audio arrays + joined texts + sample masks.

    Parity with reference dataset.py:216-262 including the empty-VTT fallback
    (whole recording → one zero-padded segment with empty text).
    """
    segment_arrays: list[np.ndarray] = []
    segment_texts: list[str] = []
    segment_masks: list[np.ndarray] = []

    # dtype-preserving: int16 passthrough audio (audio.decode_audio_fast)
    # stays int16 end-to-end — the loop's compact transfer ships it verbatim
    dtype = audio.dtype if audio.dtype == np.int16 else np.float32
    for (c_start, c_end, texts) in chunks:
        s_samp = int(c_start * sample_rate)
        e_samp = int(c_end * sample_rate)
        seg = audio[s_samp:e_samp]
        real_len = len(seg)
        if real_len >= target_samples:
            seg = seg[:target_samples]
            mask = np.ones(target_samples, dtype=bool)
        else:
            pad = target_samples - real_len
            seg = np.concatenate([seg, np.zeros(pad, dtype=dtype)], axis=0)
            mask = np.concatenate(
                [np.ones(real_len, dtype=bool), np.zeros(pad, dtype=bool)], axis=0
            )
        segment_arrays.append(np.ascontiguousarray(seg, dtype=dtype))
        segment_masks.append(mask)
        segment_texts.append(" ".join(texts))

    if not segment_arrays:
        real_len = min(len(audio), target_samples)
        pad_len = target_samples - real_len
        seg = np.concatenate(
            [audio[:real_len].astype(dtype), np.zeros(pad_len, dtype=dtype)]
        )
        mask = np.concatenate(
            [np.ones(real_len, dtype=bool), np.zeros(pad_len, dtype=bool)]
        )
        segment_arrays = [seg]
        segment_masks = [mask]
        segment_texts = [""]

    return segment_arrays, segment_texts, segment_masks


def preprocess_recording(
    audio: np.ndarray,
    vtt_text: str,
    sample_rate: int,
    target_samples: int,
) -> tuple[list[np.ndarray], list[str], list[np.ndarray], list[dict]]:
    """Full recording → (segments, texts, masks, meta): parse + group + fix-size.

    ``meta`` is ``segment_meta``'s per-segment timing/overlap record (empty-VTT
    fallback gets one span covering the retained audio).
    """
    from statecatcher_tpu_torch.data.vtt import vtt_to_segments_with_text

    window_sec = target_samples / float(sample_rate)
    cues = vtt_to_segments_with_text(vtt_text)
    chunks = group_cues_into_chunks(cues, window_sec)
    arrays, texts, masks = chunks_to_segments(audio, chunks, sample_rate, target_samples)
    meta = segment_meta(chunks, window_sec)
    if not meta:
        meta = [{"start": 0.0, "end": min(len(audio) / sample_rate, window_sec),
                 "overlap_start": None, "dup_first_text": None}]
    return arrays, texts, masks, meta
