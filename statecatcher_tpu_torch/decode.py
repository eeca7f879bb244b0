"""CTC greedy decoding and the segment-boundary dedup of evaluation.

Port of ``statecatcher_tpu/decode.py`` (reference decoder.py:3-30
semantics: argmax → collapse repeats → drop blanks → trim to in_lens),
vectorised: the collapse/drop is a boolean keep-mask, and only the dense
(preds, keep) pair goes to the host.  ``boundary_trimmed_lens`` and
``dedup_reference_text`` (numpy and string code, copied) are eval.py's.
"""

from __future__ import annotations

import numpy as np
import torch


def ctc_greedy_decode(log_probs: torch.Tensor, in_lens: torch.Tensor,
                      blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) scores, (B,) lengths → (preds (B, T) int32, keep (B, T) bool).

    ``preds[b, t]`` is kept iff it is not blank, differs from the previous
    frame's argmax, and ``t < in_lens[b]``.
    """
    preds = torch.argmax(log_probs, dim=-1).to(torch.int32)
    B, T = preds.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=preds.dtype, device=preds.device),
                      preds[:, :-1]], dim=1)
    t_idx = torch.arange(T, device=preds.device)[None, :]
    keep = (preds != blank_id) & (preds != prev) & (t_idx < in_lens.to(preds.device)[:, None])
    return preds, keep


def keep_to_token_lists(preds, keep) -> list[list[int]]:
    """Host-side: dense (preds, keep) → ragged per-utterance token lists."""
    preds = preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
    keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else np.asarray(keep)
    return [[int(x) for x in row[k]] for row, k in zip(preds, keep)]


def ctc_greedy_decode_to_lists(log_probs: torch.Tensor, in_lens: torch.Tensor,
                               blank_id: int = 0) -> list[list[int]]:
    preds, keep = ctc_greedy_decode(log_probs, in_lens, blank_id)
    return keep_to_token_lists(preds, keep)


def boundary_trimmed_lens(in_lens, metas: list, sample_rate: int, hop_length: int,
                          stack_order: int = 1, latency_margin_frames: int = 2) -> np.ndarray:
    """Segment-boundary dedup: cap each row's decodable frames at the next
    chunk's start time, plus a small CTC emission-latency margin.

    The cue grouping duplicates a kept boundary cue into the next chunk
    (``data/chunking.py:group_cues_into_chunks``), so the audio past
    ``overlap_start`` is decoded again, in full, by the next segment; this
    trims the fragment so each audio instant is transcribed once.  CTC emits
    a character a few frames after its audio, hence the margin (2 frames,
    ~20 ms; eval.py passes 0 for the stateful RNN-T decoders).

    ``metas[i]`` is this segment's ``chunking.segment_meta`` record for row i
    (or None when the dataset provides none: the row is left as it is).
    """
    out = np.asarray(in_lens).copy()
    frames_per_sec = sample_rate / float(hop_length * max(1, stack_order))
    for i, m in enumerate(metas):
        if not m or m.get("overlap_start") is None:
            continue
        keep_sec = m["overlap_start"] - m["start"]
        out[i] = min(int(out[i]), max(0, int(keep_sec * frames_per_sec) + latency_margin_frames))
    return out


def dedup_reference_text(text: str, meta: dict | None) -> str:
    """Drop the duplicated leading boundary cue from a segment's reference
    text when joining per-recording transcripts (its words were already
    contributed by the previous segment's text)."""
    if not meta:
        return text
    dup = meta.get("dup_first_text")
    if dup and text.startswith(dup):
        return text[len(dup):].lstrip()
    return text
