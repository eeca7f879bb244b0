"""Host data plane (own copies of ``statecatcher_tpu/data``, numpy only):
WAV decode, VTT parsing, cue grouping into fixed segments, the local
WAV+VTT dataset and the prefetching batch pipeline.  The HTTP client and its
fake server are not ported yet."""

from statecatcher_tpu_torch.data.chunking import chunks_to_segments, group_cues_into_chunks
from statecatcher_tpu_torch.data.local import LocalSpeechDataset
from statecatcher_tpu_torch.data.vtt import parse_timestamp, vtt_to_segments_with_text

__all__ = [
    "parse_timestamp",
    "vtt_to_segments_with_text",
    "group_cues_into_chunks",
    "chunks_to_segments",
    "LocalSpeechDataset",
]
