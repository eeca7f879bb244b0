"""Host data plane (own copies of ``statecatcher_tpu/data``): the HTTP client
of the speechcatcher-data API and its fake server, WAV decode (native or
numpy), VTT parsing, cue grouping into fixed segments, the local WAV+VTT
dataset and the prefetching batch pipeline."""

from statecatcher_tpu_torch.data.chunking import chunks_to_segments, group_cues_into_chunks
from statecatcher_tpu_torch.data.client import SpeechDataset
from statecatcher_tpu_torch.data.local import LocalSpeechDataset
from statecatcher_tpu_torch.data.vtt import parse_timestamp, vtt_to_segments_with_text

__all__ = [
    "parse_timestamp",
    "vtt_to_segments_with_text",
    "group_cues_into_chunks",
    "chunks_to_segments",
    "SpeechDataset",
    "LocalSpeechDataset",
]
