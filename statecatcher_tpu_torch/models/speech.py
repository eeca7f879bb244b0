"""SpeechModel: the top-level module, CTC mode.

Port of ``statecatcher_tpu/models/speech.py``.  The ASR module sits under the
name ``asr`` as in the flax tree, so converted weights load by name.  The
RNN-T predictor/joiner (``mode="rnnt"``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch.config import ModelConfig
from statecatcher_tpu_torch.models.asr import ASRModel, init_carry


class SpeechModel(nn.Module):
    def __init__(self, cfg: ModelConfig, feat_dim: int, mode: str = "ctc",
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode != "ctc":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP.md queue 1, RNN-T)")
        self.cfg = cfg
        self.mode = mode
        self.asr = ASRModel(cfg, feat_dim, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.asr.device

    def encode(self, feats, state=None, frame_mask=None):
        return self.asr(feats, state, frame_mask)

    def forward(self, feats, state=None, frame_mask=None):
        return self.encode(feats, state, frame_mask)

    def init_state(self, batch_size: int) -> dict:
        return init_carry(self.cfg, batch_size, device=self.device)


def build_speech_model(cfg: ModelConfig, feat_dim: int, mode: str = "ctc",
                       device="cuda", generator: Optional[torch.Generator] = None
                       ) -> SpeechModel:
    return SpeechModel(cfg, feat_dim, mode, device=device, generator=generator)
