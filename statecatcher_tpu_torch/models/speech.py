"""SpeechModel: the top-level module, CTC or RNN-T mode.

Port of ``statecatcher_tpu/models/speech.py``.  The ASR module sits under the
name ``asr`` and, in ``mode="rnnt"``, the predictor/joiner under ``joiner``,
as in the flax tree, so converted weights load by name.  The joiner's input
width is the encoder's output, the vocab size.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.config import ModelConfig
from statecatcher_tpu_torch.models.asr import ASRModel, init_carry
from statecatcher_tpu_torch.models.layers import torch_dtype
from statecatcher_tpu_torch.models.rnnt import RNNTPredictorJoiner


class SpeechModel(nn.Module):
    def __init__(self, cfg: ModelConfig, feat_dim: int, mode: str = "ctc",
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("ctc", "rnnt"):
            raise ValueError(f"mode must be 'ctc' or 'rnnt', got {mode!r}")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.mode = mode
        self.asr = ASRModel(cfg, feat_dim, device=dev, generator=generator)
        if mode == "rnnt":
            self.joiner = RNNTPredictorJoiner(
                cfg.vocab_size, cfg.vocab_size, cfg.rnnt_pred_emb_dim, cfg.rnnt_joiner_dim,
                dtype=torch_dtype(cfg.dtype), param_dtype=torch_dtype(cfg.param_dtype),
                generator=generator).to(dev)

    @property
    def device(self) -> torch.device:
        return self.asr.device

    def encode(self, feats, state=None, frame_mask=None):
        return self.asr(feats, state, frame_mask)

    def rnnt_project(self, enc_out, prefix):
        return self.joiner.project(enc_out, prefix)

    def rnnt_joint_logits(self, enc_out, prefix):
        return self.joiner(enc_out, prefix)

    def rnnt_decode_tables(self):
        """(pred_table (V, J), join_kernel (J, V), join_bias (V,))."""
        return self.joiner.decode_tables()

    def rnnt_project_encoder(self, enc_out):
        return self.joiner.project_encoder(enc_out)

    def forward(self, feats, state=None, frame_mask=None, prefix=None):
        """``(logits, new_state)``; in RNN-T mode with a ``prefix``,
        ``(logits, new_state, (enc_p, pred_p, join_kernel, join_bias))``."""
        enc_out, new_state = self.encode(feats, state, frame_mask)
        if self.mode == "rnnt" and prefix is not None:
            return enc_out, new_state, self.rnnt_project(enc_out, prefix)
        return enc_out, new_state

    def init_state(self, batch_size: int) -> dict:
        return init_carry(self.cfg, batch_size, device=self.device)


def build_speech_model(cfg: ModelConfig, feat_dim: int, mode: str = "ctc",
                       device="cuda", generator: Optional[torch.Generator] = None
                       ) -> SpeechModel:
    return SpeechModel(cfg, feat_dim, mode, device=device, generator=generator)
