"""ASRModel: input projection, frame stacking, masking policy, encoder.

Port of ``statecatcher_tpu/models/asr.py`` for every encoder: the LSTM
(the config's default), the LucyRNN (the 6-gate ``variant="native"``, and
the 7-gate cell for every other variant, the config's "triton" among them),
the xLSTM and the RWKV: the optional input projection, ``stack_order``
trim-and-fold, the masking policy, and the cast of the carried state to
``carry_dtype``.  The LSTM masks inside its
recurrence (frozen state, zero output) and has its own ``classifier`` Dense
to the vocabulary; the other encoders get zero-input masking of padded
frames and project to the vocabulary themselves.  The stateful contract is
the JAX package's: ``logits, new_state = model(feats, state, frame_mask)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.config import ModelConfig
from statecatcher_tpu_torch.models.layers import Dense, torch_dtype
from statecatcher_tpu_torch.models.lstm import LSTMEncoder, lstm_init_carry
from statecatcher_tpu_torch.models.lucyrnn import LucyRNNEncoder
from statecatcher_tpu_torch.models.lucyrnn_native import LucyNativeEncoder
from statecatcher_tpu_torch.models.rwkv import RWKVEncoder, rwkv_init_carry
from statecatcher_tpu_torch.models.xlstm import XLSTMEncoder, xlstm_init_carry


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for an unknown encoder.  As in the JAX package, every
    ``lucyrnn.variant`` but "native" builds the 7-gate cell."""
    if cfg.encoder not in ("lstm", "lucyrnn", "xlstm", "rwkv"):
        raise ValueError(f"Unknown encoder type: {cfg.encoder!r}")


class ASRModel(nn.Module):
    """Input projection → frame stacking → LSTM encoder → classifier, or
    LucyRNN (7-gate or native), xLSTM or RWKV encoder (→ vocab logits).

    Parameters are initialised on the CPU from ``generator`` (a fresh one
    seeded 0 when None) and then moved to ``device``.
    """

    def __init__(self, cfg: ModelConfig, feat_dim: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.feat_dim = feat_dim
        self.dtype = torch_dtype(cfg.dtype)
        param_dtype = torch_dtype(cfg.param_dtype)
        in_dim = feat_dim
        if cfg.input_proj_dim > 0:
            self.proj = Dense(feat_dim, cfg.input_proj_dim, dtype=self.dtype,
                              param_dtype=param_dtype, generator=generator)
            in_dim = cfg.input_proj_dim
        else:
            self.proj = None
        in_dim *= max(1, cfg.stack_order)
        self.classifier = None
        if cfg.encoder == "lstm":
            self.encoder = LSTMEncoder(in_dim, cfg.hidden_size, cfg.num_layers, dtype=self.dtype,
                                       param_dtype=param_dtype, generator=generator)
            self.classifier = Dense(cfg.hidden_size, cfg.vocab_size, dtype=self.dtype,
                                    param_dtype=param_dtype, generator=generator)
        elif cfg.encoder == "xlstm":
            self.encoder = XLSTMEncoder(in_dim, cfg.vocab_size, cfg.xlstm, dtype=self.dtype,
                                        param_dtype=param_dtype, generator=generator)
        elif cfg.encoder == "rwkv":
            self.encoder = RWKVEncoder(in_dim, cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
                                       dtype=self.dtype, param_dtype=param_dtype,
                                       generator=generator)
        else:
            lcfg = dataclasses.replace(cfg.lucyrnn, hidden_dim=cfg.hidden_size,
                                       num_layers=cfg.num_layers)
            encoder = LucyRNNEncoder
            if lcfg.variant == "native":
                # the fused and dual cells are 7-gate kernels: the native
                # variant runs its scans through K5 instead, as in JAX
                if lcfg.kernel_impl in ("pallas-fused", "auto-fused", "pallas-dual"):
                    lcfg = dataclasses.replace(lcfg, kernel_impl="pallas")
                encoder = LucyNativeEncoder
            self.encoder = encoder(in_dim, cfg.vocab_size, lcfg, dtype=self.dtype,
                                   param_dtype=param_dtype, generator=generator)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    def init_state(self, batch_size: int) -> dict:
        return init_carry(self.cfg, batch_size, device=self.device)

    def forward(self, feats, state=None, frame_mask=None):
        cfg = self.cfg
        x = feats.to(self.dtype)
        if self.proj is not None:
            x = self.proj(x)
        if cfg.stack_order > 1:
            # trim T to a multiple of the stack, fold consecutive frames into
            # features; frame_mask is already at the stacked rate
            s = cfg.stack_order
            B, T, F = x.shape
            Tt = T - (T % s)
            x = x[:, :Tt].reshape(B, Tt // s, F * s)
        if self.classifier is not None:
            # the LSTM masks inside its recurrence
            y, new_state = self.encoder(x, state, frame_mask)
            logits = self.classifier(y)
        else:
            if frame_mask is not None:
                # zero-input masking (reference model.py:374-377)
                x = x * frame_mask[..., None].to(x.dtype)
            logits, new_state = self.encoder(x, state, frame_mask)
        cdt = carry_dtype(cfg)
        return logits, {k: v.to(cdt) for k, v in new_state.items()}


def carry_dtype(cfg: ModelConfig) -> torch.dtype:
    """Dtype of the inter-segment carry (``cfg.carry_dtype``; "auto" → the
    activation dtype)."""
    return torch_dtype(cfg.dtype if cfg.carry_dtype == "auto" else cfg.carry_dtype)


def init_carry(cfg: ModelConfig, batch_size: int, dtype=None, device="cuda") -> dict:
    """Zero carry of the encoder: LSTM {"h", "c"} of (B, L, H); LucyRNN
    {"h", "s"} of (B, tracks, L, D) (native: (B, L, D)); xLSTM {"C", "n",
    "m"} (``models/xlstm.py:xlstm_init_carry``); RWKV's five (B, L, D)
    leaves (``models/rwkv.py:rwkv_init_carry``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dtype is None:
        dtype = carry_dtype(cfg)
    if cfg.encoder == "lstm":
        return lstm_init_carry(batch_size, cfg.num_layers, cfg.hidden_size, dtype, dev)
    if cfg.encoder == "xlstm":
        return xlstm_init_carry(cfg.xlstm, batch_size, dtype, dev)
    if cfg.encoder == "rwkv":
        return rwkv_init_carry(cfg.hidden_size, cfg.num_layers, batch_size, dtype, dev)
    if cfg.lucyrnn.variant == "native":
        shape = (batch_size, cfg.num_layers, cfg.hidden_size)
    else:
        shape = (batch_size, cfg.lucyrnn.num_tracks, cfg.num_layers, cfg.hidden_size)
    return {"h": torch.zeros(shape, dtype=dtype, device=dev),
            "s": torch.zeros(shape, dtype=dtype, device=dev)}


def build_model(cfg: ModelConfig, feat_dim: int, device="cuda",
                generator: Optional[torch.Generator] = None) -> ASRModel:
    """ASRModel for ``cfg`` on ``device``."""
    return ASRModel(cfg, feat_dim, device=device, generator=generator)
