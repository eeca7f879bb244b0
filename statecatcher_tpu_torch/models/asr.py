"""ASRModel: input projection, frame stacking, masking policy, encoder.

Port of ``statecatcher_tpu/models/asr.py`` for the LucyRNN encoder (the
7-gate ``variant="triton"`` and the 6-gate ``variant="native"``) and the
xLSTM encoder: the optional input projection, ``stack_order``
trim-and-fold, zero-input masking of padded frames, and the cast of the
carried state to ``carry_dtype``.  The stateful
contract is the JAX package's: ``logits, new_state = model(feats, state,
frame_mask)``.

The LSTM and RWKV encoders are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.config import ModelConfig
from statecatcher_tpu_torch.models.layers import Dense, torch_dtype
from statecatcher_tpu_torch.models.lucyrnn import LucyRNNEncoder
from statecatcher_tpu_torch.models.lucyrnn_native import LucyNativeEncoder
from statecatcher_tpu_torch.models.xlstm import XLSTMEncoder, xlstm_init_carry


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configurations this port lacks."""
    if cfg.encoder not in ("lucyrnn", "xlstm"):
        raise NotImplementedError(
            f"encoder={cfg.encoder!r} is not ported yet (ROADMAP.md queue 1 item 2); "
            "'lucyrnn' and 'xlstm' are")
    if cfg.encoder == "lucyrnn" and cfg.lucyrnn.variant not in ("triton", "native"):
        raise NotImplementedError(
            f"lucyrnn.variant={cfg.lucyrnn.variant!r} is not ported; the 7-gate 'triton' "
            "and the 6-gate 'native' variants are")


class ASRModel(nn.Module):
    """Input projection → frame stacking → LucyRNN (7-gate or native) or
    xLSTM encoder (→ vocab logits).

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
        if cfg.encoder == "xlstm":
            self.encoder = XLSTMEncoder(in_dim, cfg.vocab_size, cfg.xlstm, dtype=self.dtype,
                                        param_dtype=param_dtype, generator=generator)
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
    """Zero carry of the encoder: LucyRNN {"h", "s"} of (B, tracks, L, D)
    (native: (B, L, D)); xLSTM {"C", "n", "m"}
    (``models/xlstm.py:xlstm_init_carry``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dtype is None:
        dtype = carry_dtype(cfg)
    if cfg.encoder == "xlstm":
        return xlstm_init_carry(cfg.xlstm, batch_size, dtype, dev)
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
