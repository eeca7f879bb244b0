"""LucyRNN "native" variant: the 6-gate LayerNorm cell, in PyTorch.

Port of ``statecatcher_tpu/models/lucyrnn_native.py`` (reference lucyrnn.py
semantics, with that module's documented fixes: single-apply s update,
the true exponential prefix-sum decay, masks composed into the scans):

  u      = LN_in(W_in x)                       # per-layer input projection
  z      = sigmoid(LN_z(W_z u))
  kv     = (W_k u) * (W_v u)
  decay  = sigmoid(W_decay u)                      (decay_mode="learned")
         | exp(-lambda_decay * t), t = 0..T-1      (decay_mode="prefix_sum")
  s_t    = decay_t * s_{t-1} + kv_t            # first linear scan
  c_t    = tanh(LN_h(W_h(u_t + s_t)))          # fused_ops=False
         | tanh(LN_h(h_pre_t + s_t))           # fused_ops=True (W_fused's 5th
                                               #   block is h_pre)
  h_t    = (1 - z_t) * c_t + z_t * h_{t-1}     # second linear scan

Both scans run through ``ops/scan.py:linear_scan``: the linear scan K5
(K5a forward, K5b backward) on the card, its plain versions on the CPU.
The JAX package's r gate (``sigmoid(LN_r(W_r u))``) is computed there and
never used; here it is not computed at all.  Its parameters (``W_r``, or
the first block of ``W_fused``, and ``layernorm_r``) stay, as does
``W_decay`` under ``prefix_sum``: they are leaves of the flax tree, and
their gradients are None here where JAX's are zeros (the train step reads
None as zeros, so weight decay reaches them as it does in JAX).

With ``mask_state_updates`` the frame mask turns masked steps of both scans
into the identity map (a = 1, b = 0).  Every dense kernel is initialised
orthogonal (reference lucyrnn.py:34-37) from the explicit generator; the
output projection is zero-initialised.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch.config import LucyRNNConfig
from statecatcher_tpu_torch.models.layers import Dense, LayerNorm, orthogonal_
from statecatcher_tpu_torch.ops.scan import linear_scan


def _masked_scan(a, b, s0, frame_mask, impl):
    """``linear_scan`` with masked steps forced to the identity map."""
    if frame_mask is not None:
        m = frame_mask[..., None].to(a.dtype)
        a = m * a + (1.0 - m)
        b = m * b
    return linear_scan(a, b, s0, impl=impl)


class LucyNativeCell(nn.Module):
    """One 6-gate LayerNorm LucyRNN layer.  Submodule names follow the flax
    tree (``input_proj``, ``W_fused`` or ``W_r`` … ``W_h``, ``layernorm_*``)."""

    def __init__(self, in_features: int, hidden_dim: int, cfg: LucyRNNConfig, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        D = hidden_dim
        self.cfg = cfg
        if cfg.decay_mode not in ("learned", "prefix_sum"):
            raise ValueError(f"Unknown decay_mode: {cfg.decay_mode!r}")

        def dense(n_in, n_out):
            return Dense(n_in, n_out, dtype=dtype, param_dtype=param_dtype,
                         generator=generator, kernel_init=orthogonal_)

        self.input_proj = dense(in_features, D)
        if cfg.fused_ops:
            self.W_fused = dense(D, 6 * D)
        else:
            for name in ("W_r", "W_z", "W_k", "W_v", "W_decay", "W_h"):
                self.add_module(name, dense(D, D))
        if cfg.layer_norm:
            # eps 1e-5: torch's LayerNorm default, as in the reference
            for name in ("layernorm_in", "layernorm_r", "layernorm_z", "layernorm_h"):
                self.add_module(name, LayerNorm(D, eps=1e-5, dtype=dtype,
                                                param_dtype=param_dtype))

    def _ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.cfg.layer_norm else x

    def forward(self, x, h0, s0, frame_mask=None):
        cfg = self.cfg
        u = self._ln("layernorm_in", self.input_proj(x))
        if cfg.fused_ops:
            _, z_pre, k, v, h_pre, decay_logits = torch.chunk(self.W_fused(u), 6, dim=-1)
        else:
            z_pre, k, v, decay_logits = (getattr(self, n)(u) for n in ("W_z", "W_k", "W_v",
                                                                      "W_decay"))
        z = torch.sigmoid(self._ln("layernorm_z", z_pre))
        kv = k * v
        if cfg.decay_mode == "learned":
            decay = torch.sigmoid(decay_logits)
        else:
            # positional decay exp(−λ·t), t counted within the segment
            t_idx = torch.arange(x.shape[1], device=x.device,
                                 dtype=torch.promote_types(kv.dtype, torch.float32))
            decay = torch.exp(-cfg.lambda_decay * t_idx).to(kv.dtype)
            decay = decay[None, :, None].expand(kv.shape)

        s_all = _masked_scan(decay, kv, s0, frame_mask, cfg.kernel_impl)
        if cfg.fused_ops:
            c = torch.tanh(self._ln("layernorm_h", h_pre + s_all))
        else:
            c = torch.tanh(self._ln("layernorm_h", self.W_h(u + s_all)))
        h_all = _masked_scan(z, (1.0 - z) * c, h0, frame_mask, cfg.kernel_impl)
        return h_all, h_all[:, -1, :], s_all[:, -1, :]


class LucyNativeEncoder(nn.Module):
    """Stacked 6-gate LucyRNN (``layer{l}``) under a zero-initialised vocab
    projection (``output_proj``): no inter-layer norm, no tracks, no merge
    projection.  Carry ``{"h", "s"}`` of (B, L, D), batch-major."""

    def __init__(self, input_dim: int, vocab_size: int, cfg: LucyRNNConfig, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        for l in range(cfg.num_layers):
            self.add_module(f"layer{l}", LucyNativeCell(
                input_dim if l == 0 else cfg.hidden_dim, cfg.hidden_dim, cfg, dtype=dtype,
                param_dtype=param_dtype, generator=generator))
        self.output_proj = Dense(cfg.hidden_dim, vocab_size, dtype=dtype,
                                 param_dtype=param_dtype, generator=generator, kernel_init=None)

    def init_state(self, batch_size: int) -> dict:
        shape = (batch_size, self.cfg.num_layers, self.cfg.hidden_dim)
        dev = self.output_proj.weight.device
        return {"h": torch.zeros(shape, dtype=self.dtype, device=dev),
                "s": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def forward(self, x, state: Optional[dict] = None, frame_mask=None):
        cfg = self.cfg
        if state is None:
            state = self.init_state(x.shape[0])
        cell_mask = frame_mask if cfg.mask_state_updates else None
        h_layers, s_layers = [], []
        for l in range(cfg.num_layers):
            x, h_T, s_T = getattr(self, f"layer{l}")(
                x, state["h"][:, l].to(self.dtype), state["s"][:, l].to(self.dtype), cell_mask)
            h_layers.append(h_T)
            s_layers.append(s_T)
        logits = self.output_proj(x)
        return logits, {"h": torch.stack(h_layers, dim=1), "s": torch.stack(s_layers, dim=1)}
