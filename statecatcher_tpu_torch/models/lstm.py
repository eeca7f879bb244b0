"""LSTM encoder: the config's default encoder.

Port of ``statecatcher_tpu/models/lstm.py:37-116``.  The input-side gate
projection of the whole segment is one (B·T, Din)×(Din, 4H) product hoisted
out of the recurrence, ``gx = x @ w_ih + (b_ih + b_hh)`` (the two biases
summed first, in the parameter dtype); each step then adds ``h @ w_hh`` and
splits the gates in the order i, f, g, o:

    c' = σ(f)·c + σ(i)·tanh(g),   h' = σ(o)·tanh(c')

A masked frame freezes (h, c) and outputs ``m·h'``, that is zero, exactly as
the JAX scan blends ``m·new + (1 − m)·old``; the mask may have holes and a
row may be masked throughout (its state is the carry it came in with).  This
is why cuDNN's ``nn.LSTM`` is not used: packed sequences refuse rows of
length 0 and assume the valid frames are a prefix.

Parameters keep the flax layout ((Din, 4H) and (H, 4H), so ``convert.py``
copies them without a transpose) and are drawn U(−1/√H, 1/√H) from an
explicit ``torch.Generator``.  The recurrence is a Python loop of torch ops,
as JAX runs it as an XLA ``lax.scan`` with no Pallas kernel.

Carry: ``{"h": (B, L, H), "c": (B, L, H)}``, batch-major.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class LSTMLayer(nn.Module):
    def __init__(self, input_dim: int, hidden_size: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        H = hidden_size
        self.hidden_size = H
        self.dtype = dtype
        bound = 1.0 / math.sqrt(H)
        shapes = {"w_ih": (input_dim, 4 * H), "w_hh": (H, 4 * H), "b_ih": (4 * H,),
                  "b_hh": (4 * H,)}
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape, dtype=param_dtype))
            with torch.no_grad():
                p.uniform_(-bound, bound, generator=generator)
            setattr(self, name, p)

    def forward(self, x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None):
        """x (B, T, Din), h0/c0 (B, H), frame_mask (B, T) or None →
        (y (B, T, H), h_T, c_T)."""
        dt = self.dtype
        H = self.hidden_size
        gx = x.to(dt) @ self.w_ih.to(dt) + (self.b_ih + self.b_hh).to(dt)   # (B, T, 4H)
        w_hh = self.w_hh.to(dt)
        h, c = h0.to(dt), c0.to(dt)
        # one view a step: indexing gx[:, t] would make autograd fill and add
        # a (B, T, 4H) gradient for every step; unbind's backward is one stack
        steps = gx.unbind(1)
        if frame_mask is not None:
            mask = frame_mask.to(dt)[..., None]
            keep, hold = mask.unbind(1), (1 - mask).unbind(1)
        ys = []
        for t, gx_t in enumerate(steps):
            g = gx_t + h @ w_hh
            sig = torch.sigmoid(g)                # i, f, o (the g quarter unused)
            i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 3 * H:]
            c_new = f * c + i * torch.tanh(g[:, 2 * H:3 * H])
            h_new = o * torch.tanh(c_new)
            if frame_mask is not None:
                # m·new + (1 − m)·old, exact for m ∈ {0, 1} in any order
                mm = keep[t]
                h_new = torch.addcmul(hold[t] * h, mm, h_new)
                c_new = torch.addcmul(hold[t] * c, mm, c_new)
                ys.append(mm * h_new)
            else:
                ys.append(h_new)
            h, c = h_new, c_new
        y = torch.stack(ys, dim=1) if ys else gx.new_zeros(x.shape[0], 0, H)
        return y, h, c


class LSTMEncoder(nn.Module):
    """Multi-layer unidirectional LSTM over ``{"h", "c"}`` of (B, L, H)."""

    def __init__(self, input_dim: int, hidden_size: int, num_layers: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        for l in range(num_layers):
            setattr(self, f"layer{l}", LSTMLayer(
                input_dim if l == 0 else hidden_size, hidden_size, dtype=dtype,
                param_dtype=param_dtype, generator=generator))

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                frame_mask: Optional[torch.Tensor] = None):
        if state is None:
            state = lstm_init_carry(x.shape[0], self.num_layers, self.hidden_size, self.dtype,
                                    x.device)
        hs, cs = [], []
        y = x
        for l in range(self.num_layers):
            y, h, c = getattr(self, f"layer{l}")(y, state["h"][:, l], state["c"][:, l],
                                                 frame_mask)
            hs.append(h)
            cs.append(c)
        return y, {"h": torch.stack(hs, dim=1), "c": torch.stack(cs, dim=1)}


def lstm_init_carry(batch_size: int, num_layers: int, hidden_size: int, dtype: torch.dtype,
                    device) -> dict:
    shape = (batch_size, num_layers, hidden_size)
    return {"h": torch.zeros(shape, dtype=dtype, device=device),
            "c": torch.zeros(shape, dtype=dtype, device=device)}
