"""RWKV encoder (v4-style): the WKV time mix, parallel in time.

Port of ``statecatcher_tpu/models/rwkv.py``.  The WKV recurrence

    wkv_t = (num_{t-1} + e^{u+k_t} v_t) / (den_{t-1} + e^{u+k_t})
    num_t = e^{-w} num_{t-1} + e^{k_t} v_t
    den_t = e^{-w} den_{t-1} + e^{k_t}

runs in log space: ``den`` and the positive and negative parts of ``num``
(sign-split) are each the inclusive scan L_t = logaddexp(L_{t-1} − w, b_t),
with the carried state as L_{-1}.  JAX computes them with
``lax.associative_scan``; here they are one Hillis–Steele scan of the three
stacked: ⌈log₂ T⌉ steps of

    L_t ← logaddexp(L_t, L_{t−s} − w·s),   s = 1, 2, 4, …

each a few elementwise passes over the whole segment, so no step walks time
(a frame loop, as the LSTM's, costs a launch a frame on the card).  w·s is
exact in floating point (s is a power of two), so each term is rounded once
a step, near the size of the values that matter; a decayed term becomes
negligible rather than losing its digits.  A chunked ``logcumsumexp`` with a
per-chunk offset of w·(t − s₀) adds offsets up to w·C to terms that still
matter, and at the init's decays (up to e) it was 6.6–21.5× further
from a float64 step loop than JAX's f32 scan at T=1598 (chunks of 16–64;
``tools/wkv_orders.py``); ``tests/test_torch_rwkv.py`` holds this form
within 2× of JAX's error.

Under autograd the scan is recomputed in the backward
(``torch.utils.checkpoint``): its ⌈log₂ T⌉ steps would otherwise keep
~30 tensors of the segment's size a layer.

The WKV runs in at least float32 (the model's dtype under float64, where
JAX's casts keep float32); the log states start at −1e30 ("empty") in
float32, and the ``+1e-20`` inside log(max(±v, 0) + 1e-20) is JAX's.

Block: token shift with the carried ``last_x``, time mix (``mix_k/v/r``
blends, ``key/value/receptance/output`` without bias, decay = exp(w) with w
stored in log space, bonus u = ``time_first``) and channel mix (relu² FFN at
4×, sigmoid receptance), each pre-LayerNorm and residual; ``ln_out`` and a
zero-initialised ``vocab_proj``.  The encoder ignores ``frame_mask``, as
JAX's does: padded frames still decay the state and replace ``last_x``.

Carry (batch-major): ``last_x_tm``, ``last_x_cm``, ``log_num_p``,
``log_num_n``, ``log_den``, each (B, L, D).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from statecatcher_tpu_torch.models.layers import Dense, LayerNorm

NEG = -1e30
CARRY_KEYS = ("last_x_tm", "last_x_cm", "log_num_p", "log_num_n", "log_den")


def decay_logsum_scan(logb: torch.Tensor, w: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of L_t = logaddexp(L_{t-1} − w, logb_t) over axis −2.

    logb (..., T, D), w (D,) positive decay, init (..., D) (−1e30: empty).
    """
    T = logb.shape[-2]
    L, s = logb, 1
    while s < T:
        L = torch.cat([L[..., :s, :], torch.logaddexp(L[..., s:, :], L[..., :-s, :] - w * s)],
                      dim=-2)
        s *= 2
    steps = torch.arange(1, T + 1, dtype=logb.dtype, device=logb.device)[:, None]
    return torch.logaddexp(L, init[..., None, :] - steps * w)


def _log_pos(v: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(v, min=0.0) + 1e-20)


def _wkv(k, v, w, u, log_num_p0, log_num_n0, log_den0):
    logv_p, logv_n = _log_pos(v), _log_pos(-v)
    init = torch.stack([log_num_p0, log_num_n0, log_den0])                 # (3, B, D)
    scans = decay_logsum_scan(torch.stack([k + logv_p, k + logv_n, k]), w, init)
    # exclusive: the state BEFORE step t, the carried one at t = 0
    prev = torch.cat([init[:, :, None], scans[:, :, :-1]], dim=2)
    bonus = u + k
    top_p = torch.logaddexp(prev[0], bonus + logv_p)
    top_n = torch.logaddexp(prev[1], bonus + logv_n)
    bot = torch.logaddexp(prev[2], bonus)
    wkv = torch.exp(top_p - bot) - torch.exp(top_n - bot)
    return wkv, scans[0, :, -1], scans[1, :, -1], scans[2, :, -1]


def wkv_parallel(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                 state: tuple) -> tuple[torch.Tensor, tuple]:
    """k, v (B, T, D), w (D,) positive decay, u (D,) bonus, state
    (log_num_p, log_num_n, log_den) each (B, D) → (wkv (B, T, D), new
    state).  Computes in at least float32."""
    cdt = torch.promote_types(k.dtype, torch.float32)
    args = [x.to(cdt) for x in (k, v, w, u, *state)]
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        wkv, *new = checkpoint(_wkv, *args, use_reentrant=False)
    else:
        wkv, *new = _wkv(*args)
    return wkv, tuple(new)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, with the carried last frame at t = 0 (in the wider of the
    two dtypes, as JAX's concatenate promotes)."""
    dt = torch.promote_types(x.dtype, last.dtype)
    return torch.cat([last[:, None, :].to(dt), x[:, :-1].to(dt)], dim=1)


def _mix(x, prev, mix):
    """x·mix + prev·(1 − mix), promoted as JAX promotes (the Dense after it
    casts to the model dtype)."""
    return x * mix + prev * (1 - mix)


class RWKVTimeMix(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        D = dim
        self.dtype = dtype
        for name in ("mix_k", "mix_v", "mix_r"):
            setattr(self, name, nn.Parameter(torch.full((D,), 0.5, dtype=param_dtype)))
        # the decay spreads time constants across channels (the RWKV convention)
        self.time_decay = nn.Parameter(torch.linspace(-5.0, 1.0, D).to(param_dtype))
        self.time_first = nn.Parameter(torch.zeros(D, dtype=param_dtype))
        for name in ("key", "value", "receptance", "output"):
            setattr(self, name, Dense(D, D, dtype=dtype, param_dtype=param_dtype,
                                      generator=generator, use_bias=False))

    def forward(self, x: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        prev = _token_shift(x, state["last_x"])
        k = self.key(_mix(x, prev, self.mix_k))
        v = self.value(_mix(x, prev, self.mix_v))
        r = torch.sigmoid(self.receptance(_mix(x, prev, self.mix_r)))
        cdt = torch.promote_types(self.dtype, torch.float32)
        wkv, (np_, nn_, nd) = wkv_parallel(
            k, v, torch.exp(self.time_decay.to(cdt)), self.time_first,
            (state["log_num_p"], state["log_num_n"], state["log_den"]))
        out = self.output(r * wkv.to(self.dtype))
        return out, {"last_x": x[:, -1], "log_num_p": np_, "log_num_n": nn_, "log_den": nd}


class RWKVChannelMix(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator, hidden_mult: int = 4):
        super().__init__()
        D = dim
        self.mix_k = nn.Parameter(torch.full((D,), 0.5, dtype=param_dtype))
        self.mix_r = nn.Parameter(torch.full((D,), 0.5, dtype=param_dtype))
        # flax creates them in call order: key, receptance, value
        self.key = Dense(D, D * hidden_mult, dtype=dtype, param_dtype=param_dtype,
                         generator=generator, use_bias=False)
        self.receptance = Dense(D, D, dtype=dtype, param_dtype=param_dtype,
                                generator=generator, use_bias=False)
        self.value = Dense(D * hidden_mult, D, dtype=dtype, param_dtype=param_dtype,
                           generator=generator, use_bias=False)

    def forward(self, x: torch.Tensor, last_x: torch.Tensor):
        prev = _token_shift(x, last_x)
        k = self.key(_mix(x, prev, self.mix_k))
        r = torch.sigmoid(self.receptance(_mix(x, prev, self.mix_r)))
        return r * self.value(torch.relu(k).square()), x[:, -1]


class RWKVEncoder(nn.Module):
    """RWKV block stack with a vocabulary head and the carried state above."""

    def __init__(self, input_dim: int, vocab_size: int, dim: int = 512, num_layers: int = 4, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dim, self.num_layers, self.dtype = dim, num_layers, dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.input_proj = Dense(input_dim, dim, generator=generator, **kw)
        for l in range(num_layers):
            setattr(self, f"ln_tm{l}", LayerNorm(dim, eps=1e-6, **kw))
            setattr(self, f"time_mix{l}", RWKVTimeMix(dim, generator=generator, **kw))
            setattr(self, f"ln_cm{l}", LayerNorm(dim, eps=1e-6, **kw))
            setattr(self, f"channel_mix{l}", RWKVChannelMix(dim, generator=generator, **kw))
        self.ln_out = LayerNorm(dim, eps=1e-6, **kw)
        self.vocab_proj = Dense(dim, vocab_size, generator=generator, kernel_init=None, **kw)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None, frame_mask=None):
        # frame_mask is ignored, as in JAX: ASRModel zeroes padded inputs
        if state is None:
            state = rwkv_init_carry(self.dim, self.num_layers, x.shape[0], self.dtype, x.device)
        x = self.input_proj(x)
        new = {k: [] for k in CARRY_KEYS}
        for l in range(self.num_layers):
            h, tm = getattr(self, f"time_mix{l}")(getattr(self, f"ln_tm{l}")(x), {
                "last_x": state["last_x_tm"][:, l], "log_num_p": state["log_num_p"][:, l],
                "log_num_n": state["log_num_n"][:, l], "log_den": state["log_den"][:, l]})
            x = x + h
            f, cm_last = getattr(self, f"channel_mix{l}")(getattr(self, f"ln_cm{l}")(x),
                                                          state["last_x_cm"][:, l])
            x = x + f
            new["last_x_tm"].append(tm["last_x"])
            new["last_x_cm"].append(cm_last)
            for key in ("log_num_p", "log_num_n", "log_den"):
                new[key].append(tm[key])
        logits = self.vocab_proj(self.ln_out(x))
        return logits, {k: torch.stack(v, dim=1) for k, v in new.items()}


def rwkv_init_carry(dim: int, num_layers: int, batch_size: int, dtype=torch.float32,
                    device="cpu") -> dict:
    """The empty carry: ``last_x_*`` zero in ``dtype``, the log states −1e30
    in float32."""
    shape = (batch_size, num_layers, dim)
    carry = {k: torch.zeros(shape, dtype=dtype, device=device) for k in CARRY_KEYS[:2]}
    for k in CARRY_KEYS[2:]:
        carry[k] = torch.full(shape, NEG, dtype=torch.float32, device=device)
    return carry
