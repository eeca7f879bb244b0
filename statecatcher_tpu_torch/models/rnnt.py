"""RNN-T predictor + joiner.

Port of ``statecatcher_tpu/models/rnnt.py``: a stateless one-token embedding
predictor, encoder and predictor projections into a shared join space, a
broadcast add + tanh, and the final vocab projection.  The predictor input is
the blank-prefixed label sequence (``make_prefix``).

Parameter names follow the flax tree (``embedding``, ``enc_proj``,
``pred_proj``, ``join_kernel``, ``join_bias``) so converted weights load by
name.  ``join_kernel`` keeps the JAX layout (J, V): the loss kernels
(``ops/rnnt_joint.py``) read the same matrix.
"""

from __future__ import annotations

import torch
from torch import nn

from statecatcher_tpu_torch.models.layers import Dense, Embed, lecun_normal_


class RNNTPredictorJoiner(nn.Module):
    """Embedding predictor + add-joiner.  Parameters are initialised on the
    CPU from ``generator``, as the other modules of the port."""

    def __init__(self, vocab_size: int, enc_out_dim: int, pred_emb_dim: int = 64,
                 join_dim: int = 64, *, dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.embedding = Embed(vocab_size, pred_emb_dim, dtype=dtype, param_dtype=param_dtype,
                               generator=generator)
        self.enc_proj = Dense(enc_out_dim, join_dim, dtype=dtype, param_dtype=param_dtype,
                              generator=generator)
        self.pred_proj = Dense(pred_emb_dim, join_dim, dtype=dtype, param_dtype=param_dtype,
                               generator=generator)
        # (J, V), flax's (in, out): lecun_normal over fan-in J, drawn as the
        # (out, in) matrix lecun_normal_ takes
        w = torch.empty(vocab_size, join_dim, dtype=param_dtype)
        lecun_normal_(w, generator)
        self.join_kernel = nn.Parameter(w.T.contiguous())
        self.join_bias = nn.Parameter(torch.zeros(vocab_size, dtype=param_dtype))

    def project(self, enc_out: torch.Tensor, prefix: torch.Tensor):
        """(enc_p (B, T, J), pred_p (B, U+1, J), join_kernel, join_bias)."""
        return (self.enc_proj(enc_out), self.pred_proj(self.embedding(prefix)),
                self.join_kernel, self.join_bias)

    def joint(self, enc_proj: torch.Tensor, pred_proj: torch.Tensor) -> torch.Tensor:
        """(B, T, J) × (B, U+1, J) → (B, T, U+1, V) logits: tanh of the
        broadcast sum, then the vocab projection, in the joint's dtype."""
        j = torch.tanh(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
        return j @ self.join_kernel.to(j.dtype) + self.join_bias.to(j.dtype)

    def decode_tables(self):
        """(pred_table (V, J), join_kernel (J, V), join_bias (V,)): the
        predictor's projection of every token, so each greedy emission is
        one (B, J) × (J, V) product (``rnnt_decode.py``)."""
        tokens = torch.arange(self.vocab_size, device=self.join_kernel.device)
        return self.pred_proj(self.embedding(tokens)), self.join_kernel, self.join_bias

    def project_encoder(self, enc_out: torch.Tensor) -> torch.Tensor:
        """Encoder output → join space, the projection the loss uses."""
        return self.enc_proj(enc_out)

    def forward(self, enc_out: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
        enc_p, pred_p, _, _ = self.project(enc_out, prefix)
        return self.joint(enc_p, pred_p)


def make_prefix(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Blank-prefixed predictor input (B, U+1)."""
    blank_col = torch.full_like(labels[:, :1], blank_id)
    return torch.cat([blank_col, labels], dim=1)
