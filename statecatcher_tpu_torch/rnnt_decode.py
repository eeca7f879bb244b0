"""RNN-T greedy decoding, batched, with the decode state carried across
segments.

Port of the greedy half of ``statecatcher_tpu/rnnt_decode.py`` (``:25-109``):
at each frame emit the argmax label and re-query the joint with the updated
predictor context until blank, at most ``max_symbols`` times.  The predictor
is a one-token embedding, so the context is the last emitted token, looked up
in a precomputed (V, J) table: each emission is one (B, J) × (J, V) product.
Everything stays on the device (no host sync per frame or symbol); the state
(last_token, out_buf, out_len) is the streaming twin of the encoder carry.
Beam search (``rnnt_beam_*``) is not ported yet (ROADMAP.md queue 1 item 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RNNTDecodeState(NamedTuple):
    last_token: torch.Tensor   # (B,) int32: predictor context (blank at start)
    out_buf: torch.Tensor      # (B, max_out) int32
    out_len: torch.Tensor      # (B,) int32


def rnnt_decode_init(batch: int, max_out: int, blank_id: int, device="cpu") -> RNNTDecodeState:
    return RNNTDecodeState(
        last_token=torch.full((batch,), blank_id, dtype=torch.int32, device=device),
        out_buf=torch.zeros((batch, max_out), dtype=torch.int32, device=device),
        out_len=torch.zeros((batch,), dtype=torch.int32, device=device))


@torch.no_grad()
def rnnt_greedy_decode(enc_proj: torch.Tensor, pred_table: torch.Tensor,
                       join_kernel: torch.Tensor, join_bias: torch.Tensor,
                       in_lens: torch.Tensor, blank_id: int = 0, max_symbols: int = 4,
                       init_state: Optional[RNNTDecodeState] = None,
                       max_out: int = 512) -> RNNTDecodeState:
    """enc_proj (B, T, J) in the join space, pred_table (V, J), join_kernel
    (J, V), join_bias (V,), in_lens (B,) → the advanced decode state.  A row
    stops emitting in a frame at its first blank, and for good once its
    buffer is full."""
    B, T, _ = enc_proj.shape
    dev = enc_proj.device
    st = init_state if init_state is not None else rnnt_decode_init(B, max_out, blank_id, dev)
    last, out_buf, out_len = st.last_token.to(dev), st.out_buf.to(dev), st.out_len.to(dev)
    Mo = out_buf.shape[1]
    cols = torch.arange(Mo, device=dev)[None, :]
    in_lens = in_lens.to(dev)
    for t in range(T):
        enc_t = enc_proj[:, t]
        can_emit = t < in_lens
        for _ in range(max_symbols):
            joint = torch.tanh(enc_t + pred_table[last.to(torch.int64)])
            nxt = torch.argmax(joint @ join_kernel + join_bias, dim=-1).to(torch.int32)
            emit = can_emit & (nxt != blank_id) & (out_len < Mo)
            pos = torch.clamp(out_len, max=Mo - 1)
            out_buf = torch.where((cols == pos[:, None]) & emit[:, None], nxt[:, None], out_buf)
            out_len = out_len + emit.to(torch.int32)
            last = torch.where(emit, nxt, last)
            can_emit = emit
    return RNNTDecodeState(last_token=last, out_buf=out_buf, out_len=out_len)


def rnnt_state_to_lists(state: RNNTDecodeState) -> list[list[int]]:
    buf = state.out_buf.cpu().numpy()
    lens = state.out_len.cpu().numpy()
    return [[int(x) for x in buf[b, :lens[b]]] for b in range(buf.shape[0])]


def rnnt_drain(state: RNNTDecodeState) -> tuple[RNNTDecodeState, list[list[int]]]:
    """Move the emitted tokens to the host and reset the buffer cursor.
    Lossless: the next frame needs only ``last_token``, which is kept, so
    the fixed buffer holds one stretch of emissions at a time."""
    committed = rnnt_state_to_lists(state)
    return (RNNTDecodeState(last_token=state.last_token,
                            out_buf=torch.zeros_like(state.out_buf),
                            out_len=torch.zeros_like(state.out_len)),
            committed)
