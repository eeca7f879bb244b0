"""RNN-T decoding, greedy and beam, batched, with the decode state carried
across segments.

Port of ``statecatcher_tpu/rnnt_decode.py``.  Greedy: at each frame emit
the argmax label and re-query the joint with the updated predictor context
until blank, at most ``max_symbols`` times.  The predictor is a one-token
embedding, so the context is the last emitted token, looked up in a
precomputed (V, J) table: each emission is one (B, J) × (J, V) product.
Beam: W hypotheses a row, expanded ``max_symbols`` rounds a frame with a
frontier mask (a hypothesis that took blank this frame emits no more in it),
equal label sequences merged by ``beam.py``'s rolling hash and run
log-sum-exp, the best W kept by ``beam.top_k``'s stable order (the same
translation of JAX's uint32 hashes, ``lax.associative_scan`` and
``lax.top_k``; unlike the CTC merge, −1e30 scores stay as they are).
Everything stays on the device (no host sync per frame or symbol) except
the commits; the states are the streaming twins of the encoder carry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from statecatcher_tpu_torch.beam import (
    committed_prefix_shift,
    extend_buffers,
    hash_extend,
    merge_runs,
    top_k,
)


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


# --------------------------------------------------------------------------- #
# Beam search
# --------------------------------------------------------------------------- #
_NEG = -1e30


class RNNTBeamState(NamedTuple):
    """W hypotheses per utterance, mergeable by rolling prefix hash."""

    scores: torch.Tensor      # (B, W) log prob of each hypothesis
    last_token: torch.Tensor  # (B, W) int32
    hashes: torch.Tensor      # (B, W) int64 holding the uint32 hash
    toks: torch.Tensor        # (B, W, Lmax) int32
    lens: torch.Tensor        # (B, W) int32


def rnnt_beam_init(batch: int, beam: int, max_out: int, blank_id: int, device="cpu",
                   dtype: torch.dtype = torch.float32) -> RNNTBeamState:
    scores = torch.full((batch, beam), _NEG, dtype=dtype, device=device)
    scores[:, 0] = 0.0
    return RNNTBeamState(
        scores=scores,
        last_token=torch.full((batch, beam), blank_id, dtype=torch.int32, device=device),
        hashes=torch.zeros((batch, beam), dtype=torch.int64, device=device),
        toks=torch.zeros((batch, beam, max_out), dtype=torch.int32, device=device),
        lens=torch.zeros((batch, beam), dtype=torch.int32, device=device))


def _merge_dedup(scores, hashes, W: int):
    """Merge equal-hash candidates (log-sum-exp), keep the top W: → (their
    scores, their indices into the candidate axis)."""
    order, is_end, (run,) = merge_runs(hashes, scores)
    run = torch.where(is_end, run, torch.full_like(run, _NEG))
    top_vals, top_idx = top_k(run, W)
    return top_vals, torch.gather(order, 1, top_idx)


@torch.no_grad()
def rnnt_beam_search(enc_proj: torch.Tensor, pred_table: torch.Tensor,
                     join_kernel: torch.Tensor, join_bias: torch.Tensor,
                     in_lens: torch.Tensor, blank_id: int = 0, beam: int = 4, topk: int = 4,
                     max_symbols: int = 3, init_state: Optional[RNNTBeamState] = None,
                     max_out: int = 512) -> RNNTBeamState:
    """Time-synchronous RNN-T beam search: enc_proj (B, T, J), the decode
    tables, in_lens (B,) → the advanced state.  Per frame each hypothesis
    expands ``max_symbols`` rounds: blank keeps it (it advances to the next
    frame and leaves the frontier), a label extends it; equal label
    sequences merge by hash.  The hypotheses are in pruning order
    (``rnnt_beam_to_lists`` ranks them)."""
    B, T, _ = enc_proj.shape
    dev = enc_proj.device
    K = min(topk, pred_table.shape[0])
    st = (rnnt_beam_init(B, beam, max_out, blank_id, dev, enc_proj.dtype) if init_state is None
          else RNNTBeamState(*(x.to(dev) for x in init_state)))
    W = st.scores.shape[1]
    Mo = st.toks.shape[2]
    in_lens = in_lens.to(dev)
    ar = torch.arange(W, device=dev)
    cand_parent = torch.cat([ar, ar.repeat_interleave(K)])[None].expand(B, W + W * K)
    stay_token = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    for t in range(T):
        enc_t = enc_proj[:, t]
        active = (t < in_lens)[:, None]
        frontier = torch.ones((B, W), dtype=torch.bool, device=dev)
        for _ in range(max_symbols):
            joint = torch.tanh(enc_t[:, None, :] + pred_table[st.last_token.to(torch.int64)])
            logp = torch.log_softmax(joint @ join_kernel + join_bias, dim=-1)   # (B, W, V)
            # stay candidates: advance via blank
            stay = st.scores + torch.where(frontier, logp[..., blank_id],
                                           torch.zeros_like(st.scores))
            # expand candidates (frontier hypotheses only)
            lp_k, tok_k = top_k(logp, K)                                      # (B, W, K)
            can = frontier[:, :, None] & (tok_k != blank_id) & (st.lens[:, :, None] < Mo)
            ext_scores = torch.where(can, st.scores[:, :, None] + lp_k,
                                     torch.full_like(lp_k, _NEG))
            cand_scores = torch.cat([stay, ext_scores.reshape(B, W * K)], dim=1)
            cand_hash = torch.cat([st.hashes, hash_extend(st.hashes[:, :, None], tok_k)
                                   .reshape(B, W * K)], dim=1)
            cand_token = torch.cat([stay_token, tok_k.reshape(B, W * K)], dim=1)

            new_scores, idx = _merge_dedup(cand_scores, cand_hash, W)
            parent = torch.gather(cand_parent, 1, idx)
            token = torch.gather(cand_token, 1, idx)
            hashes = torch.gather(cand_hash, 1, idx)
            toks_new, lens_new, last_new, is_ext = extend_buffers(
                st.toks, st.lens, st.last_token, parent, token)
            frontier_new = torch.gather(frontier, 1, parent) & is_ext
            st = RNNTBeamState(
                scores=torch.where(active, new_scores, st.scores),
                last_token=torch.where(active, last_new, st.last_token),
                hashes=torch.where(active, hashes, st.hashes),
                toks=torch.where(active[:, :, None], toks_new, st.toks),
                lens=torch.where(active, lens_new, st.lens))
            frontier = torch.where(active, frontier_new, frontier)
    return st


def rnnt_beam_commit(state: RNNTBeamState, reserve: int | None = None
                     ) -> tuple[RNNTBeamState, list[list[int]]]:
    """Streaming commit of the RNN-T beam state: emit the prefix all live
    beams agree on, shift the token buffers left, recompute the residual
    hashes; ``last_token`` (the predictor context) is untouched.  See
    ``beam.committed_prefix_shift`` for ``reserve``."""
    scores_h = state.scores.cpu().numpy()
    live = scores_h > -1e29
    best = np.argmax(np.where(live, scores_h, -np.inf), axis=1).astype(np.int32)
    toks, lens, live2, hashes, committed = committed_prefix_shift(
        state.toks.cpu().numpy(), state.lens.cpu().numpy(), live, best, reserve)
    scores = np.array(scores_h, copy=True)
    scores[~live2] = _NEG
    dev = state.scores.device
    new = RNNTBeamState(
        scores=torch.from_numpy(scores).to(dev),
        last_token=state.last_token,
        hashes=torch.from_numpy(hashes.astype(np.int64)).to(dev),
        toks=torch.from_numpy(toks).to(dev),
        lens=torch.from_numpy(lens).to(dev))
    return new, committed


def rnnt_beam_to_lists(state: RNNTBeamState) -> list[list[tuple[float, list[int]]]]:
    """Host-side: per batch row, the live (score, tokens), best first."""
    scores = state.scores.cpu().numpy()
    toks = state.toks.cpu().numpy()
    lens = state.lens.cpu().numpy()
    out = []
    for b in range(scores.shape[0]):
        hyps = []
        for w in np.argsort(-scores[b]):
            if scores[b, w] <= -1e29:
                continue
            hyps.append((float(scores[b, w]), [int(x) for x in toks[b, w, :lens[b, w]]]))
        out.append(hyps)
    return out
