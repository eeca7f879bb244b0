"""Batched CTC prefix beam search with streaming state.

Port of ``statecatcher_tpu/beam.py``: fixed shapes throughout, all work
batched over (B, W) beams, prefix identity tracked by a rolling hash
(h = h·1000003 + tok + 1 mod 2³²), duplicate prefixes merged by a
log-sum-exp over runs of equal hashes, then the best W kept.  ``BeamState``
can be carried across segment boundaries beside the encoder carry, and
``beam_commit`` moves the prefix every live beam agrees on to the host, so
a fixed device buffer decodes a recording of any length.

What differs from JAX, and why it gives the same function:

  * the hashes are int64 holding the uint32 value (CUDA has no uint32
    arithmetic); every multiply-add is masked with ``& 0xFFFFFFFF``, and
    h·1000003 + tok + 1 < 2⁵², so nothing overflows and the int64 order is
    the uint32 order;
  * ``lax.top_k`` puts the lower index first on ties (many candidates tie
    at −1e30), ``torch.topk`` promises no order on the card: a stable
    descending sort, first W, gives JAX's order;
  * ``jnp.argsort`` is stable: ``torch.sort(stable=True)``;
  * ``lax.associative_scan`` of (logaddexp, +) over the sorted candidates is
    only ever read at a run's last element, where it holds the run's whole
    log-sum-exp: here each run's log-sum-exp is its max plus the log of the
    sum of exps, a reduction over the run in a fixed order (deterministic
    on the card).  It rounds in another order than the scan: a merged score
    differs by a few ulps (tests/test_torch_beam.py holds it to 1e-12 in
    float64);
  * JAX's 2³²−1 sentinel at both ends of the run comparisons is kept, quirk
    included (a hash equal to it does not start or end a run there).

Everything stays on the device except ``beam_commit``'s host-side shift and
``beam_hypotheses``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
HASH_P = 1000003
_HASH_MASK = 0xFFFFFFFF
_SENTINEL = 2**32 - 1


class BeamState(NamedTuple):
    p_b: torch.Tensor       # (B, W) log prob of the prefix ending in blank
    p_nb: torch.Tensor      # (B, W) log prob of the prefix ending in non-blank
    hashes: torch.Tensor    # (B, W) int64 holding the uint32 rolling hash
    last: torch.Tensor      # (B, W) int32 last token of the prefix (-1 if empty)
    toks: torch.Tensor      # (B, W, Lmax) int32 prefix tokens
    lens: torch.Tensor      # (B, W) int32 prefix lengths


def beam_init(batch: int, beam: int, max_len: int, device="cpu",
              dtype: torch.dtype = torch.float32) -> BeamState:
    p_b = torch.full((batch, beam), NEG_INF, dtype=dtype, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        p_b=p_b,
        p_nb=torch.full((batch, beam), NEG_INF, dtype=dtype, device=device),
        hashes=torch.zeros((batch, beam), dtype=torch.int64, device=device),
        last=torch.full((batch, beam), -1, dtype=torch.int32, device=device),
        toks=torch.zeros((batch, beam, max_len), dtype=torch.int32, device=device),
        lens=torch.zeros((batch, beam), dtype=torch.int32, device=device))


def hash_extend(hashes: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """h·P + tok + 1 mod 2³², on int64 holding uint32 values."""
    return (hashes * HASH_P + tok.to(torch.int64) + 1) & _HASH_MASK


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, ties lower index
    first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def run_logsumexp(vals: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """(B, N) values in runs along axis 1 (``seg_start`` marks where a run
    begins) → each position's run's whole log-sum-exp.  JAX's scan holds it
    at the run's last element; only that element is read."""
    run = torch.cumsum(seg_start.to(torch.int64), dim=1)         # run id, nondecreasing
    same = run[:, :, None] == run[:, None, :]                     # (B, N, N)
    v = vals[:, None, :]
    m = torch.where(same, v, torch.full_like(v, -torch.inf)).amax(-1)
    s = torch.where(same, torch.exp(v - m[:, :, None]), torch.zeros_like(v)).sum(-1)
    return m + torch.log(s)


def merge_runs(hashes: torch.Tensor, *scores: torch.Tensor):
    """Sort the (B, N) candidates by hash (stably) and reduce each run of
    equal hashes: → (order, the sorted hashes, is_end, each score's run
    log-sum-exp in sorted order).  ``is_end`` marks a run's last element,
    its representative."""
    B = hashes.shape[0]
    hs, order = torch.sort(hashes, dim=1, stable=True)
    sentinel = torch.full((B, 1), _SENTINEL, dtype=hs.dtype, device=hs.device)
    seg_start = hs != torch.cat([sentinel, hs[:, :-1]], dim=1)
    is_end = hs != torch.cat([hs[:, 1:], sentinel], dim=1)
    runs = [run_logsumexp(torch.gather(s, 1, order), seg_start) for s in scores]
    return order, is_end, runs


def _merge_topk(hashes, p_b, p_nb, beam: int):
    """Merge candidates with identical prefix hash, keep the top ``beam``.
    All (B, N).  Returns the surviving candidates' indices (B, W) and their
    merged scores."""
    order, is_end, (pb_run, pnb_run) = merge_runs(hashes, p_b, p_nb)
    total = torch.logaddexp(pb_run, pnb_run)
    total = torch.where(is_end, total, torch.full_like(total, NEG_INF))
    top_vals, top_idx = top_k(total, beam)                      # indices into the sorted axis
    orig_idx = torch.gather(order, 1, top_idx)
    dead = top_vals <= NEG_INF / 2
    pb_out = torch.where(dead, NEG_INF, torch.gather(pb_run, 1, top_idx))
    pnb_out = torch.where(dead, NEG_INF, torch.gather(pnb_run, 1, top_idx))
    return orig_idx, pb_out, pnb_out


def extend_buffers(toks, lens, last, parent, token):
    """Rebuild (B, W, Lmax) prefix buffers from the parents, appending
    ``token`` where it is ≥ 0 (an extension) and the buffer has room."""
    B, W = parent.shape
    Lmax = toks.shape[-1]
    toks_par = torch.gather(toks, 1, parent[:, :, None].expand(B, W, Lmax))
    lens_par = torch.gather(lens, 1, parent)
    last_par = torch.gather(last, 1, parent)
    is_ext = token >= 0
    pos = torch.clamp(lens_par, max=Lmax - 1)
    cols = torch.arange(Lmax, device=toks.device)
    put = is_ext[:, :, None] & (cols == pos[:, :, None].to(cols.dtype))
    toks_new = torch.where(put, torch.clamp(token, min=0)[:, :, None].to(toks.dtype), toks_par)
    lens_new = torch.where(is_ext, torch.clamp(lens_par + 1, max=Lmax), lens_par)
    last_new = torch.where(is_ext, token.to(last.dtype), last_par)
    return toks_new, lens_new, last_new, is_ext


def beam_step(state: BeamState, lp: torch.Tensor, active: torch.Tensor, beam: int,
              topk: int, blank_id: int) -> BeamState:
    """One frame of prefix beam search.  lp: (B, V) log-probs; active: (B,)."""
    B, W = state.p_b.shape
    V = lp.shape[-1]
    K = min(topk, V)
    dev = lp.device
    neg = torch.full((), NEG_INF, dtype=lp.dtype, device=dev)

    top_lp, top_tok = top_k(lp, K)                                # (B, K)
    lp_blank = lp[:, blank_id]

    # candidate 0 of each beam, "stay": extend by blank or repeat the last token
    stay_pb = torch.logaddexp(state.p_b, state.p_nb) + lp_blank[:, None]
    last_lp = torch.where(state.last >= 0,
                          torch.gather(lp, 1, torch.clamp(state.last, min=0).to(torch.int64)),
                          neg)
    stay_pnb = state.p_nb + last_lp

    # K extension candidates per beam: from p_b always, from p_nb unless c is
    # the last token
    tok = top_tok[:, None, :].expand(B, W, K)
    tlp = top_lp[:, None, :].expand(B, W, K)
    same_as_last = tok == state.last[:, :, None].to(tok.dtype)
    ext_src = torch.where(same_as_last, state.p_b[:, :, None],
                          torch.logaddexp(state.p_b, state.p_nb)[:, :, None])
    ext_pnb = torch.where(tok == blank_id, neg, ext_src + tlp)
    ext_hash = hash_extend(state.hashes[:, :, None], tok)

    # the candidates: stay (W) ++ extend (W·K)
    cand_pb = torch.cat([stay_pb, torch.full((B, W * K), NEG_INF, dtype=lp.dtype, device=dev)],
                        dim=1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, W * K)], dim=1)
    cand_hash = torch.cat([state.hashes, ext_hash.reshape(B, W * K)], dim=1)
    ar = torch.arange(W, device=dev)
    cand_parent = torch.cat([ar, ar.repeat_interleave(K)])[None].expand(B, W + W * K)
    cand_token = torch.cat([torch.full((B, W), -1, dtype=torch.int64, device=dev),
                            tok.reshape(B, W * K)], dim=1)

    idx, pb_new, pnb_new = _merge_topk(cand_hash, cand_pb, cand_pnb, W)
    parent = torch.gather(cand_parent, 1, idx)
    token = torch.gather(cand_token, 1, idx)
    hash_new = torch.gather(cand_hash, 1, idx)
    toks_new, lens_new, last_new, _ = extend_buffers(state.toks, state.lens, state.last,
                                                     parent, token)
    # frames past in_len keep the previous state
    keep = active.to(dev)[:, None]
    return BeamState(
        p_b=torch.where(keep, pb_new, state.p_b),
        p_nb=torch.where(keep, pnb_new, state.p_nb),
        hashes=torch.where(keep, hash_new, state.hashes),
        last=torch.where(keep, last_new, state.last),
        toks=torch.where(keep[:, :, None], toks_new, state.toks),
        lens=torch.where(keep, lens_new, state.lens))


@torch.no_grad()
def ctc_beam_search(log_probs: torch.Tensor, in_lens: torch.Tensor, beam: int = 8,
                    topk: int = 16, blank_id: int = 0, max_len: int = 256,
                    init_state: Optional[BeamState] = None
                    ) -> tuple[BeamState, torch.Tensor]:
    """Prefix beam search over a segment, one frame a step: log_probs (B, T,
    V), in_lens (B,) → (final BeamState, each beam's total log-prob (B, W)).
    The state starts from ``init_state`` (carried) or empty."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    state = (beam_init(B, beam, max_len, dev, log_probs.dtype) if init_state is None
             else BeamState(*(x.to(dev) for x in init_state)))
    in_lens = in_lens.to(dev)
    for t in range(T):
        state = beam_step(state, log_probs[:, t], t < in_lens, beam, topk, blank_id)
    return state, torch.logaddexp(state.p_b, state.p_nb)


def _rolling_hashes(toks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The uint32 rolling prefix hash (h = h·P + tok + 1) of (…, L) token
    buffers with (…,) lengths, on the host."""
    P = np.uint32(HASH_P)
    h = np.zeros(toks.shape[:-1], np.uint32)
    valid = np.arange(toks.shape[-1]) < lens[..., None]
    with np.errstate(over="ignore"):
        for j in range(toks.shape[-1]):
            step = h * P + toks[..., j].astype(np.uint32) + np.uint32(1)
            h = np.where(valid[..., j], step, h)
    return h


def committed_prefix_shift(toks: np.ndarray, lens: np.ndarray, live: np.ndarray,
                           best: np.ndarray, reserve: int | None = None):
    """Host-side core of the streaming commit: per batch row, the longest
    common prefix (LCP) of the live beams' tokens is removed from the
    buffers (a left shift) and returned as the committed emission.
    Lossless: every live hypothesis is ``committed ++ residual``, and equal
    residuals mean equal sequences, so hash merging is unaffected.

    ``reserve``: if set, guarantee at least ``reserve`` free slots after the
    shift by force-committing along the best beam when the LCP is too
    short; beams that disagree with the forced prefix are pruned (``live``
    cleared).  With ``reserve=None`` the operation is exact.

    Returns (toks, lens, live, recomputed uint32 hashes, committed lists).
    """
    toks = np.array(toks, np.int32, copy=True)
    lens = np.array(lens, np.int32, copy=True)
    live = np.array(live, bool, copy=True)
    B, W, L = toks.shape
    committed: list[list[int]] = []
    for b in range(B):
        lw = np.where(live[b])[0]
        if lw.size == 0:
            committed.append([])
            continue
        ref_w = int(best[b]) if live[b, best[b]] else int(lw[0])
        ref = toks[b, ref_w, :lens[b, ref_w]]
        # LCP over the live beams (a shorter live beam caps it at its length)
        n = len(ref)
        for w in lw:
            m = min(n, int(lens[b, w]))
            neq = np.nonzero(toks[b, w, :m] != ref[:m])[0]
            n = int(neq[0]) if neq.size else m
            if n == 0:
                break
        commit_n = n
        if reserve is not None:
            need = int(lens[b, lw].max()) - (L - reserve)
            if need > commit_n:
                # force-commit along the best beam; prune disagreeing beams
                commit_n = min(need, int(lens[b, ref_w]))
                for w in lw:
                    if int(lens[b, w]) < commit_n or np.any(toks[b, w, :commit_n]
                                                            != ref[:commit_n]):
                        live[b, w] = False
        committed.append([int(x) for x in ref[:commit_n]])
        if commit_n:
            for w in range(W):
                if not live[b, w]:
                    lens[b, w] = 0
                    continue
                r = int(lens[b, w]) - commit_n
                toks[b, w, :r] = toks[b, w, commit_n:commit_n + r]
                toks[b, w, r:] = 0
                lens[b, w] = r
    return toks, lens, live, _rolling_hashes(toks, lens), committed


def beam_commit(state: BeamState, totals, reserve: int | None = None,
                return_best: bool = False):
    """Streaming commit of the CTC prefix-beam state: the prefix all live
    beams agree on goes to the host per row, the token buffers are shifted
    left to free room, and the state comes back with the row's committed
    token lists.  ``last`` (the repeat-collapse context) is untouched.
    Scores of pruned beams are killed on the device, with no copy of p_b or
    p_nb to the host.  With ``return_best`` also the best beam's residual
    per row and the residuals' fill level, from the host arrays in hand."""
    totals_h = totals.detach().cpu().numpy()
    live = totals_h > NEG_INF / 2
    best = np.argmax(np.where(live, totals_h, -np.inf), axis=1).astype(np.int32)
    toks, lens, live2, hashes, committed = committed_prefix_shift(
        state.toks.cpu().numpy(), state.lens.cpu().numpy(), live, best, reserve)
    dev = state.p_b.device
    kill = torch.from_numpy(~live2).to(dev)
    new = BeamState(
        p_b=torch.where(kill, NEG_INF, state.p_b),
        p_nb=torch.where(kill, NEG_INF, state.p_nb),
        hashes=torch.from_numpy(hashes.astype(np.int64)).to(dev),
        last=state.last,
        toks=torch.from_numpy(toks).to(dev),
        lens=torch.from_numpy(lens).to(dev))
    if not return_best:
        return new, committed
    best_resid = []
    for b in range(toks.shape[0]):
        lw = np.where(live2[b])[0]
        if lw.size == 0:
            best_resid.append([])
            continue
        w = int(best[b]) if live2[b, best[b]] else int(lw[0])
        best_resid.append([int(x) for x in toks[b, w, :lens[b, w]]])
    return new, committed, best_resid, int(lens.max())


def beam_hypotheses(state: BeamState, totals) -> list[list[tuple[float, list[int]]]]:
    """Host-side: per batch row, the live (score, tokens), best first."""
    totals = totals.detach().cpu().numpy()
    toks = state.toks.cpu().numpy()
    lens = state.lens.cpu().numpy()
    out = []
    for b in range(totals.shape[0]):
        hyps = []
        for w in np.argsort(-totals[b]):
            if totals[b, w] <= NEG_INF / 2:
                continue
            hyps.append((float(totals[b, w]), [int(x) for x in toks[b, w, :lens[b, w]]]))
        out.append(hyps)
    return out
