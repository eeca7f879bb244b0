"""The CTC lattice's order of work on the card (``ctc_alpha`` and
``ctc_beta``, K3/K4, ``ops/csrc/ctc_lattice.cu``), written out as plain torch
here and held against the plain versions and against JAX.

The kernels give one block of warps to a batch row.  With C states a lane
(C = ceil(S / 1024)), warp j owns the W = 32·C states [j·W, (j+1)·W) and
lane l the C consecutive states j·W + l·C + i.  Padded states (s ≥ S) read
zeros for emit and are never stored.  α's state s needs s, s−1 and s−2 of
the frame before, so within a warp a frame is two shuffles (``__shfl_up``)
and one lse3; the warp's first lane takes s−1 and s−2 from the edge pair
(the top two states) of warp j−1.  β mirrors it (s+1, s+2, ``__shfl_down``,
the bottom two states of warp j+1), so its pipeline runs from the top warp
down.  The walk's first frame (α's t = 0, β's t = in_len − 1) comes from its
own rule; then each warp walks chunks of F frames (8 for C ≤ 2, 4 above):
it waits once a chunk for the warp before it to have finished that chunk,
takes the chunk's F edge pairs from a ring of 4 chunk slots, and writes its
own edge pairs into its own ring, whose slot it reuses only after the next
warp has read it.  Its emit comes from its own ring of chunks (6 stages for
C = 1, 3 above), copied ahead of the walk.  Rows past the walk are written
after it: α repeats its last row (−1e30 when in_len ≤ 0), β's are dead.
lse3 is the plain version's f32 operations in its order (so that the card
gives its bits), but for the one of its three exps that is exp(0) = 1.

``walk`` below follows that order lane by lane, with the warps in the
skewed order of the pipeline (round r: the warp of rank q walks chunk
r − q), asserting every hand-off (a slot read holds the chunk expected, a
slot written has been read) and that every output value is written once.
It is on no path of the port.  Held:

  * against ``ctc_alpha_ref``/``ctc_beta_ref`` in float64, rtol 1e-10 and
    the same dead states (≤ −1e29), at S = 31, 32, 33, 63, 65 (one to three
    warps, a warp's edge inside and past the states) and S = 1201, 2100,
    4096 (C = 2, 3, 4: 19, 22 and 32 warps) at tiny T, with in_len 0, 1,
    < T, = T and > T, label_len 0, repeated labels (no skip) and an
    unalignable row;
  * the kernel's lse3 against the plain version's ``_lse3`` plus emit in
    float32, bit for bit, ties and −1e30 included;
  * against the JAX package's ``_alpha_all``/``_beta_all`` run in Pallas
    interpret mode, forward only, at tests/test_torch_ctc.py's tolerance:
    2e-5 on live values, the same dead states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops import ctc_pallas as jcp
from statecatcher_tpu_torch.ops.ctc_lattice import (
    _lse3,
    ctc_alpha_ref,
    ctc_beta_ref,
    skip_allowed,
)
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

NEG = -1e30
LANES = 32
EDGE_SLOTS = 4     # ctc_lattice.cu: kEdgeSlots


def states_per_lane(S):
    return -(-S // 1024)


def chunk_frames(C):
    return 8 if C <= 2 else 4


def ring_stages(C):
    return 6 if C == 1 else 3


def _lse3_add(a, b, c, e):
    """The kernel's lse3 + e: the plain version's operations in its order,
    (exp(a−m) + exp(b−m)) + exp(c−m), with the term that is exp(0) = 1 not
    computed: (ea + eb) + 1 when c is the largest, else (1 + ep) + ec with p
    the other of a and b; the floor gives −1e30 + e."""
    m = torch.maximum(torch.maximum(a, b), c)
    c_top = c >= m
    ep = torch.exp(torch.where(c_top | ~(a >= m), a, b) - m)
    eq = torch.exp(torch.where(c_top, b, c) - m)
    one = torch.ones_like(ep)
    s = torch.where(c_top, ep + eq, one + ep) + torch.where(c_top, one, eq)
    out = (m + torch.log(s)) + e
    return torch.where(m <= NEG / 2, NEG + e, out)


def _shfl(v, d):
    """``__shfl_up_sync`` (d > 0) or ``__shfl_down_sync`` (d < 0) by |d|
    over lanes: a lane whose source is outside the warp keeps its own value."""
    out = v.clone()
    if d > 0:
        out[d:] = v[:-d]
    else:
        out[:d] = v[-d:]
    return out


def _step(v, ev, skip, g, rev):
    """One frame of one warp: v, ev, skip (32, C); g the edge pair (x, y) of
    the warp before (α: its states top−1, top; β: bottom, bottom+1)."""
    C = v.shape[1]
    if C == 1:
        x1, x2 = _shfl(v[:, 0], -1 if rev else 1), _shfl(v[:, 0], -2 if rev else 2)
        if not rev:
            x1[0], x2[0], x2[1] = g[1], g[0], g[1]
        else:
            x1[31], x2[31], x2[30] = g[0], g[1], g[0]
        x1, x2 = x1[:, None], x2[:, None]
    elif not rev:
        p1, p2 = _shfl(v[:, C - 1], 1), _shfl(v[:, C - 2], 1)
        p1[0], p2[0] = g[1], g[0]
        x1 = torch.cat([p1[:, None], v[:, :-1]], 1)                  # s − 1
        x2 = torch.cat([p2[:, None], p1[:, None], v[:, :-2]], 1)     # s − 2
    else:
        n1, n2 = _shfl(v[:, 0], -1), _shfl(v[:, 1], -1)
        n1[31], n2[31] = g[0], g[1]
        x1 = torch.cat([v[:, 1:], n1[:, None]], 1)                   # s + 1
        x2 = torch.cat([v[:, 2:], n1[:, None], n2[:, None]], 1)      # s + 2
    x2 = torch.where(skip, x2, torch.full_like(x2, NEG))
    return _lse3_add(v, x1, x2, ev)


def _edge(v, rev):
    """A warp's edge pair: α its top two states, β its bottom two."""
    flat = v.reshape(-1)
    return flat[:2].clone() if rev else flat[-2:].clone()


def _walk_row(e, skip_row, L, ll, rev):
    """One batch row's α (or β) (T, S) by the kernel's order of work."""
    T, S = e.shape
    C = states_per_lane(S)
    W, F, NE = LANES * C, chunk_frames(C), ring_stages(C)
    nw = -(-S // W)
    assert nw <= 32
    s_idx = torch.arange(nw * W).reshape(nw, LANES, C)
    real = s_idx < S
    sc = s_idx.clamp(max=S - 1)
    if rev:
        skip = (s_idx + 2 < S) & skip_row[(s_idx + 2).clamp(max=S - 1)]
    else:
        skip = (s_idx >= 2) & real & skip_row[sc]
    rows = min(max(L, 0), T)
    n = max(rows - 1, 0)
    out = torch.full((T, S), float("nan"), dtype=e.dtype)
    written = torch.zeros((T, S), dtype=torch.int64)

    def store(t, w, v):
        out[t, s_idx[w][real[w]]] = v[real[w]]
        written[t, s_idx[w][real[w]]] += 1

    # the walk's first frame, from its own rule
    v = torch.full((nw, LANES, C), NEG, dtype=e.dtype)
    if rows > 0:
        t0 = rows - 1 if rev else 0
        e0 = torch.where(real, e[t0, sc], torch.zeros_like(v))
        if rev:
            term = (s_idx == 2 * ll) | ((ll > 0) & (s_idx == 2 * ll - 1))
            v = torch.where(real, e0 + torch.where(term & (L <= T), 0.0, NEG), v)
        else:
            v = torch.where(real & (s_idx <= 1), e0, v)
        for w in range(nw):
            store(t0, w, v[w])
    warp_of = [nw - 1 - q if rev else q for q in range(nw)]    # by rank
    up_of = [w + 1 if rev else w - 1 for w in range(nw)]
    rank_of = {w: q for q, w in enumerate(warp_of)}
    edge0 = [_edge(v[w], rev) for w in range(nw)]
    carry = [edge0[up_of[w]] if rank_of[w] > 0 else torch.full((2,), NEG, dtype=e.dtype)
             for w in range(nw)]
    # each warp's ring of edge slots: (chunk, F edge pairs, read yet)
    ring = [[None] * EDGE_SLOTS for _ in range(nw)]
    n_chunks = -(-n // F)
    for rnd in range(n_chunks + nw - 1):
        for q in range(nw):
            c, w = rnd - q, warp_of[q]
            if not 0 <= c < n_chunks:
                continue
            slot = c % EDGE_SLOTS
            # the emit ring: chunk c was copied into stage c % NE while the
            # walk was NE − 1 chunks behind; zeros past the walk and the states
            ks = torch.arange(c * F + 1, c * F + F + 1)
            ts = rows - 1 - ks if rev else ks
            ok = ks <= n
            ev = torch.zeros((F, LANES, C), dtype=e.dtype)
            ev[ok] = torch.where(real[w], e[ts[ok]][:, sc[w]], 0.0)
            assert c % NE != (c + NE - 1) % NE    # the stage refilled is not this one
            if rank_of[w] > 0:                    # full: the warp before finished chunk c
                held = ring[up_of[w]][slot]
                assert held is not None and held[0] == c and not held[2]
                g = held[1]
                held[2] = True                    # empty: arrived
            else:
                g = torch.full((F, 2), NEG, dtype=e.dtype)
            has_down = rank_of[w] < nw - 1
            if has_down and c >= EDGE_SLOTS:      # the next warp has read chunk c − 4
                assert ring[w][slot][0] == c - EDGE_SLOTS and ring[w][slot][2]
            mine = torch.full((F, 2), float("nan"), dtype=e.dtype)
            for f in range(F):
                k = c * F + 1 + f
                if k > n:
                    break
                v[w] = _step(v[w], ev[f], skip[w], carry[w] if f == 0 else g[f - 1], rev)
                store(rows - 1 - k if rev else k, w, v[w])
                mine[f] = _edge(v[w], rev)
            carry[w] = g[F - 1]
            if has_down:
                ring[w][slot] = [c, mine, False]
    for w in range(nw):                            # rows past the walk
        for t in range(rows, T):
            store(t, w, torch.full_like(v[w], NEG) if rev else v[w])
    assert torch.equal(written, torch.ones_like(written))
    return out


def walk(emit, allow_skip, in_lens, label_lens, rev):
    """α (``rev`` False) or β (B, T, S) by the kernels' order of work."""
    return torch.stack([_walk_row(emit[b], allow_skip[b].bool(), int(in_lens[b]),
                                  int(label_lens[b]), rev) for b in range(emit.shape[0])])


def _problem(seed, T, S, V=9):
    """Emit (B, T, S) float32 from log-softmaxed logits gathered at an
    extended label row of S states (blank 0 at even s, labels at odd s, one
    repeat), and six rows: in_len T; in_len 0 with label_len 0; in_len 1;
    in_len < T with fewer labels; in_len > T; an unalignable row (3 frames,
    every label)."""
    rng = np.random.default_rng(seed)
    B, U = 6, S // 2
    logits = rng.standard_normal((B, T, V)) * 2.0
    lp = torch.log_softmax(torch.from_numpy(logits), -1).float()
    steps = rng.integers(1, V - 1, size=(B, max(U, 1)))
    labels = torch.from_numpy((np.cumsum(steps, axis=1) % (V - 1) + 1)[:, :U])
    ext = torch.zeros((B, S), dtype=torch.int64)
    ext[:, 1::2] = labels
    if U >= 2:
        ext[:, 3] = ext[:, 1]                        # a repeat: no skip into state 3
    emit = torch.gather(lp, 2, ext[:, None, :].expand(B, T, S)).contiguous()
    skip = skip_allowed(ext, 0)
    in_lens = torch.tensor([T, 0, 1, T - 3, T + 4, 3], dtype=torch.int32)
    label_lens = torch.tensor([U, 0, U, max(U - 2, 0), U, U], dtype=torch.int32)
    return emit, skip, in_lens, label_lens


def _assert_lattice(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want > -1e29
    assert np.array_equal(live, got > -1e29)
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=atol)


SHAPES = [(21, 31), (19, 32), (21, 33), (18, 63), (21, 65), (7, 1201), (6, 2100), (5, 4096)]


@pytest.mark.parametrize("T,S", SHAPES, ids=[f"S{S}" for _, S in SHAPES])
def test_walk_matches_plain_float64(T, S):
    emit, skip, in_lens, label_lens = _problem(T + S, T, S)
    e64 = emit.double()
    assert not skip[:, 3].any()                                      # the repeat
    alpha = walk(e64, skip, in_lens, label_lens, rev=False)
    beta = walk(e64, skip, in_lens, label_lens, rev=True)
    _assert_lattice(alpha, ctc_alpha_ref(e64, skip, in_lens), 1e-10, 0)
    _assert_lattice(beta, ctc_beta_ref(e64, skip, in_lens, label_lens), 1e-10, 0)
    assert (alpha[1] <= -1e29).all() and (beta[1] <= -1e29).all()   # in_len 0
    assert (beta[4] <= -1e29).all()                                  # in_len > T


@pytest.mark.parametrize("T,S", [(21, 33), (18, 63), (7, 1201)], ids=["S33", "S63", "S1201"])
def test_walk_matches_jax_interpret(T, S):
    emit, skip, in_lens, label_lens = _problem(2 * T + S, T, S)
    args = [jnp.asarray(x.numpy()) for x in (emit, skip, in_lens)]
    with pltpu.force_tpu_interpret_mode():
        ja = jcp._alpha_all(*args)
        jb = jcp._beta_all(*args, jnp.asarray(label_lens.numpy()))
    e64 = emit.double()
    _assert_lattice(walk(e64, skip, in_lens, label_lens, rev=False), ja, 0, 2e-5)
    _assert_lattice(walk(e64, skip, in_lens, label_lens, rev=True), jb, 0, 2e-5)


def test_lse3_is_the_plain_lse3_bit_for_bit():
    """In float32, the kernel's lse3 (the term exp(0) = 1 not computed) plus
    emit equals the plain version's ``_lse3`` plus emit bit for bit, with
    ties among a, b, c and dead (−1e30) terms."""
    rng = np.random.default_rng(5)
    n = 20000
    x = torch.from_numpy((rng.standard_normal((3, n)) * 30 - 900).astype(np.float32))
    pick = torch.from_numpy(rng.integers(0, 7, (3, n)))
    x = torch.where(pick == 0, torch.full_like(x, NEG), x)           # dead terms
    x[1] = torch.where(pick[1] == 1, x[0], x[1])                      # ties
    x[2] = torch.where(pick[2] == 1, x[0], x[2])
    x[2] = torch.where(pick[2] == 2, x[1], x[2])
    e = torch.from_numpy((rng.standard_normal(n) * 3 - 7).astype(np.float32))
    a, b, c = x
    assert torch.equal(_lse3_add(a, b, c, e), _lse3(a, b, c) + e)
    assert (pick == 0).all(0).any() and (a == b).any() and (a == c).any() and (b == c).any()
