"""The banded lattice's order of work on the card (``rnnt_band_alpha`` and
``rnnt_band_beta``, ``ops/csrc/rnnt_wavefront.cuh``), written out as plain
torch here and held against the plain versions and against JAX.

The kernels walk the anti-diagonals d = t + u of the (t, u) plane, one
block of two warps a batch row.  With f(t) = t + o(t) (o(t) the band start
of frame t's time block; f strictly increases), diagonal d's in-band cells
are the frames t_lo(d) ≤ t ≤ t_hi(d) (t_hi capped at the last frame run),
each at window column w = d − f(t); both ends move by 0 or 1 a diagonal.
Lane j holds cells k = j·c … j·c + c − 1 of the diagonal (k = t − t_lo(d)),
c = ceil(Wp / 32) or more.

The producer warp finds a chunk of 8 diagonals' spans by counting, from the
span before the chunk, the frames that have left or entered (a ballot on the
card), and moves each cell's offset g = t·Wp + w on from the previous
diagonal without a lookup: +1 (α) or −1 (β) for the same frame, the
neighbour cell's where t_lo moved (a shuffle for the end cell; the lane
past the warp keeps its own value), fresh for the frame that enters (α at
t_hi, w = 0; β at t_lo, w = Wp − 1).  Its record of a cell carries blank,
emit (−1e30 outside the span) and a floor for the up input (0 at α's start
cell and β's virtual base, else −1e30).

The consumer warp: α: a cell of diagonal d reads up from index k + Δ − 1
and right from index k + Δ of diagonal d − 1, Δ = t_lo(d) − t_lo(d−1),
from its own registers or one neighbour lane's (one shuffle a diagonal; −1e30
from outside the warp); x = logaddexp(max(up, floor), right); it sends up =
x + blank and right = x + emit (−1e30 or below outside the span, which also
cuts the edges that leave the band).  β walks downwards: a cell reads
β(t+1, u) from index k + 1 − Δ' and β(t, u+1) from index k − Δ' of diagonal
d + 1, Δ' = t_lo(d+1) − t_lo(d), and x = logaddexp(blank + max(up, floor),
emit + right).  ``walk_alpha`` and ``walk_beta`` below follow that
arithmetic lane by lane, asserting the spans and offsets against their
definitions; they are on no path of the port.  Held:

  * against ``rnnt_band_alpha_ref`` and ``rnnt_band_beta_ref`` in float64:
    rtol 1e-9, the same dead states (≤ −1e29), at Wp = 8, 48 and 80 (one,
    two and three cells a lane) with ragged t_len, t_len = 1, u_len = 0,
    U+1 < Wp, a row whose band misses its corner, a steep row whose band
    start jumps past Wp (diagonals with no cell) and a row whose band
    starts shift by 8 and by 16;
  * the NLL read from the walk's α against the JAX package's
    ``rnnt_nll_banded`` (its XLA scan; no Pallas kernel, no JAX gradient)
    at tests/test_torch_rnnt_band.py's loss tolerance (rtol 1e-5), 1e30 for
    the row that misses its corner.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt_band as jrb
from statecatcher_tpu_torch.ops import rnnt_band as rb
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

NEG = -1e30
LANES = 32
CHUNK = 8          # rnnt_wavefront.cuh: chunk_of<C>() for C <= 16


def _frames_f(o_row, tl, Tb):
    """f(t) = t + o(t) for the frames the lattice runs, as a list."""
    return [t + int(o_row[t // Tb]) for t in range(tl)]


def _span(F, d, Wp, last):
    """(t_lo, t_hi) of diagonal d from their definitions."""
    lo = next((t for t in range(last + 1) if F[t] + Wp - 1 >= d), last + 1)
    hi = max((t for t in range(last + 1) if F[t] <= d), default=-1)
    return lo, hi


def _shuffle(v, src, fill=NEG):
    """``__shfl_sync(v, lane + src)`` for every lane, ``fill`` from outside
    the warp (``None``: the lane's own value, as ``__shfl_up/down_sync``)."""
    lanes = torch.arange(LANES)
    srcs = lanes + src
    out = v.clone() if fill is None else torch.full_like(v, fill)
    ok = (srcs >= 0) & (srcs < LANES)
    out[ok] = v[srcs[ok]]
    return out


def _cells(Wp):
    c = -(-Wp // LANES)
    return c, torch.arange(LANES * c).reshape(LANES, c)


def _chunk_spans(F, d0, sgn, lo0, hi0, Wp, last):
    """The producer's spans of the CHUNK diagonals from d0 on: lane k tests
    the k-th frame that may leave or enter, each diagonal counts the lanes
    whose frame has.  Returns [(d, lo, hi)]."""
    f = lambda t: F[t] if 0 <= t <= last else None
    spans = []
    for j in range(CHUNK):
        d = d0 + sgn * j
        if sgn > 0:
            lo = lo0 + sum(1 for k in range(LANES) if f(lo0 + k) is not None
                           and f(lo0 + k) + Wp - 1 < d)
            hi = hi0 + sum(1 for k in range(LANES) if f(hi0 + 1 + k) is not None
                           and f(hi0 + 1 + k) <= d)
        else:
            lo = lo0 - sum(1 for k in range(LANES) if f(lo0 - 1 - k) is not None
                           and f(lo0 - 1 - k) + Wp - 1 >= d)
            hi = hi0 - sum(1 for k in range(LANES) if f(hi0 - k) is not None
                           and f(hi0 - k) > d)
        spans.append((d, lo, hi))
    return spans


def consume(m0, m1, dl, bl, em, floor_up, rev):
    """The consumer warp's diagonal: from the previous diagonal's messages
    (α: m0 up, m1 right; β: m0 its β), how far t_lo moved and the cells'
    records, one shuffle, each cell's two inputs and its logaddexp.  Returns
    (x, m0, m1): the cells' values and their messages."""
    c = m0.shape[1]
    if not rev and dl:   # up from index k, right from k + 1: lane + 1's first
        gv = _shuffle(m1[:, 0], 1)
        up_in, rt_in = m0, torch.cat([m1[:, 1:], gv[:, None]], 1)
    elif not rev:        # up from index k − 1: lane − 1's last; right from k
        gv = _shuffle(m0[:, c - 1], -1)
        up_in, rt_in = torch.cat([gv[:, None], m0[:, :-1]], 1), m1
    elif dl:             # (t+1, u) from index k, (t, u+1) from k − 1
        gv = _shuffle(m0[:, c - 1], -1)
        up_in, rt_in = m0, torch.cat([gv[:, None], m0[:, :-1]], 1)
    else:                # (t+1, u) from index k + 1, (t, u+1) from k
        gv = _shuffle(m0[:, 0], 1)
        up_in, rt_in = torch.cat([m0[:, 1:], gv[:, None]], 1), m0
    up = torch.maximum(up_in, floor_up)
    if rev:
        x = torch.logaddexp(bl + up, em + rt_in)
        return x, x, m1
    x = torch.logaddexp(up, rt_in)
    return x, x + bl, x + em


def _walk(blank, emit, o, t_lens, u_lens, Tb, rev):
    """α (``rev`` False) or β by the kernels' order of work: the producer's
    spans, moved offsets and records, the consumer's messages."""
    B, Tp, Wp = blank.shape
    c, k = _cells(Wp)
    out = torch.empty_like(blank)
    lane_w = torch.arange(Wp)
    sgn = -1 if rev else 1
    for b in range(B):
        last = min(max(int(t_lens[b]), 1), Tp) - 1
        F = _frames_f(o[b], last + 1, Tb)
        o_last = int(o[b, last // Tb])
        ws = int(u_lens[b]) - o_last if rev else 0        # the corner's column
        w_virt = -1
        if rev and 0 <= ws < Wp:
            w_virt = ws + (int(o[b, (last + 1) // Tb]) if last + 1 < Tp else o_last) - o_last
        d_first = F[last] + Wp - 1 if rev else F[0]
        n_diag = abs(F[0] - F[last]) + Wp
        lo0, hi0 = (last + 1, last) if rev else (0, -1)
        g = torch.zeros((LANES, c), dtype=torch.int64)    # each cell's t * Wp + w
        m0 = torch.full((LANES, c), NEG, dtype=blank.dtype)  # α: up, β: β
        m1 = m0.clone()                                      # α: right
        prev_lo, prev_h = lo0, hi0
        for n0 in range(0, n_diag, CHUNK):
            spans = _chunk_spans(F, d_first + sgn * n0, sgn, lo0, hi0, Wp, last)
            for j, (d, lo, h) in enumerate(spans):
                hi = h if n0 + j < n_diag else -1            # past the walk's end: no cell
                if n0 + j < n_diag:
                    assert (lo, h) == _span(F, d, Wp, last)
                dl = sgn * (lo - prev_lo)
                # the producer: offsets moved on (or taken from the neighbour
                # cell where lo moved), fresh for the frame that enters
                t = lo + k
                ok = t <= hi
                if dl:
                    nb = _shuffle(g[:, c - 1] if rev else g[:, 0], -1 if rev else 1, None)
                    g = (torch.cat([nb[:, None], g[:, :-1]], 1) if rev
                         else torch.cat([g[:, 1:], nb[:, None]], 1))
                enters = (dl == 1) & (t == lo) if rev else (h > prev_h) & (t == h)
                g = torch.where(enters, t * Wp + (Wp - 1 if rev else 0), g + sgn)
                w = g - t * Wp
                assert ((w[ok] >= 0) & (w[ok] < Wp)).all()
                assert torch.equal(w[ok], (d - torch.tensor(F)[t.clamp(max=last)])[ok])
                tc, wc = t.clamp(max=last), w.clamp(0, Wp - 1)
                bl = torch.where(ok, blank[b, tc, wc], NEG)
                em = torch.where(ok, emit[b, tc, wc], NEG)
                start = (t == last) & (w == w_virt) if rev else (t == 0) & (w == 0)
                floor_up = torch.where(ok & start, 0.0, NEG).to(blank.dtype)
                x, m0, m1 = consume(m0, m1, dl, bl, em, floor_up, rev)
                out[b, tc[ok], wc[ok]] = x[ok]
                prev_lo, prev_h = lo, h
            lo0, hi0 = spans[-1][1], spans[-1][2]
        out[b, last + 1:] = (torch.where(lane_w == ws, 0.0, NEG).to(blank.dtype) if rev
                             else out[b, last])
    return out


def walk_alpha(blank, emit, o, t_lens, Tb):
    """Banded α (B, Tp, Wp) by the kernel's diagonal walk."""
    return _walk(blank, emit, o, t_lens, None, Tb, rev=False)


def walk_beta(blank, emit, o, t_lens, u_lens, Tb):
    """Banded β (B, Tp, Wp) by the kernel's diagonal walk, downwards."""
    return _walk(blank, emit, o, t_lens, u_lens, Tb, rev=True)


def _rows(Wp, Tb):
    """(Tp, U+1 padded, (t_len, u_len) of each row) at window width Wp: full,
    ragged, t_len = 1, u_len = 0, a row whose band misses its corner (it
    ends in time block 0 with u_len ≥ Wp) and a steep row whose band start
    jumps by more than Wp, so that some diagonals hold no in-band cell."""
    Tp = -(-max(24, Wp + 24) // Tb) * Tb
    U1p = 2 * Wp + 16
    return Tp, U1p, [(Tp, U1p - 1), (Tp - 11, U1p // 2), (1, 0), (Tp - 5, 0), (5, Wp + 3),
                      (2 * Tb + 4, U1p - 1)]


def _problem(seed, Wp, Tb=8, shifts=True, u1_small=False):
    """Log-prob tables (B, Tp, Wp) from a numpy seed, band starts from
    ``band_offsets`` and, with ``shifts``, one more full row whose band starts
    step by 8 and by 16.  ``u1_small``: U+1 below Wp, so o ≡ 0."""
    Tp, U1p, rows = _rows(Wp, Tb)
    if u1_small:
        U1p = Wp
        rows = [(Tp, Wp - 5), (Tp - 7, 3), (1, 0), (Tp - 3, 0)]
    t_lens = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    u_lens = torch.tensor([r[1] for r in rows], dtype=torch.int32)
    o = rb.band_offsets(t_lens, u_lens, Tp, U1p, Wp, Tb)
    if shifts:
        nblk = Tp // Tb
        steps = np.zeros(nblk, np.int64)
        steps[1::3] = 8
        steps[2::5] = 16
        own = np.minimum(np.cumsum(steps), U1p - Wp) // 8 * 8
        own[0] = 0
        o = torch.cat([o, torch.from_numpy(own).to(torch.int32)[None]])
        t_lens = torch.cat([t_lens, torch.tensor([Tp - 2], dtype=torch.int32)])
        u_lens = torch.cat([u_lens, torch.tensor([int(own[-1]) + Wp // 2], dtype=torch.int32)])
    rng = np.random.default_rng(seed)
    B = t_lens.shape[0]
    blank = torch.from_numpy(rng.standard_normal((B, Tp, Wp)) - 1.5)
    emit = torch.from_numpy(rng.standard_normal((B, Tp, Wp)) - 1.5)
    return blank, emit, o, t_lens, u_lens


def _assert_lattice_equal(got, want):
    live = want > -1e29
    assert torch.equal(live, got > -1e29)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-9, atol=0)


CASES = [(8, 8, True, False), (48, 8, True, False), (80, 16, True, False),
         (48, 8, False, True)]


@pytest.mark.parametrize("Wp,Tb,shifts,u1_small", CASES,
                         ids=["Wp8", "Wp48", "Wp80-Tb16", "Wp48-U1-below-Wp"])
def test_walk_matches_plain_float64(Wp, Tb, shifts, u1_small):
    blank, emit, o, t_lens, u_lens = _problem(Wp + Tb, Wp, Tb, shifts, u1_small)
    if shifts:                       # the extra row's band really steps by 8 and 16
        steps = set(np.diff(o[-1].numpy()).tolist())
        assert {8, 16} <= steps
    if not u1_small:                 # row 5's band jumps past its own width
        assert np.diff(o[5].numpy()).max() > Wp
    _assert_lattice_equal(walk_alpha(blank, emit, o, t_lens, Tb),
                          rb.rnnt_band_alpha_ref(blank, emit, o, t_lens, Tb))
    beta = walk_beta(blank, emit, o, t_lens, u_lens, Tb)
    _assert_lattice_equal(beta, rb.rnnt_band_beta_ref(blank, emit, o, t_lens, u_lens, Tb))
    if not u1_small:                 # row 4 misses its corner: β is dead everywhere
        assert (beta[4] <= -1e29).all()


@pytest.mark.parametrize("Wp", [8, 48])
def test_walk_nll_matches_jax(Wp):
    blank, emit, o, t_lens, u_lens = _problem(7 + Wp, Wp)
    bl, em = blank.float(), emit.float()
    alpha = walk_alpha(bl, em, o, t_lens, 8)
    nll = rb.band_nll_from_alpha(alpha, bl, o, t_lens, u_lens, 8)
    want = np.asarray(jrb.rnnt_nll_banded(jnp.asarray(bl.numpy()), jnp.asarray(em.numpy()),
                                          jnp.asarray(o.numpy()), jnp.asarray(t_lens.numpy()),
                                          jnp.asarray(u_lens.numpy()), 8))
    np.testing.assert_allclose(nll.numpy(), want, rtol=1e-5)
    assert nll[4].item() == want[4] == np.float32(1e30)
