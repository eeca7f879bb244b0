"""K7a/K7b's order of work on the card: the exact RNN-T lattice
(``rnnt_alpha``, ``rnnt_beta`` for U+1 ≤ 1024) walked as the anti-diagonal
wavefront of ``ops/csrc/rnnt_wavefront.cuh`` with no band, written out as
plain torch here and held against the plain versions and against JAX.

With no band, o ≡ 0 and the window is the whole row (Wp = U+1, w = u), so
diagonal d's cells are the frames t_lo(d) = max(0, d − U) ≤ t ≤ t_hi(d) =
min(d, t_last) in closed form: the producer needs no ballots and no moved
offsets, and a cell's column is w = d − t.  Emit has its own rows of U
floats, and column U has no emit (−1e30 in its record).  t_len is clamped
to T; a row with t_len ≤ 0 runs no frame and holds α's start state (0 at u
= 0) or β's base (0 at u = u_len) on every row.

Where it fits in shared memory (U+1 up to ~140, C ≤ 5) the producer reads
the tables from a ring of R frame rows of each, R ≥ U+1 + 3·8 and ≥ 32·C
(any count: a diagonal's cells wrap once at most), the rows at an even
stride so that the lanes of a diagonal do not meet on one shared-memory
bank; a chunk's frames are copied row by row, a float a lane, two chunks
ahead.  Above that it loads each entry from the tables itself.
``walk_exact`` follows the producer's copies and records and the consumer's
messages (``consume`` of tests/test_torch_band_wavefront.py) lane by lane,
asserting the spans against their definitions, each cell's ring row (moved
on from lo's) against t mod R, that every ring entry read is its cell's
table entry, copied by a group the producer had waited for, and that the
lanes' reads meet on no bank more than twice gcd(C, 32) times.  It is on no
path of the port.  Held:

  * against ``rnnt_alpha_ref`` and ``rnnt_beta_ref`` in float64: rtol 1e-9,
    the same dead states (≤ −1e29), at U+1 = 1, 13, 49 and 129 (one, one,
    two and five cells a lane, all through the ring) and 161 (six: the
    producer's own loads), with rows of t_len = T, 1, 0, short and past T
    and u_len = U, 0, in between and past U;
  * the NLL read from the walk's α against the JAX package's ``_alpha_all``
    run in Pallas interpret mode (forward only, no JAX gradient) at
    tests/test_torch_rnnt_lattice.py's NLL tolerance (rtol 1e-5).

The walk keeps its values less a whole-number shift, moved every 8
diagonals once they pass −512 (``rnnt_lattice._diagonal_walk``); in
float32 at T = 1598 the
plain versions' diagonal walk holds the NLL and the occupancy gradient
nearer float64 than the frame order.  And the plain versions' two orders
(``order``) against each other in float64, and the order each shape takes
by default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops import rnnt_dp_pallas as jdp
from statecatcher_tpu_torch.ops.rnnt_lattice import (
    nll_from_alpha,
    occupancy_grads,
    rnnt_alpha_ref,
    rnnt_beta_ref,
    wavefront_route,
)
from test_torch_band_wavefront import _span, consume
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

NEG = -1e30
LANES = 32
RING_AHEAD = 2                            # rnnt_wavefront.cuh: kRingAhead
RENORM = 8                                # rnnt_wavefront.cuh: kRenorm
SHIFT_FROM = 512.0                        # rnnt_wavefront.cuh: kShiftFrom
INSTANTIATED = (4, 6, 8, 12, 16, 24, 32)  # C of the producer's own loads (launch_walk)


def plan(Wp):
    """(C, ring): the cells a lane and whether the exact ring is taken, as
    launch_walk picks them: the ring with C = ceil(Wp / 32) while C ≤ 5 and
    it fits in 227 KB of shared memory, else the least instantiated C."""
    c = -(-Wp // LANES)
    chunk = 8 if c <= 16 else 4
    R = max(Wp + (RING_AHEAD + 1) * chunk, 32 * c)
    ring_bytes = -(-R * (Wp + Wp % 2 + (Wp - 1) + (Wp - 1) % 2) * 4 // 16) * 16
    if c <= 5 and ring_bytes + 2 * chunk * c * 32 * 16 + 2 * chunk * 4 <= 227 * 1024:
        return c, True
    return next(x for x in INSTANTIATED if x >= c), False


class Ring:
    """One table's rows in the exact ring (``ExactRing``) as the producer
    fills them: each slot's value, the table index it holds and the copy
    group that wrote it."""

    def __init__(self, table, R, stride):
        self.src, self.width = table.reshape(-1), table.shape[1]
        self.R, self.stride = R, stride
        assert stride % 2 == 0 and stride >= self.width
        self.val = torch.full((R * stride,), float("nan"), dtype=table.dtype)
        self.index = torch.full((R * stride,), -1, dtype=torch.int64)
        self.group = torch.full((R * stride,), -1, dtype=torch.int64)

    def copy(self, first, n, group):
        """Frames first .. first + n − 1, row by row, one float a lane."""
        row = first % self.R
        for f in range(n):
            w = torch.arange(self.width)
            r, x = row * self.stride + w, (first + f) * self.width + w
            self.val[r], self.index[r], self.group[r] = self.src[x], x, group
            row = row + 1 if row + 1 < self.R else 0

    def read(self, r, w, want, waited, mask):
        """The entries at rows r, columns w, asserting (where ``mask``) that
        each holds its table index ``want`` from a group already waited for,
        and that the lanes meet on no shared-memory bank more than twice
        gcd(C, 32) times (twice: once a row wraps)."""
        slot = r * self.stride + w
        assert torch.equal(self.index[slot][mask], want[mask])
        assert (self.group[slot][mask] <= waited).all()
        c = slot.shape[1]
        for i in range(c):
            lanes = mask[:, i]
            if lanes.any():
                banks = torch.bincount(slot[lanes, i] % 32, minlength=32)
                assert banks.max() <= 2 * np.gcd(c, 32), banks.tolist()
        return self.val[slot]


def walk_exact(blank, emit, t_lens, u_lens, rev):
    """α (``rev`` False) or β (B, T, U+1) by the kernels' order of work."""
    B, T, Wp = blank.shape
    We = Wp - 1
    c, ring = plan(Wp)
    chunk = 8 if c <= 16 else 4
    k = torch.arange(LANES * c).reshape(LANES, c)
    out = torch.empty_like(blank)
    lane_w = torch.arange(Wp)
    sgn = -1 if rev else 1
    for b in range(B):
        tl, ul = int(t_lens[b]), int(u_lens[b]) if rev else 0
        if tl <= 0:                                       # no frame runs
            out[b] = torch.where(lane_w == ul, 0.0, NEG).to(blank.dtype)
            continue
        last = min(tl, T) - 1
        w_virt = ul if rev and 0 <= ul < Wp else -1
        d_first = last + Wp - 1 if rev else 0
        n_diag = last + Wp
        frames = list(range(last + 1))                    # f(t) = t
        if ring:
            R = max(Wp + (RING_AHEAD + 1) * chunk, 32 * c)
            rb = Ring(blank[b], R, Wp + Wp % 2)
            re = Ring(emit[b], R, We + We % 2) if We else None
            state = {"loaded": last + 1 if rev else -1, "group": 0}

            def ring_copy(limit):
                loaded = state["loaded"]
                end = max(limit - (Wp - 1), 0) if rev else min(limit, last)
                n = max(sgn * (end - loaded), 0)
                first = loaded - n if rev else loaded + 1
                rb.copy(first, n, state["group"])
                if re:
                    re.copy(first, n, state["group"])
                state["loaded"] = loaded + sgn * n
                state["group"] += 1                       # a group is committed either way

            for cc in range(RING_AHEAD):
                ring_copy(d_first + sgn * ((cc + 1) * chunk - 1))
            lo_row = (last + 1 if rev else 0) % R          # lo's ring row, moved on
        m0 = torch.full((LANES, c), NEG, dtype=blank.dtype)
        m1 = m0.clone()
        shift = 0.0
        lo_prev = last + 1 if rev else 0
        for cc in range(-(-n_diag // chunk)):
            if cc and cc * chunk % RENORM == 0:           # the messages drop by the shift's step
                top = float((m0 if rev else torch.maximum(m0, m1)).max())
                delta = float(np.floor(top)) if -1e29 < top < -SHIFT_FROM else 0.0
                m0, m1, shift = m0 - delta, m1 - delta, shift + delta
            if ring:                                      # wait for all but the last group
                waited = state["group"] - RING_AHEAD
                ring_copy(d_first + sgn * ((cc + RING_AHEAD + 1) * chunk - 1))
            for j in range(chunk):
                n = cc * chunk + j
                d = d_first + sgn * n
                lo, hi = max(d - (Wp - 1), 0), min(d, last) if n < n_diag else -1
                if n < n_diag:
                    assert (lo, hi) == _span(frames, d, Wp, last)
                dl = sgn * (lo - lo_prev)
                lo_prev = lo
                t = lo + k
                ok = t <= hi
                tc = torch.where(ok, t, 0)
                wc = torch.where(ok, d - t, 0)
                assert ((wc >= 0) & (wc < Wp))[ok].all()
                has_em = ok & (wc < We)                   # column U has no emit
                em = torch.full_like(m0, NEG)
                if ring:
                    lo_row = (lo_row - dl) % R if rev else (lo_row + dl) % R
                    row = lo_row + k
                    row = torch.where(row >= R, row - R, row)     # one wrap at most
                    assert torch.equal(row[ok], t[ok] % R)
                    bl = rb.read(row, wc, tc * Wp + wc, waited, ok)
                    if re:
                        em = torch.where(has_em, re.read(row, wc, tc * We + wc, waited, has_em),
                                         NEG)
                else:
                    bl = blank[b, tc, wc]
                    if We:
                        em = torch.where(has_em, emit[b, tc, wc.clamp(max=We - 1)], NEG)
                bl = torch.where(ok, bl, NEG)
                start = (t == last) & (wc == w_virt) if rev else (t == 0) & (wc == 0)
                floor_up = torch.where(ok & start, 0.0, NEG).to(blank.dtype)
                x, m0, m1 = consume(m0, m1, dl, bl, em, floor_up, rev)
                out[b, tc[ok], wc[ok]] = x[ok] + shift
        out[b, last + 1:] = (torch.where(lane_w == ul, 0.0, NEG).to(blank.dtype) if rev
                             else out[b, last])
    return out


def _problem(seed, T, U):
    """Log-prob tables (float64) from a numpy seed; rows: t_len = T, 1, 0,
    short, past T, T with u_len = U, 0, U // 2, 0, past U, U // 3."""
    rng = np.random.default_rng(seed)
    t_lens = torch.tensor([T, 1, 0, T - 7, T + 5, T], dtype=torch.int32)
    u_lens = torch.tensor([U, 0, U // 2, 0, U + 2, U // 3], dtype=torch.int32)
    B = t_lens.shape[0]
    blank = torch.from_numpy(rng.standard_normal((B, T, U + 1)) - 1.5)
    emit = torch.from_numpy(rng.standard_normal((B, T, U)) - 1.5)
    return blank, emit, t_lens, u_lens


def _assert_lattice_equal(got, want):
    live = want > -1e29
    assert torch.equal(live, got > -1e29)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-9, atol=0)


# (U, T): one cell a lane (U+1 = 1, 13), two (49), five (129; all through
# the ring) and six (161: the producer's own loads)
CASES = [(0, 21), (12, 30), (48, 40), (128, 20), (160, 12)]


@pytest.mark.parametrize("U,T", CASES, ids=["U1=1", "U1=13", "U1=49", "U1=129", "U1=161"])
def test_walk_matches_plain_float64(U, T):
    blank, emit, t_lens, u_lens = _problem(U + T, T, U)
    alpha = walk_exact(blank, emit, t_lens, None, False)
    _assert_lattice_equal(alpha, rnnt_alpha_ref(blank, emit, t_lens))
    beta = walk_exact(blank, emit, t_lens, u_lens, True)
    _assert_lattice_equal(beta, rnnt_beta_ref(blank, emit, t_lens, u_lens))
    # the t_len = 0 row: α's start state and β's base on every row
    assert (alpha[2, :, 0] == 0).all() and (alpha[2, :, 1:] <= -1e29).all()
    if U:
        assert (beta[2, :, U // 2] == 0).all() and (beta[4] <= -1e29).all()


@pytest.mark.parametrize("U,T", [(12, 30), (48, 40)])
def test_walk_nll_matches_jax(U, T):
    blank, emit, t_lens, u_lens = _problem(7 + U, T, U)
    bl, em = blank.float(), emit.float()
    # the NLL reads (t_len − 1, u_len): both inside the lattice
    tl, ul = t_lens.clamp(max=T), u_lens.clamp(max=U)
    nll = nll_from_alpha(walk_exact(bl, em, tl, None, False), bl, tl, ul)
    with pltpu.force_tpu_interpret_mode():
        j_alpha = jdp._alpha_all(jnp.asarray(bl.numpy()), jnp.asarray(em.numpy()),
                                 jnp.asarray(tl.numpy()))
        want = np.asarray(jdp._nll_from_alpha(j_alpha, jnp.asarray(bl.numpy()),
                                              jnp.asarray(tl.numpy()),
                                              jnp.asarray(ul.numpy())))
    np.testing.assert_allclose(nll.numpy(), want, rtol=1e-5)


# (U, T): the wavefront's widths and one of the scan route's (U+1 > 1024)
ORDER_CASES = [(0, 9), (12, 30), (48, 40), (1030, 4)]


@pytest.mark.parametrize("U,T", ORDER_CASES, ids=["U1=1", "U1=13", "U1=49", "U1=1031"])
def test_plain_orders_agree_in_float64(U, T):
    """The plain versions' two orders (the wavefront's diagonals, the scan's
    frames) are one function: in float64 they agree to rtol 1e-9."""
    blank, emit, t_lens, u_lens = _problem(40 + U, T, U)
    for fn, args in ((rnnt_alpha_ref, (blank, emit, t_lens)),
                     (rnnt_beta_ref, (blank, emit, t_lens, u_lens))):
        _assert_lattice_equal(fn(*args, order="diagonals"), fn(*args, order="frames"))


@pytest.mark.parametrize("U,T,order", [(12, 30, "diagonals"), (1030, 4, "frames")],
                         ids=["wavefront", "scan"])
def test_plain_order_follows_the_route(U, T, order):
    """With no order named, the plain versions take the order of the card's
    route for the shape (``wavefront_route``), bit for bit in float32."""
    blank, emit, t_lens, u_lens = (x.float() if x.is_floating_point() else x
                                   for x in _problem(50 + U, T, U))
    assert wavefront_route(T, U + 1) == (order == "diagonals")
    assert torch.equal(rnnt_alpha_ref(blank, emit, t_lens),
                       rnnt_alpha_ref(blank, emit, t_lens, order=order))
    assert torch.equal(rnnt_beta_ref(blank, emit, t_lens, u_lens),
                       rnnt_beta_ref(blank, emit, t_lens, u_lens, order=order))


def test_plain_order_must_be_known():
    blank, emit, t_lens, _ = _problem(1, 5, 3)
    with pytest.raises(ValueError, match="order"):
        rnnt_alpha_ref(blank, emit, t_lens, order="columns")


def test_plain_diagonals_hold_float64_at_long_t():
    """At T = 1598, U = 48 with log-probs near a random model's (−log 1024),
    the f32 diagonal walk, shifted every 8 diagonals past −512, keeps the NLL
    within 2e-3 of float64's and the occupancy gradient within 2e-3 of its
    norm."""
    rng = np.random.default_rng(5)
    B, T, U = 2, 1598, 48
    blank = torch.from_numpy(-6.93 + 0.05 * rng.standard_normal((B, T, U + 1)))
    emit = torch.from_numpy(-6.93 + 0.05 * rng.standard_normal((B, T, U)))
    t_lens, u_lens = torch.tensor([T, T - 11], dtype=torch.int32), torch.tensor([U, U - 5])

    def solve(bl, em):
        alpha = rnnt_alpha_ref(bl, em, t_lens, order="diagonals")
        beta = rnnt_beta_ref(bl, em, t_lens, u_lens, order="diagonals")
        nll = nll_from_alpha(alpha, bl, t_lens, u_lens)
        g = occupancy_grads(bl, em, t_lens, u_lens, alpha, beta, nll, torch.ones_like(nll))
        return nll.double(), torch.cat([x.flatten() for x in g]).double()

    nll64, g64 = solve(blank, emit)
    nll32, g32 = solve(blank.float(), emit.float())
    assert (nll32 - nll64).abs().max() < 2e-3
    assert (g32 - g64).norm() / g64.norm() < 2e-3
