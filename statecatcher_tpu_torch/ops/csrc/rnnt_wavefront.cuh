// The RNN-T alpha/beta lattice as an anti-diagonal wavefront, for Hopper
// (sm_90a): one block of two warps walks one batch row.  Two lattices share
// the walk: the banded one (the port's own kernels over K8's tables) and the
// exact one (K7a/K7b, rnnt_lattice.cu), which is the banded walk with no
// band.
//
// Banded tables in window coordinates: blank, emit (B, Tp, Wp) f32, where
// column w of frame t is label position u = o(t) + w, o(t) = o[b, t / Tb]
// the band start of frame t's time block (non-decreasing); the outputs alpha
// or beta (B, Tp, Wp) likewise.  The function (ops/rnnt_band.py holds the
// plain versions, rnnt_band_alpha_ref and rnnt_band_beta_ref):
//   alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
//                           alpha(t, u-1) + emit(t, u-1)),
//   an edge that leaves the band counting as -1e30, frame 0 starting from 0
//   at w = 0; frames t >= max(t_len, 1) repeat the last one.
//   beta(t, u) = logaddexp(blank(t, u) + beta(t+1, u), emit(t, u) + beta(t, u+1)),
//   the last frame t_last = max(t_len, 1) - 1 reading a virtual base in
//   place of beta(t_last+1, .): 0 at the corner's column w* = u_len -
//   o(t_last) moved by o(t_last+1) - o(t_last), -1e30 elsewhere and
//   everywhere when w* is outside the window; frames t > t_last hold the
//   base (0 at w*).
//
// The exact lattice (kBand false): o = 0 and Wp = U+1, so w = u; blank and
// the output are (B, T, U+1), emit is (B, T, U) (rows of U floats; column U
// has no emit and reads -1e30); t_len is clamped to T, and a row with
// t_len <= 0 runs no frame: every row of it holds alpha's start state (0 at
// u = 0) or beta's base (0 at u = u_len).  A u_len outside [0, U] gives a
// base of -1e30 everywhere.
//
// Bound on the card: bytes, about 3 * B * Tp * Wp * 4 (the two tables read
// once, the output written once), 0.009 ms at B=32, Tp=1600, Wp=48.  The
// time is the chain's: a row is one dependent walk.
//
// Design.  Every cell of the anti-diagonal d = t + u depends only on
// diagonal d - 1 (alpha; d + 1 for beta).  With f(t) = t + o(t), which
// strictly increases, diagonal d's in-band cells are the frames t_lo(d) <=
// t <= t_hi(d) (t_hi capped at t_last), at window column w = d - f(t); at
// most Wp of them, and both ends move by 0 or 1 a diagonal, the same for the
// whole warp.  Lane j holds cells k = j*C .. j*C + C - 1 (k = t - t_lo(d);
// C >= Wp / 32, a template parameter).
//   alpha: a finished cell sends up = alpha + blank(t, w) to (t+1, u) and
//     right = alpha + emit(t, w) to (t, u+1).  A cell of diagonal d reads up
//     from index k + D - 1 and right from index k + D of diagonal d - 1, D =
//     t_lo(d) - t_lo(d-1): its own registers, or for one end cell the
//     neighbour lane's (one shuffle a diagonal).  A message from outside
//     [t_lo, t_hi] is -1e30, which also cuts the edges that leave the band.
//   beta: a cell reads beta(t+1, u) from index k + 1 - D' and beta(t, u+1)
//     from index k - D' of diagonal d + 1, D' = t_lo(d+1) - t_lo(d), and
//     adds its own blank and emit.
// So the chain of a diagonal is one shuffle, a few selects and one
// logaddexp: no scan, no barrier.  One warp walking alone has no other warp
// to hide its latencies, so whatever else it did a diagonal would sit on the
// chain (on an H100 it took three times as long a diagonal as the split
// below, PERF.md); the block has two warps:
//   the producer (warp 1) finds a chunk of kChunk diagonals' spans by
//     ballots (lane k tests the k-th frame that may leave or enter), moves
//     each cell's offset t * Wp + w on from the previous diagonal without a
//     lookup (the same frame one column on, the neighbour cell's where t_lo
//     moved, fresh for the frame that enters), and writes one 16-byte
//     record a cell (blank, emit, a floor on the up input, the output
//     offset) into a double buffer in shared memory, laid out so that lane
//     j reads its own cells' records;
//   the consumer (warp 0) walks the chain: per diagonal one shuffle, the
//     selects, the logaddexps, the messages and a predicated store, its
//     records read from shared memory (one 16-byte load a cell).
// They meet at named barriers once a chunk (full and empty, two of each).
// The producer reads the tables from a ring of frame rows in shared memory
// (Wp <= kRingMaxWp), R >= Wp + 3 * kChunk frames, since a diagonal spans up
// to Wp frames and the copies run two chunks ahead: one ring for blank, one
// for emit, each cell's entries at row t mod R, column w.  The frames that
// enter in a chunk are contiguous in the tables and in the rings, so a
// chunk's copies are one flat run of 16-byte cp.async copies a table.
// For larger Wp, where Wp frames do not fit, the producer loads each cell's
// entries from device memory itself, a chunk ahead of the consumer.  No
// global load is on the chain: the consumer loads nothing from device memory.
// A cell outside [t_lo, t_hi] gets blank = emit = -1e30 in its record, so
// its messages are -1e30 or below without a select; the start cell (alpha)
// and the virtual base (beta) come in as a floor on the cell's up input.
// Stores are fire-and-forget; alpha's tail rows read its last row back after
// the walk.  No atomics; each cell is computed once, in a fixed order, so two
// calls give the same bits.
//
// With no band the producer needs neither ballots nor moved offsets: t_lo(d)
// = max(0, d - U) and t_hi(d) = min(d, t_last) in closed form, and a cell's
// column is w = d - t.  Its ring (ExactRing) holds R rows of each table, R
// any count >= Wp + 3 * kChunk and >= 32 * C (so that one diagonal's cells
// wrap once at most), which lets it take U+1 up to ~140 in shared memory
// (the banded ring's power of two stops at 104); each table's rows at an
// even stride: the lanes of a diagonal read cells C frames and -C columns
// apart, C * (stride - 1) floats, and at U = 48 an unpadded blank row (49
// floats) put all 32 lanes on one bank.  Rows of U+1 or U floats are rarely
// 16-byte aligned in the tables, so a chunk's frames, one run in each table,
// are copied in 4-byte copies, a float a lane.  The consumer is the same code
// for both lattices.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lucy_tile.cuh"

namespace rnnt_wavefront {

constexpr float kNeg = -1e30f;
constexpr int kRingAhead = 2;     // frame ring: chunks the copies run ahead
constexpr int kRingMaxWp = 104;   // frame ring up to here: 128 frames * 2 * 104 floats
constexpr int kMaxWp = 1024;
// The exact walk's shift: every kRenorm diagonals (a multiple of both chunk
// sizes) its messages drop by the floor of their largest live value, if
// that is below -kShiftFrom
constexpr int kRenorm = 8;
constexpr float kShiftFrom = 512.0f;
constexpr int kFull = 1, kEmpty = 3;  // named barriers: full 1, 2; empty 3, 4

// Diagonals a chunk: fewer for many cells a lane, to keep the records small
template <int C>
__host__ __device__ constexpr int chunk_of() {
  return C <= 16 ? 8 : 4;
}

// torch.logaddexp for finite arguments, in one of two forms.  kFast: by the
// fast intrinsics, ex2.approx and lg2.approx (an absolute error of ~1e-7 in
// the log term, below half an ulp of any |m| >= 2); else by the accurate
// expf and log1pf, torch's own operations, which put ~200 more cycles and a
// branch for special values on every diagonal's chain.
template <bool kFast>
__device__ __forceinline__ float lae(float x, float y) {
  const float m = fmaxf(x, y);
  if constexpr (kFast) {
    return m + __logf(1.0f + __expf(-fabsf(x - y)));
  } else {
    return m + log1pf(expf(-fabsf(x - y)));
  }
}

// A store that only `ok` lanes make, with no branch around it
__device__ __forceinline__ void store_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(ok)));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One cell of one diagonal, as the producer hands it to the consumer: its
// blank and emit (-1e30 outside the span), the floor of its up input (0 at
// alpha's start cell and beta's virtual base, else -1e30) and its offset in
// the output row (-1 outside the span).
struct __align__(16) Rec {
  float bl, em, floor_up;
  int off;
};

// Frames of the ring: the least power of two >= Wp + (kRingAhead + 1) *
// kChunk, the most frames that the diagonals of the chunk being read and of
// the chunks being copied span.
__host__ __device__ inline int ring_frames(int Wp, int chunk) {
  int r = 1;
  while (r < Wp + (kRingAhead + 1) * chunk) r <<= 1;
  return r;
}

// t / Tb as __umulhi(t, magic), magic = floor((2^32 - 1) / Tb) + 1: exact
// while t * Tb < 2^32 (the caller checks Tp * Tb).
inline unsigned div_magic(int Tb) { return 0xffffffffu / static_cast<unsigned>(Tb) + 1u; }

// f(t) = t + o(t), the diagonal of frame t's window column 0, from the band
// starts in shared memory
struct Frames {
  const int* os;
  unsigned magic;
  __device__ __forceinline__ int f(int t) const {
    return t + os[__umulhi(static_cast<unsigned>(t), magic)];
  }
};

// The exact lattice's ring: rows (frames mod R) of blank at stride sb, then
// rows of emit at stride se, both even; its bytes rounded up to 16 (the
// records follow)
struct ExactRing {
  int R, sb, se;
  __host__ __device__ ExactRing(int Wp, int C) {
    const int chunk = C <= 16 ? 8 : 4;  // chunk_of<C>()
    R = Wp + (kRingAhead + 1) * chunk > 32 * C ? Wp + (kRingAhead + 1) * chunk : 32 * C;
    sb = (Wp + 1) & ~1;
    se = Wp & ~1;                       // U = Wp - 1 rounded up to even
  }
  __host__ __device__ size_t bytes() const {
    return (static_cast<size_t>(R) * (sb + se) * 4 + 15) & ~static_cast<size_t>(15);
  }
};

// The exact ring's copies: n rows of `width` floats, contiguous in the table
// from src on, into ring rows row0, row0 + 1, ... (mod R) at `stride`, in
// 4-byte copies, lane l taking floats l, l + 32, ... of the run: its first
// float's row f0 and column c0, and a step of 32 floats as q rows and r
// columns, found once a kernel
struct RowSweep {
  int width, q, r, f0, c0;
  __device__ RowSweep(int w, int lane)
      : width(w), q(w ? 32 / w : 0), r(w ? 32 % w : 0), f0(w ? lane / w : 0),
        c0(w ? lane % w : 0) {}
  __device__ __forceinline__ void copy(float* ring, int stride, int R, int row0,
                                       const float* src, int n, int lane) const {
    int f = f0, col = c0;
    for (int e = lane; e < n * width; e += 32) {
      const int row = row0 + f < R ? row0 + f : row0 + f - R;
      lucy_tile::cp_async<4>(ring + row * stride + col, src + e, true);
      f += q;
      col += r;
      if (col >= width) {
        col -= width;
        ++f;
      }
    }
  }
};

// Shared memory of one row (one block), in bytes: the frame ring, the
// records, each chunk's lo steps, the band starts.
inline size_t smem_bytes(int C, bool ring, bool band, int Wp, int nblk) {
  const int chunk = C <= 16 ? 8 : 4;  // chunk_of<C>()
  const size_t frames = !ring ? 0
                        : band ? static_cast<size_t>(ring_frames(Wp, chunk)) * 2 * Wp * 4
                               : ExactRing(Wp, C).bytes();
  return frames + static_cast<size_t>(2) * chunk * C * 32 * sizeof(Rec) +
         (2 * chunk + static_cast<size_t>(band ? nblk : 0)) * sizeof(int);
}

// The walk of one row.  kBand: the banded lattice (o, Tb and magic give the
// band starts) with the fast lae; else the exact one, Tp = T and Wp = U+1 (o
// unused), with the accurate lae.
template <bool kRev, int C, bool kRing, bool kBand>
__device__ __forceinline__ void walk(const float* __restrict__ blank,
                                     const float* __restrict__ emit, const int* __restrict__ o,
                                     const int* __restrict__ t_lens,
                                     const int* __restrict__ u_lens, float* __restrict__ out,
                                     int Tp, int Wp, int Tb, unsigned magic) {
  constexpr int kChunk = chunk_of<C>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const int nblk = Tp / Tb;
  const int We = kBand ? Wp : Wp - 1;  // floats of an emit row
  const ExactRing xr(Wp, C);
  const int R = !kRing ? 0 : kBand ? ring_frames(Wp, kChunk) : xr.R;
  float* ring = reinterpret_cast<float*>(smem);
  float* ring_em = ring + static_cast<size_t>(R) * xr.sb;  // the exact ring's emit rows
  Rec* recs = reinterpret_cast<Rec*>(
      ring + (!kRing ? 0 : kBand ? static_cast<size_t>(R) * 2 * Wp : xr.bytes() / 4));
  int* dls = reinterpret_cast<int*>(recs + 2 * kChunk * C * 32);
  int* os = dls + 2 * kChunk;
  if constexpr (kBand) {
    for (int i = threadIdx.x; i < nblk; i += 64) os[i] = o[static_cast<size_t>(b) * nblk + i];
    __syncthreads();
  }
  const Frames fr{os, magic};
  const auto f = [&](int t) {
    if constexpr (kBand) {
      return fr.f(t);
    } else {
      return t;
    }
  };

  int tl = t_lens[b];
  if constexpr (!kBand) {
    // no frame runs: every row holds alpha's start state or beta's base
    if (tl <= 0) {
      const int ws = kRev ? u_lens[b] : 0;
      float* o_row = out + static_cast<size_t>(b) * Tp * Wp;
      for (int w = threadIdx.x; w < Wp; w += 64) {
        const float v = w == ws ? 0.0f : kNeg;
        for (int t = 0; t < Tp; ++t) o_row[static_cast<size_t>(t) * Wp + w] = v;
      }
      return;
    }
  }
  tl = tl < 1 ? 1 : (tl > Tp ? Tp : tl);
  const int last = tl - 1;
  const size_t row = static_cast<size_t>(b) * Tp * Wp;
  const float* bl_g = blank + row;
  const float* em_g = emit + static_cast<size_t>(b) * Tp * We;
  float* out_g = out + row;
  const int sgn = kRev ? -1 : 1;
  const int d_first = kRev ? f(last) + Wp - 1 : f(0);
  const int n_diag = kRev ? d_first - f(0) + 1 : f(last) + Wp - d_first;
  const int n_chunks = (n_diag + kChunk - 1) / kChunk;

  if (producer) {
    // beta's virtual base
    int w_virt = -1;
    if constexpr (kRev) {
      if constexpr (kBand) {
        const int o_last = os[last / Tb];
        const int ws = u_lens[b] - o_last;
        if (ws >= 0 && ws < Wp)
          w_virt = ws + (last + 1 < Tp ? os[(last + 1) / Tb] : o_last) - o_last;
      } else {
        const int ws = u_lens[b];
        if (ws >= 0 && ws < Wp) w_virt = ws;
      }
    }
    // The frame ring copies, at the start of chunk c, the frames that enter
    // the walk up to the end of chunk c + kRingAhead (alpha: f(t) <= limit;
    // beta: f(t) + Wp - 1 >= limit).  Banded: each lane tests one candidate,
    // a ballot counts them (f increases, so they are a prefix), the warp
    // copies them; exact: in closed form.
    int loaded = kRev ? last + 1 : -1;  // the frames copied so far end here
    const RowSweep sweep_bl(kRing && !kBand ? Wp : 0, lane);
    const RowSweep sweep_em(kRing && !kBand ? We : 0, lane);
    auto ring_copy = [&](int limit) {
      if constexpr (kBand) {
        const int t = loaded + sgn * (1 + lane);
        const int tc = t < 0 ? 0 : (t > last ? last : t);
        const bool in = t >= 0 && t <= last &&
                        (kRev ? fr.f(tc) + Wp - 1 >= limit : fr.f(tc) <= limit);
        const int n = __popc(__ballot_sync(0xffffffffu, in));
        // frames first .. first + n - 1: contiguous in the tables, and in the
        // ring but for one wrap
        const int first = kRev ? loaded - n : loaded + 1;
        const int rows = R * Wp, gbase = first * Wp, rbase = (first & (R - 1)) * Wp;
        for (int u = 4 * lane; u < n * Wp; u += 4 * 32) {  // 16-byte copies
          const int r = rbase + u < rows ? rbase + u : rbase + u - rows;
          lucy_tile::cp_async<16>(ring + r, bl_g + gbase + u, true);
          lucy_tile::cp_async<16>(ring + rows + r, em_g + gbase + u, true);
        }
        loaded += sgn * n;
      } else {
        const int end = kRev ? max(limit - (Wp - 1), 0) : min(limit, last);
        const int n = max(sgn * (end - loaded), 0);
        const int first = kRev ? loaded - n : loaded + 1;
        const int row0 = first % R;
        sweep_bl.copy(ring, xr.sb, R, row0, bl_g + static_cast<size_t>(first) * Wp, n, lane);
        sweep_em.copy(ring_em, xr.se, R, row0, em_g + static_cast<size_t>(first) * We, n, lane);
        loaded += sgn * n;
      }
      lucy_tile::cp_async_commit();
    };
    if constexpr (kRing) {
      for (int c = 0; c < kRingAhead; ++c) ring_copy(d_first + sgn * ((c + 1) * kChunk - 1));
    }
    // The span lo..hi of the diagonal before the chunk (no cells before the
    // walk's first diagonal).  A banded chunk's spans come from ballots: lane
    // k holds f of the k-th frame that may leave or enter, and each diagonal
    // counts the lanes whose frame has (f increases, so they are a prefix).
    int lo0 = kRev ? last + 1 : 0, hi0 = kRev ? last : -1, hprev = hi0;
    int lo0_row = kRing && !kBand ? lo0 % R : 0;  // the exact ring's row of lo0
    int g[C], a[C];  // each cell's table offset and ring address (see below)
#pragma unroll
    for (int i = 0; i < C; ++i) g[i] = a[i] = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c & 1;
      if constexpr (kRing) {
        lucy_tile::cp_async_wait<kRingAhead - 1>();  // this chunk's frames have landed
        __syncwarp();                                // ... those of the other lanes too
        ring_copy(d_first + sgn * ((c + kRingAhead + 1) * kChunk - 1));
      }
      int lo[kChunk], hi[kChunk], hraw[kChunk], dl[kChunk];
      if constexpr (kBand) {
        const int ta = kRev ? lo0 - 1 - lane : lo0 + lane;    // may leave (alpha) or enter
        const int tb = kRev ? hi0 - lane : hi0 + 1 + lane;    // may enter (alpha) or leave
        const int fa = fr.f(ta < 0 ? 0 : (ta > last ? last : ta));
        const int fb = fr.f(tb < 0 ? 0 : (tb > last ? last : tb));
        const bool a_ok = ta >= 0 && ta <= last, b_ok = tb >= 0 && tb <= last;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int n = c * kChunk + j;
          const int d = d_first + sgn * n;
          int h;
          if (!kRev) {
            lo[j] = lo0 + __popc(__ballot_sync(0xffffffffu, a_ok && fa + Wp - 1 < d));
            h = hi0 + __popc(__ballot_sync(0xffffffffu, b_ok && fb <= d));
          } else {
            lo[j] = lo0 - __popc(__ballot_sync(0xffffffffu, a_ok && fa + Wp - 1 >= d));
            h = hi0 - __popc(__ballot_sync(0xffffffffu, b_ok && fb > d));
          }
          hraw[j] = h;
          hi[j] = n < n_diag ? h : -1;  // past the walk's end: no cell
          dl[j] = sgn * (lo[j] - (j ? lo[j > 0 ? j - 1 : 0] : lo0));  // how far lo moved
          if (j == kChunk - 1) hi0 = h;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int n = c * kChunk + j;
          const int d = d_first + sgn * n;
          lo[j] = max(d - (Wp - 1), 0);
          hraw[j] = min(d, last);
          hi[j] = n < n_diag ? hraw[j] : -1;  // past the walk's end: no cell
          dl[j] = sgn * (lo[j] - (j ? lo[j > 0 ? j - 1 : 0] : lo0));  // how far lo moved
        }
      }
      [[maybe_unused]] const int lo_prev = lo0;      // lo before the chunk
      lo0 = lo[kChunk - 1];
      if (c >= 2) bar_sync(kEmpty + slot, 64);       // the consumer is done with the slot
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) dls[slot * kChunk + j] = dl[j];
      }
      Rec* rs = recs + static_cast<size_t>(slot) * kChunk * C * 32;
      // the records.  Banded: each cell's table offset g = t * Wp + w (and
      // its ring address a) follows from the previous diagonal's without a
      // lookup: the same frame one column on (alpha: +1; beta: -1), the
      // neighbour cell's where lo moved (one shuffle for the end cell), and
      // fresh for the frame that enters (alpha: at hi, w = 0; beta: at lo, w
      // = Wp - 1).  Cells outside the span carry garbage, read a harmless
      // address, and are masked.  Exact: w = d - t.
#pragma unroll(kRing || (!kBand && C <= 8) ? kChunk : 1)
      for (int j = 0; j < kChunk; ++j) {
        float bl[C], em[C];
        int t[C];
        bool ok[C];
        if constexpr (kBand) {
          const int h = j ? hraw[j > 0 ? j - 1 : 0] : hprev;
          const int g_nb = kRev ? __shfl_up_sync(0xffffffffu, g[C - 1], 1)
                                : __shfl_down_sync(0xffffffffu, g[0], 1);
          const int a_nb = kRev ? __shfl_up_sync(0xffffffffu, a[C - 1], 1)
                                : __shfl_down_sync(0xffffffffu, a[0], 1);
#pragma unroll
          for (int i = 0; i < C; ++i) {  // alpha reads cell i + 1 before it moves, beta i - 1
            const int ii = kRev ? C - 1 - i : i;
            t[ii] = lo[j] + lane * C + ii;
            ok[ii] = t[ii] <= hi[j];
            int gi = g[ii], ai = a[ii];
            if (dl[j]) {
              if (!kRev) {
                gi = ii + 1 < C ? g[ii + 1 < C ? ii + 1 : ii] : g_nb;
                ai = ii + 1 < C ? a[ii + 1 < C ? ii + 1 : ii] : a_nb;
              } else {
                gi = ii > 0 ? g[ii > 0 ? ii - 1 : 0] : g_nb;
                ai = ii > 0 ? a[ii > 0 ? ii - 1 : 0] : a_nb;
              }
            }
            const bool enters = kRev ? dl[j] && t[ii] == lo[j] : hraw[j] > h && t[ii] == hraw[j];
            const int w0 = kRev ? Wp - 1 : 0;
            gi = enters ? t[ii] * Wp + w0 : gi + sgn;
            ai = enters ? (t[ii] & (R - 1)) * Wp + w0 : ai + sgn;
            g[ii] = gi;
            a[ii] = ai;
            if constexpr (kRing) {
              const float* q = ring + (ok[ii] ? ai : 0);
              bl[ii] = q[0];
              em[ii] = q[R * Wp];
            } else {
              bl[ii] = __ldg(bl_g + (ok[ii] ? gi : 0));
              em[ii] = __ldg(em_g + (ok[ii] ? gi : 0));
            }
          }
        } else {
          const int d = d_first + sgn * (c * kChunk + j);
          if constexpr (kRing) {  // lo's ring row, moved on by how far lo moved (a step at most)
            lo0_row += lo[j] - (j ? lo[j > 0 ? j - 1 : 0] : lo_prev);
            lo0_row = lo0_row < 0 ? lo0_row + R : (lo0_row >= R ? lo0_row - R : lo0_row);
          }
#pragma unroll
          for (int i = 0; i < C; ++i) {
            t[i] = lo[j] + lane * C + i;
            ok[i] = t[i] <= hi[j];
            const int tc = ok[i] ? t[i] : 0, wc = ok[i] ? d - t[i] : 0;
            const bool has_em = ok[i] && wc < We;  // column U has no emit
            g[i] = tc * Wp + wc;
            em[i] = kNeg;
            if constexpr (kRing) {
              int row = lo0_row + lane * C + i;
              row = row >= R ? row - R : row;
              bl[i] = ring[row * xr.sb + wc];
              if (has_em) em[i] = ring_em[row * xr.se + wc];
            } else {
              bl[i] = __ldg(bl_g + g[i]);
              if (has_em) em[i] = __ldg(em_g + (tc * We + wc));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int w = g[i] - t[i] * Wp;
          const bool start = kRev ? t[i] == last && w == w_virt : t[i] == 0 && w == 0;
          rs[(j * C + i) * 32 + lane] = Rec{ok[i] ? bl[i] : kNeg, ok[i] ? em[i] : kNeg,
                                            ok[i] && start ? 0.0f : kNeg, ok[i] ? g[i] : -1};
        }
      }
      hprev = hraw[kChunk - 1];
      bar_arrive(kFull + slot, 64);                  // the slot is ready
    }
    lucy_tile::cp_async_wait<0>();
    return;
  }

  // The consumer.  alpha: m0 = up, m1 = right messages of the previous
  // diagonal; beta: m0 = the previous diagonal's beta (m1 unused).  The
  // exact walk keeps them less the row's shift (a whole number, exact in
  // f32), moved every kRenorm diagonals to the floor of the largest live
  // message once that is below -kShiftFrom, so that its chain rounds values
  // under ~600, not alpha and beta of ~1e4 (f32 spacing ~1e-3) at every
  // step; each value is stored as x + shift, one rounding.  Beta's base
  // (floor_up 0) enters while the shift is 0: no live value comes before it.
  // ops/rnnt_lattice.py's diagonal walk takes the same steps.
  float m0[C], m1[C];
  float shift = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) m0[i] = m1[i] = kNeg;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    bar_sync(kFull + slot, 64);                      // the producer has filled the slot
    if constexpr (!kBand) {
      if (c > 0 && (c * kChunk) % kRenorm == 0) {
        float top = kNeg;
#pragma unroll
        for (int i = 0; i < C; ++i) top = fmaxf(top, kRev ? m0[i] : fmaxf(m0[i], m1[i]));
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, k));
        const float delta = top > -1e29f && top < -kShiftFrom ? floorf(top) : 0.0f;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          m0[i] -= delta;
          m1[i] -= delta;
        }
        shift += delta;
      }
    }
    const Rec* rs = recs + static_cast<size_t>(slot) * kChunk * C * 32;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int dl = dls[slot * kChunk + j];
      Rec r[C];
#pragma unroll
      for (int i = 0; i < C; ++i) r[i] = rs[(j * C + i) * 32 + lane];
      // the one value that crosses lanes, and each cell's two inputs (all
      // read before any is overwritten)
      float v;
      int src;
      if (!kRev) {
        v = dl ? m1[0] : m0[C - 1];
        src = dl ? lane + 1 : lane - 1;
      } else {
        v = dl ? m0[C - 1] : m0[0];
        src = dl ? lane - 1 : lane + 1;
      }
      float g = __shfl_sync(0xffffffffu, v, src & 31);
      if (src < 0 || src > 31) g = kNeg;
      float in_up[C], in_rt[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (!kRev) {  // up from k + D - 1, right from k + D
          in_up[i] = dl ? m0[i] : (i > 0 ? m0[i > 0 ? i - 1 : 0] : g);
          in_rt[i] = dl ? (i + 1 < C ? m1[i + 1 < C ? i + 1 : i] : g) : m1[i];
        } else {      // (t+1, u) from k + 1 - D', (t, u+1) from k - D'
          in_up[i] = dl ? m0[i] : (i + 1 < C ? m0[i + 1 < C ? i + 1 : i] : g);
          in_rt[i] = dl ? (i > 0 ? m0[i > 0 ? i - 1 : 0] : g) : m0[i];
        }
      }
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float up = fmaxf(in_up[i], r[i].floor_up);
        float x;
        if (!kRev) {
          x = lae<kBand>(up, in_rt[i]);
          m0[i] = x + r[i].bl;
          m1[i] = x + r[i].em;
        } else {
          x = lae<kBand>(r[i].bl + up, r[i].em + in_rt[i]);
          m0[i] = x;
        }
        store_if(out_g + (r[i].off < 0 ? 0 : r[i].off), kBand ? x : x + shift, r[i].off >= 0);
      }
    }
    if (c + 2 < n_chunks) bar_arrive(kEmpty + slot, 64);  // the slot is free again
  }

  // frames past the last: alpha repeats its last row (read back from this
  // warp's own stores), beta holds the base
  int ws = -1;
  if constexpr (kRev) ws = kBand ? u_lens[b] - os[last / Tb] : u_lens[b];
  __syncwarp();
  for (int w = lane; w < Wp; w += 32) {
    const float v = kRev ? (w == ws ? 0.0f : kNeg) : out_g[static_cast<size_t>(last) * Wp + w];
    for (int t = tl; t < Tp; ++t) out_g[static_cast<size_t>(t) * Wp + w] = v;
  }
}

// The banded lattice's kernel and the exact one's, separate names for the
// profiler
template <bool kRev, int C, bool kRing>
__global__ void __launch_bounds__(64, 1)
    band_wavefront_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                          const int* __restrict__ o, const int* __restrict__ t_lens,
                          const int* __restrict__ u_lens, float* __restrict__ out, int Tp,
                          int Wp, int Tb, unsigned magic) {
  walk<kRev, C, kRing, true>(blank, emit, o, t_lens, u_lens, out, Tp, Wp, Tb, magic);
}

template <bool kRev, int C, bool kRing>
__global__ void __launch_bounds__(64, 1)
    exact_wavefront_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                           const int* __restrict__ o, const int* __restrict__ t_lens,
                           const int* __restrict__ u_lens, float* __restrict__ out, int Tp,
                           int Wp, int Tb, unsigned magic) {
  walk<kRev, C, kRing, false>(blank, emit, o, t_lens, u_lens, out, Tp, Wp, Tb, magic);
}

template <bool kRev, int C, bool kRing, bool kBand>
cudaError_t launch_one(const float* blank, const float* emit, const int* o, const int* t_lens,
                       const int* u_lens, float* out, int B, int Tp, int Wp, int Tb,
                       cudaStream_t stream) {
  void (*kernel)(const float*, const float*, const int*, const int*, const int*, float*, int, int,
                 int, unsigned);
  if constexpr (kBand) {
    kernel = band_wavefront_kernel<kRev, C, kRing>;
  } else {
    kernel = exact_wavefront_kernel<kRev, C, kRing>;
  }
  const size_t bytes = smem_bytes(C, kRing, kBand, Wp, Tp / Tb);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = lucy_tile::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, 64, bytes, stream>>>(blank, emit, o, t_lens, u_lens, out, Tp, Wp, Tb,
                                   kBand ? div_magic(Tb) : 0u);
  return cudaGetLastError();
}

// Either lattice for any Wp <= kMaxWp: the frame ring with C = ceil(Wp / 32)
// up to kRingMaxWp (banded) or as far as the exact ring fits in shared
// memory (C <= 5), else the producer's own loads with the least instantiated
// C >= Wp / 32.
template <bool kRev, bool kBand>
cudaError_t launch_walk(const float* blank, const float* emit, const int* o, const int* t_lens,
                        const int* u_lens, float* out, int B, int Tp, int Wp, int Tb,
                        cudaStream_t stream) {
  const int c = (Wp + 31) / 32;
#define RNNT_WAVEFRONT_CASE(COND, C, RING)                                                      \
  if (COND)                                                                                     \
  return launch_one<kRev, C, RING, kBand>(blank, emit, o, t_lens, u_lens, out, B, Tp, Wp, Tb, \
                                          stream)
  if (kBand ? Wp <= kRingMaxWp : smem_bytes(c, true, false, Wp, 0) <= 227 * 1024) {
    RNNT_WAVEFRONT_CASE(c == 1, 1, true);
    RNNT_WAVEFRONT_CASE(c == 2, 2, true);
    RNNT_WAVEFRONT_CASE(c == 3, 3, true);
    RNNT_WAVEFRONT_CASE(c == 4, 4, true);
    if constexpr (!kBand) RNNT_WAVEFRONT_CASE(c == 5, 5, true);
  }
  RNNT_WAVEFRONT_CASE(c <= 4, 4, false);
  RNNT_WAVEFRONT_CASE(c <= 6, 6, false);
  RNNT_WAVEFRONT_CASE(c <= 8, 8, false);
  RNNT_WAVEFRONT_CASE(c <= 12, 12, false);
  RNNT_WAVEFRONT_CASE(c <= 16, 16, false);
  RNNT_WAVEFRONT_CASE(c <= 24, 24, false);
  RNNT_WAVEFRONT_CASE(c <= 32, 32, false);
#undef RNNT_WAVEFRONT_CASE
  return cudaErrorInvalidValue;
}

// The banded lattice (Wp a multiple of 4, Tb dividing Tp, Tp * Tb < 2^32,
// the tables 16-byte aligned; the caller checks)
template <bool kRev>
cudaError_t launch(const float* blank, const float* emit, const int* o, const int* t_lens,
                   const int* u_lens, float* out, int B, int Tp, int Wp, int Tb,
                   cudaStream_t stream) {
  return launch_walk<kRev, true>(blank, emit, o, t_lens, u_lens, out, B, Tp, Wp, Tb, stream);
}

// The exact lattice: blank (B, T, U1), emit (B, T, U1 - 1), U1 <= kMaxWp and
// T * U1 < 2^31 (the caller checks); any alignment of 4 bytes
template <bool kRev>
cudaError_t launch_exact(const float* blank, const float* emit, const int* t_lens,
                         const int* u_lens, float* out, int B, int T, int U1,
                         cudaStream_t stream) {
  return launch_walk<kRev, false>(blank, emit, nullptr, t_lens, u_lens, out, B, T, U1, T, stream);
}

}  // namespace rnnt_wavefront
