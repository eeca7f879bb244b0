// The banded RNN-T alpha/beta lattice as an anti-diagonal wavefront, for
// Hopper (sm_90a): one warp walks one batch row.
//
// Tables in window coordinates: blank, emit (B, Tp, Wp) f32, where column w
// of frame t is label position u = o(t) + w, o(t) = o[b, t / Tb] the band
// start of frame t's time block (non-decreasing); the outputs alpha or beta
// (B, Tp, Wp) likewise.  The function (ops/rnnt_band.py holds the plain
// versions, rnnt_band_alpha_ref and rnnt_band_beta_ref):
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
constexpr int kFull = 1, kEmpty = 3;  // named barriers: full 1, 2; empty 3, 4

// Diagonals a chunk: fewer for many cells a lane, to keep the records small
template <int C>
__host__ __device__ constexpr int chunk_of() {
  return C <= 16 ? 8 : 4;
}

// torch.logaddexp for finite arguments, by the fast intrinsics: ex2.approx
// and lg2.approx (an absolute error of ~1e-7 in the log term, below half an
// ulp of any |m| >= 2; the accurate expf and log1pf put ~200 more cycles and
// a branch for special values on every diagonal's chain)
__device__ __forceinline__ float lae(float x, float y) {
  const float m = fmaxf(x, y);
  return m + __logf(1.0f + __expf(-fabsf(x - y)));
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

// Shared memory of one row (one block), in bytes: the frame ring, the
// records, each chunk's lo steps, the band starts.
template <int C, bool kRing>
size_t smem_bytes(int Wp, int nblk) {
  constexpr int chunk = chunk_of<C>();
  const size_t frames = kRing ? static_cast<size_t>(ring_frames(Wp, chunk)) * 2 * Wp * 4 : 0;
  return frames + static_cast<size_t>(2) * chunk * C * 32 * sizeof(Rec) +
         (2 * chunk + static_cast<size_t>(nblk)) * sizeof(int);
}

template <bool kRev, int C, bool kRing>
__global__ void __launch_bounds__(64, 1)
    band_wavefront_kernel(const float* __restrict__ blank, const float* __restrict__ emit,
                          const int* __restrict__ o, const int* __restrict__ t_lens,
                          const int* __restrict__ u_lens, float* __restrict__ out, int Tp,
                          int Wp, int Tb, unsigned magic) {
  constexpr int kChunk = chunk_of<C>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const int nblk = Tp / Tb;
  const int R = kRing ? ring_frames(Wp, kChunk) : 0;
  float* ring = reinterpret_cast<float*>(smem);
  Rec* recs = reinterpret_cast<Rec*>(ring + (kRing ? static_cast<size_t>(R) * 2 * Wp : 0));
  int* dls = reinterpret_cast<int*>(recs + 2 * kChunk * C * 32);
  int* os = dls + 2 * kChunk;
  for (int i = threadIdx.x; i < nblk; i += 64) os[i] = o[static_cast<size_t>(b) * nblk + i];
  __syncthreads();
  const Frames fr{os, magic};

  int tl = t_lens[b];
  tl = tl < 1 ? 1 : (tl > Tp ? Tp : tl);
  const int last = tl - 1;
  const size_t row = static_cast<size_t>(b) * Tp * Wp;
  const float* bl_g = blank + row;
  const float* em_g = emit + row;
  float* out_g = out + row;
  const int sgn = kRev ? -1 : 1;
  const int d_first = kRev ? fr.f(last) + Wp - 1 : fr.f(0);
  const int n_diag = kRev ? d_first - fr.f(0) + 1 : fr.f(last) + Wp - d_first;
  const int n_chunks = (n_diag + kChunk - 1) / kChunk;

  if (producer) {
    // beta's virtual base
    int w_virt = -1;
    if constexpr (kRev) {
      const int o_last = os[last / Tb];
      const int ws = u_lens[b] - o_last;
      if (ws >= 0 && ws < Wp)
        w_virt = ws + (last + 1 < Tp ? os[(last + 1) / Tb] : o_last) - o_last;
    }
    // The frame ring copies, at the start of chunk c, the frames that enter
    // the walk up to the end of chunk c + kRingAhead (alpha: f(t) <= limit;
    // beta: f(t) + Wp - 1 >= limit): each lane tests one candidate, a ballot
    // counts them (f increases, so they are a prefix), the warp copies them.
    int loaded = kRev ? last + 1 : -1;  // the frames copied so far end here
    auto ring_copy = [&](int limit) {
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
      lucy_tile::cp_async_commit();
    };
    if constexpr (kRing) {
      for (int c = 0; c < kRingAhead; ++c) ring_copy(d_first + sgn * ((c + 1) * kChunk - 1));
    }
    // The span lo..hi of the diagonal before the chunk (no cells before the
    // walk's first diagonal).  A chunk's spans come from ballots: lane k
    // holds f of the k-th frame that may leave or enter, and each diagonal
    // counts the lanes whose frame has (f increases, so they are a prefix).
    int lo0 = kRev ? last + 1 : 0, hi0 = kRev ? last : -1, hprev = hi0;
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
      const int ta = kRev ? lo0 - 1 - lane : lo0 + lane;    // may leave (alpha) or enter
      const int tb = kRev ? hi0 - lane : hi0 + 1 + lane;    // may enter (alpha) or leave
      const int fa = fr.f(ta < 0 ? 0 : (ta > last ? last : ta));
      const int fb = fr.f(tb < 0 ? 0 : (tb > last ? last : tb));
      const bool a_ok = ta >= 0 && ta <= last, b_ok = tb >= 0 && tb <= last;
      int lo[kChunk], hi[kChunk], hraw[kChunk], dl[kChunk];
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
      lo0 = lo[kChunk - 1];
      if (c >= 2) bar_sync(kEmpty + slot, 64);       // the consumer is done with the slot
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) dls[slot * kChunk + j] = dl[j];
      }
      Rec* rs = recs + static_cast<size_t>(slot) * kChunk * C * 32;
      // the records.  Each cell's table offset g = t * Wp + w (and its ring
      // address a) follows from the previous diagonal's without a lookup: the
      // same frame one column on (alpha: +1; beta: -1), the neighbour cell's
      // where lo moved (one shuffle for the end cell), and fresh for the frame
      // that enters (alpha: at hi, w = 0; beta: at lo, w = Wp - 1).  Cells
      // outside the span carry garbage, read a harmless address, and are
      // masked.
#pragma unroll(kRing ? kChunk : 1)
      for (int j = 0; j < kChunk; ++j) {
        const int h = j ? hraw[j > 0 ? j - 1 : 0] : hprev;
        const int g_nb = kRev ? __shfl_up_sync(0xffffffffu, g[C - 1], 1)
                              : __shfl_down_sync(0xffffffffu, g[0], 1);
        const int a_nb = kRev ? __shfl_up_sync(0xffffffffu, a[C - 1], 1)
                              : __shfl_down_sync(0xffffffffu, a[0], 1);
        float bl[C], em[C];
        int t[C];
        bool ok[C];
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
  // diagonal; beta: m0 = the previous diagonal's beta (m1 unused).
  float m0[C], m1[C];
#pragma unroll
  for (int i = 0; i < C; ++i) m0[i] = m1[i] = kNeg;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    bar_sync(kFull + slot, 64);                      // the producer has filled the slot
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
          x = lae(up, in_rt[i]);
          m0[i] = x + r[i].bl;
          m1[i] = x + r[i].em;
        } else {
          x = lae(r[i].bl + up, r[i].em + in_rt[i]);
          m0[i] = x;
        }
        store_if(out_g + (r[i].off < 0 ? 0 : r[i].off), x, r[i].off >= 0);
      }
    }
    if (c + 2 < n_chunks) bar_arrive(kEmpty + slot, 64);  // the slot is free again
  }

  // frames past the last: alpha repeats its last row (read back from this
  // warp's own stores), beta holds the base
  int ws = -1;
  if constexpr (kRev) ws = u_lens[b] - os[last / Tb];
  __syncwarp();
  for (int w = lane; w < Wp; w += 32) {
    const float v = kRev ? (w == ws ? 0.0f : kNeg) : out_g[static_cast<size_t>(last) * Wp + w];
    for (int t = tl; t < Tp; ++t) out_g[static_cast<size_t>(t) * Wp + w] = v;
  }
}

template <bool kRev, int C, bool kRing>
cudaError_t launch_one(const float* blank, const float* emit, const int* o, const int* t_lens,
                       const int* u_lens, float* out, int B, int Tp, int Wp, int Tb,
                       cudaStream_t stream) {
  auto kernel = band_wavefront_kernel<kRev, C, kRing>;
  const size_t bytes = smem_bytes<C, kRing>(Wp, Tp / Tb);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = lucy_tile::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, 64, bytes, stream>>>(blank, emit, o, t_lens, u_lens, out, Tp, Wp, Tb,
                                   div_magic(Tb));
  return cudaGetLastError();
}

// The banded lattice for any Wp <= kMaxWp (a multiple of 4, Tb dividing Tp,
// Tp * Tb < 2^32, the tables 16-byte aligned; the caller checks): the frame
// ring with C = ceil(Wp / 32) up to kRingMaxWp, else the producer's own
// loads with the least instantiated C >= Wp / 32.
template <bool kRev>
cudaError_t launch(const float* blank, const float* emit, const int* o, const int* t_lens,
                   const int* u_lens, float* out, int B, int Tp, int Wp, int Tb,
                   cudaStream_t stream) {
  const int c = (Wp + 31) / 32;
#define RNNT_WAVEFRONT_CASE(COND, C, RING) \
  if (COND) return launch_one<kRev, C, RING>(blank, emit, o, t_lens, u_lens, out, B, Tp, Wp, Tb, stream)
  if (Wp <= kRingMaxWp) {
    RNNT_WAVEFRONT_CASE(c == 1, 1, true);
    RNNT_WAVEFRONT_CASE(c == 2, 2, true);
    RNNT_WAVEFRONT_CASE(c == 3, 3, true);
    RNNT_WAVEFRONT_CASE(c == 4, 4, true);
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

}  // namespace rnnt_wavefront
