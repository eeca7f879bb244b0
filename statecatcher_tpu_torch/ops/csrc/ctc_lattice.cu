// CTC alpha/beta lattice for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/ctc_pallas.py:
//   K3  ctc_alpha_kernel  <- _alpha_kernel (:58), launched by _alpha_all (:179)
//   K4  ctc_beta_kernel   <- _beta_kernel (:92), launched by _beta_all (:218)
//
//   emit        (B, T, S) f32, S = 2U+1 extended-label states, the log-prob of
//               each state's label at each frame
//   allow_skip  (B, S) uint8, 1 where the s-2 -> s skip is allowed
//   in_lens     (B) int32;  label_lens (B) int32 (beta only)
//   ->          alpha or beta (B, T, S) f32
//
// Rules, as the TPU kernels (ops/ctc_lattice.py holds the plain versions):
//   alpha: t = 0 reaches states s <= 1 (alpha = emit there, -1e30 elsewhere);
//          t > 0: alpha_t(s) = lse3(alpha(s), alpha(s-1), alpha(s-2) if skip)
//          + emit;  rows are frozen (copied) for t >= in_len.
//   beta:  t >= in_len: -1e30 (dead);  t = in_len-1: emit + (0 at the
//          terminal states 2L and 2L-1 (L > 0), -1e30 elsewhere);  t below:
//          beta_t(s) = emit + lse3(beta(s), beta(s+1), beta(s+2) if skip
//          into s+2).  Time is walked backwards in place: no flipped copy.
//   lse3 is _logaddexp3 with its -1e30 floor: -1e30 when the max is below
//   -5e29.
//
// Bound on the card: bytes, emit read and alpha (or beta) written once:
// 2*B*T*S*4 bytes, 105 MB at B=32, T=1598, U=128 (S=257), 0.031 ms at
// 3.35 TB/s each.  But the T-long chain of dependent frames sets the time:
// each frame needs the previous one.
//
// Design: a one-way pipeline of warps, one block per batch row.  Warp j owns
// the W = 32*C states [j*W, (j+1)*W), lane l the C consecutive states j*W +
// l*C + i (C = ceil(S / 1024) by default, so at most 32 warps and S <= 4096).
// Information in alpha flows only upward in s: state s of frame t needs s,
// s-1 and s-2 of frame t-1.  So within a warp a frame's chain is two
// shuffles and one lse3, and warp j needs of the other warps only warp
// j-1's top two states of the frame before.  Beta is the mirror image
// (s+1, s+2; warp j needs warp j+1's bottom two states), so its pipeline
// runs from the top warp down.  The first frame of the walk (alpha's t = 0,
// beta's t = in_len - 1) is computed before the chain from its own rule.
//   Hand-offs: each warp keeps its two edge states of every frame of a
//     chunk of F frames in registers and, after the chunk, its edge lanes
//     write them (as float4s) into a ring of kEdgeSlots chunk slots in
//     shared memory and the warp arrives on that slot's "full" mbarrier;
//     the next warp loads the chunk's F edge pairs into registers once that
//     barrier's phase has completed and arrives on the slot's "empty"
//     mbarrier, on which the writer waits before it reuses the slot.  Both
//     barriers are probed (test_wait) at the chunk's start and waited on
//     only where their data is first needed: the edges at frame 1 (frame 0
//     takes the last chunk's), the free slot at the chunk's end.  So warp j
//     runs one chunk behind warp j-1 (a fill of (warps - 1) * F frames),
//     with no barrier inside a chunk and no block barrier after the start.
//   emit: every warp streams its own states' emit into a ring of NE chunks
//     in shared memory by cp.async (4-byte copies: a frame row of S floats
//     is not 16-byte aligned), NE - 1 chunks ahead of its walk, and loads a
//     chunk's values into registers after one wait at the chunk's start: no
//     device load is on the chain.
//   The chain is what remains: two shuffles, three selects, lse3 and one
//     add, in the plain version's f32 operations and order with accurate
//     expf/logf, so that alpha and beta are the plain version's bit for bit
//     (the training checks compare Adam's first updates, which turn any
//     other rounding of the CTC gradient into sign flips: the MUFU's
//     approximations were 0.11 ms faster and failed chip_smoke's phase 25).
//     One of lse3's three exps is exp(0) = 1 and is not computed.  The
//     stores take a moving pointer and a predicate, no branch.
// PERF.md (section 6) has the design's measurements: one warp a row, or two or
// three states a lane, were slower (a warp issues its states' work one
// after the other); at S = 257 one SM sub-partition holds three of the nine
// warps, and the issue of their expf/logf sets the pace.
// Frames past in_len need no recursion: alpha's frozen rows and beta's dead
// rows are written after the walk.  No atomics, a fixed order: two calls give
// the same bits.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "lucy_tile.cuh"
#include "rnnt_wavefront.cuh"

namespace {

using rnnt_wavefront::store_if;  // a predicated store, no branch

constexpr float kNeg = -1e30f;
constexpr int kMaxWarps = 32;
constexpr int kEdgeSlots = 4;  // chunks of edge states in flight between two warps

// Frames a chunk and emit ring stages (chunks), by states a lane: the ring
// of 32 warps must fit in shared memory
template <int C>
__host__ __device__ constexpr int chunk_frames() {
  return C <= 2 ? 8 : 4;
}
template <int C>
__host__ __device__ constexpr int ring_stages() {
  return C == 1 ? 6 : 3;
}

// The states a lane holds for S states (the warps are ceil(S / (32 C)))
inline int states_per_lane(int S) { return (S + 1023) / 1024; }

// lse3(a, b, c) + e, bit for bit the plain version's (its f32 operations in
// its order, accurate expf/logf): ms + log((exp(a-ms) + exp(b-ms)) +
// exp(c-ms)), then + e, or -1e30 + e under the floor.  One of the three
// terms is exp(0) = 1 exactly, so only the other two are computed, and the
// sum keeps the plain version's order: (ea + eb) + 1 when c is the largest,
// else (1 + ep) + ec with p the other of a and b.
__device__ __forceinline__ float lse3_add(float a, float b, float c, float e) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool c_top = c >= m;
  const float ep = expf((c_top || !(a >= m) ? a : b) - m);
  const float eq = expf((c_top ? b : c) - m);
  const float s = (c_top ? ep + eq : 1.0f + ep) + (c_top ? 1.0f : eq);
  const float out = (m + logf(s)) + e;
  return m <= kNeg * 0.5f ? kNeg + e : out;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
// Whether the phase of the given parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Shared memory of one block of nw warps, in bytes: the mbarriers, the edge
// rings (two planes of F floats a chunk) and the first frame's edges, the
// emit rings
template <int C>
size_t smem_bytes(int nw) {
  constexpr int F = chunk_frames<C>(), NE = ring_stages<C>();
  return static_cast<size_t>(nw) *
         (2 * kEdgeSlots * sizeof(uint64_t) + (kEdgeSlots * 2 * F + 2) * sizeof(float) +
          static_cast<size_t>(NE) * F * 32 * C * sizeof(float));
}

template <bool kRev, int C>
__device__ __forceinline__ void walk(const float* __restrict__ emit,
                                     const uint8_t* __restrict__ allow_skip,
                                     const int* __restrict__ in_lens,
                                     const int* __restrict__ label_lens, float* __restrict__ out,
                                     int T, int S) {
  constexpr int F = chunk_frames<C>(), NE = ring_stages<C>(), NS = kEdgeSlots, W = 32 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = kRev ? nw - 1 - warp : warp;   // place in the pipeline
  const int up = kRev ? warp + 1 : warp - 1;      // the warp this one waits on
  const bool has_up = rank > 0, has_down = rank < nw - 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);                // [nw][NS]
  uint64_t* empty = full + nw * NS;                                  // [nw][NS]
  float* edges = reinterpret_cast<float*>(empty + nw * NS);          // [nw][NS][2][F]
  float2* edge0 = reinterpret_cast<float2*>(edges + nw * NS * 2 * F);  // [nw]
  float* ring = reinterpret_cast<float*>(edge0 + nw) + static_cast<size_t>(warp) * NE * F * W;

  const int b = blockIdx.x;
  const int s0 = warp * W + lane * C;
  const int L = in_lens[b];
  const int rows = L < T ? (L > 0 ? L : 0) : T;   // alpha: rows that recurse; beta: live rows
  const int n = rows > 0 ? rows - 1 : 0;           // frames of the walk after its first
  const float* e = emit + static_cast<size_t>(b) * T * S;
  float* o = out + static_cast<size_t>(b) * T * S + s0;
  const int sgn = kRev ? -1 : 1;
  // the edge lanes: C = 1, alpha lanes 30 (x) and 31 (y), beta lanes 0 (x)
  // and 1 (y); C > 1, alpha lane 31, beta lane 0 (both)
  const int edge_lane = C == 1 ? (kRev ? lane : lane - 30) : (lane == (kRev ? 0 : 31) ? 0 : 2);

  if (lane == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[warp * NS + i], 32);
      mbar_init(&empty[warp * NS + i], 32);
    }
  }
  // emit of the walk's chunk c (frames k = c F + 1 ...) into ring stage
  // c % NE: each lane copies (and later reads) only its own states; a frame
  // past the walk copies the last one
  bool in[C];
#pragma unroll
  for (int i = 0; i < C; ++i) in[i] = s0 + i < S;
  const float* e_lane = e + (s0 < S ? s0 : S - 1);
  auto copy_chunk = [&](int c) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int k = min(c * F + 1 + f, n);
      const int t = kRev ? max(rows - 1 - k, 0) : k;
      float* r = ring + ((c % NE) * F + f) * W + lane;
#pragma unroll
      for (int i = 0; i < C; ++i)
        lucy_tile::cp_async<4>(r + i * 32, e_lane + t * S + (in[i] ? i : 0), in[i]);
    }
    lucy_tile::cp_async_commit();
  };
  for (int c = 0; c < NE - 1; ++c) copy_chunk(c);

  // the first frame of the walk, from its own rule
  bool skip[C];
  float v[C];
  const int t0 = kRev ? rows - 1 : 0;
  {
    const int ll = kRev ? label_lens[b] : 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int s = s0 + i;
      if (!kRev) {
        skip[i] = s >= 2 && in[i] && allow_skip[static_cast<size_t>(b) * S + s] != 0;
        v[i] = rows > 0 && s <= 1 && in[i] ? e[s] : kNeg;
      } else {
        skip[i] = s + 2 < S && allow_skip[static_cast<size_t>(b) * S + s + 2] != 0;
        const bool term = s == 2 * ll || (ll > 0 && s == 2 * ll - 1);
        // in_len > T: the walk starts from a dead row, emit + lse3(-1e30, ...)
        v[i] = rows > 0 && in[i]
                   ? e[static_cast<size_t>(t0) * S + s] + (term && L <= T ? 0.0f : kNeg)
                   : kNeg;
      }
      if (rows > 0) store_if(o + static_cast<ptrdiff_t>(t0) * S + i, v[i], in[i]);
    }
  }
  // a warp's two edge states: alpha its top two (x below y), beta its bottom two
  auto edge_of = [&](int plane) {
    if constexpr (C == 1) return v[0];
    else return kRev ? v[plane] : v[C - 2 + plane];
  };
  if constexpr (C == 1) {
    if (edge_lane == 0) edge0[warp].x = edge_of(0);
    if (edge_lane == 1) edge0[warp].y = edge_of(1);
  } else {
    if (edge_lane == 0) edge0[warp] = make_float2(edge_of(0), edge_of(1));
  }
  __syncthreads();                                  // the mbarriers and the first edges
  float2 carry = has_up ? edge0[up] : make_float2(kNeg, kNeg);

  // one frame: v <- the next row, from the edge pair g of the warp before
  auto step = [&](const float (&ev)[C], float2 g) {
    if constexpr (C == 1) {
      float x1, x2;
      if (!kRev) {
        x1 = __shfl_up_sync(0xffffffffu, v[0], 1);
        x2 = __shfl_up_sync(0xffffffffu, v[0], 2);
        if (lane == 0) x1 = g.y;
        if (lane < 2) x2 = lane == 0 ? g.x : g.y;
      } else {
        x1 = __shfl_down_sync(0xffffffffu, v[0], 1);
        x2 = __shfl_down_sync(0xffffffffu, v[0], 2);
        if (lane == 31) x1 = g.x;
        if (lane > 29) x2 = lane == 31 ? g.y : g.x;
      }
      v[0] = lse3_add(v[0], x1, skip[0] ? x2 : kNeg, ev[0]);
    } else {
      float nv[C];
      if (!kRev) {
        float p1 = __shfl_up_sync(0xffffffffu, v[C - 1], 1);
        float p2 = __shfl_up_sync(0xffffffffu, v[C - 2], 1);
        if (lane == 0) { p1 = g.y; p2 = g.x; }
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float a1 = i >= 1 ? v[i >= 1 ? i - 1 : 0] : p1;
          const float a2 = i >= 2 ? v[i >= 2 ? i - 2 : 0] : (i == 1 ? p1 : p2);
          nv[i] = lse3_add(v[i], a1, skip[i] ? a2 : kNeg, ev[i]);
        }
      } else {
        float n1 = __shfl_down_sync(0xffffffffu, v[0], 1);
        float n2 = __shfl_down_sync(0xffffffffu, v[1], 1);
        if (lane == 31) { n1 = g.x; n2 = g.y; }
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float b1 = i + 1 < C ? v[i + 1 < C ? i + 1 : i] : n1;
          const float b2 = i + 2 < C ? v[i + 2 < C ? i + 2 : i] : (i + 2 == C ? n1 : n2);
          nv[i] = lse3_add(v[i], b1, skip[i] ? b2 : kNeg, ev[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = nv[i];
    }
  };

  const int n_chunks = (n + F - 1) / F;
  float* op = o + static_cast<ptrdiff_t>(t0) * S;   // this lane's output at the frame walked
  // A chunk: the mbarriers are probed at its start and waited on only where
  // their data is first needed (the edges of the warp before at frame 1, the
  // free slot at the end), so their latency overlaps frame 0's chain.
  auto run_chunk = [&](int c, auto tail) {
    constexpr bool kTail = decltype(tail)::value;
    const int slot = c % NS;
    const unsigned par = (c / NS) & 1;
    const bool up_done = !has_up || mbar_test(&full[up * NS + slot], par);
    const bool slot_free = !has_down || c < NS || mbar_test(&empty[warp * NS + slot], par ^ 1u);
    lucy_tile::cp_async_wait<NE - 2>();             // this chunk's emit has landed
    float ev[F][C];
    const float* r = ring + (c % NE) * F * W;
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int i = 0; i < C; ++i) ev[f][i] = r[(f * C + i) * 32 + lane];
    copy_chunk(c + NE - 1);                         // into the stage chunk c - 1 read
    float hx[F] = {}, hy[F] = {};                   // this warp's edge states, frame by frame
    auto frame = [&](int f, float2 g) {
      step(ev[f], g);
      op += sgn * S;
#pragma unroll
      for (int i = 0; i < C; ++i) store_if(op + i, v[i], in[i]);
      hx[f] = edge_of(0);
      hy[f] = edge_of(1);
    };
    frame(0, carry);
    float2 g[F];
    if (has_up) {                                   // the warp before finished chunk c
      if (!up_done) mbar_wait(&full[up * NS + slot], par);
      const float4* p = reinterpret_cast<const float4*>(edges + (up * NS + slot) * 2 * F);
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float4 x = p[q], y = p[F / 4 + q];
        g[4 * q] = make_float2(x.x, y.x);
        g[4 * q + 1] = make_float2(x.y, y.y);
        g[4 * q + 2] = make_float2(x.z, y.z);
        g[4 * q + 3] = make_float2(x.w, y.w);
      }
      mbar_arrive(&empty[up * NS + slot]);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = make_float2(kNeg, kNeg);
    }
#pragma unroll
    for (int f = 1; f < F; ++f) {
      if (kTail && c * F + 1 + f > n) break;
      frame(f, g[f - 1]);
    }
    carry = g[F - 1];
    if (has_down) {
      // the edge lanes write their chunk's states as float4s: plane x then
      // plane y, one each (C = 1: hx = hy) or both; the writes of a tail
      // chunk past the walk are unread
      if (!slot_free) mbar_wait(&empty[warp * NS + slot], par ^ 1u);
      float4* p = reinterpret_cast<float4*>(edges + (warp * NS + slot) * 2 * F);
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float4 x = make_float4(hx[4 * q], hx[4 * q + 1], hx[4 * q + 2], hx[4 * q + 3]);
        const float4 y = make_float4(hy[4 * q], hy[4 * q + 1], hy[4 * q + 2], hy[4 * q + 3]);
        if (C == 1) {
          if (edge_lane == 0 || edge_lane == 1) p[edge_lane * (F / 4) + q] = x;
        } else if (edge_lane == 0) {
          p[q] = x;
          p[F / 4 + q] = y;
        }
      }
      mbar_arrive(&full[warp * NS + slot]);
    }
  };
  const int n_full = n / F;
  for (int c = 0; c < n_full; ++c) run_chunk(c, std::false_type{});
  if (n_full < n_chunks) run_chunk(n_full, std::true_type{});
  lucy_tile::cp_async_wait<0>();

  // rows past the walk: alpha repeats its last row (-1e30 when in_len <= 0),
  // beta's are dead
  for (int t = rows; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      store_if(o + static_cast<size_t>(t) * S + i, kRev ? kNeg : v[i], in[i]);
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ctc_alpha_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ allow_skip,
                     const int* __restrict__ in_lens, const int* __restrict__ label_lens,
                     float* __restrict__ alpha, int T, int S) {
  walk<false, C>(emit, allow_skip, in_lens, label_lens, alpha, T, S);
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ctc_beta_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ allow_skip,
                    const int* __restrict__ in_lens, const int* __restrict__ label_lens,
                    float* __restrict__ beta, int T, int S) {
  walk<true, C>(emit, allow_skip, in_lens, label_lens, beta, T, S);
}

template <bool kRev, int C>
int launch_one(const float* emit, const uint8_t* allow_skip, const int* in_lens,
               const int* label_lens, float* out, int B, int T, int S, cudaStream_t stream) {
  const int nw = (S + 32 * C - 1) / (32 * C);
  const size_t bytes = smem_bytes<C>(nw);
  // a row's offsets t * S are ints
  if (nw > kMaxWarps || bytes > 227 * 1024 || static_cast<long long>(T) * S >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kRev ? ctc_beta_kernel<C> : ctc_alpha_kernel<C>;
  const cudaError_t err = lucy_tile::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, 32 * nw, bytes, stream>>>(emit, allow_skip, in_lens, label_lens, out, T, S);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRev>
int launch(const float* emit, const uint8_t* allow_skip, const int* in_lens,
           const int* label_lens, float* out, int B, int T, int S, void* stream) {
  const int c = states_per_lane(S);
  const auto st = static_cast<cudaStream_t>(stream);
#define CTC_LATTICE_CASE(C) \
  if (c == C) return launch_one<kRev, C>(emit, allow_skip, in_lens, label_lens, out, B, T, S, st)
  CTC_LATTICE_CASE(1);
  CTC_LATTICE_CASE(2);
  CTC_LATTICE_CASE(3);
  CTC_LATTICE_CASE(4);
#undef CTC_LATTICE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); S must be at most
// 4 * 1024 (the wrapper checks) and T * S below 2^31.
extern "C" int ctc_alpha(const float* emit, const uint8_t* allow_skip, const int* in_lens,
                         float* alpha, int B, int T, int S, void* stream) {
  return launch<false>(emit, allow_skip, in_lens, in_lens, alpha, B, T, S, stream);
}

extern "C" int ctc_beta(const float* emit, const uint8_t* allow_skip, const int* in_lens,
                        const int* label_lens, float* beta, int B, int T, int S,
                        void* stream) {
  return launch<true>(emit, allow_skip, in_lens, label_lens, beta, B, T, S, stream);
}
