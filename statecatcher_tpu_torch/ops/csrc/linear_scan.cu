// First-order linear scan for Hopper (sm_90a): forward and reverse adjoint.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/lucy_pallas.py:
//   K5a  linear_scan_fwd_kernel <- _scan_kernel (:35), launched by
//                                  _linear_scan_pallas_fwd_impl (:79)
//   K5b  linear_scan_rev_kernel <- _rev_scan_kernel (:118), launched by
//                                  _linear_scan_pallas_rev_impl (:174)
//
//   K5a:  a, b (B, T, D) f32 or bf16, s0 (B, D) f32 (the wrapper casts) ->
//         s (B, T, D) in a's dtype, s_t = a_t * s_{t-1} + b_t from s_{-1} = s0
//   K5b:  a, g (B, T, D) -> lam (B, T, D) in a's dtype,
//         lam_t = g_t + a_{t+1} * lam_{t+1}, lam_{T-1} = g_{T-1}
// Both carry the state in f32 whatever the inputs' dtype and round only what
// they write, as the TPU kernels' f32 scratch carry does.  The product and
// the sum are rounded separately (no fused multiply-add), in the order of the
// plain sequential versions (ops/scan.py), so f32 results equal theirs.
//
// Bound on the card: bytes, two planes read and one written: 3*B*T*D*4 bytes,
// 314 MB at B=32, T=1598, D=512 f32, 0.094 ms at 3.35 TB/s (0.047 ms bf16).
// The T steps of each (b, d) column are a dependent chain of two operations,
// ~8 cycles a step, so the walk itself needs ~13k cycles a column, a tenth of
// the byte bound: the time is set by the bytes each SM keeps in flight.
//
// K5a's design: a block owns one batch row and DT columns (one 128-byte line
// of a row: 32 in f32, 64 in bf16) and walks time in tiles of TC = 32 steps
// through an S = 4 stage ring in shared memory.  Four copy warps fill the
// ring by cp.async (lucy_tile.cuh's row copies, 16 bytes a thread where the
// rows allow) S-1 tiles ahead of the walk: 3 x 8 KB in flight a block, at
// B=32, D=512 512 blocks (f32; 256 in bf16) in one wave, ~90 KB (f32; ~47 KB
// bf16) in flight an SM, past the ~25 KB that 3.35 TB/s over 132 SMs needs
// at a microsecond's latency.  Meanwhile one thread a column walks the tile
// that has landed out of shared memory, s = a*s + b with the product and the
// sum each rounded once, and writes s into an output tile (two buffers) that
// the copy warps store in the next phase with coalesced 16-byte stores.  So
// the walk of tile j, the loads of tiles j+1 .. j+3 and the stores of tile
// j-1 overlap; one barrier a phase separates them, and the walk never waits
// on a device load.  (The one-thread-per-column kernel this replaced took
// twice K5b's time on the same bytes: nvcc had put its loads between the
// stores of its walk, so a thread kept ~5 loads in flight, not K5b's 30.)
// Steps past T and columns past D are loaded as zeros and never stored.  The
// streaming shape (B=1, T=32, D=512) is 16 blocks (8 in bf16) and one tile.
// What bounds it: the copies.  Without the walk it takes the same time, a
// torch.add over the same bytes takes ~15 % less, and one thread's
// cp.async.bulk a row in place of the copy warps is slower; two copy warps
// took 0.072 ms in bf16 against four's 0.062 (tools/lucy_cell_variants.py).

// K5b's design: one thread per (b, d) column walks T backwards (neighbouring
// threads read neighbouring d, so each step's loads coalesce), loading kChunk
// steps of a and g into registers before it runs them, so that the loads of
// a chunk overlap one another instead of each waiting on the last step.  (The
// TPU kernels scanned each time chunk as a Hillis-Steele composition; on this
// card the sequential walk already does the least work.)

#include "lucy_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename Tx>
struct ScanTile {
  static constexpr int DT = 128 / static_cast<int>(sizeof(Tx));  // columns per block
  static constexpr int TC = 32;                                    // steps per tile
  static constexpr int S = 4;                                      // ring stages
  static constexpr int kWalk = DT;                                 // one thread per column
  static constexpr int kCopy = 128;                                // four copy warps
  static constexpr int kThreads = kWalk + kCopy;
  static constexpr int kStageElems = 2 * TC * DT;                  // a rows, then b rows
  static constexpr int kOutElems = TC * DT;                        // one buffer
  static constexpr size_t kSmem = (S * kStageElems + 2 * kOutElems) * sizeof(Tx);
  static_assert(DT % 32 == 0 && S >= 2, "tile geometry");
};

template <typename Tx, int VB>
__global__ void __launch_bounds__(ScanTile<Tx>::kThreads)
linear_scan_fwd_kernel(const Tx* __restrict__ a, const Tx* __restrict__ b,
                       const float* __restrict__ s0, Tx* __restrict__ out, int T, int D) {
  using P = ScanTile<Tx>;
  constexpr int DT = P::DT, TC = P::TC, S = P::S;
  extern __shared__ __align__(16) unsigned char smem[];
  Tx* stages = reinterpret_cast<Tx*>(smem);
  Tx* outs = stages + S * P::kStageElems;

  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * DT;
  const int nT = (T + TC - 1) / TC;
  const bool walker = threadIdx.x < P::kWalk;
  const int ct = threadIdx.x - P::kWalk;                   // copy thread index
  const size_t base = static_cast<size_t>(bi) * T * D;
  const Tx* ab = a + base;
  const Tx* bb = b + base;
  Tx* ob = out + base;
  float s = walker && d0 + static_cast<int>(threadIdx.x) < D
                ? s0[static_cast<size_t>(bi) * D + d0 + threadIdx.x]
                : 0.0f;

  auto load = [&](int j) {                                 // copy threads: tile j's a and b
    if (j < nT) {
      const int t0 = j * TC;
      lucy_tile::copy_rows<Tx, DT, VB>(
          stages + (j % S) * P::kStageElems, 2 * TC,
          [&](int r) -> const Tx* {
            const int t = t0 + (r < TC ? r : r - TC);
            return t < T ? (r < TC ? ab : bb) + static_cast<size_t>(t) * D : nullptr;
          },
          d0, D, a, ct, P::kCopy);
    }
    lucy_tile::cp_async_commit();
  };

  if (!walker)
    for (int j = 0; j < S - 1; ++j) load(j);

  // Phase j: the walkers walk tile j; the copy warps start tile j+S-1's loads
  // and store tile j-1's outputs.
  for (int j = 0; j <= nT; ++j) {
    if (!walker) lucy_tile::cp_async_wait<S - 2>();        // tile j has landed
    __syncthreads();
    if (walker) {
      if (j < nT) {
        const Tx* in = stages + (j % S) * P::kStageElems + threadIdx.x;
        Tx* o = outs + (j & 1) * P::kOutElems + threadIdx.x;
#pragma unroll
        for (int t = 0; t < TC; ++t) {                      // steps past T: never stored
          s = __fadd_rn(__fmul_rn(lucy_tile::to_f32(in[t * DT]), s),
                        lucy_tile::to_f32(in[(TC + t) * DT]));
          lucy_tile::store(o + t * DT, s);
        }
      }
    } else {
      load(j + S - 1);                                     // into the stage tile j-1 used
      if (j >= 1) {
        const int t0 = (j - 1) * TC;
        lucy_tile::store_rows<Tx, DT, VB>(
            outs + ((j - 1) & 1) * P::kOutElems, TC,
            [&](int r) -> Tx* {
              return t0 + r < T ? ob + static_cast<size_t>(t0 + r) * D : nullptr;
            },
            d0, D, ct, P::kCopy);
      }
    }
  }
}

template <typename Tx, int VB>
int launch_fwd_vb(const void* a, const void* b, const float* s0, void* out, int B, int T, int D,
                  cudaStream_t stream) {
  using P = ScanTile<Tx>;
  auto kernel = linear_scan_fwd_kernel<Tx, VB>;
  const dim3 grid((D + P::DT - 1) / P::DT, B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(static_cast<const Tx*>(a),
                                                  static_cast<const Tx*>(b), s0,
                                                  static_cast<Tx*>(out), T, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tx>
int launch_fwd(const void* a, const void* b, const float* s0, void* out, int B, int T, int D,
               cudaStream_t stream) {
  switch (lucy_tile::copy_unit_bytes(sizeof(Tx), D, {a, b, out})) {
    case 16: return launch_fwd_vb<Tx, 16>(a, b, s0, out, B, T, D, stream);
    case 8: return launch_fwd_vb<Tx, 8>(a, b, s0, out, B, T, D, stream);
    case 4: return launch_fwd_vb<Tx, 4>(a, b, s0, out, B, T, D, stream);
    default:
      if constexpr (sizeof(Tx) == 2) return launch_fwd_vb<Tx, 2>(a, b, s0, out, B, T, D, stream);
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
}

template <typename Tx>
__global__ void __launch_bounds__(kThreads)
linear_scan_rev_kernel(const Tx* __restrict__ a, const Tx* __restrict__ g, Tx* __restrict__ out,
                       int B, int T, int D) {
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(B) * D) return;
  const long long bi = col / D;
  const size_t base = static_cast<size_t>(bi) * T * D + (col - bi * D);
  float lam = 0.0f, a_next = 0.0f;  // a_T is never used: lam_T = 0
  for (int t1 = T - 1; t1 >= 0; t1 -= kChunk) {
    float ac[kChunk], gc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t1 - k;
      const size_t i = base + static_cast<size_t>(t) * D;
      ac[k] = t >= 0 ? ld(a + i) : 1.0f;
      gc[k] = t >= 0 ? ld(g + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int t = t1 - k;
      lam = __fadd_rn(gc[k], __fmul_rn(a_next, lam));
      a_next = ac[k];
      if (t >= 0) st(out + base + static_cast<size_t>(t) * D, lam);
    }
  }
}

unsigned blocks_for(int B, int D) {
  return static_cast<unsigned>((static_cast<long long>(B) * D + kThreads - 1) / kThreads);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  dtype 0 is
// float32, 1 bfloat16 (a, b, g and the output).  The grid must hold it (the
// wrapper checks): linear_scan_fwd B <= 65535, linear_scan_rev B*D/128
// blocks.
extern "C" int linear_scan_fwd(int dtype, const void* a, const void* b, const float* s0,
                               void* out, int B, int T, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(a, b, s0, out, B, T, D, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(a, b, s0, out, B, T, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int linear_scan_rev(int dtype, const void* a, const void* g, void* out, int B, int T,
                               int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    linear_scan_rev_kernel<float><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<float*>(out), B,
        T, D);
  else if (dtype == 1)
    linear_scan_rev_kernel<__nv_bfloat16><<<blocks_for(B, D), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), B, T, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
