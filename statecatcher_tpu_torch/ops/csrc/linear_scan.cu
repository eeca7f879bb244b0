// First-order linear scan for Hopper (sm_90a): forward and reverse adjoint.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/lucy_pallas.py:
//   K5a  lucy_tile::ring_scan_kernel<FwdScan>  <- _scan_kernel (:35), launched
//                                  by _linear_scan_pallas_fwd_impl (:79)
//   K5b  lucy_tile::ring_scan_kernel<RevScan>  <- _rev_scan_kernel (:118),
//                                  launched by _linear_scan_pallas_rev_impl (:174)
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
// The design: both are lucy_tile.cuh's ring scan (`ring_scan_kernel`) with a
// step of their own.  A block owns one batch row and DT columns (one 128-byte
// line of a row: 32 in f32, 64 in bf16) and walks time in tiles of TC = 32
// steps through an S = 4 stage ring in shared memory.  Four copy warps fill
// the ring by cp.async (lucy_tile.cuh's row copies, 16 bytes a thread where
// the rows allow) S-1 tiles ahead of the walk: 3 x 8 KB in flight a block, at
// B=32, D=512 512 blocks (f32; 256 in bf16) in one wave, ~90 KB (f32; ~47 KB
// bf16) in flight an SM, past the ~25 KB that 3.35 TB/s over 132 SMs needs
// at a microsecond's latency.  Meanwhile one thread a column walks the tile
// that has landed out of shared memory and writes its outputs into an output
// tile (two buffers) that the copy warps store in the next phase with
// coalesced 16-byte stores.  So the walk of tile j, the loads of tiles j+1 ..
// j+3 and the stores of tile j-1 overlap; one barrier a phase separates them,
// and the walk never waits on a device load.  K5a walks forwards, s = a*s +
// b.  K5b visits the tiles from the latest to the earliest and walks each
// from its latest step down, lam = g + a_next*lam, with a_next (a_{t+1})
// carried in a register from the step walked before: for a tile's top step
// it is the first row of the tile walked before it.  Both of K5b's carries
// start at 0, and the zero rows past T at the top of the first tile walked
// leave them at 0.  Steps past T and columns past D are loaded as zeros and
// never stored.  The streaming shape (B=1, T=32, D=512) is 16 blocks (8 in
// bf16) and one tile.  What bounds both: the copies.  Without the walk each
// takes the same time, a torch.add over the same bytes takes ~12 % less, and
// one thread's cp.async.bulk a row in place of the copy warps was slower; two
// copy warps took 0.072 ms in bf16 against four's 0.062, and 3 stages, 8
// copy warps, tiles of 16 steps or 32 columns a block in bf16 gained nothing
// in both dtypes (tools/lucy_cell_variants.py).  (The one-thread-per-column
// kernels this replaced kept a chunk of steps' loads in registers, taking
// turns with the walk: K5a took 0.36 ms f32, nvcc having put its loads
// between the stores of its walk, so that a thread kept ~5 loads in flight;
// K5b 0.19 ms with 30.)

#include "lucy_tile.cuh"

namespace {

// The ring's geometry, shared by K5a and K5b.
template <typename Tx>
struct ScanTile {
  static constexpr int DT = 128 / static_cast<int>(sizeof(Tx));  // columns per block
  static constexpr int TC = 32;                                    // steps per tile
  static constexpr int S = 4;                                      // ring stages
  static constexpr int kCopy = 128;                                // four copy warps
};

// K5a: s <- a*s + b from s0, the product and the sum each rounded once.
template <typename Tx>
struct FwdScan : ScanTile<Tx> {
  static constexpr int kIn = 2, kOut = 1, kCarry = 1, kInit = 1;
  static constexpr bool kReverse = false;
  template <typename X>
  __device__ static __forceinline__ void step(X x, float (&c)[1], float (&y)[1]) {
    c[0] = __fadd_rn(__fmul_rn(x(0), c[0]), x(1));
    y[0] = c[0];
  }
};

// K5b, walking backwards: lam <- g + a_next*lam (c[0] = lam, c[1] = a_next,
// both from 0: lam past T-1 is 0), then a_next <- a.
template <typename Tx>
struct RevScan : ScanTile<Tx> {
  static constexpr int kIn = 2, kOut = 1, kCarry = 2, kInit = 0;
  static constexpr bool kReverse = true;
  template <typename X>
  __device__ static __forceinline__ void step(X x, float (&c)[2], float (&y)[1]) {
    c[0] = __fadd_rn(x(1), __fmul_rn(c[1], c[0]));
    c[1] = x(0);
    y[0] = c[0];
  }
};

template <template <typename> class Step>
int launch(int dtype, const lucy_tile::ScanPlanes& p, int B, int T, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return lucy_tile::launch_ring_scan<Step<float>, float>(p, B, T, D, s);
  if (dtype == 1)
    return lucy_tile::launch_ring_scan<Step<__nv_bfloat16>, __nv_bfloat16>(p, B, T, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns the cudaError_t of its first failed launch (0 on success).
// dtype 0 is float32, 1 bfloat16 (a, b, g and the output).  Any B: the
// launches walk the batch in slices of the grid's 65535 rows.
extern "C" int linear_scan_fwd(int dtype, const void* a, const void* b, const float* s0,
                               void* out, int B, int T, int D, void* stream) {
  return launch<FwdScan>(dtype, {{a, b, nullptr, nullptr}, {s0, nullptr}, {out, nullptr}}, B,
                         T, D, stream);
}

extern "C" int linear_scan_rev(int dtype, const void* a, const void* g, void* out, int B, int T,
                               int D, void* stream) {
  return launch<RevScan>(dtype, {{a, g, nullptr, nullptr}, {nullptr, nullptr}, {out, nullptr}},
                         B, T, D, stream);
}
