// The fused lane-major chunkwise mLSTM for Hopper (sm_90a): K9a and K9b.  The
// chunk math, its contract, bound and design are in mlstm_chunk.cuh.
//
// Replaces the TPU kernels of statecatcher_tpu/ops/mlstm_fused.py:
//   K9a  mlstm_fwd_kernel  <- _fwd_kernel (:158), launched by _fused_fwd_impl (:199)
//   K9b  mlstm_fwd_kernel (entry states only), then mlstm_bwd_kernel
//                          <- _bwd_kernel (:251), launched by _fused_bwd_impl (:322)
//
// Layout: q, k (B, Tp, H*dqk), v, h, dh (B, Tp, H*dv) in the model dtype
// (float32 or bfloat16; head h is the column slice [h*d, (h+1)*d)); the
// gates ic, lf and their adjoints (B, H, Tp) f32; states (B, H, dqk, dv),
// (B, H, dqk), (B, H) f32.  q is scaled by dqk^-1/2 inside.
//
// K9b's backward walk (mlstm_bwd_kernel, one block per (b, head)) takes, per
// chunk in reverse, the adjoint of the chunk step in passes, as
// ops/mlstm_fused.py:mlstm_chunk_bwd_ref writes it:
//   1. S = inv q k^T and G = dh v^T (t >= s), U = C dh, Y = dC' v, Z = dC'^T k;
//   2. per row t: den, dqn (|qn| vs exp(-mu): sign(qn), ties halved), dmu from
//      the denominator, dsp, dw = k . (Y + dn'); dg = <dC', C> + <dn', n>;
//   3. Q = E (G/den + dqn) (= dS + dqn E), dD = S Q, its row and column sums;
//   4. dq = inv Q k + inv sp (dqn n + U/den); dk = inv Q^T q + w (Y + dn');
//      dv = (W/den)^T dh + w Z; then dC = g dC' + inv sum_t (sp/den) q dh^T
//      and dn = g dn' + inv sum_t sp dqn q;
//   5. the gate chain's scalars (thread 0): mu, sp, the two maxima, the
//      running max R (each tie an equal share), a = i - b and the reverse
//      cumulative sum of db -> dlogf.
// dq, dk, dv, dic, dlf are 0 on rows t >= T.

#include <cmath>

#include "mlstm_chunk.cuh"

namespace mlstm {
namespace {

struct BwdParams {
  const void *q, *k, *v, *dh;
  const float *ic, *lf, *dCT, *dnT, *dmT;
  void *dq, *dk, *dv;
  float *dic, *dlf, *dC0, *dn0, *dm0;
  float* work;              // per (b, head): entry states, then S, Q, U, Y, Z
  long long work_stride;
  Layout lay;
  int H, Tp, T, dqk, dv_, L;
  float inv;
};

constexpr int kRowArrays = 11;    // den dqn dmu dsp dw rowD colD db da dR cnt

inline size_t bwd_smem_bytes(int dqk, int L) {
  return sizeof(float) * (6 * L + 4 + kRowArrays * L + dqk + kThreads + kStage);
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_kernel(BwdParams p) {
  extern __shared__ float sm[];
  const int L = p.L, dqk = p.dqk, dv = p.dv_, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / p.H, hh = bh % p.H;
  const Gates G(sm, L);
  float* rden = G.sc + 4;
  float* rdqn = rden + L;
  float* rdmu = rdqn + L;
  float* rdsp = rdmu + L;
  float* rdw = rdsp + L;
  float* rowD = rdw + L;
  float* colD = rowD + L;
  float* db = colD + L;
  float* da = db + L;
  float* dR = da + L;
  float* cnt = dR + L;
  float* dns = cnt + L;                  // exit adjoint of n (dqk)
  float* red = dns + dqk;                // kThreads
  float* stage = red + kThreads;

  const Layout& y = p.lay;
  const long long qoff = b * y.qk_b + hh * y.qk_h, voff = b * y.v_b + hh * y.v_h;
  Rows<Tin> rows{static_cast<const Tin*>(p.q) + qoff, static_cast<const Tin*>(p.k) + qoff,
                 static_cast<const Tin*>(p.v) + voff, y.qk_r, y.v_r, 0, p.T, L};
  const Tin* dh = static_cast<const Tin*>(p.dh) + voff;
  Tin* dq = static_cast<Tin*>(p.dq) + qoff;
  Tin* dk = static_cast<Tin*>(p.dk) + qoff;
  Tin* dvo = static_cast<Tin*>(p.dv) + voff;
  const float* ic = p.ic + static_cast<size_t>(bh) * p.Tp;
  const float* lf = p.lf + static_cast<size_t>(bh) * p.Tp;
  const int NC = p.Tp / L;
  float* wk = p.work + bh * p.work_stride;
  const float* Cent = wk;
  const float* nent = Cent + static_cast<size_t>(NC) * dqk * dv;
  const float* ment = nent + static_cast<size_t>(NC) * dqk;
  float* Sg = wk + static_cast<size_t>(NC) * (static_cast<size_t>(dqk) * dv + dqk + 1);
  float* Qg = Sg + L * L;
  float* Ug = Qg + L * L;
  float* Yg = Ug + L * dqk;
  float* Zg = Yg + L * dqk;
  const size_t sC = static_cast<size_t>(bh) * dqk * dv;
  float* Lam = p.dC0 + sC;               // the exit adjoint of C, entry adjoint at the end
  for (size_t e = tid; e < static_cast<size_t>(dqk) * dv; e += kThreads) Lam[e] = p.dCT[sC + e];
  for (int d = tid; d < dqk; d += kThreads) dns[d] = p.dnT[static_cast<size_t>(bh) * dqk + d];
  float dm = p.dmT[bh];
  __syncthreads();

  auto DH = [&](int t, int c) {
    return rows.valid(t) ? ld(dh + static_cast<size_t>(rows.t0 + t) * y.v_r + c) : 0.f;
  };
  auto Ef = [&](int t, int s) { return s <= t ? expf(G.b[t] + G.a[s] - G.mu[t]) : 0.f; };

  for (int c = NC - 1; c >= 0; --c) {
    rows.t0 = c * L;
    const float m = ment[c];
    const float* Cc = Cent + static_cast<size_t>(c) * dqk * dv;
    const float* nc = nent + static_cast<size_t>(c) * dqk;
    gate_prep(ic, lf, rows.t0, p.T, L, m, G);
    const float bL = G.sc[0], A = G.sc[1], g = G.sc[3];

    // 1. S, G (lower triangle of 64-tiles), U = C dh, Y = dC' v, Z = dC'^T k
    for (int t0 = 0; t0 < L; t0 += kTile)
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        float acc[4][4] = {};
        tile_mma<true, false>(
            0, dqk, [&](int mm, int d) { return rows.Q(t0 + mm, d); },
            [&](int d, int nn) { return rows.K(s0 + nn, d); }, stage, acc);
        float acg[4][4] = {};
        tile_mma<true, false>(
            0, dv, [&](int mm, int cc) { return DH(t0 + mm, cc); },
            [&](int cc, int nn) { return rows.V(s0 + nn, cc); }, stage, acg);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + ty + 16 * i, s = s0 + tx + 16 * j;
            if (t < L && s < L) {
              Sg[t * L + s] = s <= t ? acc[i][j] * p.inv : 0.f;
              Qg[t * L + s] = s <= t ? acg[i][j] : 0.f;      // G for now
            }
          }
      }
    for (int t0 = 0; t0 < L; t0 += kTile)
      for (int d0 = 0; d0 < dqk; d0 += kTile) {
        float au[4][4] = {}, ay[4][4] = {};
        tile_mma<true, false>(
            0, dv, [&](int mm, int cc) { return DH(t0 + mm, cc); },
            [&](int cc, int nn) {
              return d0 + nn < dqk ? Cc[static_cast<size_t>(d0 + nn) * dv + cc] : 0.f;
            },
            stage, au);
        tile_mma<true, false>(
            0, dv, [&](int mm, int cc) { return rows.V(t0 + mm, cc); },
            [&](int cc, int nn) {
              return d0 + nn < dqk ? Lam[static_cast<size_t>(d0 + nn) * dv + cc] : 0.f;
            },
            stage, ay);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + ty + 16 * i, d = d0 + tx + 16 * j;
            if (t < L && d < dqk) {
              Ug[t * dqk + d] = au[i][j];
              Yg[t * dqk + d] = ay[i][j];
            }
          }
      }
    for (int t0 = 0; t0 < L; t0 += kTile)
      for (int v0 = 0; v0 < dv; v0 += kTile) {
        float acc[4][4] = {};
        tile_mma<true, true>(
            0, dqk, [&](int mm, int d) { return rows.K(t0 + mm, d); },
            [&](int d, int nn) {
              return v0 + nn < dv ? Lam[static_cast<size_t>(d) * dv + v0 + nn] : 0.f;
            },
            stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + ty + 16 * i, cc = v0 + tx + 16 * j;
            if (t < L && cc < dv) Zg[static_cast<size_t>(t) * dv + cc] = acc[i][j];
          }
      }
    // dg = <dC', C> + <dn', n>: fixed-order partial sums, then a tree
    {
      float part = 0.f;
      for (size_t e = tid; e < static_cast<size_t>(dqk) * dv; e += kThreads) part += Lam[e] * Cc[e];
      for (int d = tid; d < dqk; d += kThreads) part += dns[d] * nc[d];
      red[tid] = part;
    }
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    const float dg = red[0];

    // 2. per row: the denominator's adjoints, dsp, dw (one warp per row)
    for (int t = warp; t < L; t += kThreads / 32) {
      float sw = 0.f, swg = 0.f, qn_ = 0.f, qU = 0.f, kY = 0.f;
      for (int s = lane; s <= t; s += 32) {
        const float W = Sg[t * L + s] * Ef(t, s);
        sw += W;
        swg += W * Qg[t * L + s];
      }
      for (int d = lane; d < dqk; d += 32) {
        const float qv = rows.Q(t, d);
        qn_ += qv * nc[d];
        qU += qv * Ug[t * dqk + d];
        kY += rows.K(t, d) * (Yg[t * dqk + d] + dns[d]);
      }
      sw = warp_sum(sw);
      swg = warp_sum(swg);
      qn_ = warp_sum(qn_);
      qU = warp_sum(qU);
      kY = warp_sum(kY);
      if (lane == 0) {
        const float qn = sw + G.sp[t] * p.inv * qn_, emu = expf(-G.mu[t]);
        const float den = fmaxf(fabsf(qn), emu);
        const float dden = -(swg + G.sp[t] * p.inv * qU) / (den * den);
        const float toq = to_first(fabsf(qn), emu);
        const float dqn = dden * toq * static_cast<float>((qn > 0.f) - (qn < 0.f));
        rden[t] = den;
        rdqn[t] = dqn;
        rdmu[t] = -dden * (1.f - toq) * emu;
        rdsp[t] = p.inv * qU / den + p.inv * dqn * qn_;
        rdw[t] = kY;
      }
    }
    __syncthreads();

    // 3. Q = E (G/den + dqn); dD = S Q: row sums, then column sums
    for (int t = warp; t < L; t += kThreads / 32) {
      float rs = 0.f;
      for (int s = lane; s <= t; s += 32) {
        const float qv = Ef(t, s) * (Qg[t * L + s] / rden[t] + rdqn[t]);
        Qg[t * L + s] = qv;
        rs += Sg[t * L + s] * qv;
      }
      rs = warp_sum(rs);
      if (lane == 0) rowD[t] = rs;
    }
    __syncthreads();
    for (int s = tid; s < L; s += kThreads) {
      float cs = 0.f;
      for (int t = s; t < L; ++t) cs += Sg[t * L + s] * Qg[t * L + s];
      colD[s] = cs;
    }

    // 4. dq, dk, dv of the chunk's rows
    for (int t0 = 0; t0 < L; t0 += kTile)
      for (int d0 = 0; d0 < dqk; d0 += kTile) {
        float acc[4][4] = {};
        tile_mma<true, true>(
            0, min(L, t0 + kTile),
            [&](int mm, int s) { return t0 + mm < L ? Qg[(t0 + mm) * L + s] : 0.f; },
            [&](int s, int nn) { return d0 + nn < dqk ? rows.K(s, d0 + nn) : 0.f; }, stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + ty + 16 * i, d = d0 + tx + 16 * j;
            if (t < L && d < dqk)
              st(dq + static_cast<size_t>(rows.t0 + t) * y.qk_r + d,
                 rows.valid(t) ? p.inv * acc[i][j] + p.inv * G.sp[t] *
                                     (rdqn[t] * nc[d] + Ug[t * dqk + d] / rden[t])
                               : 0.f);
          }
      }
    for (int s0 = 0; s0 < L; s0 += kTile)
      for (int d0 = 0; d0 < dqk; d0 += kTile) {
        float acc[4][4] = {};
        tile_mma<false, true>(
            s0, L, [&](int mm, int t) { return s0 + mm < L ? Qg[t * L + s0 + mm] : 0.f; },
            [&](int t, int nn) { return d0 + nn < dqk ? rows.Q(t, d0 + nn) : 0.f; }, stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + ty + 16 * i, d = d0 + tx + 16 * j;
            if (s < L && d < dqk)
              st(dk + static_cast<size_t>(rows.t0 + s) * y.qk_r + d,
                 rows.valid(s) ? p.inv * acc[i][j] + G.w[s] * (Yg[s * dqk + d] + dns[d]) : 0.f);
          }
      }
    for (int s0 = 0; s0 < L; s0 += kTile)
      for (int v0 = 0; v0 < dv; v0 += kTile) {
        float acc[4][4] = {};
        tile_mma<false, true>(
            s0, L,
            [&](int mm, int t) {
              const int s = s0 + mm;
              return s < L ? Sg[t * L + s] * Ef(t, s) / rden[t] : 0.f;
            },
            [&](int t, int nn) { return v0 + nn < dv ? DH(t, v0 + nn) : 0.f; }, stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + ty + 16 * i, cc = v0 + tx + 16 * j;
            if (s < L && cc < dv)
              st(dvo + static_cast<size_t>(rows.t0 + s) * y.v_r + cc,
                 rows.valid(s) ? acc[i][j] + G.w[s] * Zg[static_cast<size_t>(s) * dv + cc] : 0.f);
          }
      }
    // the entry adjoints of C and n (dC' and dn' are read for the last time above)
    for (int d0 = 0; d0 < dqk; d0 += kTile)
      for (int v0 = 0; v0 < dv; v0 += kTile) {
        float acc[4][4] = {};
        tile_mma<false, true>(
            0, L,
            [&](int mm, int t) {
              return d0 + mm < dqk ? rows.Q(t, d0 + mm) * (G.sp[t] / rden[t] * p.inv) : 0.f;
            },
            [&](int t, int nn) { return v0 + nn < dv ? DH(t, v0 + nn) : 0.f; }, stage, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = d0 + ty + 16 * i, cc = v0 + tx + 16 * j;
            if (d < dqk && cc < dv) {
              float* x = Lam + static_cast<size_t>(d) * dv + cc;
              *x = g * *x + acc[i][j];
            }
          }
      }
    for (int d = tid; d < dqk; d += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < L; ++t) sum += G.sp[t] * rdqn[t] * rows.Q(t, d);
      red[d] = g * dns[d] + p.inv * sum;       // dqk <= kThreads (the wrapper checks)
    }
    __syncthreads();
    for (int d = tid; d < dqk; d += kThreads) dns[d] = red[d];
    __syncthreads();

    // 5. the gate chain
    for (int t = tid; t < L; t += kThreads) {
      float n_hit = 0.f;
      for (int s = 0; s <= t; ++s) n_hit += G.a[s] == G.R[t] ? 1.f : 0.f;
      cnt[t] = n_hit;
    }
    if (tid == 0) {
      float dmc = 0.f, dbL = 0.f, sum_dz = 0.f;
      for (int t = 0; t < L; ++t) {
        const float dX = rdsp[t] * G.sp[t];
        const float dmu = rdmu[t] - rowD[t] - dX;
        db[t] = rowD[t] + dX + dmu;
        const float tom = to_first(m, G.R[t]);
        dmc += dX + dmu * tom;
        dR[t] = dmu * (1.f - tom);
        const float dZ = rdw[t] * G.w[t];
        da[t] = colD[t] + dZ;
        sum_dz += dZ;
      }
      const float dY = dg * g;
      dbL = sum_dz + dY;
      dmc += dY;
      const float dm_tot = dm - sum_dz - dY;
      const float to1 = to_first(m + bL, bL + A);
      dmc += dm_tot * to1;
      dbL += dm_tot;
      dR[L - 1] += dm_tot * (1.f - to1);
      red[0] = dmc;
      red[1] = dbL;
    }
    __syncthreads();
    for (int s = tid; s < L; s += kThreads) {
      float add = 0.f;
      for (int t = s; t < L; ++t)
        if (G.a[s] == G.R[t]) add += dR[t] / cnt[t];
      da[s] += add;
    }
    __syncthreads();
    if (tid == 0) {
      dm = red[0];
      db[L - 1] += red[1];
      float run = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        run += db[t] - da[t];
        const bool valid = rows.t0 + t < p.T;
        p.dic[static_cast<size_t>(bh) * p.Tp + rows.t0 + t] = valid ? da[t] : 0.f;
        p.dlf[static_cast<size_t>(bh) * p.Tp + rows.t0 + t] = valid ? run : 0.f;
      }
      red[0] = dm;
    }
    __syncthreads();
    dm = red[0];
    __syncthreads();
  }

  for (int d = tid; d < dqk; d += kThreads) p.dn0[static_cast<size_t>(bh) * dqk + d] = dns[d];
  if (tid == 0) p.dm0[bh] = dm;
}

Layout lane_layout(int H, int Tp, int dqk, int dv) {
  const long long Gq = static_cast<long long>(H) * dqk, Gv = static_cast<long long>(H) * dv;
  return {Tp * Gq, dqk, Gq, Tp * Gv, dv, Gv};
}

float inv_sqrt(int d) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))); }

template <typename Tin>
int launch_bwd(const BwdParams& p, int B, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(p.dqk, p.L);
  cudaError_t err = cudaFuncSetAttribute(mlstm_bwd_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_kernel<Tin><<<B * p.H, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mlstm

using namespace mlstm;

// Each returns the first cudaError_t of its launches (0 on success).  dtype 0
// is float32, 1 bfloat16 (q, k, v, h, dh, dq, dk, dv).  L must divide Tp,
// T > Tp - L, and L and dqk be at most 256 (the wrapper checks).
extern "C" int mlstm_fused_fwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, void* h, float* CT, float* nT, float* mT, int B,
                               int H, int Tp, int T, int dqk, int dv, int L, void* stream) {
  FwdParams p{q,  k,  v,  ic, lf, C0,      n0, m0, h, CT, nT, mT, nullptr, 0,
              lane_layout(H, Tp, dqk, dv), H,  Tp, T, dqk, dv, L,  inv_sqrt(dqk)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, float>(p, B, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// work: per (b, head), NC*(dqk*dv + dqk + 1) + 2*L*L + 2*L*dqk + L*dv floats.
extern "C" int mlstm_fused_bwd(int dtype, const void* q, const void* k, const void* v,
                               const float* ic, const float* lf, const float* C0, const float* n0,
                               const float* m0, const void* dh, const float* dCT,
                               const float* dnT, const float* dmT, void* dq, void* dk, void* dv,
                               float* dic, float* dlf, float* dC0, float* dn0, float* dm0,
                               float* work, int B, int H, int Tp, int T, int dqk, int dv_, int L,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int NC = Tp / L;
  const long long stride = static_cast<long long>(NC) * (static_cast<long long>(dqk) * dv_ + dqk + 1) +
                           2LL * L * L + 2LL * L * dqk + static_cast<long long>(L) * dv_;
  const Layout lay = lane_layout(H, Tp, dqk, dv_);
  // phase 1: each chunk's entry state (C_T, n_T, m_T land in dC0, dn0, dm0
  // and are overwritten below)
  FwdParams f{q,   k,  v,  ic, lf,  C0, n0, m0, nullptr, dC0, dn0, dm0, work, stride,
              lay, H,  Tp, T,  dqk, dv_, L, inv_sqrt(dqk)};
  auto s = static_cast<cudaStream_t>(stream);
  int err = dtype == 0 ? launch_fwd<float, float>(f, B, s)
                       : launch_fwd<__nv_bfloat16, __nv_bfloat16>(f, B, s);
  if (err != 0) return err;
  BwdParams p{q,   k,   v,   dh,  ic,   lf,  dCT, dnT, dmT, dq,     dk,  dv, dic, dlf,
              dC0, dn0, dm0, work, stride, lay, H,  Tp,  T,   dqk,    dv_, L,  inv_sqrt(dqk)};
  return dtype == 0 ? launch_bwd<float>(p, B, s) : launch_bwd<__nv_bfloat16>(p, B, s);
}
