// Shared pieces of the FP32-FMA spectral-gradient kernels for Hopper
// (sm_90a): K8 (dau_factored_grads.cu, the factored gather) and, for
// `THREADS`, `to_f32` and `round_as`, K2's dx kernel and K1
// (dau_spectral_grads.cu; K1's cross-spectra run on the tensor cores and
// use none of the block layout below). A block owns ST s x FT f of the
// unit gradients and walks a range of bins itself. It stages both phase
// tables and its units' bilinear taps in shared memory (`stage_block`)
// and, per bin, forms the cross-spectra of its (s, f) in registers
// (`cross_bin`):
//
//   Tre[k,m,s,f] = sum_n Xre*Ere + Xim*Eim     Tim = sum_n Xim*Ere - Xre*Eim
//
// with X = xs (B, M, 2N, S) and E = es (B, 2N, F) re/im-stacked, f32 sums.
// The two kernels differ in what they do with T.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dau_spectral {

constexpr int THREADS = 128;
constexpr int FGROUPS = 8;            // f groups per block
constexpr int SGROUPS = THREADS / FGROUPS;
constexpr int TF = 4;                 // f per thread
constexpr int FT = FGROUPS * TF;      // f per block
constexpr int NC = 16;                // images staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a value rounded to T and widened back
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Shared-memory plan of a block that gives each thread TS s, shared by the
// host launcher and the kernel.
struct Plan {
  int st;     // s per block
  int tab;    // floats of the two phase tables, rounded to 4
  int units;  // (s, f, g) units per block
  int sx;     // floats of the xs stage [M][2*NC][st]
  int se;     // floats of the es stage [2*NC][FT]
};

__host__ __device__ inline Plan make_plan(int M, int G, int P1, int RB, int NJ, int TS) {
  Plan p;
  p.st = SGROUPS * TS;
  p.tab = round4(2 * (P1 + RB) * NJ);
  p.units = G * p.st * FT;
  p.sx = M * 2 * NC * p.st;
  p.se = 2 * NC * FT;
  return p;
}

__host__ __device__ inline long long plan_bytes(const Plan& p) {
  return 4LL * (p.tab + 6LL * p.units + p.sx + p.se);
}

// The block's shared memory, laid out by its plan.
struct Smem {
  float* t1;  // [2*P1][NJ] axis-1 [cos; sin]
  float* t2;  // [2*RB][NJ] axis-2 [cos; sin], rfft coefficient folded
  int* j;     // [2][G][ST][FT] tap index of mu1 (into t2), of mu2 (into t1)
  float* w;   // [4][G][ST][FT] their weights at j and j+1, mu1 then mu2
  float* sx;  // [M][2*NC][ST] xs stage
  float* se;  // [2*NC][FT] es stage
};

// Lays out the dynamic shared memory and stages the tables t1 (2*P1, NJ),
// t2 (2*RB, NJ) and the taps of the block's units from idx (2, G, S, F) and
// wts (4, G, S, F), zero outside S and F. The first __syncthreads of
// `cross_bin` publishes them.
__device__ inline Smem stage_block(float* smem, const Plan& pl, const float* __restrict__ t1,
                                   const float* __restrict__ t2, const int* __restrict__ idx,
                                   const float* __restrict__ wts, int G, int S, int F, int P1,
                                   int RB, int NJ, int s0, int f0) {
  Smem sm;
  sm.t1 = smem;
  sm.t2 = smem + 2 * P1 * NJ;
  sm.j = reinterpret_cast<int*>(smem + pl.tab);
  sm.w = smem + pl.tab + 2 * pl.units;
  sm.sx = sm.w + 4 * pl.units;
  sm.se = sm.sx + pl.sx;
  const int tid = threadIdx.x;
  const size_t SF = (size_t)S * F;
  const size_t GSF = (size_t)G * SF;
  for (int i = tid; i < 2 * P1 * NJ; i += THREADS) sm.t1[i] = t1[i];
  for (int i = tid; i < 2 * RB * NJ; i += THREADS) sm.t2[i] = t2[i];
  for (int i = tid; i < pl.units; i += THREADS) {
    const int g = i / (pl.st * FT);
    const int r = i - g * pl.st * FT;
    const int s = s0 + r / FT;
    const int f = f0 + r % FT;
    const bool ok = s < S && f < F;
    const size_t gi = g * SF + (size_t)s * F + f;
    sm.j[i] = ok ? idx[gi] : 0;
    sm.j[pl.units + i] = ok ? idx[GSF + gi] : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) sm.w[q * pl.units + i] = ok ? wts[q * GSF + gi] : 0.f;
  }
  return sm;
}

// T of bin k at the thread's TS s x TF f (thread (sg, fg) = (tid / FGROUPS,
// tid % FGROUPS) owns s = s0 + sg*TS + t, f = f0 + fg*TF + u), f32 sums over
// the N images, unrounded. Per pass it stages NC images of xs (the block's s
// tile) and es (its f tile) in shared memory; every thread of the block
// must call it.
template <typename T, int M, int TS>
__device__ __forceinline__ void cross_bin(const T* __restrict__ xs, const T* __restrict__ es,
                                          const Smem& sm, int k, int N, int S, int F, int s0,
                                          int f0, float (&tre)[M][TS][TF],
                                          float (&tim)[M][TS][TF]) {
  constexpr int ST = SGROUPS * TS;
  const int tid = threadIdx.x;
  const int fg = tid % FGROUPS;
  const int sg = tid / FGROUPS;
  const int N2 = 2 * N;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int t = 0; t < TS; ++t)
#pragma unroll
      for (int u = 0; u < TF; ++u) tre[m][t][u] = tim[m][t][u] = 0.f;

  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    __syncthreads();  // the previous stage's reads are done
    // xs rows [n0, n0 + nc) (re) and [N + n0, N + n0 + nc) (im) of each m,
    // columns [s0, s0 + ST); stage row r < nc is re, r >= nc im. Each
    // thread owns one column and every (THREADS/ST)-th row: no division,
    // and the unrolled loads are all in flight before the stores.
    {
      constexpr int XR = THREADS / ST;  // rows per pass
      const int s = tid % ST;
      const bool s_ok = s0 + s < S;
      float v[M][2 * NC / XR];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const T* src = xs + ((size_t)k * M + m) * N2 * S + s0 + s;
#pragma unroll
        for (int q = 0; q < 2 * NC / XR; ++q) {
          const int r = q * XR + tid / ST;
          const int row = r < nc ? n0 + r : N + n0 + r - nc;
          v[m][q] = (r < 2 * nc && s_ok) ? to_f32(src[(size_t)row * S]) : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int q = 0; q < 2 * NC / XR; ++q)
          sm.sx[(m * 2 * NC + q * XR + tid / ST) * ST + s] = v[m][q];
    }
    {
      constexpr int ER = THREADS / FT;
      const int f = tid % FT;
      const bool f_ok = f0 + f < F;
      const T* src = es + (size_t)k * N2 * F + f0 + f;
#pragma unroll
      for (int q = 0; q < 2 * NC / ER; ++q) {
        const int r = q * ER + tid / FT;
        const int row = r < nc ? n0 + r : N + n0 + r - nc;
        sm.se[r * FT + f] = (r < 2 * nc && f_ok) ? to_f32(src[(size_t)row * F]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < nc; ++i) {
      const float4 qr = *reinterpret_cast<const float4*>(sm.se + i * FT + fg * TF);
      const float4 qi = *reinterpret_cast<const float4*>(sm.se + (nc + i) * FT + fg * TF);
      const float er[TF] = {qr.x, qr.y, qr.z, qr.w};
      const float ei[TF] = {qi.x, qi.y, qi.z, qi.w};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float xr[TS], xi[TS];
#pragma unroll
        for (int t = 0; t < TS; ++t) {
          xr[t] = sm.sx[(m * 2 * NC + i) * ST + sg * TS + t];
          xi[t] = sm.sx[(m * 2 * NC + nc + i) * ST + sg * TS + t];
        }
#pragma unroll
        for (int t = 0; t < TS; ++t)
#pragma unroll
          for (int u = 0; u < TF; ++u) {
            tre[m][t][u] = fmaf(xr[t], er[u], fmaf(xi[t], ei[u], tre[m][t][u]));
            tim[m][t][u] = fmaf(xi[t], er[u], fmaf(-xr[t], ei[u], tim[m][t][u]));
          }
      }
    }
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, preferring
// shared memory over L1.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Ranges of `units` (bins, or k1 rows) so that a grid of `blocks` tiles per
// range fills the card about once, at `per_sm` resident blocks of `kernel`
// per SM: the count (>= 1, <= units, none empty), or -cudaError.
template <typename K>
int fill_ranges(K kernel, size_t smem, int blocks, int units) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = set_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  int r = (per_sm * sms) / blocks;
  r = r < 1 ? 1 : (r > units ? units : r);
  return (units + ((units + r - 1) / r) - 1) / ((units + r - 1) / r);
}

}  // namespace dau_spectral
