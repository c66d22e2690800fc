// The fused apply-phi of the Fourier engine for Hopper (sm_90a): K3, first
// of its two launches.
//
// Replaces dau_convnet_tpu/kernels/fused_fwd.py::fused_apply_phi_call (the
// Pallas kernel `_kernel`). K3 is two launches on this card: this kernel
// forms the per-bin products with Phi,
//
//   Phi[k,ci,co] = sum_g round(py_g[k1] * px_g[k2])   (summed in the operand
//                                                      dtype, as the Pallas
//                                                      kernel's phi scratch)
//   Y[k,n,co]    = sum_ci X[k,n,ci] * Phi[k,ci,co]    (complex, f32 sums)
//
// into y (2, B, N, CO) f32 [Yre; Yim], and K7's kernel (dau_partial_idft.cu)
// closes it with the partial iDFT out[ij, (n, co)] = sum_k dct[ij,k] Yre -
// dst[ij,k] Yim. X = xs (B, 2N, CI) re/im-stacked, in f32 or bf16; py_g from
// the rows k1 of t1 (2*P1, NJ) and the two taps of mu2's one-hot (w folded
// in), px_g from the rows k2 of t2 (2*RB, NJ) and the taps of mu1's; the
// wrapper rounds tables and tap weights to the operand dtype. The input
// gradient is the same kernel with CI = F, CO = S and sin-negated tables.
//
// What the Pallas kernel keeps out of device memory is Phi (B*CI*CO complex,
// 90 MB in bf16 at AlexNet conv4); so does this one. Y (15 MB f32 at conv4,
// N = 32) goes to device memory for the second launch.
//
// Bound: the per-bin products, 4 FMAs per (k, n, ci, co) (5.8 GFLOP at
// conv4, N = 32), on 15 MB of bf16 spectra: bound by operations, ~0.006 ms
// on the tensor cores, ~0.09 ms on FP32 FMAs, which this version runs. One
// block per (bin, 32 co): per 32 images and 32 ci it builds the Phi tile
// (32 ci x 32 co, complex) in shared memory from the taps (read from device
// memory, coalesced along co) and the two table rows of its bin, stages X's
// 32 x 32 complex tile, and each thread accumulates 2 n x 4 co complex sums,
// 16 FMAs per ci for 2 float4 and 4 scalar shared loads. A block rebuilds
// its Phi tiles for every 32 images beyond the first 32. What it leaves for
// later: tensor cores for the products, the taps read once per block rather
// than once per bin.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CO_T = 32;          // co per block
constexpr int N_T = 32;           // images per pass
constexpr int CI_C = 32;          // ci per stage
constexpr int NJ_MAX = 64;        // largest exponent table width

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// idx (2, G, CI, CO) int: tap index of mu1's one-hot (into t2), of mu2's
// (into t1); wts (4, G, CI, CO) f32: their weights at j and j+1, mu1's then
// mu2's (w folded in). y (2, B, N, CO) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
apply_phi_kernel(const T* __restrict__ xs, const float* __restrict__ t1,
                 const float* __restrict__ t2, const int* __restrict__ idx,
                 const float* __restrict__ wts, float* __restrict__ y, int N, int CI, int CO,
                 int G, int P1, int RB, int NJ) {
  __shared__ float tab[4][NJ_MAX];                          // t1 cos, sin row k1; t2 row k2
  __shared__ __align__(16) float phr[CI_C][CO_T], phm[CI_C][CO_T];   // [ci][co]
  __shared__ float sx[2][N_T][CI_C + 1];                    // [re/im][n][ci]

  const int tid = threadIdx.x;
  const int cg = tid % 8;            // co = cg*4 + [0, 4)
  const int ng = tid / 8;            // n = ng*2 + [0, 2)
  const int co0 = blockIdx.x * CO_T;
  const int k = blockIdx.y;
  const int B = gridDim.y;
  const int k1 = k / RB;
  const int k2 = k - k1 * RB;
  const size_t CC = (size_t)CI * CO;
  const size_t GCC = (size_t)G * CC;

  for (int i = tid; i < NJ; i += THREADS) {
    tab[0][i] = t1[k1 * NJ + i];
    tab[1][i] = t1[(P1 + k1) * NJ + i];
    tab[2][i] = t2[k2 * NJ + i];
    tab[3][i] = t2[(RB + k2) * NJ + i];
  }

  for (int n0 = 0; n0 < N; n0 += N_T) {
    const int nc = min(N_T, N - n0);
    float yr[2][4], yi[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) yr[a][u] = yi[a][u] = 0.f;

    for (int ci0 = 0; ci0 < CI; ci0 += CI_C) {
      __syncthreads();  // the previous stage's reads are done (and tab is in)
      for (int i = tid; i < CI_C * CO_T; i += THREADS) {
        const int c = i / CO_T;
        const int o = i % CO_T;
        float vr = 0.f, vi = 0.f;
        if (ci0 + c < CI && co0 + o < CO) {
          for (int g = 0; g < G; ++g) {
            const size_t gi = g * CC + (size_t)(ci0 + c) * CO + co0 + o;
            const int j1 = idx[gi];
            const int j2 = idx[GCC + gi];
            const float a0 = wts[gi], a1 = wts[GCC + gi];
            const float b0 = wts[2 * GCC + gi], b1 = wts[3 * GCC + gi];
            const float pyre = fmaf(tab[0][j2 + 1], b1, tab[0][j2] * b0);
            const float pyim = fmaf(tab[1][j2 + 1], b1, tab[1][j2] * b0);
            const float pxre = fmaf(tab[2][j1 + 1], a1, tab[2][j1] * a0);
            const float pxim = fmaf(tab[3][j1 + 1], a1, tab[3][j1] * a0);
            const float pre = round_as(pyre * pxre - pyim * pxim, T());
            const float pim = round_as(pyre * pxim + pyim * pxre, T());
            vr = g == 0 ? pre : round_as(vr + pre, T());
            vi = g == 0 ? pim : round_as(vi + pim, T());
          }
        }
        phr[c][o] = vr;
        phm[c][o] = vi;
      }
      for (int i = tid; i < 2 * N_T * CI_C; i += THREADS) {
        const int c = i % CI_C;
        const int r = (i / CI_C) % N_T;
        const int h = i / (N_T * CI_C);
        float v = 0.f;
        if (r < nc && ci0 + c < CI)
          v = to_f32(xs[((size_t)k * 2 * N + h * N + n0 + r) * CI + ci0 + c]);
        sx[h][r][c] = v;
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < CI_C; ++c) {
        const float4 qr = *reinterpret_cast<const float4*>(&phr[c][cg * 4]);
        const float4 qi = *reinterpret_cast<const float4*>(&phm[c][cg * 4]);
        const float pr[4] = {qr.x, qr.y, qr.z, qr.w};
        const float pi[4] = {qi.x, qi.y, qi.z, qi.w};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float xr = sx[0][ng * 2 + a][c];
          const float xi = sx[1][ng * 2 + a][c];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            yr[a][u] = fmaf(xr, pr[u], fmaf(-xi, pi[u], yr[a][u]));
            yi[a][u] = fmaf(xr, pi[u], fmaf(xi, pr[u], yi[a][u]));
          }
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (ng * 2 + a >= nc) continue;
      const int n = n0 + ng * 2 + a;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int co = co0 + cg * 4 + u;
        if (co >= CO) continue;
        y[((size_t)k * N + n) * CO + co] = yr[a][u];
        y[((size_t)(B + k) * N + n) * CO + co] = yi[a][u];
      }
    }
  }
}

}  // namespace

extern "C" {

// xs (B, 2N, CI) in dtype (0 f32, 1 bf16); t1 (2*P1, NJ), t2 (2*RB, NJ) f32;
// idx (2, G, CI, CO) int32; wts (4, G, CI, CO) f32; y (2, B, N, CO) f32.
// NJ <= 64. Returns a cudaError_t.
int dau_apply_phi_launch(const void* xs, const void* t1, const void* t2, const void* idx,
                         const void* wts, void* y, int dtype, int B, int N, int CI, int CO,
                         int G, int P1, int RB, int NJ, void* stream) {
  if (NJ > NJ_MAX || B != P1 * RB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((CO + CO_T - 1) / CO_T, B);
  const float* ft1 = static_cast<const float*>(t1);
  const float* ft2 = static_cast<const float*>(t2);
  const int* ii = static_cast<const int*>(idx);
  const float* fw = static_cast<const float*>(wts);
  float* fy = static_cast<float*>(y);
  if (dtype == 0)
    apply_phi_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(xs), ft1, ft2, ii, fw, fy, N, CI, CO, G, P1, RB, NJ);
  else if (dtype == 1)
    apply_phi_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xs), ft1, ft2, ii, fw, fy, N, CI, CO, G, P1, RB, NJ);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
