// The partial inverse DFT of the Fourier engine for Hopper (sm_90a): K7.
//
// Replaces dau_convnet_tpu/kernels/spectral.py::partial_idft (the Pallas
// kernel `_idft_kernel`). It computes
//
//   table[p, c] = sum_k C[k,p] * tre[k,c] - S[k,p] * tim[k,c]
//
// for the (B, P) iDFT matrices C, S (rounded to the spectra's dtype by the
// wrapper, passed widened to f32 as cs (2, B, P)) and the (B, C) spectra
// tre, tim (f32 or bf16), with f32 sums, into a (P, C) table of f32 or bf16.
// The fused apply-phi (K3) closes with the same kernel on its f32 spectra.
//
// Bound: at AlexNet conv4 (B = 153, P = 81, C = M*S*F = 442,368, bf16) the
// kernel reads 271 MB of spectra and writes a 72 MB table for 21.9 GFLOP, so
// it is bound by bytes (~0.10 ms at 3.35 TB/s) on the tensor cores, but by
// operations on FP32 FMAs (~0.33 ms at 67 TFLOP/s), which this version runs:
//   - one block per 96 p x 128 c output tile (the ragged edges of P and C
//     masked, no padding of the operands): 256 threads, each keeping 6 p x
//     8 c f32 sums in registers;
//   - it walks the bins 16 at a time, staging those rows of C, S (96 p) and
//     of tre, tim (128 c, read once, coalesced along c) in shared memory;
//     per staged bin a thread does 96 FMAs for 12 broadcast loads of C, S
//     and 4 float4 loads of the spectra.
// What it leaves for later: tensor cores (wgmma/mma.sync in bf16, which would
// take it to its byte bound), cp.async double buffering of the stages.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 6;               // p per thread
constexpr int TC = 8;               // c per thread
constexpr int PG = 16;              // p groups per block
constexpr int CG = THREADS / PG;    // c groups per block
constexpr int PT = PG * TP;         // p per block
constexpr int CT = CG * TC;         // c per block
constexpr int KC = 16;              // bins per stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
partial_idft_kernel(const float* __restrict__ cs, const Tin* __restrict__ tre,
                    const Tin* __restrict__ tim, Tout* __restrict__ out, int B, int P,
                    long long C) {
  __shared__ float sa[2][KC][PT];                 // [cos/sin][bin][p]
  __shared__ __align__(16) float sb[2][KC][CT];   // [re/im][bin][c]

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;
  const long long c0 = (long long)blockIdx.x * CT;
  const int p0 = blockIdx.y * PT;

  float acc[TP][TC];
#pragma unroll
  for (int t = 0; t < TP; ++t)
#pragma unroll
    for (int u = 0; u < TC; ++u) acc[t][u] = 0.f;

  for (int k0 = 0; k0 < B; k0 += KC) {
    __syncthreads();  // the previous stage's reads are done
    for (int i = tid; i < 2 * KC * PT; i += THREADS) {
      const int p = i % PT;
      const int r = (i / PT) % KC;
      const int h = i / (KC * PT);
      const int k = k0 + r;
      sa[h][r][p] = (k < B && p0 + p < P) ? cs[((size_t)h * B + k) * P + p0 + p] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2 * KC * CT / THREADS; ++q) {
      const int i = q * THREADS + tid;
      const int c = i % CT;
      const int r = (i / CT) % KC;
      const int h = i / (KC * CT);
      const int k = k0 + r;
      const Tin* src = h ? tim : tre;
      sb[h][r][c] = (k < B && c0 + c < C) ? to_f32(src[(size_t)k * C + c0 + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < KC; ++r) {
      float ac[TP], as[TP], br[TC], bi[TC];
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        ac[t] = sa[0][r][pg * TP + t];
        as[t] = sa[1][r][pg * TP + t];
      }
#pragma unroll
      for (int v = 0; v < TC / 4; ++v) {
        const float4 qr = *reinterpret_cast<const float4*>(&sb[0][r][cg * TC + 4 * v]);
        const float4 qi = *reinterpret_cast<const float4*>(&sb[1][r][cg * TC + 4 * v]);
        br[4 * v] = qr.x; br[4 * v + 1] = qr.y; br[4 * v + 2] = qr.z; br[4 * v + 3] = qr.w;
        bi[4 * v] = qi.x; bi[4 * v + 1] = qi.y; bi[4 * v + 2] = qi.z; bi[4 * v + 3] = qi.w;
      }
#pragma unroll
      for (int t = 0; t < TP; ++t)
#pragma unroll
        for (int u = 0; u < TC; ++u)
          acc[t][u] = fmaf(ac[t], br[u], fmaf(-as[t], bi[u], acc[t][u]));
    }
  }

#pragma unroll
  for (int t = 0; t < TP; ++t) {
    const int p = p0 + pg * TP + t;
    if (p >= P) continue;
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const long long c = c0 + cg * TC + u;
      if (c < C) store(out + (size_t)p * C + c, acc[t][u]);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const float* cs, const void* tre, const void* tim, void* out, int B, int P,
                   long long C, cudaStream_t stream) {
  const dim3 grid((unsigned)((C + CT - 1) / CT), (P + PT - 1) / PT);
  partial_idft_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      cs, static_cast<const Tin*>(tre), static_cast<const Tin*>(tim), static_cast<Tout*>(out),
      B, P, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cs (2, B, P) f32: [C; S]; tre, tim (B, C) in dtype_in; out (P, C) in
// dtype_out (0 f32, 1 bf16). Returns a cudaError_t.
int dau_partial_idft_launch(const void* cs, const void* tre, const void* tim, void* out,
                            int dtype_in, int dtype_out, int B, int P, long long C,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fcs = static_cast<const float*>(cs);
  if (C <= 0 || P <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype_in * 2 + dtype_out) {
    case 0: return (int)launch<float, float>(fcs, tre, tim, out, B, P, C, st);
    case 1: return (int)launch<float, __nv_bfloat16>(fcs, tre, tim, out, B, P, C, st);
    case 2: return (int)launch<__nv_bfloat16, float>(fcs, tre, tim, out, B, P, C, st);
    case 3: return (int)launch<__nv_bfloat16, __nv_bfloat16>(fcs, tre, tim, out, B, P, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
