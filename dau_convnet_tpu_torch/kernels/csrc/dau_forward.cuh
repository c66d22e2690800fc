// DAU forward for Hopper (sm_90a): displaced aggregation with the Gaussian
// blur fused in front of it (K5, built from dau_forward_fused.cu).
//
// Replaces dau_convnet_tpu/kernels/forward.py::dau_forward_fused_pallas (the
// Pallas kernel `_fused_kernel`). It computes the same function, not the
// same blocks:
//
//   xb[n,s]   = blur(x[n,s]) with the kb x kb filter under zero padding, and
//               zero OUTSIDE the image (the aggregation reads zeros there, not
//               the blur of the padding);
//   y[n,f,i,j] = sum_s sum_{ky,kx} K[s,ky*ks+kx,f] * xb[n,s,i+ky-c,j+kx-c],
//               c = ks/2, with K the synthesized aggregation kernel that the
//               wrapper builds outside the kernel.
//
// Bound: in this dense form the kernel is FLOP-bound. It does 2*ks^2*S*F*H*W
// FLOPs per image (ks = 9: 12.3 GFLOP per AlexNet-DAU image) on a few
// hundred KB of input, far above the card's operations-per-byte line. The
// design therefore spends its effort on keeping the FMA units fed from
// registers, with as few shared-memory loads per FMA as it can:
//   - one block per (F tile of 32 channels, tile of output rows, image);
//   - each thread owns an 8-channel x 4-column register tile (32 f32
//     accumulators). Per (s, ky) it loads a 4+ks-1 wide strip of blurred
//     input once into registers and reuses it across all ks kx taps, and
//     per tap it reads the 8 kernel weights with two 16-byte shared loads
//     that the warp broadcasts: ~14 FMAs per shared load instruction;
//   - input channels are staged SC = 2 at a time: the next stage's K tile
//     is copied with cp.async into a second buffer while the current one is
//     used. Raw x with a halo of kb/2 + ks/2 is loaded into shared memory
//     and blurred there into a second shared tile, each thread blurring 4
//     neighbouring columns with a sliding register window (one shared load
//     per 4 FMAs); the blur is redone per F tile (1/32 of the aggregation's
//     FMAs) and the blurred plane never goes to device memory;
//   - accumulation is in f32 for both f32 and bf16 input, and the output is
//     written in the input's dtype.
// What it leaves for later: tensor cores (wgmma), TMA staging, and gathering
// only the 4*G taps per unit instead of the dense ks^2 positions.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dau_fwd {

constexpr int TF = 8;   // output channels per thread
constexpr int TPX = 4;  // consecutive output columns per thread
constexpr int SC = 2;   // input channels staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Shared-memory plan, shared by the host launcher and the kernel.
struct Plan {
  int ft, rt, cg;          // F tile, output rows per block, column groups
  int pad;                 // kb/2 + ks/2
  int xh, xw;              // staged raw-x tile, per channel
  int xbh, xbw;            // blurred tile, per channel (xbw % 4 == 0)
  int k_chunk;              // one stage of K; k_floats holds two (double buffer)
  int k_floats, xb_floats, x_floats, f_floats;
};

__host__ __device__ inline Plan make_plan(int ks, int kb, int ft, int rt, int cg) {
  Plan p;
  p.ft = ft; p.rt = rt; p.cg = cg;
  p.pad = ks / 2 + kb / 2;
  p.xh = rt + 2 * p.pad;
  p.xw = cg * TPX + 2 * p.pad;
  p.xbh = rt + ks - 1;
  p.xbw = cg * TPX + round4(ks - 1);
  p.k_chunk = SC * ks * ks * ft;
  p.k_floats = 2 * p.k_chunk;
  p.xb_floats = SC * p.xbh * p.xbw;
  p.x_floats = SC * p.xh * p.xw;
  p.f_floats = round4(kb * kb);
  return p;
}

inline long long smem_bytes(int ks, int kb, int ft, int rt, int cg) {
  const Plan p = make_plan(ks, kb, ft, rt, cg);
  return 4LL * (p.k_floats + p.xb_floats + p.x_floats + p.f_floats);
}

template <typename T, int KS>
__global__ void __launch_bounds__(256)
dau_forward_kernel(const T* __restrict__ x, const float* __restrict__ filt,
                   const float* __restrict__ kern, T* __restrict__ out,
                   int S, int F, int fk, int H, int W, int kb, int ft, int rt, int cg) {
  constexpr int CA = KS / 2;
  constexpr int NV = round4(TPX + KS - 1) / 4;  // float4 loads per x strip
  const Plan pl = make_plan(KS, kb, ft, rt, cg);

  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [2][SC][KS*KS][ft]
  float* sXB = sK + pl.k_floats;                  // [SC][xbh][xbw]
  float* sX = sXB + pl.xb_floats;                 // [SC][xh][xw]
  float* sF = sX + pl.x_floats;                   // [kb*kb]

  const int f0 = blockIdx.x * ft;
  const int r0 = blockIdx.y * rt;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int npg = rt * cg;
  const bool active = tid < (ft / TF) * npg;
  const int fg = tid / npg;
  const int pg = tid - fg * npg;
  const int pr = pg / cg;
  const int pc = pg - pr * cg;

  for (int i = tid; i < kb * kb; i += nthr) sF[i] = filt[i];

  float acc[TF][TPX];
#pragma unroll
  for (int t = 0; t < TF; ++t)
#pragma unroll
    for (int j = 0; j < TPX; ++j) acc[t][j] = 0.f;

  const T* xn = x + (size_t)n * S * H * W;
  const int xplane = pl.xh * pl.xw;
  const int xbplane = pl.xbh * pl.xbw;
  const int kplane = KS * KS * ft;

  // K[s0:s0+SC, :, f0:f0+ft] -> dst, asynchronously (global layout
  // (S, KS*KS, fk), fk = F padded to a multiple of ft)
  auto stage_k = [&](int s0, float* dst) {
    const int q = ft / 4;
    for (int i = tid; i < pl.k_chunk / 4; i += nthr) {
      const int sp = i / q;
      const int f = (i - sp * q) * 4;
      const int sc = sp / (KS * KS);
      const bool valid = s0 + sc < S;
      const size_t off = valid ? ((size_t)(s0 + sc) * KS * KS + (sp - sc * KS * KS)) * fk + f0 + f : 0;
      cp_async16(dst + sp * ft + f, kern + off, valid);
    }
    cp_async_commit();
  };
  // input rows [r0 - pad, r0 + rt + pad), cols [-pad, width - pad) of the
  // SC channels from s0 -> dst (zero outside the image), four independent
  // loads in flight per thread
  auto stage_in = [&](int s0, float* dst, int floats, int width, int plane, int pad) {
    for (int base = tid; base < floats; base += 4 * nthr) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * nthr;
        const int sc = i / plane;
        const int rem = i - sc * plane;
        const int yy = rem / width;
        const int gy = r0 - pad + yy;
        const int gx = rem - yy * width - pad;
        v[u] = 0.f;
        if (i < floats && s0 + sc < S && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v[u] = to_f32(xn[((size_t)(s0 + sc) * H + gy) * W + gx]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * nthr < floats) dst[base + u * nthr] = v[u];
    }
  };

  stage_k(0, sK);
  int buf = 0;
  for (int s0 = 0; s0 < S; s0 += SC, buf ^= 1) {
    __syncthreads();  // the previous chunk's reads of sX, sXB and sK[buf ^ 1] are done
    // prefetch the next chunk's K while this one is staged (and blurred) and used
    if (s0 + SC < S)
      stage_k(s0 + SC, sK + (buf ^ 1) * pl.k_chunk);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    stage_in(s0, sX, pl.x_floats, pl.xw, xplane, pl.pad);
    cp_async_wait_one();  // this chunk's K has landed
    __syncthreads();

    // blur into sXB: rows [r0 - CA, r0 + rt + CA), cols [-CA, xbw - CA),
    // zero outside the image. A thread blurs 4 neighbouring columns at a
    // time, sliding a 4-wide window of x along each filter row (one shared
    // load per 4 FMAs).
    for (int i = tid; i < pl.xb_floats / 4; i += nthr) {
      const int q4 = pl.xbw / 4;
      const int sc = i / (pl.xbh * q4);
      const int rem = i - sc * pl.xbh * q4;
      const int yy = rem / q4;
      const int xx = (rem - yy * q4) * 4;
      const int gy = r0 - CA + yy;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < H && xx - CA < W && xx + 3 - CA >= 0) {
        // x at image (gy - kb/2 + dy, gx - kb/2 + dx) is sX[yy + dy][xx + dx]
        const float* src = sX + sc * xplane + yy * pl.xw + xx;
        for (int dy = 0; dy < kb; ++dy) {
          const float* row = src + dy * pl.xw;
          const float* frow = sF + dy * kb;
          float r0v = row[0], r1v = row[1], r2v = row[2];
          for (int dx = 0; dx < kb; ++dx) {
            const float r3v = row[dx + 3];
            const float fv = frow[dx];
            o[0] = fmaf(fv, r0v, o[0]);
            o[1] = fmaf(fv, r1v, o[1]);
            o[2] = fmaf(fv, r2v, o[2]);
            o[3] = fmaf(fv, r3v, o[3]);
            r0v = r1v; r1v = r2v; r2v = r3v;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gx = xx + j - CA;
          if (gx < 0 || gx >= W) o[j] = 0.f;
        }
      }
      *reinterpret_cast<float4*>(sXB + sc * xbplane + yy * pl.xbw + xx) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();

    if (active) {
#pragma unroll 1
      for (int sc = 0; sc < SC; ++sc) {
        const float* xbase = sXB + sc * xbplane + pr * pl.xbw + pc * TPX;
        const float* kbase = sK + buf * pl.k_chunk + sc * kplane + fg * TF;
#pragma unroll
        for (int ky = 0; ky < KS; ++ky) {
          float xr[4 * NV];
          const float4* xrow = reinterpret_cast<const float4*>(xbase + ky * pl.xbw);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float4 q = xrow[v];
            xr[4 * v] = q.x; xr[4 * v + 1] = q.y; xr[4 * v + 2] = q.z; xr[4 * v + 3] = q.w;
          }
#pragma unroll
          for (int kx = 0; kx < KS; ++kx) {
            const float4* kp = reinterpret_cast<const float4*>(kbase + (ky * KS + kx) * ft);
            float kv[TF];
#pragma unroll
            for (int v = 0; v < TF / 4; ++v) {
              const float4 q = kp[v];
              kv[4 * v] = q.x; kv[4 * v + 1] = q.y; kv[4 * v + 2] = q.z; kv[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int t = 0; t < TF; ++t)
#pragma unroll
              for (int j = 0; j < TPX; ++j)
                acc[t][j] = fmaf(kv[t], xr[kx + j], acc[t][j]);
          }
        }
      }
    }
  }

  if (!active) return;
  const int i = r0 + pr;
  if (i >= H) return;
#pragma unroll
  for (int t = 0; t < TF; ++t) {
    const int f = f0 + fg * TF + t;
    if (f >= F) continue;
    T* orow = out + (((size_t)n * F + f) * H + i) * W;
#pragma unroll
    for (int j = 0; j < TPX; ++j) {
      const int col = pc * TPX + j;
      if (col < W) store_out(orow + col, acc[t][j]);
    }
  }
}

template <typename T, int KS>
cudaError_t launch(const void* x, const void* filt, const void* kern, void* out,
                   int N, int S, int F, int fk, int H, int W, int kb, int ft, int rt,
                   int cg, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = dau_forward_kernel<T, KS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + ft - 1) / ft, (H + rt - 1) / rt, N);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(filt),
      static_cast<const float*>(kern), static_cast<T*>(out),
      S, F, fk, H, W, kb, ft, rt, cg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ks(int ks, const void* x, const void* filt, const void* kern, void* out,
                        int N, int S, int F, int fk, int H, int W, int kb, int ft, int rt,
                        int cg, int threads, size_t smem, cudaStream_t stream) {
#define DAU_KS_CASE(K)                                                                    \
  case K:                                                                                 \
    return launch<T, K>(x, filt, kern, out, N, S, F, fk, H, W, kb, ft, rt, cg,            \
                              threads, smem, stream);
  switch (ks) {
    DAU_KS_CASE(3)
    DAU_KS_CASE(5)
    DAU_KS_CASE(7)
    DAU_KS_CASE(9)
    DAU_KS_CASE(11)
    DAU_KS_CASE(13)
    DAU_KS_CASE(15)
    DAU_KS_CASE(17)
    default:
      return cudaErrorInvalidValue;
  }
#undef DAU_KS_CASE
}

inline int dispatch(const void* x, const void* filt, const void* kern, void* out, int dtype, int N,
             int S, int F, int fk, int H, int W, int kb, int ks, int ft, int rt, int cg,
             int threads, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_ks<float>(ks, x, filt, kern, out, N, S, F, fk, H, W, kb, ft,
                                         rt, cg, threads, (size_t)smem, st);
  if (dtype == 1)
    return (int)dispatch_ks<__nv_bfloat16>(ks, x, filt, kern, out, N, S, F, fk, H, W,
                                                 kb, ft, rt, cg, threads, (size_t)smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dau_fwd
