// DAU parameter-gradient position table for Hopper (sm_90a), K6.
//
// Replaces dau_convnet_tpu/kernels/backward.py::grad_tables_pallas (the
// Pallas kernel `_table_kernel`). It computes the same function, not the
// same blocks:
//
//   table[m,s,f,ky,kx] = sum_n sum_{i,j} xb[m,n,s,i+ky-c,j+kx-c] * err[n,f,i,j]
//
// c = ks/2, xb zero outside the image; bf16 input is widened on load, the sum
// is taken in f32 and the table is written in f32. The per-unit gradients are
// read out of the table afterwards by a tap-gather in torch.
//
// Bound: for each position p = (ky, kx) the table is a GEMM, F x (M*S),
// contracting over N*H*W (5,408 terms at 13x13, 23,328 at 27x27 for N = 32),
// so the kernel is FLOP-bound: 2*ks^2*M*S*F*N*H*W FLOPs (1.18 TFLOP per
// AlexNet-DAU step at M = 3) on a few MB of input. The design keeps the FMA
// units fed from registers:
//   - one block per (32 output channels f, 8*TM planes (m, s), 3 kernel rows
//     ky); it loops over every image and every row tile of it, so each
//     output element is summed by one thread in one fixed order: no atomics,
//     and a step is deterministic;
//   - per stage it copies a tile of err rows (f fastest, from the (N, H, W,
//     F) copy the wrapper makes) and the xb rows those err rows meet at the
//     block's 3 ky, with the ks/2 halo, into shared memory, zero outside the
//     image. The staged xb rows serve all 3 ky (row r of the err tile meets
//     xb row r + ky) and all ks kx;
//   - each thread owns 4 f x TM planes x all ks kx of one ky (4*TM*ks f32
//     accumulators). Per 4 columns j of an err row it loads a (4 + ks - 1)
//     wide window of each of its xb rows once and reuses it across the 4 j
//     and all kx, and reads 4 err values per j with one 16-byte load that
//     the warp broadcasts: 4*TM*ks*4 FMAs per 4 + 3*TM shared loads (29 at
//     ks = 9, TM = 2).
// What it leaves for later: tensor cores, cp.async/TMA double buffering,
// and computing only the 4*G taps per unit the tap-gather reads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TF = 4;                   // output channels per thread
constexpr int FG = 8;                   // channel groups per block
constexpr int FT = TF * FG;             // output channels per block
constexpr int MG = 8;                   // plane groups per block
constexpr int KYG = 3;                  // kernel rows per block, one per thread
constexpr int THREADS = FG * MG * KYG;  // 192

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// planes (m, s) per thread: fewer at large ks, so 4*TM*ks accumulators fit
__host__ __device__ constexpr int planes_per_thread(int ks) { return ks <= 9 ? 2 : 1; }

// Shared-memory plan, shared by the host launcher and the kernel.
struct Plan {
  int wp;        // staged err row: W rounded up to 4 (zeros past W)
  int xw;        // staged xb row: image column j sits at j + ks/2
  int xr;        // staged xb rows per plane: rt + KYG - 1
  int e_floats;  // [rt][wp][FT]
  int x_floats;  // [MG*TM][xr][xw]
};

__host__ __device__ inline Plan make_plan(int ks, int rt, int W) {
  Plan p;
  p.wp = round4(W);
  p.xw = p.wp + round4(ks - 1);
  p.xr = rt + KYG - 1;
  p.e_floats = rt * p.wp * FT;
  p.x_floats = MG * planes_per_thread(ks) * p.xr * p.xw;
  return p;
}

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
dau_grad_tables_kernel(const T* __restrict__ xb, const T* __restrict__ err,
                       float* __restrict__ table, int M, int N, int S, int F, int H, int W,
                       long long sm, long long sn, long long ss, int rt) {
  constexpr int CA = KS / 2;
  constexpr int TM = planes_per_thread(KS);
  constexpr int MT = MG * TM;                  // planes per block
  constexpr int NV = round4(4 + KS - 1) / 4;   // float4 loads per xb window
  const Plan pl = make_plan(KS, rt, W);

  extern __shared__ float4 smem4[];
  float* sE = reinterpret_cast<float*>(smem4);  // [rt][wp][FT]
  float* sX = sE + pl.e_floats;                  // [MT][xr][xw]

  const int f0 = blockIdx.x * FT;
  const int ms0 = blockIdx.y * MT;
  const int ky0 = blockIdx.z * KYG;
  const int MS = M * S;
  const int tid = threadIdx.x;
  const int fg = tid % FG;
  const int mg = (tid / FG) % MG;
  const int kyl = tid / (FG * MG);
  const int ky = ky0 + kyl;
  const int xplane = pl.xr * pl.xw;

  float acc[TF][TM][KS];
#pragma unroll
  for (int t = 0; t < TF; ++t)
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) acc[t][u][kx] = 0.f;

  for (int n = 0; n < N; ++n) {
    for (int i0 = 0; i0 < H; i0 += rt) {
      __syncthreads();  // the previous stage's reads of sE and sX are done
      // err rows [i0, i0 + rt), channels [f0, f0 + FT) of image n, from the
      // (N, H, W, F) copy: f fastest, four loads in flight per thread
      for (int base = tid; base < pl.e_floats; base += 4 * THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = base + u * THREADS;
          const int f = i % FT;
          const int rj = i / FT;
          const int r = rj / pl.wp;
          const int j = rj - r * pl.wp;
          v[u] = 0.f;
          if (i < pl.e_floats && i0 + r < H && j < W && f0 + f < F)
            v[u] = to_f32(err[(((size_t)n * H + i0 + r) * W + j) * F + f0 + f]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (base + u * THREADS < pl.e_floats) sE[base + u * THREADS] = v[u];
      }
      // xb rows [i0 + ky0 - CA, i0 + rt + ky0 + KYG - 1 - CA), columns
      // [-CA, xw - CA) of planes [ms0, ms0 + MT), zero outside the image
      for (int base = tid; base < pl.x_floats; base += 4 * THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = base + u * THREADS;
          const int p = i / xplane;
          const int rem = i - p * xplane;
          const int rr = rem / pl.xw;
          const int gy = i0 + ky0 - CA + rr;
          const int gx = rem - rr * pl.xw - CA;
          const int ms = ms0 + p;
          v[u] = 0.f;
          if (i < pl.x_floats && ms < MS && gy >= 0 && gy < H && gx >= 0 && gx < W) {
            const int m = ms / S;
            const int s = ms - m * S;
            v[u] = to_f32(xb[m * sm + n * sn + s * ss + (long long)gy * W + gx]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (base + u * THREADS < pl.x_floats) sX[base + u * THREADS] = v[u];
      }
      __syncthreads();

      if (ky < KS) {
        const int rows = min(rt, H - i0);
#pragma unroll 1
        for (int r = 0; r < rows; ++r) {
          const float* erow = sE + r * pl.wp * FT + fg * TF;
          const float* xrow = sX + (mg * TM) * xplane + (r + kyl) * pl.xw;
#pragma unroll 1
          for (int j0 = 0; j0 < pl.wp; j0 += 4) {
            float xv[TM][4 * NV];
#pragma unroll
            for (int u = 0; u < TM; ++u) {
              const float4* src = reinterpret_cast<const float4*>(xrow + u * xplane + j0);
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                const float4 q = src[v];
                xv[u][4 * v] = q.x; xv[u][4 * v + 1] = q.y;
                xv[u][4 * v + 2] = q.z; xv[u][4 * v + 3] = q.w;
              }
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float4 q = *reinterpret_cast<const float4*>(erow + (j0 + jj) * FT);
              const float e[TF] = {q.x, q.y, q.z, q.w};
#pragma unroll
              for (int t = 0; t < TF; ++t)
#pragma unroll
                for (int u = 0; u < TM; ++u)
#pragma unroll
                  for (int kx = 0; kx < KS; ++kx)
                    acc[t][u][kx] = fmaf(e[t], xv[u][jj + kx], acc[t][u][kx]);
            }
          }
        }
      }
    }
  }

  if (ky >= KS) return;
#pragma unroll
  for (int t = 0; t < TF; ++t) {
    const int f = f0 + fg * TF + t;
    if (f >= F) continue;
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int ms = ms0 + mg * TM + u;
      if (ms >= MS) continue;
      float* o = table + (((size_t)ms * F + f) * KS + ky) * KS;
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) o[kx] = acc[t][u][kx];
    }
  }
}

template <typename T, int KS>
cudaError_t launch(const void* xb, const void* err, void* table, int M, int N, int S, int F,
                   int H, int W, long long sm, long long sn, long long ss, int rt, size_t smem,
                   cudaStream_t stream) {
  auto kernel = dau_grad_tables_kernel<T, KS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int MT = MG * planes_per_thread(KS);
  dim3 grid((F + FT - 1) / FT, (M * S + MT - 1) / MT, (KS + KYG - 1) / KYG);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xb), static_cast<const T*>(err), static_cast<float*>(table),
      M, N, S, F, H, W, sm, sn, ss, rt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ks(int ks, const void* xb, const void* err, void* table, int M, int N,
                        int S, int F, int H, int W, long long sm, long long sn, long long ss,
                        int rt, size_t smem, cudaStream_t stream) {
#define DAU_KS_CASE(K)                                                                   \
  case K:                                                                                \
    return launch<T, K>(xb, err, table, M, N, S, F, H, W, sm, sn, ss, rt, smem, stream);
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

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for kernel size ks, rt err rows per
// stage and image width W.
long long dau_grad_tables_smem_bytes(int ks, int rt, int W) {
  const Plan p = make_plan(ks, rt, W);
  return 4LL * (p.e_floats + p.x_floats);
}

// xb: (M, N, S, H, W) f32 (dtype 0) or bf16 (dtype 1) with element strides
// sm, sn, ss for m, n, s and rows contiguous (row stride W); err: (N, H, W, F)
// contiguous, in xb's dtype; table: (M*S, F, ks, ks) f32. rt err rows are
// staged per pass. Returns a cudaError_t.
int dau_grad_tables_launch(const void* xb, const void* err, void* table, int dtype, int M,
                           int N, int S, int F, int H, int W, long long sm, long long sn,
                           long long ss, int ks, int rt, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_ks<float>(ks, xb, err, table, M, N, S, F, H, W, sm, sn, ss, rt,
                                   (size_t)smem, st);
  if (dtype == 1)
    return (int)dispatch_ks<__nv_bfloat16>(ks, xb, err, table, M, N, S, F, H, W, sm, sn, ss,
                                           rt, (size_t)smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
