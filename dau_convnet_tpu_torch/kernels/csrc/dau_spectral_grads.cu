// Fused spectral unit gradients of the Fourier engine for Hopper (sm_90a):
// K1 (the unit gradients) and K2 (the same call that also emits the
// input-gradient spectra).
//
// Replaces dau_convnet_tpu/kernels/fused_bwd.py::fused_spectral_grads_call
// (the Pallas kernel `_kernel_spectral`, phi gather). It computes the same
// function, not the same blocks:
//
//   Tre[k,m,s,f] = sum_n Xre*Ere + Xim*Eim     Tim = sum_n Xim*Ere - Xre*Eim
//   grad[m,s,g,f] = sum_k Re(phiU[k,g,s,f]) * Tre - Im(phiU) * Tim
//   dX[k,n,s] = sum_{g,f} conj(phiU) * w[g,s,f] * Eb[k,n,f]            (K2)
//
// with X = xs (B, M, 2N, S) and E = es (B, 2N, F) the re/im-stacked spectra,
// phiU[k] = py[k1] * px[k2] (k = k1*RB + k2) the unit's phase factor built
// from the integer-exponent tables t1 (2*P1, NJ) and t2 (2*RB, NJ; the rfft
// coefficient folded in) and its two bilinear taps per axis. Sums in f32;
// T is rounded to the operand dtype before the gather, as the Pallas
// kernel's tre/tim scratch is; the tables and tap weights arrive already
// rounded to it (the wrapper does that).
//
// Bound: the per-bin cross products, 4 FMAs per (k, m, n, s, f) at N = 32,
// are 40.4 GFLOP per AlexNet-DAU step over conv3-conv5 on ~30 MB of bf16
// spectra per layer, so the kernel is bound by operations, not bytes:
// ~0.04 ms on the tensor cores, ~0.6 ms on FP32 FMAs. This version runs
// FP32 FMAs:
//   - K1: one block per (32 f, 32 or 16 s, a range of bins); it walks its
//     bins itself and keeps the M*G sums of each of its (s, f) in registers,
//     so the sum over bins is deterministic and needs no atomics. Ranges are
//     chosen so the grid fills the card once; the wrapper sums the
//     per-range partials. Per bin it stages 16 images of xs (its s tile)
//     and es (its f tile) in shared memory, forms T in registers (each
//     thread 2 or 1 s x 4 f x M, 4 FMAs per image for 6 or 3 shared loads
//     per m, x loads broadcast across the warp), rounds T, and gathers:
//     the tap indices and weights of its units sit in shared memory, the
//     phase factor is two table reads per axis.
//   - K2's dx contracts over F, which the F-tiled K1 block does not own: a
//     second kernel, one block per (bin, 32 s), loops over F in chunks of
//     32, builds sum_g w*phiU for the chunk in shared memory and
//     accumulates a (32 n x 32 s) complex tile, 4 FMAs per (n, s, f).
// What it leaves for later: tensor cores (wgmma) for the cross products,
// cp.async/TMA double buffering of the stages. The block layout, the staging
// and the cross products are shared with K8 (dau_spectral.cuh).

#include "dau_spectral.cuh"

namespace {

using namespace dau_spectral;

constexpr int DX_T = 32;              // s, f and n tile of the dx kernel
constexpr int NJ_MAX = 64;            // largest exponent table width (dx kernel)

// s per thread: 2 while the M*G sums of 8 (s, f) fit the registers, else 1
__host__ __device__ constexpr int s_per_thread(int m, int g) { return m * g <= 8 ? 2 : 1; }

// idx (2, G, S, F) int: tap index j of mu1 (into t2) and of mu2 (into t1);
// wts (4, G, S, F) f32: the weights at j and j+1, mu1 then mu2.
template <typename T, int M, int G>
__global__ void __launch_bounds__(THREADS)
spectral_grads_kernel(const T* __restrict__ xs, const T* __restrict__ es,
                      const float* __restrict__ t1, const float* __restrict__ t2,
                      const int* __restrict__ idx, const float* __restrict__ wts,
                      float* __restrict__ out, int B, int N, int S, int F, int P1, int RB,
                      int NJ, int bins_per_block) {
  constexpr int TS = s_per_thread(M, G);
  constexpr int ST = SGROUPS * TS;
  const Plan pl = make_plan(M, G, P1, RB, NJ, TS);

  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int fg = tid % FGROUPS;
  const int sg = tid / FGROUPS;
  const int f0 = blockIdx.x * FT;
  const int s0 = blockIdx.y * ST;
  const int kbeg = blockIdx.z * bins_per_block;
  const int kend = min(B, kbeg + bins_per_block);
  const Smem sm = stage_block(reinterpret_cast<float*>(smem4), pl, t1, t2, idx, wts, G, S, F,
                              P1, RB, NJ, s0, f0);

  float acc[M][G][TS][TF];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int t = 0; t < TS; ++t)
#pragma unroll
        for (int u = 0; u < TF; ++u) acc[m][g][t][u] = 0.f;

  for (int k = kbeg; k < kend; ++k) {
    float tre[M][TS][TF], tim[M][TS][TF];
    cross_bin<T, M, TS>(xs, es, sm, k, N, S, F, s0, f0, tre, tim);

    // the gather: grad += Re(phiU) * T_re - Im(phiU) * T_im, T rounded to T
    const int k1 = k / RB;
    const int k2 = k - k1 * RB;
    const float* t1c = sm.t1 + k1 * NJ;
    const float* t1s = sm.t1 + (P1 + k1) * NJ;
    const float* t2c = sm.t2 + k2 * NJ;
    const float* t2s = sm.t2 + (RB + k2) * NJ;
#pragma unroll
    for (int t = 0; t < TS; ++t)
#pragma unroll
      for (int u = 0; u < TF; ++u) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          tre[m][t][u] = round_as(tre[m][t][u], T());
          tim[m][t][u] = round_as(tim[m][t][u], T());
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int ui = (g * ST + sg * TS + t) * FT + fg * TF + u;
          const int j1 = sm.j[ui];
          const int j2 = sm.j[pl.units + ui];
          const float a0 = sm.w[ui], a1 = sm.w[pl.units + ui];
          const float b0 = sm.w[2 * pl.units + ui], b1 = sm.w[3 * pl.units + ui];
          const float pyre = fmaf(t1c[j2 + 1], b1, t1c[j2] * b0);
          const float pyim = fmaf(t1s[j2 + 1], b1, t1s[j2] * b0);
          const float pxre = fmaf(t2c[j1 + 1], a1, t2c[j1] * a0);
          const float pxim = fmaf(t2s[j1 + 1], a1, t2s[j1] * a0);
          const float phre = pyre * pxre - pyim * pxim;
          const float phim = pyre * pxim + pyim * pxre;
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m][g][t][u] = fmaf(phre, tre[m][t][u], fmaf(-phim, tim[m][t][u], acc[m][g][t][u]));
        }
      }
  }

  // partial sums of this bin range: out (R, M, S, G, F)
#pragma unroll
  for (int t = 0; t < TS; ++t) {
    const int s = s0 + sg * TS + t;
    if (s >= S) continue;
#pragma unroll
    for (int u = 0; u < TF; ++u) {
      const int f = f0 + fg * TF + u;
      if (f >= F) continue;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int g = 0; g < G; ++g)
          out[((((size_t)blockIdx.z * M + m) * S + s) * G + g) * F + f] = acc[m][g][t][u];
    }
  }
}

// K2's input-gradient spectra: dxs (B, 2N, S) f32, [dXre; dXim] rows.
// One block per (32 s, bin); thread (sg, ng) owns s = sg*4 + [0, 4) and
// n = ng*2 + [0, 2) of each 32-image chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
spectral_dx_kernel(const T* __restrict__ esb, const float* __restrict__ t1,
                   const float* __restrict__ t2, const int* __restrict__ idx,
                   const float* __restrict__ wts, const float* __restrict__ wg,
                   float* __restrict__ dxs, int B, int N, int S, int F, int G, int P1,
                   int RB, int NJ) {
  __shared__ float tab[4][NJ_MAX];                 // t1 cos, t1 sin rows k1; t2 rows k2
  __shared__ float pr[DX_T][DX_T + 1], pi[DX_T][DX_T + 1];   // [s][f]
  __shared__ float eb[2][DX_T][DX_T + 1];                    // [re/im][n][f]

  const int tid = threadIdx.x;
  const int sg = tid % 8;
  const int ng = tid / 8;
  const int s0 = blockIdx.x * DX_T;
  const int k = blockIdx.y;
  const int k1 = k / RB;
  const int k2 = k - k1 * RB;
  const int N2 = 2 * N;
  const size_t SF = (size_t)S * F;
  const size_t GSF = (size_t)G * SF;

  for (int i = tid; i < NJ; i += THREADS) {
    tab[0][i] = t1[k1 * NJ + i];
    tab[1][i] = t1[(P1 + k1) * NJ + i];
    tab[2][i] = t2[k2 * NJ + i];
    tab[3][i] = t2[(RB + k2) * NJ + i];
  }

  for (int n0 = 0; n0 < N; n0 += DX_T) {
    const int nc = min(DX_T, N - n0);
    float dre[2][4], dim[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dre[a][b] = dim[a][b] = 0.f;

    for (int fc0 = 0; fc0 < F; fc0 += DX_T) {
      __syncthreads();  // the previous chunk's reads are done (and tab is in)
      // sum_g w * phiU over this chunk's (s, f)
      for (int i = tid; i < DX_T * DX_T; i += THREADS) {
        const int s = i / DX_T;
        const int f = i % DX_T;
        float vr = 0.f, vi = 0.f;
        if (s0 + s < S && fc0 + f < F) {
          for (int g = 0; g < G; ++g) {
            const size_t gi = g * SF + (size_t)(s0 + s) * F + fc0 + f;
            const int j1 = idx[gi];
            const int j2 = idx[GSF + gi];
            const float a0 = wts[gi], a1 = wts[GSF + gi];
            const float b0 = wts[2 * GSF + gi], b1 = wts[3 * GSF + gi];
            const float pyre = fmaf(tab[0][j2 + 1], b1, tab[0][j2] * b0);
            const float pyim = fmaf(tab[1][j2 + 1], b1, tab[1][j2] * b0);
            const float pxre = fmaf(tab[2][j1 + 1], a1, tab[2][j1] * a0);
            const float pxim = fmaf(tab[3][j1 + 1], a1, tab[3][j1] * a0);
            const float w = wg[gi];
            vr = fmaf(pyre * pxre - pyim * pxim, w, vr);
            vi = fmaf(pyre * pxim + pyim * pxre, w, vi);
          }
        }
        pr[s][f] = vr;
        pi[s][f] = vi;
      }
      for (int i = tid; i < 2 * DX_T * DX_T; i += THREADS) {
        const int f = i % DX_T;
        const int r = (i / DX_T) % DX_T;
        const int h = i / (DX_T * DX_T);
        float v = 0.f;
        if (r < nc && fc0 + f < F)
          v = to_f32(esb[((size_t)k * N2 + h * N + n0 + r) * F + fc0 + f]);
        eb[h][r][f] = v;
      }
      __syncthreads();

#pragma unroll 4
      for (int f = 0; f < DX_T; ++f) {
        float er[2], ei[2], vr[4], vi[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          er[a] = eb[0][ng * 2 + a][f];
          ei[a] = eb[1][ng * 2 + a][f];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          vr[b] = pr[sg * 4 + b][f];
          vi[b] = pi[sg * 4 + b][f];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            dre[a][b] = fmaf(er[a], vr[b], fmaf(ei[a], vi[b], dre[a][b]));
            dim[a][b] = fmaf(ei[a], vr[b], fmaf(-er[a], vi[b], dim[a][b]));
          }
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int n = n0 + ng * 2 + a;
      if (ng * 2 + a >= nc) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = s0 + sg * 4 + b;
        if (s >= S) continue;
        dxs[((size_t)k * N2 + n) * S + s] = dre[a][b];
        dxs[((size_t)k * N2 + N + n) * S + s] = dim[a][b];
      }
    }
  }
}

template <typename T, int M, int G>
cudaError_t launch_grads(const void* xs, const void* es, const float* t1, const float* t2,
                         const int* idx, const float* wts, float* out, int B, int N, int S,
                         int F, int P1, int RB, int NJ, int R, size_t smem,
                         cudaStream_t stream) {
  cudaError_t e = set_smem(spectral_grads_kernel<T, M, G>, smem);
  if (e != cudaSuccess) return e;
  constexpr int ST = SGROUPS * s_per_thread(M, G);
  const int per = (B + R - 1) / R;
  dim3 grid((F + FT - 1) / FT, (S + ST - 1) / ST, R);
  spectral_grads_kernel<T, M, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(es), t1, t2, idx, wts, out, B, N, S, F,
      P1, RB, NJ, per);
  return cudaGetLastError();
}

// f(T, M, G) instantiated for T in {float, bf16}, M in {3, 4}, G in {1..4}
#define DAU_MG_DISPATCH(CALL)                                           \
  switch (M * 8 + G) {                                                  \
    case 3 * 8 + 1: return CALL(3, 1);                                  \
    case 3 * 8 + 2: return CALL(3, 2);                                  \
    case 3 * 8 + 3: return CALL(3, 3);                                  \
    case 3 * 8 + 4: return CALL(3, 4);                                  \
    case 4 * 8 + 1: return CALL(4, 1);                                  \
    case 4 * 8 + 2: return CALL(4, 2);                                  \
    case 4 * 8 + 3: return CALL(4, 3);                                  \
    case 4 * 8 + 4: return CALL(4, 4);                                  \
    default: return -(int)cudaErrorInvalidValue;                        \
  }

template <typename T>
int ranges(int M, int G, int B, int S, int F, size_t smem) {
  const int blocks = ((F + FT - 1) / FT) * ((S + SGROUPS * s_per_thread(M, G) - 1) /
                                            (SGROUPS * s_per_thread(M, G)));
#define DAU_RANGES(MM, GG) fill_ranges(spectral_grads_kernel<T, MM, GG>, smem, blocks, B)
  DAU_MG_DISPATCH(DAU_RANGES)
#undef DAU_RANGES
}

template <typename T>
int dispatch_grads(int M, int G, const void* xs, const void* es, const float* t1,
                   const float* t2, const int* idx, const float* wts, float* out, int B, int N,
                   int S, int F, int P1, int RB, int NJ, int R, size_t smem,
                   cudaStream_t stream) {
#define DAU_LAUNCH(MM, GG) \
  (int)launch_grads<T, MM, GG>(xs, es, t1, t2, idx, wts, out, B, N, S, F, P1, RB, NJ, R, smem, stream)
  DAU_MG_DISPATCH(DAU_LAUNCH)
#undef DAU_LAUNCH
}

}  // namespace

extern "C" {

// Shared-memory bytes of K1 for M filters, G units and the table sizes.
long long dau_spectral_grads_smem_bytes(int M, int G, int P1, int RB, int NJ) {
  return plan_bytes(make_plan(M, G, P1, RB, NJ, s_per_thread(M, G)));
}

// Bin ranges for K1 so its grid fills the card about once: the blocks of
// one range times the ranges stay within the card's resident blocks.
// Returns the count (>= 1, <= B), or -cudaError on failure.
int dau_spectral_grads_ranges(int dtype, int M, int G, int B, int S, int F, int P1, int RB,
                              int NJ) {
  const size_t smem = (size_t)dau_spectral_grads_smem_bytes(M, G, P1, RB, NJ);
  return dtype == 0 ? ranges<float>(M, G, B, S, F, smem)
                    : ranges<__nv_bfloat16>(M, G, B, S, F, smem);
}

// K1: xs (B, M, 2N, S), es (B, 2N, F) in dtype (0 f32, 1 bf16); t1 (2*P1,
// NJ), t2 (2*RB, NJ) f32; idx (2, G, S, F) int32, wts (4, G, S, F) f32;
// out (R, M, S, G, F) f32 partial sums over R bin ranges. Returns a
// cudaError_t.
int dau_spectral_grads_launch(const void* xs, const void* es, const void* t1, const void* t2,
                              const void* idx, const void* wts, void* out, int dtype, int M,
                              int G, int B, int N, int S, int F, int P1, int RB, int NJ, int R,
                              long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ft1 = static_cast<const float*>(t1);
  const float* ft2 = static_cast<const float*>(t2);
  const int* ii = static_cast<const int*>(idx);
  const float* fw = static_cast<const float*>(wts);
  float* fo = static_cast<float*>(out);
  int e;
  if (dtype == 0)
    e = dispatch_grads<float>(M, G, xs, es, ft1, ft2, ii, fw, fo, B, N, S, F, P1, RB, NJ, R,
                              (size_t)smem, st);
  else if (dtype == 1)
    e = dispatch_grads<__nv_bfloat16>(M, G, xs, es, ft1, ft2, ii, fw, fo, B, N, S, F, P1, RB,
                                      NJ, R, (size_t)smem, st);
  else
    return (int)cudaErrorInvalidValue;
  return e < 0 ? -e : e;
}

// K2's dx kernel: esb (B, 2N, F) in dtype; wg (G, S, F) f32; dxs (B, 2N, S)
// f32. NJ <= 64. Returns a cudaError_t.
int dau_spectral_dx_launch(const void* esb, const void* t1, const void* t2, const void* idx,
                           const void* wts, const void* wg, void* dxs, int dtype, int G, int B,
                           int N, int S, int F, int P1, int RB, int NJ, void* stream) {
  if (NJ > NJ_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + DX_T - 1) / DX_T, B);
  const float* ft1 = static_cast<const float*>(t1);
  const float* ft2 = static_cast<const float*>(t2);
  const int* ii = static_cast<const int*>(idx);
  const float* fw = static_cast<const float*>(wts);
  const float* fg = static_cast<const float*>(wg);
  float* fo = static_cast<float*>(dxs);
  if (dtype == 0)
    spectral_dx_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(esb), ft1, ft2, ii, fw, fg, fo, B, N, S, F, G, P1, RB, NJ);
  else if (dtype == 1)
    spectral_dx_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(esb), ft1, ft2, ii, fw, fg, fo, B, N, S, F, G, P1,
        RB, NJ);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
