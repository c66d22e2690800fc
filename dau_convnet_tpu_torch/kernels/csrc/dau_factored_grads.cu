// The factored spectral gather of the Fourier engine for Hopper (sm_90a): K8.
//
// Replaces dau_convnet_tpu/kernels/fused_bwd.py::_fused_factored_call (the
// Pallas kernel `_kernel_factored`, reached through
// fused_spectral_grads_call(gather="factored")). It computes the unit
// gradients of K1 by the factored contraction and with its roundings:
//
//   T[k,m,s,f]  = sum_n X conj(E)                       (f32, rounded to T)
//   P[k1,j2]    = sum_k2 t2c[k2,j2] Tre - t2s[k2,j2] Tim,
//   Q[k1,j2]    = sum_k2 t2s[k2,j2] Tre + t2c[k2,j2] Tim (f32, rounded to T)
//   E[j1,j2]    = sum_k1 t1c[k1,j1] P - t1s[k1,j1] Q      (f32)
//   grad[m,s,g,f] = sum_{j1,j2} a2[g,j1] a1[g,j2] E[j1,j2] (f32)
//
// (k = k1*RB + k2; t1 (2*P1, NJ), t2 (2*RB, NJ) the integer-exponent tables,
// t2 carrying the rfft coefficient; a1, a2 the bilinear one-hots of mu1,
// mu2). The dx spectra of K8 with dx are K2's function: the wrapper takes
// them from K2's dx kernel (dau_spectral_grads.cu).
//
// The Pallas kernel materialises E, M*NJ^2 f32 per (s, f) (1.7 KB at M = 3,
// NJ = 12), so that its per-unit combine is independent of the bins. Each
// one-hot has two non-zeros, so the combine reads E at four entries per unit
// only. This kernel never forms the rest of E: per (s, f) it keeps, for each
// unit, P and Q at the unit's two j2 taps of a1 (4*M*G sums), rounds them
// at the end of each k1 row, and folds them with the row's two j1 taps of a2
// into the unit's gradient (M*G sums). The sum over j1, j2 and k1 is then
// the four-entry combine of E, taken in another order (f32).
//
// Bound: as K1's, the per-bin cross products (4 FMAs per (k, m, n, s, f);
// 17.3 GFLOP at AlexNet conv4, N = 32) on ~30 MB of bf16 spectra, so bound
// by operations: ~0.02 ms on the tensor cores, ~0.26 ms on FP32 FMAs. This
// version runs FP32 FMAs in K1's block layout (dau_spectral.cuh): one block
// per (32 f, 16 s, a range of whole k1 rows), T in registers per bin, T
// never in device memory. A thread owns 1 s x 4 f (K1 gives it 2 s where
// M*G <= 8): its 4*M*G P/Q sums per (s, f) take the registers of the second
// s. The P/Q update costs 8*M*G FMAs per (bin, s, f) beside T's 4*M*N. The
// row ranges fill the card once; the wrapper sums the per-range partials.
// What it leaves for later: tensor cores for the cross products.

#include "dau_spectral.cuh"

namespace {

using namespace dau_spectral;

constexpr int TS = 1;                  // s per thread
constexpr int ST = SGROUPS * TS;       // s per block

template <typename T, int M, int G>
__global__ void __launch_bounds__(THREADS)
factored_grads_kernel(const T* __restrict__ xs, const T* __restrict__ es,
                      const float* __restrict__ t1, const float* __restrict__ t2,
                      const int* __restrict__ idx, const float* __restrict__ wts,
                      float* __restrict__ out, int N, int S, int F, int P1, int RB, int NJ,
                      int rows_per_block) {
  const Plan pl = make_plan(M, G, P1, RB, NJ, TS);

  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int fg = tid % FGROUPS;
  const int sg = tid / FGROUPS;
  const int f0 = blockIdx.x * FT;
  const int s0 = blockIdx.y * ST;
  const int rbeg = blockIdx.z * rows_per_block;
  const int rend = min(P1, rbeg + rows_per_block);
  const Smem sm = stage_block(reinterpret_cast<float*>(smem4), pl, t1, t2, idx, wts, G, S, F,
                              P1, RB, NJ, s0, f0);

  float acc[M][G][TF];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < TF; ++u) acc[m][g][u] = 0.f;

  for (int k1 = rbeg; k1 < rend; ++k1) {
    // P and Q of this row at each unit's taps j2 = j, j + 1 of a1
    float p[M][G][2][TF], q[M][G][2][TF];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < TF; ++u) p[m][g][h][u] = q[m][g][h][u] = 0.f;

    for (int k2 = 0; k2 < RB; ++k2) {
      float tre[M][TS][TF], tim[M][TS][TF];
      cross_bin<T, M, TS>(xs, es, sm, k1 * RB + k2, N, S, F, s0, f0, tre, tim);
      const float* t2c = sm.t2 + k2 * NJ;
      const float* t2s = sm.t2 + (RB + k2) * NJ;
#pragma unroll
      for (int u = 0; u < TF; ++u) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          tre[m][0][u] = round_as(tre[m][0][u], T());
          tim[m][0][u] = round_as(tim[m][0][u], T());
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = sm.j[(g * ST + sg) * FT + fg * TF + u];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float c = t2c[j + h], s = t2s[j + h];
#pragma unroll
            for (int m = 0; m < M; ++m) {
              p[m][g][h][u] = fmaf(c, tre[m][0][u], fmaf(-s, tim[m][0][u], p[m][g][h][u]));
              q[m][g][h][u] = fmaf(s, tre[m][0][u], fmaf(c, tim[m][0][u], q[m][g][h][u]));
            }
          }
        }
      }
    }

    // the row's share of the combine: P, Q rounded to T, then in f32
    //   grad += sum_{j1} a2[j1] (t1c[k1,j1] Pw - t1s[k1,j1] Qw),
    //   Pw = sum_{j2} a1[j2] P[j2], Qw likewise
    const float* t1c = sm.t1 + k1 * NJ;
    const float* t1s = sm.t1 + (P1 + k1) * NJ;
#pragma unroll
    for (int u = 0; u < TF; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int ui = (g * ST + sg) * FT + fg * TF + u;
        const int j2 = sm.j[pl.units + ui];
        const float a0 = sm.w[ui], a1 = sm.w[pl.units + ui];
        const float b0 = sm.w[2 * pl.units + ui], b1 = sm.w[3 * pl.units + ui];
        const float pyre = fmaf(t1c[j2 + 1], b1, t1c[j2] * b0);
        const float pyim = fmaf(t1s[j2 + 1], b1, t1s[j2] * b0);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float pw = fmaf(round_as(p[m][g][1][u], T()), a1,
                                round_as(p[m][g][0][u], T()) * a0);
          const float qw = fmaf(round_as(q[m][g][1][u], T()), a1,
                                round_as(q[m][g][0][u], T()) * a0);
          acc[m][g][u] = fmaf(pyre, pw, fmaf(-pyim, qw, acc[m][g][u]));
        }
      }
  }

  // partial sums of this row range: out (R, M, S, G, F)
  const int s = s0 + sg;
  if (s >= S) return;
#pragma unroll
  for (int u = 0; u < TF; ++u) {
    const int f = f0 + fg * TF + u;
    if (f >= F) continue;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int g = 0; g < G; ++g)
        out[((((size_t)blockIdx.z * M + m) * S + s) * G + g) * F + f] = acc[m][g][u];
  }
}

template <typename T, int M, int G>
cudaError_t launch(const void* xs, const void* es, const float* t1, const float* t2,
                   const int* idx, const float* wts, float* out, int N, int S, int F, int P1,
                   int RB, int NJ, int R, size_t smem, cudaStream_t stream) {
  cudaError_t e = set_smem(factored_grads_kernel<T, M, G>, smem);
  if (e != cudaSuccess) return e;
  const int per = (P1 + R - 1) / R;
  dim3 grid((F + FT - 1) / FT, (S + ST - 1) / ST, R);
  factored_grads_kernel<T, M, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(es), t1, t2, idx, wts, out, N, S, F, P1,
      RB, NJ, per);
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
int ranges(int M, int G, int S, int F, int P1, size_t smem) {
  const int blocks = ((F + FT - 1) / FT) * ((S + ST - 1) / ST);
#define DAU_RANGES(MM, GG) fill_ranges(factored_grads_kernel<T, MM, GG>, smem, blocks, P1)
  DAU_MG_DISPATCH(DAU_RANGES)
#undef DAU_RANGES
}

template <typename T>
int dispatch(int M, int G, const void* xs, const void* es, const float* t1, const float* t2,
             const int* idx, const float* wts, float* out, int N, int S, int F, int P1, int RB,
             int NJ, int R, size_t smem, cudaStream_t stream) {
#define DAU_LAUNCH(MM, GG) \
  (int)launch<T, MM, GG>(xs, es, t1, t2, idx, wts, out, N, S, F, P1, RB, NJ, R, smem, stream)
  DAU_MG_DISPATCH(DAU_LAUNCH)
#undef DAU_LAUNCH
}

}  // namespace

extern "C" {

// Shared-memory bytes of K8 for M filters, G units and the table sizes.
long long dau_factored_grads_smem_bytes(int M, int G, int P1, int RB, int NJ) {
  return plan_bytes(make_plan(M, G, P1, RB, NJ, TS));
}

// Ranges of whole k1 rows for K8 so its grid fills the card about once.
// Returns the count (>= 1, <= P1), or -cudaError on failure. (B, RB and NJ
// complete K1's signature.)
int dau_factored_grads_ranges(int dtype, int M, int G, int B, int S, int F, int P1, int RB,
                              int NJ) {
  const size_t smem = (size_t)dau_factored_grads_smem_bytes(M, G, P1, RB, NJ);
  (void)B;
  return dtype == 0 ? ranges<float>(M, G, S, F, P1, smem)
                    : ranges<__nv_bfloat16>(M, G, S, F, P1, smem);
}

// K8: the arguments of K1's launch (dau_spectral_grads_launch); B = P1*RB,
// out (R, M, S, G, F) f32 partial sums over R ranges of k1 rows. Returns a
// cudaError_t.
int dau_factored_grads_launch(const void* xs, const void* es, const void* t1, const void* t2,
                              const void* idx, const void* wts, void* out, int dtype, int M,
                              int G, int B, int N, int S, int F, int P1, int RB, int NJ, int R,
                              long long smem, void* stream) {
  if (B != P1 * RB || R < 1 || R > P1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ft1 = static_cast<const float*>(t1);
  const float* ft2 = static_cast<const float*>(t2);
  const int* ii = static_cast<const int*>(idx);
  const float* fw = static_cast<const float*>(wts);
  float* fo = static_cast<float*>(out);
  int e;
  if (dtype == 0)
    e = dispatch<float>(M, G, xs, es, ft1, ft2, ii, fw, fo, N, S, F, P1, RB, NJ, R,
                        (size_t)smem, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(M, G, xs, es, ft1, ft2, ii, fw, fo, N, S, F, P1, RB, NJ, R,
                                (size_t)smem, st);
  else
    return (int)cudaErrorInvalidValue;
  return e < 0 ? -e : e;
}

}  // extern "C"
