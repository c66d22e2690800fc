// Fused spectral unit gradients of the Fourier engine for Hopper (sm_90a):
// K1 (the unit gradients), K2 (the same call that also emits the
// input-gradient spectra) and K8 (the unit gradients by the factored
// gather).
//
// Replaces dau_convnet_tpu/kernels/fused_bwd.py::fused_spectral_grads_call:
// the Pallas kernel `_kernel_spectral` (phi gather; K1, K2) and, through
// `_fused_factored_call`, `_kernel_factored` (K8). It computes the same
// functions, not the same blocks:
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
// Bound: the per-bin cross products, 8N operations per (k, m, s, f), are
// 40.4 GFLOP per AlexNet-DAU step over conv3-conv5 on ~30 MB of bf16 spectra
// per layer: ~0.04 ms on the tensor cores. The gather adds 4G operations per
// (k, m, s, f) and the phase factor ~12 per (k, g, s, f), on the FP32 units.
// K1's design (`spectral_grads_kernel`):
//   - the cross-spectra of a bin are one GEMM per m on the tensor cores,
//     T (64 s x 2*FT) = X^T (64 s x 2N) . ES (2N x 2*FT), bf16 operands and
//     f32 sums. ES is an interleaved copy of es: column 2f is [Ere; Eim],
//     column 2f+1 is [-Eim; Ere], so Tre and Tim of one (s, f) land in
//     adjacent accumulator registers of one thread. f32 spectra reach the
//     kernel split in three bf16 parts stacked along K (x as [x1, x1, x2,
//     x1, x2, x3] against ES as [E1, E2, E1, E3, E2, E1]: the six products
//     of K4), so K is 2N (bf16) or 12N (f32). One launch of
//     `operands_kernel` builds ES, the split X where one is needed, the
//     units' taps and the table quads (below), so the wrapper issues two
//     launches and a sum, not the ~30 small torch ops it would take;
//   - one block per (64 s, 2 warpgroups x FT f, a range of bins) walks its
//     bins itself; its thread 0 streams, one step ahead, per bin and 64-row
//     K chunk the X tile of all M planes (one 4-D TMA box, MN-major,
//     128-byte swizzled, straight from xs), the ES tile (chunk-major, no
//     swizzle) and the bin's two phase-table rows into a ring of STAGES
//     stages; TMA reads zeros past S, K and 2F, so the ragged edges need no
//     mask. There is no producer warp: the block's registers are the limit,
//     and a warp more would lower every thread's share;
//   - each warpgroup issues M chains of wgmma m64n(2*FT)k16 per chunk into
//     M*FT f32 sums per thread (restarted every bin: no fold is needed) on
//     its own FT f of the shared X tile. While they run it builds its units'
//     phase factors from the staged table rows and the units' taps (staged
//     once per block in shared memory, laid out by thread so every read is
//     conflict-free); then it rounds T to the operand dtype and adds the
//     gather into M*G*FT/2 registers. FT = 16 while M*G <= 8, else 8;
//   - the ranges are chosen so the grid fills the card in whole waves; the
//     wrapper sums the per-range partials (R, M, S, G, F): deterministic,
//     no atomics.
// What paces it: `tools/k1_variants.py` times variants of this source on
// the card (PERF.md, section 7).
// K8 is the same kernel under another gather policy (`FactoredGather`): the
// same ring, wgmma chains, table quads and staged taps, with the factored
// contraction of the Pallas kernel, and its roundings, in place of the
// phase gather that closes each bin (k = k1*RB + k2):
//   P[m,g,h] += c2[j+h]*Tre - s2[j+h]*Tim,  Q[m,g,h] += s2[j+h]*Tre + c2[j+h]*Tim
// for h in {0, 1} at each unit's taps j, j+1 into t2 (the bin's t2 quad),
// T rounded to the operand dtype first; at the end of each k1 row P and Q
// are rounded to it and folded with the row's t1 quad at the unit's taps
// into t1, grad += (b0*c1[j'] + b1*c1[j'+1])*(a0*P0 + a1*P1) - (b0*s1[j'] +
// b1*s1[j'+1])*(a0*Q0 + a1*Q1), and restarted. The Pallas kernel forms
// E[j1,j2] = sum_k1 t1 (P, Q) over all NJ^2 entries and combines four of
// them per unit; here only those four are ever formed, the sum over k1
// taken in another f32 order. A block's bins are whole k1 rows (17 x 9 bins
// at conv3-conv5, 31 x 16 at conv2), ranges of rows chosen to fill the card
// in whole waves. Each thread keeps 2*M*G*FT P/Q sums beside K1's M*FT
// cross-spectra and M*G*FT/2 gradient sums, so K8's tile is narrower: FT =
// 8 (wgmma m64n16k16) on the AlexNet-DAU path (M = 3, G = 2), 16 at M = 3,
// G = 1, 4 (m64n8k16) from M*G = 8 on (`FactoredGather::tile_f`). The bin's stage is freed after its P/Q update, which reads
// the stage's table rows. Its dx spectra are K2's function: the wrapper
// takes them from K2's dx kernel.
// K2's dx contracts over F, which the F-tiled K1 block does not own: a second
// kernel (`dx::spectral_dx_kernel`, below), one bf16 wgmma GEMM per bin over
// all F, its A built on the FP32 units and its B streamed by TMA; K1's
// operand kernel builds B and the units' tap records in its launch.

#include "dau_tap_gemm.cuh"

namespace {

constexpr int NJ_MAX = 64;  // largest exponent table width

using tapgemm::round_as;

// ------------------------------------------------------------------ K1, K8

namespace tc {

using namespace dau_hopper;

constexpr int ST = 64;         // s per block: the wgmma M
constexpr int KC = 64;         // K rows per stage
constexpr int STAGES = 2;
constexpr int MAX_RANGES = 8;

constexpr int WGS = 2;         // warpgroups, each on its own FT f of the block
constexpr int THREADS = 128 * WGS;  // thread 0 also issues the loads

// The gather that closes each bin, the template parameter of
// `spectral_grads_kernel`, and the f per warpgroup FT it leaves room for
// (the wgmma's N is 2*FT).
// K1: the phi gather. Per thread M*FT cross-spectra, M*G*FT/2 gather sums
// and G*FT/2 phase factors fit the registers at FT = 16 up to M*G = 8,
// else at FT = 8.
struct PhiGather {
  static constexpr bool kFactored = false;
  __host__ __device__ static constexpr int tile_f(int m, int g) { return m * g <= 8 ? 16 : 8; }
};
// K8: the factored gather. Beside the M*FT cross-spectra and M*G*FT/2
// gradient sums each thread keeps P and Q at each unit's two taps,
// 2*M*G*FT sums: the widest FT at which the three take at most 170
// registers (FT*M*(5G+2)/2: 16 at M = 3, G = 1; 8 at M = 3, G = 2 and M = 4,
// G = 1), else FT = 4, at which every instance builds without a spill
// (chip_smoke.py prints ptxas' registers and spills of each).
struct FactoredGather {
  static constexpr bool kFactored = true;
  __host__ __device__ static constexpr int tile_f(int m, int g) {
    return 16 * m * (5 * g + 2) / 2 <= 170 ? 16 : 8 * m * (5 * g + 2) / 2 <= 170 ? 8 : 4;
  }
};

// floats of one staged phase-table row: NJ-1 quads (c[j], c[j+1], s[j],
// s[j+1]), padded to 128 bytes
__host__ __device__ constexpr int table_row(int nj) {
  return (4 * (nj > 1 ? nj - 1 : 1) + 31) / 32 * 32;
}

// (Tre, Tim) of one (s, f) rounded to T, in one conversion for bf16
__device__ __forceinline__ void round_pair(float&, float&, float) {}
__device__ __forceinline__ void round_pair(float& re, float& im, __nv_bfloat16) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(re, im);
  re = __low2float(h);
  im = __high2float(h);
}

// Shared memory of a block, laid out from a 1024-byte aligned base:
// X stages, ES stages, table rows, the units' weights and taps, the ring.
struct Layout {
  int a, b, tab, w4, jj, ring, bytes;
};

__host__ __device__ inline Layout layout(int M, int G, int NJ, int ft) {
  Layout l;
  l.a = 0;                                          // [STAGES][M][KC][64 s] bf16
  l.b = l.a + STAGES * M * KC * ST * 2;             // [STAGES][2*WGS*FT/8][KC][8] bf16
  l.tab = l.b + STAGES * 2 * WGS * ft / 8 * KC * 16;  // [STAGES][2][table_row] f32
  l.w4 = l.tab + STAGES * 2 * table_row(NJ) * 4;    // [G][FT/2][THREADS] float4
  l.jj = l.w4 + G * ft / 2 * THREADS * 16;          // [G][FT/2][THREADS] int
  l.ring = l.jj + G * ft / 2 * THREADS * 4;
  l.bytes = 1024 + l.ring + (int)sizeof(Ring<STAGES>);
  return l;
}

// idx (2, G, S, F) int: tap index j of mu1 (into t2) and of mu2 (into t1);
// wts (4, G, S, F) f32: the weights at j and j+1, mu1 then mu2; out (R, M,
// S, G, F) f32. Gather::kFactored: the block's bins are whole k1 rows
// (bins_per_block a multiple of RB).
template <typename T, int M, int G, typename Gather>
__global__ void __launch_bounds__(THREADS, 1)
spectral_grads_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap e_map,
                      const __grid_constant__ CUtensorMap t1_map,
                      const __grid_constant__ CUtensorMap t2_map, const int* __restrict__ idx,
                      const float* __restrict__ wts, float* __restrict__ out, int B, int K,
                      int S, int F, int RB, int NJ, int bins_per_block) {
  constexpr bool kFactored = Gather::kFactored;
  constexpr int FT = Gather::tile_f(M, G);
  constexpr int NP = FT / 2;            // (s, f) pairs per thread
  constexpr int A_M = KC * ST * 2;      // bytes of one m's X tile
  constexpr int B_WG = 2 * FT / 8 * KC * 16;  // bytes of one warpgroup's ES tile
  constexpr int B_STAGE = WGS * B_WG;
  const Layout lay = layout(M, G, NJ, FT);
  const int tabw = table_row(NJ);
  const int q = 4 * (NJ - 1);
  const uint32_t stage_bytes = M * A_M + B_STAGE + 2 * q * 4;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // rounded up to 1024 bytes by pointer arithmetic on the shared array, so
  // that the compiler knows every derived pointer is shared (32-bit shared
  // loads, not 64-bit generic ones)
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float4* w4 = reinterpret_cast<float4*>(base + lay.w4);
  int* jj = reinterpret_cast<int*>(base + lay.jj);
  Ring<STAGES>& ring = *reinterpret_cast<Ring<STAGES>*>(base + lay.ring);

  const int f0 = blockIdx.x * WGS * FT;
  const int s0 = blockIdx.y * ST;
  const int kbeg = blockIdx.z * bins_per_block;
  const int kend = min(B, kbeg + bins_per_block);
  const int chunks = (K + KC - 1) / KC;
  const int steps = (kend - kbeg) * chunks;  // (bin, K chunk) stages, in order
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = warp / 4;

  // thread 0 loads step i into the ring once the block has freed its stage
  // (STAGES steps back): the bin's X tile of all M planes, its ES tile and
  // its two table rows
  RingPos<STAGES> ahead;
  auto issue = [&](int i) {
    const int k = kbeg + i / chunks;
    const int c = i % chunks;
    const int k1 = k / RB;
    uint64_t* full = ahead.acquire(ring, stage_bytes);
    float* tab = reinterpret_cast<float*>(base + lay.tab) + ahead.stage * 2 * tabw;
    tma_load_4d(base + lay.a + ahead.stage * M * A_M, &x_map, full, s0, c * KC, 0, k);
    tma_load_4d(base + lay.b + ahead.stage * B_STAGE, &e_map, full, 0, c * KC, f0 / 4, k);
    tma_load_2d(tab, &t1_map, full, 0, k1);
    tma_load_2d(tab + tabw, &t2_map, full, 0, k - k1 * RB);
    ahead.next();
  };

  if (tid == 0) {
    ring.init(THREADS);
    issue(0);
  }
  __syncthreads();

  // this thread's units: accumulator pair p = h*FT/4 + j holds row
  // s0 + 16*(warp%4) + lane/4 + 8h, columns 2f and 2f+1 of its warpgroup's
  // tile, f = f0 + wg*FT + 4j + lane%4
  const int srow = s0 + 16 * (warp % 4) + lane / 4;
  const int fcol = f0 + wg * FT + lane % 4;
  {
    const size_t SF = (size_t)S * F;
    const size_t GSF = (size_t)G * SF;
#pragma unroll
    for (int u = 0; u < G * NP; ++u) {
      const int g = u / NP;
      const int p = u % NP;
      const int s = srow + 8 * (p / (FT / 4));
      const int f = fcol + 4 * (p % (FT / 4));
      const bool ok = s < S && f < F;
      const size_t gi = g * SF + (size_t)s * F + f;
      w4[u * THREADS + tid] =
          ok ? make_float4(wts[gi], wts[GSF + gi], wts[2 * GSF + gi], wts[3 * GSF + gi])
             : make_float4(0.f, 0.f, 0.f, 0.f);
      jj[u * THREADS + tid] = ok ? (idx[gi] | (idx[GSF + gi] << 16)) : 0;
    }
  }

  float gacc[M][G][NP];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < NP; ++p) gacc[m][g][p] = 0.f;
  // K8: P and Q of the current k1 row at each unit's taps j, j+1 into t2,
  // {P(j), P(j+1), Q(j), Q(j+1)}
  constexpr int MF = kFactored ? M : 1;
  float pq[MF][G][NP][4];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int h = 0; h < 4; ++h) pq[m][g][p][h] = 0.f;

  RingPos<STAGES> pos;
  for (int k = kbeg; k < kend; ++k) {
    float tacc[M][FT];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int v = 0; v < FT; ++v) tacc[m][v] = 0.f;
    float phr[kFactored ? 1 : G][NP], phm[kFactored ? 1 : G][NP];  // K1: phiU at bin k
    for (int c = 0; c < chunks; ++c) {
      const int i = (k - kbeg) * chunks + c;
      if (tid == 0 && i + 1 < steps) issue(i + 1);  // waits for step i-1's release
      pos.wait_full(ring);
      // X: 64 K rows of 128 swizzled bytes per m (a k16 step is 2048 bytes);
      // ES: 8-column chunks of KC 16-byte rows (a k16 step is 256 bytes)
      const uint64_t db = make_desc(base + lay.b + pos.stage * B_STAGE + wg * B_WG, 128,
                                    KC * 16, kNoSwizzle);
#pragma unroll
      for (int m = 0; m < M; ++m) fence_regs(tacc[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint64_t da = make_desc(base + lay.a + (pos.stage * M + m) * A_M, KC * 128,
                                      1024, kSwizzle128);
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if constexpr (FT == 16)
            wgmma_m64n32<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));
          else if constexpr (FT == 8)
            wgmma_m64n16<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));
          else
            wgmma_m64n8<1, 1>(tacc[m], desc_advance(da, 2048 * kk), desc_advance(db, 256 * kk));
        }
      }
      wgmma_commit();
      if constexpr (!kFactored) {
        if (c + 1 == chunks) {
          // while the wgmmas run: each unit's phase factor phiU = py[k1] *
          // px[k2] from the bin's table quads (c[j], c[j+1], s[j], s[j+1]) in
          // this stage and the unit's taps
          const float4* ty =
              reinterpret_cast<const float4*>(base + lay.tab) + pos.stage * tabw / 2;
          const float4* tx = ty + tabw / 4;
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const int u = (g * NP + p) * THREADS + tid;
              const float4 w = w4[u];  // a0, a1 (mu1), b0, b1 (mu2)
              const int j = jj[u];
              const float4 y = ty[j >> 16];
              const float4 x = tx[j & 0xffff];
              const float pyre = fmaf(y.y, w.w, y.x * w.z);
              const float pyim = fmaf(y.w, w.w, y.z * w.z);
              const float pxre = fmaf(x.y, w.y, x.x * w.x);
              const float pxim = fmaf(x.w, w.y, x.z * w.x);
              phr[g][p] = pyre * pxre - pyim * pxim;
              phm[g][p] = pyre * pxim + pyim * pxre;
            }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < M; ++m) fence_regs(tacc[m]);
      if (c + 1 < chunks) {  // the last chunk's stage keeps the table rows
        mbar_arrive(&ring.empty[pos.stage]);
        pos.next();
      }
    }

    if constexpr (!kFactored) {
      mbar_arrive(&ring.empty[pos.stage]);
      pos.next();

      // the gather on the accumulators: grad += Re(phiU) * Tre - Im(phiU) * Tim,
      // T rounded to T
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int v = 4 * (p % (FT / 4)) + 2 * (p / (FT / 4));
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float tr = tacc[m][v], ti = tacc[m][v + 1];
          round_pair(tr, ti, T());
#pragma unroll
          for (int g = 0; g < G; ++g)
            gacc[m][g][p] = fmaf(phr[g][p], tr, fmaf(-phm[g][p], ti, gacc[m][g][p]));
        }
      }
    } else {
      // the factored gather, with the Pallas kernel's roundings: T rounded
      // to T, then P and Q of this k1 row at each unit's taps j, j+1 into t2
      // from the bin's t2 quad (c[j], c[j+1], s[j], s[j+1]),
      //   P += c*Tre - s*Tim,  Q += s*Tre + c*Tim   (f32)
      const float4* ty = reinterpret_cast<const float4*>(base + lay.tab) + pos.stage * tabw / 2;
      const float4* tx = ty + tabw / 4;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int v = 4 * (p % (FT / 4)) + 2 * (p / (FT / 4));
#pragma unroll
        for (int m = 0; m < M; ++m) round_pair(tacc[m][v], tacc[m][v + 1], T());
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 x = tx[jj[(g * NP + p) * THREADS + tid] & 0xffff];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float tr = tacc[m][v], ti = tacc[m][v + 1];
            float(&u)[4] = pq[m][g][p];
            u[0] = fmaf(x.x, tr, fmaf(-x.z, ti, u[0]));
            u[1] = fmaf(x.y, tr, fmaf(-x.w, ti, u[1]));
            u[2] = fmaf(x.z, tr, fmaf(x.x, ti, u[2]));
            u[3] = fmaf(x.w, tr, fmaf(x.y, ti, u[3]));
          }
        }
      }
      if (k % RB == RB - 1) {
        // the row's share of the combine: P and Q rounded to T, then in f32
        //   Pw = a0*P(j) + a1*P(j+1), Qw likewise (a: mu1's taps),
        //   grad += Re(py) * Pw - Im(py) * Qw,
        // py = b0*t1[k1, j'] + b1*t1[k1, j'+1] from the row's t1 quad at
        // mu2's tap j'; then P = Q = 0
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int u = (g * NP + p) * THREADS + tid;
            const float4 w = w4[u];  // a0, a1 (mu1), b0, b1 (mu2)
            const float4 y = ty[jj[u] >> 16];
            const float pyre = fmaf(y.y, w.w, y.x * w.z);
            const float pyim = fmaf(y.w, w.w, y.z * w.z);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              float(&r)[4] = pq[m][g][p];
              const float pw = fmaf(round_as(r[1], T()), w.y, round_as(r[0], T()) * w.x);
              const float qw = fmaf(round_as(r[3], T()), w.y, round_as(r[2], T()) * w.x);
              gacc[m][g][p] = fmaf(pyre, pw, fmaf(-pyim, qw, gacc[m][g][p]));
              r[0] = r[1] = r[2] = r[3] = 0.f;
            }
          }
      }
      // the bin's stage, table rows included, is free now
      mbar_arrive(&ring.empty[pos.stage]);
      pos.next();
    }
  }

  // partial sums of this bin range: out (R, M, S, G, F)
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int s = srow + 8 * (p / (FT / 4));
    const int f = fcol + 4 * (p % (FT / 4));
    if (s >= S || f >= F) continue;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int g = 0; g < G; ++g)
        out[((((size_t)blockIdx.z * M + m) * S + s) * G + g) * F + f] = gacc[m][g][p];
  }
}

// The TMA maps of one launch: xs_t (B, M, K, S8) bf16, es_t (B, C8, K, 8)
// bf16, t1q (P1, 4*(NJ-1)) and t2q (RB, 4*(NJ-1)) f32.
struct Maps {
  CUtensorMap x, e, t1, t2;
};

inline cudaError_t make_maps(Maps* mp, const void* xs, const void* es, const void* t1q,
                             const void* t2q, int M, int B, int K, int S, int F, int P1, int RB,
                             int NJ, int ft) {
  const cuuint64_t s8 = (cuuint64_t)(S + 7) / 8 * 8;
  const cuuint64_t c8 = (cuuint64_t)(2 * F + 7) / 8;
  const cuuint64_t x_dims[4] = {s8, (cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {s8 * 2, s8 * 2 * K, s8 * 2 * K * M};
  const cuuint32_t x_box[4] = {ST, KC, (cuuint32_t)M, 1};
  cudaError_t e = make_map(&mp->x, xs, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t e_dims[4] = {8, (cuuint64_t)K, c8, (cuuint64_t)B};
  const cuuint64_t e_strides[3] = {16, 16 * (cuuint64_t)K, 16 * (cuuint64_t)K * c8};
  const cuuint32_t e_box[4] = {8, KC, (cuuint32_t)(2 * WGS * ft / 8), 1};
  e = make_map(&mp->e, es, 4, e_dims, e_strides, e_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const cuuint64_t q = 4 * (cuuint64_t)(NJ - 1);
  const cuuint32_t t_box[2] = {(cuuint32_t)q, 1};
  const cuuint64_t t_strides[1] = {q * 4};
  const cuuint64_t t1_dims[2] = {q, (cuuint64_t)P1};
  e = make_map(&mp->t1, t1q, 2, t1_dims, t_strides, t_box, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return e;
  const cuuint64_t t2_dims[2] = {q, (cuuint64_t)RB};
  return make_map(&mp->t2, t2q, 2, t2_dims, t_strides, t_box, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// One launch over R ranges of the bins, each a whole number of `unit` bins
// (K1: 1; K8: RB, a k1 row).
template <typename T, int M, int G, typename Gather>
cudaError_t launch(const Maps& mp, const int* idx, const float* wts, float* out, int B, int K,
                   int S, int F, int RB, int NJ, int unit, int R, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = dau_hopper::set_smem(spectral_grads_kernel<T, M, G, Gather>, smem);
  if (e != cudaSuccess) return e;
  constexpr int FB = WGS * Gather::tile_f(M, G);  // f per block
  const int units = B / unit;
  const int per = (units + R - 1) / R * unit;
  const dim3 grid((F + FB - 1) / FB, (S + ST - 1) / ST, R);
  spectral_grads_kernel<T, M, G, Gather><<<grid, THREADS, smem, stream>>>(
      mp.x, mp.e, mp.t1, mp.t2, idx, wts, out, B, K, S, F, RB, NJ, per);
  return cudaGetLastError();
}

// Ranges R (<= MAX_RANGES, none empty) of whole units of `unit` bins that
// fill the card in whole waves: the fewest bins per block times waves, one
// bin's worth added per wave for the block's staging. Returns R, or
// -cudaError.
template <typename T, int M, int G, typename Gather>
int ranges(int B, int S, int F, int unit, size_t smem) {
  int per_sm = 0, sms = 0;
  cudaError_t e = dau_hopper::set_smem(spectral_grads_kernel<T, M, G, Gather>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spectral_grads_kernel<T, M, G, Gather>, THREADS, smem);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  constexpr int FB = WGS * Gather::tile_f(M, G);
  const long long tiles = (long long)((F + FB - 1) / FB) * ((S + ST - 1) / ST);
  const long long slots = (long long)per_sm * sms;
  const int units = B / unit;
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= MAX_RANGES && r <= units; ++r) {
    const int per = (units + r - 1) / r;
    const int rr = (units + per - 1) / per;
    const long long cost = (tiles * rr + slots - 1) / slots * (per * unit + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rr;
    }
  }
  return best;
}

}  // namespace tc

// ------------------------------------------------------------ K1's operands

// K1's operands, built by one launch of `operands_kernel` from what the
// wrapper is handed, exactly as `fused_bwd.spectral_operands`,
// `spectral_table_quads` and `_taps` build them in torch (the card tests
// hold them equal bit for bit):
//   - units: per (g, s, f), the first non-zero entry j of each one-hot
//     column (0 if none), clamped to NJ-2, and the one-hot's entries j and
//     j+1 rounded to T: idx (2, G, S, F) int32 (mu1, mu2), wts (4, G, S, F)
//     f32 (mu1 at j, j+1; mu2 at j, j+1); a1, a2 f32 with any strides;
//   - ES: es (B, 2N, F) in T interleaved (column 2f = [Ere; Eim], 2f+1 =
//     [-Eim; Ere]) and laid out chunk-major, (B, C8, K, 8) bf16; for T =
//     float the three bf16 parts of each value stacked along K as [e1, e2,
//     e1, e3, e2, e1];
//   - X (only where xs cannot be read as it is: T = float, or S not a
//     multiple of 8): (B, M, K, S8) bf16, for T = float the parts stacked as
//     [x1, x1, x2, x1, x2, x3], zero past S;
//   - the table quads (c[j], c[j+1], s[j], s[j+1]) of t1 then t2, rounded to
//     T: (P1 + RB, NJ-1, 4) f32;
//   - with esb (B, 2N, F) and wg (G, S, F) in T, any strides, the dx
//     kernel's operands (`fused_bwd.dx_operands`): its B, the interleaved
//     error copy eb_t (B, KT, NC) bf16, row (step c, segment q, 2f' + h) of
//     bin b for f = 16c + f' holding [Ere | Eim] (h = 0) or [Eim | -Ere]
//     (h = 1) over the first 2N of NC = 2N rounded up to 8 columns, zero
//     past F and 2N, for T = float part [1, 2, 1, 3, 2, 1][q] of the split;
//     and each unit's record, (PLANES, G, F, S) u32 (`tapgemm::load_tap`).
namespace prep {

constexpr int THREADS = 256;

using tapgemm::e_part;
using tapgemm::interleaved8;
using tapgemm::table_quad;
using tapgemm::taps;
using tapgemm::to_bf16;
using tapgemm::to_f32;
using tapgemm::x_part;

struct Args {
  const void* xs;
  const void* es;
  const void* esb;               // null: no dx operands
  const void* wg;
  long long esb_st[3], wg_st[3];  // element strides of (B, 2N, F) and (G, S, F)
  const float* a1;
  const float* a2;
  long long a1_st[4], a2_st[4];  // element strides of (nj, G, S, F)
  const float* t1;
  const float* t2;
  int* idx;
  float* wts;
  __nv_bfloat16* xs_t;  // null: xs is read as it is
  __nv_bfloat16* es_t;
  float* tq;
  __nv_bfloat16* eb_t;  // the dx kernel's B: (B, KT, NC)
  uint32_t* rec;        // the dx kernel's tap records: (PLANES, G, F, S)
  int M, G, B, N, S, F, P1, RB, NJ;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
operands_kernel(const __grid_constant__ Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int segs = kF32 ? 6 : 1;
  const int N2 = 2 * a.N;
  const int K = segs * N2;
  const int S8 = (a.S + 7) / 8 * 8;
  const int C8 = (2 * a.F + 7) / 8;
  const int Q = a.NJ - 1;
  const long long n_units = (long long)a.G * a.S * a.F;
  const long long n_es = (long long)a.B * C8 * K;
  const long long n_xs = a.xs_t ? (long long)a.B * a.M * K * (S8 / 8) : 0;
  const long long n_tq = (long long)(a.P1 + a.RB) * Q;
  // the dx kernel's B: per bin KT = ceil(F/16) * segs * 32 rows (16 f per
  // step, the segments stacked within it) of NC = 2N rounded up to 8 columns
  const int NC = (N2 + 7) / 8 * 8;
  const int KT = (a.F + 15) / 16 * segs * 32;
  const long long n_eb = a.esb ? (long long)a.B * KT * (NC / 8) : 0;
  const long long total = n_units + n_es + n_xs + n_tq + n_eb;
  const T* xs = static_cast<const T*>(a.xs);
  const T* es = static_cast<const T*>(a.es);
  const size_t GSF = (size_t)n_units;

  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    if (i < n_units) {
      const int f = (int)(i % a.F);
      const int s = (int)((i / a.F) % a.S);
      const int g = (int)(i / ((long long)a.F * a.S));
      int j1, j2;
      float w[4];
      taps(a.a1 + g * a.a1_st[1] + s * a.a1_st[2] + f * a.a1_st[3], a.a1_st[0], a.NJ, j1, w[0],
           w[1], !kF32);
      taps(a.a2 + g * a.a2_st[1] + s * a.a2_st[2] + f * a.a2_st[3], a.a2_st[0], a.NJ, j2, w[2],
           w[3], !kF32);
      a.idx[i] = j1;
      a.idx[GSF + i] = j2;
#pragma unroll
      for (int q = 0; q < 4; ++q) a.wts[q * GSF + i] = w[q];
      if (a.esb) {  // the unit's dx record at (g, f, s)
        const float wv =
            to_f32(static_cast<const T*>(a.wg)[g * a.wg_st[0] + s * a.wg_st[1] + f * a.wg_st[2]]);
        uint32_t* rec = a.rec + ((size_t)g * a.F + f) * a.S + s;
        if (kF32) {
          const float v[5] = {w[0], w[1], w[2], w[3], wv};
          rec[0] = (uint32_t)j1 | ((uint32_t)j2 << 16);
#pragma unroll
          for (int q = 0; q < 5; ++q) rec[(q + 1) * GSF] = __float_as_uint(v[q]);
        } else {
          rec[0] = (__float_as_uint(wv) >> 16) | ((uint32_t)j1 << 16) | ((uint32_t)j2 << 24);
          rec[GSF] = (__float_as_uint(w[0]) >> 16) | (__float_as_uint(w[1]) & 0xffff0000u);
          rec[2 * GSF] = (__float_as_uint(w[2]) >> 16) | (__float_as_uint(w[3]) & 0xffff0000u);
        }
      }
      continue;
    }
    long long r = i - n_units;
    if (r < n_es) {  // one 8-column chunk of one K row: (b, k, c), c fastest so that
                     // neighbouring threads read neighbouring columns of es
      const int c = (int)(r % C8);
      const int k = (int)((r / C8) % K);
      const int b = (int)(r / ((long long)K * C8));
      const int q = k / N2;
      const int kk = k % N2;
      const bool im = kk >= a.N;
      const int n = im ? kk - a.N : kk;
      const T* row = es + (size_t)b * N2 * a.F;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int col = 8 * c + l;
        const int f = col / 2;
        if (f >= a.F) {
          v[l] = __float2bfloat16_rn(0.f);
          continue;
        }
        // column 2f: row kk as it is; 2f+1: [-Eim; Ere]
        const T x = (col % 2 == 0) ? row[(size_t)kk * a.F + f]
                                   : row[(size_t)(im ? n : a.N + n) * a.F + f];
        const bool neg = col % 2 == 1 && !im;
        const __nv_bfloat16 p = to_bf16(x, kF32 ? e_part(q) : 1);
        v[l] = neg ? __hneg(p) : p;
      }
      *reinterpret_cast<uint4*>(a.es_t + (((size_t)b * C8 + c) * K + k) * 8) =
          *reinterpret_cast<const uint4*>(v);
      continue;
    }
    r -= n_es;
    if (r < n_xs) {  // 8 s of one (b, m, k) row
      const int s8 = (int)(r % (S8 / 8));
      const long long bmk = r / (S8 / 8);
      const int k = (int)(bmk % K);
      const long long bm = bmk / K;
      const int q = k / N2;
      const T* src = xs + ((size_t)bm * N2 + k % N2) * a.S;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int s = 8 * s8 + l;
        v[l] = s < a.S ? to_bf16(src[s], kF32 ? x_part(q) : 1) : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(a.xs_t + (size_t)r * 8) = *reinterpret_cast<const uint4*>(v);
      continue;
    }
    r -= n_xs;
    if (r >= n_tq) {  // the dx kernel's B: 8 columns of one (b, row) of the
                      // interleaved error copy ([Ere | Eim], [Eim | -Ere]),
                      // columns fastest
      r -= n_tq;
      const int c = (int)(r % (NC / 8));
      const int row = (int)((r / (NC / 8)) % KT);
      const int b = (int)(r / ((long long)KT * (NC / 8)));
      const T* eb = static_cast<const T*>(a.esb) + b * a.esb_st[0];
      *reinterpret_cast<uint4*>(a.eb_t + (((size_t)b * KT + row) * NC + 8 * c)) =
          interleaved8<T, false>(eb, a.esb_st[1], a.esb_st[2], row, c, segs, a.N, a.F);
      continue;
    }
    {  // one table quad: row k of t1 (k < P1) or of t2
      const int j = (int)(r % Q);
      const int k = (int)(r / Q);
      const bool first = k < a.P1;
      const float4 o = first ? table_quad<T>(a.t1, a.P1, k, j, a.NJ)
                             : table_quad<T>(a.t2, a.RB, k - a.P1, j, a.NJ);
      reinterpret_cast<float4*>(a.tq)[r] = o;
    }
  }
}

}  // namespace prep

// ------------------------------------------------------------------ K2's dx

// K2's input-gradient spectra (the dx kernel; K8 dx takes it too): per bin
// k = k1*RB + k2 one GEMM on the tensor cores (`tapgemm::tap_gemm`, shared
// with K3),
//
//   D[s, c] = sum_kk A[s, kk] * Bk[kk, c],   A[s, 2f] = Vr[s, f], A[s, 2f+1] = Vi[s, f],
//   Bk[2f] = [Ere | Eim],  Bk[2f+1] = [Eim | -Ere]   (N columns each),
//
// V[k,s,f] = sum_g w[g,s,f] * phiU[k,g,s,f] (`tapgemm::WeightedUnits`), so
// column n < N of D is dXre[k, n, s] and column N + n is dXim: D^T is the
// bin's slice of dxs (B, 2N, S), [dXre; dXim] rows. B (the "interleaved
// error copy" Bk) and the units' tap records are built with K1's operands in
// the same launch.
namespace dx {

// eb_map: eb_t (B, KT, NC) bf16, KT = ceil(F/16) * SEGS * 32 rows, NC =
// 2N rounded up to 8; rec (PLANES, G, F, S) u32; tq (P1 + RB, NJ-1) float4
// quads of t1 then t2, rounded to T; dxs (B, 2N, S) f32.
// Three blocks per SM (<= 170 registers) where that costs no spill: bf16
// operands, G <= 2 (f32's shared memory holds one block an SM anyway).
template <typename T, int G>
__global__ void __launch_bounds__(tapgemm::THREADS, sizeof(T) == 2 && G <= 2 ? 3 : 1)
spectral_dx_kernel(const __grid_constant__ CUtensorMap eb_map, const uint32_t* __restrict__ rec,
                   const float4* __restrict__ tq, float* __restrict__ dxs, int B, int N2, int S,
                   int F, int P1, int RB, int NJ, int per) {
  tapgemm::tap_gemm<T, G, tapgemm::WeightedUnits>(&eb_map, rec, tq, dxs, B, N2, S, F, G, P1, RB,
                                                  NJ, per);
}

}  // namespace dx

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

template <typename T, typename Gather>
int tc_ranges(int M, int G, int B, int S, int F, int unit, size_t smem) {
#define DAU_RANGES(MM, GG) tc::ranges<T, MM, GG, Gather>(B, S, F, unit, smem)
  DAU_MG_DISPATCH(DAU_RANGES)
#undef DAU_RANGES
}

template <typename T, typename Gather>
int tc_launch(int M, int G, const tc::Maps& mp, const int* idx, const float* wts, float* out,
              int B, int K, int S, int F, int RB, int NJ, int unit, int R, size_t smem,
              cudaStream_t stream) {
#define DAU_LAUNCH(MM, GG)                                                                 \
  -(int)tc::launch<T, MM, GG, Gather>(mp, idx, wts, out, B, K, S, F, RB, NJ, unit, R, smem, \
                                      stream)
  DAU_MG_DISPATCH(DAU_LAUNCH)
#undef DAU_LAUNCH
}

// Shared-memory bytes of the kernel under `Gather` for M filters, G units
// and NJ exponents (the bins' table rows are streamed: P1 and RB do not
// enter), or -1 where M, G or NJ has no instance.
template <typename Gather>
long long tc_smem_bytes(int M, int G, int NJ) {
  if (M < 3 || M > 4 || G < 1 || G > 4 || NJ < 2 || NJ > NJ_MAX) return -1;
  return tc::layout(M, G, NJ, Gather::tile_f(M, G)).bytes;
}

// Ranges of whole units of `unit` bins (see tc::ranges), or -cudaError.
template <typename Gather>
int ranges_of(int dtype, int M, int G, int B, int S, int F, int NJ, int unit) {
  const long long smem = tc_smem_bytes<Gather>(M, G, NJ);
  if (smem < 0 || unit < 1 || B % unit != 0) return -(int)cudaErrorInvalidValue;
  return dtype == 0 ? tc_ranges<float, Gather>(M, G, B, S, F, unit, (size_t)smem)
                    : tc_ranges<__nv_bfloat16, Gather>(M, G, B, S, F, unit, (size_t)smem);
}

// One launch of the kernel under `Gather` over R ranges of whole units of
// `unit` bins; the arguments of dau_spectral_grads_launch. Returns a
// cudaError_t.
template <typename Gather>
int launch_of(const void* xs_t, const void* es_t, const void* t1q, const void* t2q,
              const void* idx, const void* wts, void* out, int dtype, int M, int G, int B, int K,
              int S, int F, int P1, int RB, int NJ, int unit, int R, long long smem,
              void* stream) {
  if (B <= 0 || K <= 0 || S <= 0 || F <= 0 || P1 <= 0 || RB <= 0 || B % unit != 0 || R < 1 ||
      R > B / unit || smem != tc_smem_bytes<Gather>(M, G, NJ))
    return (int)cudaErrorInvalidValue;
  tc::Maps mp;
  cudaError_t e = tc::make_maps(&mp, xs_t, es_t, t1q, t2q, M, B, K, S, F, P1, RB, NJ,
                                Gather::tile_f(M, G));
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  const float* fw = static_cast<const float*>(wts);
  float* fo = static_cast<float*>(out);
  int r;
  if (dtype == 0)
    r = tc_launch<float, Gather>(M, G, mp, ii, fw, fo, B, K, S, F, RB, NJ, unit, R,
                                 (size_t)smem, st);
  else if (dtype == 1)
    r = tc_launch<__nv_bfloat16, Gather>(M, G, mp, ii, fw, fo, B, K, S, F, RB, NJ, unit, R,
                                         (size_t)smem, st);
  else
    return (int)cudaErrorInvalidValue;
  return -r;
}

// f(T, G) instantiated for G in {1..4} (the dx kernel)
#define DAU_G_DISPATCH(CALL)                  \
  switch (G) {                                \
    case 1: return CALL(1);                   \
    case 2: return CALL(2);                   \
    case 3: return CALL(3);                   \
    case 4: return CALL(4);                   \
    default: return -(int)cudaErrorInvalidValue; \
  }

template <typename T>
int dx_ranges_of(int G, int B, int N2, int S, int NJ) {
#define DAU_DX_RANGES(GG) tapgemm::ranges<T>(dx::spectral_dx_kernel<T, GG>, B, N2, S, NJ)
  DAU_G_DISPATCH(DAU_DX_RANGES)
#undef DAU_DX_RANGES
}

template <typename T>
int dx_launch_of(int G, const CUtensorMap& map, const uint32_t* rec, const float4* tq, float* dxs,
                 int B, int N2, int S, int F, int P1, int RB, int NJ, int R, cudaStream_t st) {
#define DAU_DX_LAUNCH(GG)                                                                        \
  -(int)tapgemm::launch<T>(dx::spectral_dx_kernel<T, GG>, B, N2, S, NJ, R, st, map, rec, tq, dxs, \
                           B, N2, S, F, P1, RB, NJ)
  DAU_G_DISPATCH(DAU_DX_LAUNCH)
#undef DAU_DX_LAUNCH
}

}  // namespace

extern "C" {

// Shared-memory bytes of K1 for M filters, G units and NJ exponents (the
// bins' table rows are streamed: P1 and RB do not enter), or -1 where M, G
// or NJ has no instance.
long long dau_spectral_grads_smem_bytes(int M, int G, int P1, int RB, int NJ) {
  (void)P1;
  (void)RB;
  return tc_smem_bytes<tc::PhiGather>(M, G, NJ);
}

// Bin ranges for K1 so its grid fills the card in whole waves. Returns the
// count (>= 1, <= B), or -cudaError on failure.
int dau_spectral_grads_ranges(int dtype, int M, int G, int B, int S, int F, int P1, int RB,
                              int NJ) {
  (void)P1;
  (void)RB;
  return ranges_of<tc::PhiGather>(dtype, M, G, B, S, F, NJ, 1);
}

// K1: xs_t (B, M, K, S8) bf16 and es_t (B, C8, K, 8) bf16 from
// `fused_bwd.spectral_operands` (K = 2N for dtype 1, bf16 spectra; 12N for
// dtype 0, f32 spectra split in three; S8 = S rounded up to 8, C8 = 2F / 8
// rounded up); t1q (P1, 4*(NJ-1)), t2q (RB, 4*(NJ-1)) f32 table quads;
// idx (2, G, S, F) int32, wts (4, G, S, F) f32; out (R, M, S, G, F) f32
// partial sums over R bin ranges. dtype picks the rounding of T (0: none,
// 1: bf16). Returns a cudaError_t.
int dau_spectral_grads_launch(const void* xs_t, const void* es_t, const void* t1q,
                              const void* t2q, const void* idx, const void* wts, void* out,
                              int dtype, int M, int G, int B, int K, int S, int F, int P1, int RB,
                              int NJ, int R, long long smem, void* stream) {
  return launch_of<tc::PhiGather>(xs_t, es_t, t1q, t2q, idx, wts, out, dtype, M, G, B, K, S, F,
                                  P1, RB, NJ, 1, R, smem, stream);
}

// Shared-memory bytes of K8 (the factored gather, K1's kernel with
// `FactoredGather`), or -1 where M, G or NJ has no instance.
long long dau_factored_grads_smem_bytes(int M, int G, int P1, int RB, int NJ) {
  (void)P1;
  (void)RB;
  return tc_smem_bytes<tc::FactoredGather>(M, G, NJ);
}

// Ranges of whole k1 rows (RB bins each) for K8 so its grid fills the card
// in whole waves. Returns the count (>= 1, <= P1), or -cudaError.
int dau_factored_grads_ranges(int dtype, int M, int G, int B, int S, int F, int P1, int RB,
                              int NJ) {
  if (B != P1 * RB) return -(int)cudaErrorInvalidValue;
  return ranges_of<tc::FactoredGather>(dtype, M, G, B, S, F, NJ, RB);
}

// K8: the arguments of K1's launch (B = P1*RB); out (R, M, S, G, F) f32
// partial sums over R ranges of whole k1 rows. Returns a cudaError_t.
int dau_factored_grads_launch(const void* xs_t, const void* es_t, const void* t1q,
                              const void* t2q, const void* idx, const void* wts, void* out,
                              int dtype, int M, int G, int B, int K, int S, int F, int P1, int RB,
                              int NJ, int R, long long smem, void* stream) {
  if (B != P1 * RB) return (int)cudaErrorInvalidValue;
  return launch_of<tc::FactoredGather>(xs_t, es_t, t1q, t2q, idx, wts, out, dtype, M, G, B, K,
                                       S, F, P1, RB, NJ, RB, R, smem, stream);
}

// K1's operands (see `prep::operands_kernel`): xs (B, M, 2N, S) and es (B,
// 2N, F) in dtype (0 f32, 1 bf16), contiguous; a1, a2 (NJ, G, S, F) f32 with
// element strides a_strides[0..3] and [4..7]; t1 (2*P1, NJ), t2 (2*RB, NJ)
// f32. Writes idx (2, G, S, F) int32, wts (4, G, S, F) f32, es_t (B, C8, K,
// 8) bf16, tq (P1 + RB, NJ-1, 4) f32 and, where xs_t is not null, xs_t (B,
// M, K, S8) bf16. Where esb is not null, also the dx kernel's operands from
// esb (B, 2N, F) and wg (G, S, F) in dtype with element strides
// dx_strides[0..2] and [3..5]: eb_t (B, KT, NC) bf16 and rec (PLANES, G,
// F, S) u32 (KT = ceil(F/16)*32 for bf16, *192 for f32; NC = 2N rounded up
// to 8; PLANES 3 for bf16, 6 for f32). Returns a cudaError_t.
int dau_spectral_operands_launch(const void* xs, const void* es, const void* a1, const void* a2,
                                 const long long* a_strides, const void* t1, const void* t2,
                                 void* idx, void* wts, void* xs_t, void* es_t, void* tq,
                                 const void* esb, const void* wg, const long long* dx_strides,
                                 void* eb_t, void* rec, int dtype, int M, int G, int B, int N,
                                 int S, int F, int P1, int RB, int NJ, void* stream) {
  if (NJ < 2 || NJ > NJ_MAX || (dtype == 0 && xs_t == nullptr) ||
      (dtype == 1 && (S % 8 != 0) != (xs_t != nullptr)) ||
      (esb != nullptr && (wg == nullptr || eb_t == nullptr || rec == nullptr)))
    return (int)cudaErrorInvalidValue;
  prep::Args a;
  a.xs = xs;
  a.es = es;
  a.esb = esb;
  a.wg = wg;
  a.a1 = static_cast<const float*>(a1);
  a.a2 = static_cast<const float*>(a2);
  for (int i = 0; i < 4; ++i) {
    a.a1_st[i] = a_strides[i];
    a.a2_st[i] = a_strides[4 + i];
  }
  for (int i = 0; i < 3; ++i) {
    a.esb_st[i] = esb ? dx_strides[i] : 0;
    a.wg_st[i] = esb ? dx_strides[3 + i] : 0;
  }
  a.t1 = static_cast<const float*>(t1);
  a.t2 = static_cast<const float*>(t2);
  a.idx = static_cast<int*>(idx);
  a.wts = static_cast<float*>(wts);
  a.xs_t = static_cast<__nv_bfloat16*>(xs_t);
  a.es_t = static_cast<__nv_bfloat16*>(es_t);
  a.tq = static_cast<float*>(tq);
  a.eb_t = static_cast<__nv_bfloat16*>(eb_t);
  a.rec = static_cast<uint32_t*>(rec);
  a.M = M, a.G = G, a.B = B, a.N = N, a.S = S, a.F = F, a.P1 = P1, a.RB = RB, a.NJ = NJ;
  const long long segs = dtype == 0 ? 6 : 1;
  const long long k = segs * 2 * N;
  const long long total =
      (long long)G * S * F + (long long)B * ((2 * F + 7) / 8) * k +
      (xs_t ? (long long)B * M * k * ((S + 7) / 8) : 0) + (long long)(P1 + RB) * (NJ - 1) +
      (esb ? (long long)B * ((F + 15) / 16 * segs * 32) * ((2 * N + 7) / 8) : 0);
  int sms = 0;
  cudaError_t e = dau_hopper::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long want = (total + prep::THREADS - 1) / prep::THREADS;
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    prep::operands_kernel<float><<<grid, prep::THREADS, 0, st>>>(a);
  else if (dtype == 1)
    prep::operands_kernel<__nv_bfloat16><<<grid, prep::THREADS, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The dx kernel's dynamic shared memory at NJ exponents, or -1 where dtype
// or NJ has no instance.
long long dau_spectral_dx_smem_bytes(int dtype, int NJ) {
  if (NJ < 2 || NJ > NJ_MAX) return -1;
  if (dtype == 0) return tapgemm::layout<float>(NJ).bytes;
  if (dtype == 1) return tapgemm::layout<__nv_bfloat16>(NJ).bytes;
  return -1;
}

// Ranges of the dx kernel's groups of bins so its grid fills the card in
// whole waves. Returns the count (>= 1), or -cudaError.
int dau_spectral_dx_ranges(int dtype, int G, int B, int N, int S, int NJ) {
  if (B <= 0 || N <= 0 || S <= 0 || NJ < 2 || NJ > NJ_MAX) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return dx_ranges_of<float>(G, B, 2 * N, S, NJ);
  if (dtype == 1) return dx_ranges_of<__nv_bfloat16>(G, B, 2 * N, S, NJ);
  return -(int)cudaErrorInvalidValue;
}

// K2's dx kernel (K8 dx takes it too): eb_t (B, KT, NC) bf16 and rec
// (PLANES, G, F, S) u32 from the operand kernel, tq its (P1 + RB, NJ-1, 4)
// f32 table quads; dxs (B, 2N, S) f32, [dXre; dXim] rows; R ranges of
// groups of bins (dau_spectral_dx_ranges). Returns a cudaError_t.
int dau_spectral_dx_launch(const void* eb_t, const void* rec, const void* tq, void* dxs,
                           int dtype, int G, int B, int N, int S, int F, int P1, int RB, int NJ,
                           int R, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || F <= 0 || P1 <= 0 || RB <= 0 || B != P1 * RB || NJ < 2 ||
      NJ > NJ_MAX || R < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int segs = dtype == 0 ? 6 : 1;
  const cuuint64_t nc = (cuuint64_t)(2 * N + 7) / 8 * 8;
  const cuuint64_t kt = (cuuint64_t)(F + 15) / 16 * segs * 32;
  const cuuint64_t dims[3] = {nc, kt, (cuuint64_t)B};
  const cuuint64_t strides[2] = {nc * 2, nc * 2 * kt};
  const cuuint32_t box[3] = {(cuuint32_t)tapgemm::NT, (cuuint32_t)segs * 32, 1};
  CUtensorMap map;
  cudaError_t e = dau_hopper::make_map(&map, eb_t, 3, dims, strides, box,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* rr = static_cast<const uint32_t*>(rec);
  const float4* q = static_cast<const float4*>(tq);
  float* out = static_cast<float*>(dxs);
  const int r = dtype == 0
                    ? dx_launch_of<float>(G, map, rr, q, out, B, 2 * N, S, F, P1, RB, NJ, R, st)
                    : dx_launch_of<__nv_bfloat16>(G, map, rr, q, out, B, 2 * N, S, F, P1, RB,
                                                  NJ, R, st);
  return -r;
}

}  // extern "C"
