// The per-bin GEMM whose A is built from tap records, for Hopper (sm_90a):
// the mainloop of K2's dx kernel (`spectral_dx_kernel`, dau_spectral_grads.cu)
// and of K3's products kernel (`apply_phi_gemm_kernel`, dau_apply_phi.cu),
// and the pieces of their operand kernels that both use.
//
// Per bin k = k1*RB + k2 one GEMM on the tensor cores,
//
//   D[s, c] = sum_kk A[s, kk] * Bk[kk, c],   A[s, 2f] = Vr[s, f], A[s, 2f+1] = Vi[s, f],
//
// s the output's S rows, f the F contracted channels, c the 2N columns
// (n < N the real parts, N + n the imaginary ones): D^T is the bin's slice of
// a (B, 2N, S) result, [re; im] rows. V[k, s, f] sums the G units at (s, f),
// each unit's phase factor phiU[k] = py[k1] * px[k2] built from the bin's
// table quads and the unit's two bilinear taps per axis: py from t1 at mu2's
// taps (j2, b), px from t2 at mu1's (j1, a). How the units sum is the policy
// `A`:
//   - K2 (`WeightedUnits`): V = sum_g w * phiU in f32, rounded once;
//   - K3 (`RoundedUnits`): Phi = sum_g round(phiU_g), each unit's product and
//     each partial sum rounded to the operand dtype, as the Pallas kernel's
//     phi scratch stores it; w is folded into mu2's taps.
// Bk's sign pattern is its operand kernel's: K2's rows 2f, 2f+1 are [Ere |
// Eim], [Eim | -Ere] (conj(phiU) against the error), K3's [Xre | Xim],
// [-Xim | Xre] (`interleaved8`).
//   - the wgmma M is 64 s, its N 64 of the 2N columns (ragged 2N through
//     TMA's zeros), its K the 32 rows of 16 f per step: B comes by TMA,
//     128-byte swizzled MN-major, through a ring of RING stages;
//   - A is built on the FP32 units per step from the units' tap records
//     (one compact record per (g, f, s), s innermost, so a warp's loads are
//     coalesced) and the bins' staged table quads, rounded to bf16 (f32
//     operands: split in three, stacked along K against B's parts as K1
//     stacks them, six products), and written to a no-swizzle K-major tile
//     that the wgmmas read; two A buffers, so the next step's A is built
//     while this step's wgmmas run;
//   - a block owns 64 s, 64 columns and a range of groups of NB bins; each
//     tap record it loads feeds the A tiles of the group's NB bins, each bin
//     with its own 32 f32 sums per thread, summed over all F and then
//     stored: each element of D is written by one block, in one order;
//   - the ranges of groups are chosen so the grid fills the card in whole
//     waves (`ranges`).
// What paces it (`tools/k1_variants.py --dx` on an H100, N = 32, bf16, K2 at
// conv3-conv5): the warps in flight to hide each step's dependent chain
// (load a record, read its quads, build V). Two bins a group at three
// blocks per SM (<= 170 registers) beat three bins at two by 21%, one bin
// at four tied; without the records' loads it takes a third less; a deeper
// ring, or no proxy fence and barrier per step, change nothing.

#pragma once

#include "dau_hopper_gemm.cuh"

namespace {
namespace tapgemm {

using namespace dau_hopper;

// ----------------------------------------------------- operand pieces

// a value rounded to T and widened back
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// part q (1, 2, 3) of v's three-way bf16 split (`forward.split_bf16_3`)
__device__ __forceinline__ __nv_bfloat16 split_part(float v, int q) {
  const __nv_bfloat16 p1 = __float2bfloat16_rn(v);
  if (q == 1) return p1;
  const float r = v - __bfloat162float(p1);
  const __nv_bfloat16 p2 = __float2bfloat16_rn(r);
  if (q == 2) return p2;
  return __float2bfloat16_rn(r - __bfloat162float(p2));
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v, int q) { return split_part(v, q); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v, int) { return v; }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// which part segment q of the K stack holds: X [1, 1, 2, 1, 2, 3], ES [1,
// 2, 1, 3, 2, 1]; bf16 spectra have one segment. A takes X's parts, B ES's.
__device__ __forceinline__ int x_part(int q) { return q < 2 ? 1 : (q == 2 || q == 4 ? 2 : (q == 3 ? 1 : 3)); }
__device__ __forceinline__ int e_part(int q) { return q == 0 || q == 2 || q == 5 ? 1 : (q == 3 ? 3 : 2); }

// The two taps of one bilinear one-hot column col[i * st] (i < NJ; f32 or
// bf16 entries): the first non-zero entry j (0 if none), clamped to NJ-2,
// and the entries j, j+1, rounded to bf16 where `bf16` (`fused_bwd._taps`).
template <typename E>
__device__ __forceinline__ void taps(const E* col, long long st, int NJ, int& j, float& w0,
                                     float& w1, bool bf16) {
  // every entry read (no early exit), so the loads are all in flight
  j = NJ;
#pragma unroll 4
  for (int i = NJ - 1; i >= 0; --i)
    if (to_f32(col[i * st]) != 0.f) j = i;
  j = min(j == NJ ? 0 : j, NJ - 2);
  w0 = to_f32(col[j * st]);
  w1 = to_f32(col[(j + 1) * st]);
  if (bf16) {
    w0 = __bfloat162float(__float2bfloat16_rn(w0));
    w1 = __bfloat162float(__float2bfloat16_rn(w1));
  }
}

// Table quad j (c[j], c[j+1], s[j], s[j+1]) of row kr of a [cos; sin] table
// (2*rows, NJ) f32, rounded to T.
template <typename T>
__device__ __forceinline__ float4 table_quad(const float* t, int rows, int kr, int j, int NJ) {
  const float* c = t + (size_t)kr * NJ;
  const float* sn = t + (size_t)(rows + kr) * NJ;
  return make_float4(round_as(c[j], T()), round_as(c[j + 1], T()), round_as(sn[j], T()),
                     round_as(sn[j + 1], T()));
}

// 8 columns 8c .. 8c+7 of row `row` of one bin's B, the interleaved copy of
// its (2N, F) spectra e (element strides st_n, st_f): for f = 16*step + f',
// row (step, segment q, 2f' + h) holds, over the 2N columns, [Er | Ei] (h =
// 0) and the swapped halves [Ei | Er] (h = 1), one of whose halves is
// negated: the first (kNegFirst, K3: [-Xim | Xre]) or the second (K2: [Eim
// | -Ere]). Zero past F and 2N; for T = float part e_part(q) of the split.
template <typename T, bool kNegFirst>
__device__ __forceinline__ uint4 interleaved8(const T* e, long long st_n, long long st_f, int row,
                                              int c, int segs, int N, int F) {
  const int q = (row / 32) % segs;
  const int f = row / (32 * segs) * 16 + (row % 32) / 2;
  const bool odd = row % 2 == 1;
  const T* ef = e + f * st_f;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int col = 8 * c + l;
    if (f >= F || col >= 2 * N) {
      v[l] = __float2bfloat16_rn(0.f);
      continue;
    }
    const bool im = col >= N;  // the imaginary half of the columns
    const int n = im ? col - N : col;
    const int src = (odd != im) ? N + n : n;  // the imaginary part where exactly one holds
    const __nv_bfloat16 p = to_bf16(ef[src * st_n], sizeof(T) == 4 ? e_part(q) : 1);
    v[l] = odd && (im != kNegFirst) ? __hneg(p) : p;
  }
  return *reinterpret_cast<const uint4*>(v);
}

// ------------------------------------------------------------ the GEMM

constexpr int ST = 64;       // s per block: the wgmma M
constexpr int NT = 64;       // columns of 2N per block: the wgmma N
constexpr int FC = 16;       // f per step: 32 K rows per stacked segment
constexpr int NB = 2;        // bins per group
constexpr int THREADS = 128;
constexpr int TILE = ST * 2 * FC * 2;  // bytes of one 64 x 32 bf16 tile (A or B)

// per operand dtype: the stacked segments of B (the parts of A they meet:
// `x_part`), the parts of A, the stages of B's ring
template <typename T>
struct Fmt {
  static constexpr int SEGS = 1, PARTS = 1, RING = 3;
};
template <>
struct Fmt<float> {
  static constexpr int SEGS = 6, PARTS = 3, RING = 2;
};

// Shared memory: B stages, A buffers, the group's table quads, the ring.
struct Layout {
  int b, a, tab, ring, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int NJ) {
  using Q = Fmt<T>;
  Layout l;
  l.b = 0;                                    // [RING][NB][SEGS][32 kk][64 c] bf16, swizzled
  l.a = l.b + Q::RING * NB * Q::SEGS * TILE;  // [2][NB][PARTS][4 k8][64 s][8 kk] bf16
  l.tab = l.a + 2 * NB * Q::PARTS * TILE;     // [NB][2][NJ-1] float4 (t1 row, t2 row)
  l.ring = l.tab + NB * 2 * (NJ - 1) * 16;
  l.bytes = 1024 + l.ring + (int)sizeof(Ring<Q::RING>);
  return l;
}

// A unit's record at (g, f, s): bf16 operands, three planes of u32 (w | j1
// << 16 | j2 << 24; a0 | a1 << 16; b0 | b1 << 16, bf16 bits); f32, (j1 | j2
// << 16; a0; a1; b0; b1) and, where the policy weighs the units, w. j1 and a
// are mu1's taps (into t2), j2 and b mu2's (into t1); the weights are
// rounded to the operand dtype. bf16 records keep j in 8 bits: NJ <= 256.
struct Tap {
  int j1, j2;
  float a0, a1, b0, b1, w;
};

// kW: the policy uses the record's weight (f32 records without it have no
// plane for it).
template <bool kW>
__device__ __forceinline__ Tap load_tap(const uint32_t* rec, size_t plane, size_t at,
                                        __nv_bfloat16) {
  const uint32_t u0 = __ldg(rec + at), u1 = __ldg(rec + plane + at),
                 u2 = __ldg(rec + 2 * plane + at);
  Tap t;
  t.w = __uint_as_float(u0 << 16);
  t.j1 = (u0 >> 16) & 0xff;
  t.j2 = u0 >> 24;
  t.a0 = __uint_as_float(u1 << 16);
  t.a1 = __uint_as_float(u1 & 0xffff0000u);
  t.b0 = __uint_as_float(u2 << 16);
  t.b1 = __uint_as_float(u2 & 0xffff0000u);
  return t;
}

template <bool kW>
__device__ __forceinline__ Tap load_tap(const uint32_t* rec, size_t plane, size_t at, float) {
  const uint32_t u0 = __ldg(rec + at);
  Tap t;
  t.j1 = u0 & 0xffff;
  t.j2 = u0 >> 16;
  t.a0 = __uint_as_float(__ldg(rec + plane + at));
  t.a1 = __uint_as_float(__ldg(rec + 2 * plane + at));
  t.b0 = __uint_as_float(__ldg(rec + 3 * plane + at));
  t.b1 = __uint_as_float(__ldg(rec + 4 * plane + at));
  t.w = kW ? __uint_as_float(__ldg(rec + 5 * plane + at)) : 1.f;
  return t;
}

// K2: V = sum_g w * phiU, f32 sums rounded once when A is written. A record
// past S or F weighs 0 (`mask`). The G units are one pass.
struct WeightedUnits {
  static constexpr bool kWeight = true, kChunked = false;
  __device__ static void mask(Tap& t) { t.w = 0.f; }
  template <typename T>
  __device__ static void add(float& v, float u, const Tap& t) {
    v = fmaf(u, t.w, v);
  }
};

// K3: Phi = sum_g round(phiU_g), each partial sum rounded too (no rounding
// for f32 operands); starting from 0 the first unit's sum is its own product, as the
// Pallas kernel's scratch holds it. A record past S, F or the units has mu2's
// weights 0. kChunked: any number of units, G (the instance) at a time, in a
// loop whose registers cost the bf16 G = 2 instance its spill-free three
// blocks an SM; else the G units are one pass, as K2's.
template <bool kChunks>
struct RoundedUnits {
  static constexpr bool kWeight = false, kChunked = kChunks;
  __device__ static void mask(Tap& t) { t.b0 = t.b1 = 0.f; }
  template <typename T>
  __device__ static void add(float& v, float u, const Tap&) {
    v = round_as(v + round_as(u, T()), T());
  }
};

// (re, im) rounded to bf16 as one word (re in the low half), or the f32
// split's part `part` (0, 1, 2) of each
__device__ __forceinline__ uint32_t pack_part(float re, float im, int part) {
  if (part > 0) {
    float r = re - __bfloat162float(__float2bfloat16_rn(re));
    float q = im - __bfloat162float(__float2bfloat16_rn(im));
    if (part > 1) {
      r -= __bfloat162float(__float2bfloat16_rn(r));
      q -= __bfloat162float(__float2bfloat16_rn(q));
    }
    re = r;
    im = q;
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(re, im);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void st_shared_v4(uint8_t* p, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(smem_u32(p)), "r"(a), "r"(b),
               "r"(c), "r"(d)
               : "memory");
}

// The body of a block: b_map over B (B, KT, NC) bf16, KT = ceil(F/16) * SEGS
// * 32 rows, NC = 2N rounded up to 8 columns; rec (PLANES, units, F, S) u32;
// tq (P1 + RB, NJ-1) float4 quads of t1 then t2, rounded to T; out (B, 2N,
// S) f32, D^T of each bin. Group u holds bins u*NB .. u*NB + NB - 1 (fewer in the last); the
// block walks groups z*per .. z*per + per - 1. G is the units per pass: all
// of them (units == G) unless the policy is chunked.
template <typename T, int G, typename A>
__device__ __forceinline__ void tap_gemm(const CUtensorMap* b_map, const uint32_t* __restrict__ rec,
                                         const float4* __restrict__ tq, float* __restrict__ out,
                                         int B, int N2, int S, int F, int units, int P1, int RB,
                                         int NJ, int per) {
  using Q = Fmt<T>;
  constexpr int SEGS = Q::SEGS, PARTS = Q::PARTS, RING = Q::RING;
  const Layout lay = layout<T>(NJ);
  const int q = NJ - 1;  // quads per table row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float4* tab = reinterpret_cast<float4*>(base + lay.tab);
  Ring<RING>& ring = *reinterpret_cast<Ring<RING>*>(base + lay.ring);

  const int s0 = blockIdx.x * ST;
  const int c0 = blockIdx.y * NT;
  const int groups = (B + NB - 1) / NB;
  const int gbeg = blockIdx.z * per;
  const int gend = min(groups, gbeg + per);
  const int chunks = (F + FC - 1) / FC;
  const int steps = (gend - gbeg) * chunks;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // this thread builds A row r (s = s0 + r), f = 8*half .. 8*half + 7 of
  // each step's 16: pieces 2*half and 2*half + 1 of 8 K rows (4 f)
  const int r = tid % ST;
  const int half = tid / ST;
  const int s = s0 + r;
  const int gn = A::kChunked ? units : G;
  const size_t plane = (size_t)gn * F * S;

  RingPos<RING> ahead;
  auto issue = [&](int i) {
    const int k0 = (gbeg + i / chunks) * NB;
    const int nb = min(NB, B - k0);
    uint64_t* full = ahead.acquire(ring, nb * SEGS * TILE);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb)
        tma_load_3d(base + lay.b + ((ahead.stage * NB + b) * SEGS) * TILE, b_map, full, c0,
                    (i % chunks) * SEGS * 32, k0 + b);
    ahead.next();
  };
  if (tid == 0) {
    ring.init(THREADS);
    for (int i = 0; i < RING - 1 && i < steps; ++i) issue(i);
  }
  __syncthreads();

  // the sums of the group's bins: zeroed once here, and each group's first
  // wgmma restarts them (no other instruction writes them inside the
  // pipeline, so ptxas need not serialize the wgmmas)
  float acc[NB][NT / 2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int v = 0; v < NT / 2; ++v) acc[b][v] = 0.f;
  RingPos<RING> pos;
  int pending = -1;  // the stage of the previous step, if its wgmmas may still read it
  for (int i = 0; i < steps; ++i) {
    const int c = i % chunks;
    const int k0 = (gbeg + i / chunks) * NB;
    const int nb = min(NB, B - k0);
    if (c == 0) {
      // the group's table rows: t1 row k1 and t2 row k2 of each bin (every
      // read of the previous group's rows was before the last step's barrier)
      for (int e = tid; e < NB * 2 * q; e += THREADS) {
        const int b = e / (2 * q);
        const int t = (e / q) % 2;
        const int k = min(k0 + b, B - 1);
        tab[e] = tq[(t == 0 ? k / RB : P1 + k % RB) * q + e % q];
      }
      __syncthreads();
    }

    // A of this step: V[s, f] of each bin for the thread's 8 f, rounded to
    // bf16 (or split in three) and written as two 16-byte pieces per bin
    // and part
    uint8_t* abuf = base + lay.a + (i % 2) * NB * PARTS * TILE;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      float vr[NB][4], vi[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) vr[b][e] = vi[b][e] = 0.f;
      for (int g0 = 0; g0 < gn; g0 += G) {
        // the piece's 4 f x G records, all loads issued before any is used
        // (clamped addresses, masked past S, F and the units, so no branch
        // holds them)
        Tap taps[4][G];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = c * FC + 8 * half + 4 * pp + e;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int gi = A::kChunked ? min(g0 + g, gn - 1) : g;
            taps[e][g] = load_tap<A::kWeight>(
                rec, plane, ((size_t)gi * F + min(f, F - 1)) * S + min(s, S - 1), T());
            if (s >= S || f >= F || (A::kChunked && g0 + g >= gn)) A::mask(taps[e][g]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const Tap& t = taps[e][g];
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              if (b >= nb) break;
              const float4 y = tab[(2 * b) * q + t.j2];      // t1 quad at mu2's tap
              const float4 x = tab[(2 * b + 1) * q + t.j1];  // t2 quad at mu1's tap
              const float pyre = fmaf(y.y, t.b1, y.x * t.b0);
              const float pyim = fmaf(y.w, t.b1, y.z * t.b0);
              const float pxre = fmaf(x.y, t.a1, x.x * t.a0);
              const float pxim = fmaf(x.w, t.a1, x.z * t.a0);
              A::template add<T>(vr[b][e], pyre * pxre - pyim * pxim, t);
              A::template add<T>(vi[b][e], pyre * pxim + pyim * pxre, t);
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) break;
#pragma unroll
        for (int part = 0; part < PARTS; ++part)
          st_shared_v4(abuf + (b * PARTS + part) * TILE + (2 * half + pp) * 1024 + r * 16,
                       pack_part(vr[b][0], vi[b][0], part), pack_part(vr[b][1], vi[b][1], part),
                       pack_part(vr[b][2], vi[b][2], part), pack_part(vr[b][3], vi[b][3], part));
      }
    }
    // the A tiles, written by the generic proxy, to the wgmmas (async proxy)
    asm volatile("fence.proxy.async;" ::: "memory");
    __syncthreads();

    pos.wait_full(ring);
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb) break;
      const uint8_t* bt = base + lay.b + ((pos.stage * NB + b) * SEGS) * TILE;
#pragma unroll
      for (int seg = 0; seg < SEGS; ++seg) {
        const int part = SEGS == 1 ? 0 : x_part(seg) - 1;
        // A: K-major, no swizzle, K halves 1024 bytes apart, 8-row groups 128
        const uint64_t da = make_desc(abuf + (b * PARTS + part) * TILE, 1024, 128, kNoSwizzle);
        // B: MN-major, 128-byte swizzled, 8-row K groups 1024 bytes apart
        const uint64_t db = make_desc(bt + seg * TILE, TILE, 1024, kSwizzle128);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_m64n64<0, 1>(acc[b], desc_advance(da, 2048 * kk), desc_advance(db, 2048 * kk),
                             c > 0 || seg > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's wgmmas are done
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (pending >= 0) mbar_arrive(&ring.empty[pending]);
    pending = pos.stage;
    if (tid == 0 && i + RING - 1 < steps) issue(i + RING - 1);
    __syncwarp();  // reconverge warp 0 for the .aligned wgmma wait below
    pos.next();

    if (c + 1 == chunks) {
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      mbar_arrive(&ring.empty[pending]);
      pending = -1;
      // acc[b][4j + 2h + e]: s = s0 + 16*warp + lane/4 + 8h, column c0 + 8j +
      // 2*(lane%4) + e; out[k, column, s]
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) break;
        float* ob = out + (size_t)(k0 + b) * N2 * S;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int so = s0 + 16 * warp + lane / 4 + 8 * h;
              const int co = c0 + 8 * j + 2 * (lane % 4) + e;
              if (so < S && co < N2) ob[(size_t)co * S + so] = acc[b][4 * j + 2 * h + e];
            }
      }
    }
  }
}

// One launch of `kernel` (a __global__ wrapper of `tap_gemm`) over R ranges
// of groups of bins; args are the kernel's arguments after the map.
template <typename T, typename K, typename... Args>
cudaError_t launch(K kernel, int B, int N2, int S, int NJ, int R, cudaStream_t stream,
                   const Args&... args) {
  const size_t smem = layout<T>(NJ).bytes;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int groups = (B + NB - 1) / NB;
  const int per = (groups + R - 1) / R;
  const dim3 grid((S + ST - 1) / ST, (N2 + NT - 1) / NT, (groups + per - 1) / per);
  kernel<<<grid, THREADS, smem, stream>>>(args..., per);
  return cudaGetLastError();
}

// Ranges of groups that fill the card in whole waves for `kernel`: the
// fewest groups per block times waves, one group's worth added per wave for
// the block's set-up (as tc::ranges). Returns R, or -cudaError.
template <typename T, typename K>
int ranges(K kernel, int B, int N2, int S, int NJ) {
  const size_t smem = layout<T>(NJ).bytes;
  int per_sm = 0, sms = 0;
  cudaError_t e = set_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((S + ST - 1) / ST) * ((N2 + NT - 1) / NT);
  const long long slots = (long long)per_sm * sms;
  const int groups = (B + NB - 1) / NB;
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= groups; ++r) {
    const int per = (groups + r - 1) / r;
    const int rr = (groups + per - 1) / per;
    const long long cost = (tiles * rr + slots - 1) / slots * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = rr;
    }
  }
  return best;
}

}  // namespace tapgemm
}  // namespace
