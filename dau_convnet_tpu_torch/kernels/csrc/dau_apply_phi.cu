// The fused apply-phi of the Fourier engine for Hopper (sm_90a): K3, the
// first three of its four launches.
//
// Replaces dau_convnet_tpu/kernels/fused_fwd.py::fused_apply_phi_call (the
// Pallas kernel `_kernel`). K3 is four launches on this card: the operand
// kernel, the per-bin products with Phi,
//
//   Phi[k,ci,co] = sum_g round(py_g[k1] * px_g[k2])   (summed in the operand
//                                                      dtype, as the Pallas
//                                                      kernel's phi scratch)
//   Y[k,n,co]    = sum_ci X[k,n,ci] * Phi[k,ci,co]    (complex, f32 sums)
//
// the split of Y's f32 sums into the bf16 hi/lo parts that K7's kernel
// (dau_partial_idft.cu) multiplies, and that kernel, which closes K3 with
// the partial iDFT out[ij, (n, co)] = sum_k dct[ij,k] Yre - dst[ij,k] Yim.
// X = xs (B, 2N, CI) re/im-stacked, in f32 or bf16; py_g from the rows k1 of t1 (2*P1, NJ)
// and the two taps of mu2's one-hot aw (w folded in), px_g from the rows k2
// of t2 (2*RB, NJ) and the taps of mu1's a; tables and tap weights rounded
// to the operand dtype. The input gradient is the same call with CI = F, CO
// = S and sin-negated tables.
//
// What the Pallas kernel keeps out of device memory is Phi (B*CI*CO complex,
// 90 MB in bf16 at AlexNet conv4); so does this one: Phi is built per step
// in shared memory. Y (15 MB f32 at conv4, N = 32) goes to device memory as
// (B, 2N, CO) [Yre; Yim] rows, the dx kernel's epilogue; `split_kernel`
// turns it into the closing launch's parts in one pass. Split in the
// products kernel's epilogue instead, it cost the bf16 G = 2 instance its
// spill-free 168 registers (tried, not kept).
//
// Bound: the per-bin products, 4 FMAs per (k, n, ci, co) (5.8 GFLOP at
// conv4, N = 32), ~0.006 ms on the tensor cores; the bytes of the spectra,
// one-hots and output (~0.01 ms at conv4) set the bound. The design
// (`apply_phi_gemm_kernel`, the mainloop `tapgemm::tap_gemm` of
// dau_tap_gemm.cuh, shared with K2's dx kernel): per bin one bf16 GEMM on
// the tensor cores,
//
//   Y^T[k] (CO x 2N) = A (CO x 2CI) . B (2CI x 2N),   A[co, 2ci] = Phre[ci, co],
//   A[co, 2ci+1] = Phim[ci, co],  B[2ci] = [Xre | Xim],  B[2ci+1] = [-Xim | Xre],
//
// so column n < N of Y^T is Yre[k, n, :] and N + n is Yim. A is built on the
// FP32 units per step of 16 ci from the units' tap records and the bins'
// staged table quads with K3's roundings (`tapgemm::RoundedUnits`); B, the
// interleaved copy of xs (f32: split in three, six products stacked along K)
// comes by TMA. A block owns 64 co, 64 columns and a range of groups of two
// bins, so each tap record it loads feeds both bins of its group.
// `apply_phi_operands_kernel` builds B, the records (straight from the
// one-hots at any strides) and the table quads in one launch.

#include "dau_tap_gemm.cuh"

namespace {

// widest exponent table: the bf16 records keep j (<= NJ-2) in 8 bits
constexpr int NJ_MAX = 256;
constexpr int PREP_THREADS = 256;

using tapgemm::interleaved8;
using tapgemm::table_quad;
using tapgemm::taps;

// b_map over B (B, KT, NC) bf16, KT = ceil(CI/16) * SEGS * 32, NC = 2N
// rounded up to 8; rec (PLANES, units, CI, CO) u32; tq (P1 + RB, NJ-1)
// float4 table quads; y (B, 2N, CO) f32. G units per pass: all of them
// (units == G <= 4), or kChunked (G = 4) any number in passes of 4. Three
// blocks per SM (<= 170 registers) at bf16 and G <= 2, as the dx kernel.
template <typename T, int G, bool kChunked>
__global__ void __launch_bounds__(tapgemm::THREADS, sizeof(T) == 2 && G <= 2 ? 3 : 1)
apply_phi_gemm_kernel(const __grid_constant__ CUtensorMap b_map, const uint32_t* __restrict__ rec,
                      const float4* __restrict__ tq, float* __restrict__ y, int B, int N2,
                      int CO, int CI, int units, int P1, int RB, int NJ, int per) {
  tapgemm::tap_gemm<T, G, tapgemm::RoundedUnits<kChunked>>(&b_map, rec, tq, y, B, N2, CO, CI,
                                                           units, P1, RB, NJ, per);
}

struct OpArgs {
  const void* xs;
  long long xs_st[3];  // element strides of (B, 2N, CI)
  const void* aw;      // mu2's one-hot, w folded in: (NJ, G, CI, CO)
  const void* a;       // mu1's
  long long aw_st[4], a_st[4];
  const float* t1;
  const float* t2;
  __nv_bfloat16* b_t;  // (B, KT, NC)
  uint32_t* rec;       // (PLANES, G, CI, CO)
  float* tq;           // (P1 + RB, NJ-1, 4)
  int B, N, CI, CO, G, P1, RB, NJ;
};

// K3's operands from what the wrapper is handed, in one launch, exactly as
// `fused_fwd.apply_phi_operands` and `fused_bwd.spectral_table_quads` build
// them in torch:
//   - each unit's record at (g, ci, co), co innermost: mu1's taps j1, a0, a1
//     from a, mu2's j2, b0, b1 from aw (`tapgemm::taps`: the first non-zero
//     entry, clamped to NJ-2, and the entries j, j+1 rounded to T); bf16,
//     three planes (1.0 | j1 << 16 | j2 << 24; a0 | a1 << 16; b0 | b1 << 16,
//     bf16 bits); f32, five (j1 | j2 << 16; a0; a1; b0; b1);
//   - B, 8 columns of one (bin, row) of the interleaved copy of xs, columns
//     fastest (`interleaved8` with [Xre | Xim], [-Xim | Xre]);
//   - the table quads of t1 then t2, rounded to T.
// T: the operand dtype; E: the one-hots' (float or bf16), read as they are.
template <typename T, typename E>
__global__ void __launch_bounds__(PREP_THREADS)
apply_phi_operands_kernel(const __grid_constant__ OpArgs a) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int segs = kF32 ? 6 : 1;
  const int NC = (2 * a.N + 7) / 8 * 8;
  const int KT = (a.CI + 15) / 16 * segs * 32;
  const int Q = a.NJ - 1;
  const long long n_units = (long long)a.G * a.CI * a.CO;
  const long long n_b = (long long)a.B * KT * (NC / 8);
  const long long total = n_units + n_b + (long long)(a.P1 + a.RB) * Q;
  const size_t plane = (size_t)n_units;
  const E* aw = static_cast<const E*>(a.aw);
  const E* am = static_cast<const E*>(a.a);
  // neighbouring threads take neighbouring units along the one-hots'
  // smaller stride (ci in the contract_f direction's layout), so their
  // reads of each entry are coalesced; the records' writes then are not,
  // but a unit reads 2*NJ entries and writes 3 or 5 words
  const bool ci_fast = a.aw_st[2] < a.aw_st[3];

  for (long long i = blockIdx.x * (long long)PREP_THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * PREP_THREADS) {
    if (i < n_units) {
      const int co = (int)(ci_fast ? (i / a.CI) % a.CO : i % a.CO);
      const int ci = (int)(ci_fast ? i % a.CI : (i / a.CO) % a.CI);
      const int g = (int)(i / ((long long)a.CO * a.CI));
      int j1, j2;
      float w[4];
      taps(am + g * a.a_st[1] + ci * a.a_st[2] + co * a.a_st[3], a.a_st[0], a.NJ, j1, w[0], w[1],
           !kF32);
      taps(aw + g * a.aw_st[1] + ci * a.aw_st[2] + co * a.aw_st[3], a.aw_st[0], a.NJ, j2, w[2],
           w[3], !kF32);
      uint32_t* rec = a.rec + ((size_t)g * a.CI + ci) * a.CO + co;
      if (kF32) {
        rec[0] = (uint32_t)j1 | ((uint32_t)j2 << 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) rec[(q + 1) * plane] = __float_as_uint(w[q]);
      } else {
        rec[0] = 0x3f80u | ((uint32_t)j1 << 16) | ((uint32_t)j2 << 24);
        rec[plane] = (__float_as_uint(w[0]) >> 16) | (__float_as_uint(w[1]) & 0xffff0000u);
        rec[2 * plane] = (__float_as_uint(w[2]) >> 16) | (__float_as_uint(w[3]) & 0xffff0000u);
      }
      continue;
    }
    long long r = i - n_units;
    if (r < n_b) {
      const int c = (int)(r % (NC / 8));
      const int row = (int)((r / (NC / 8)) % KT);
      const int b = (int)(r / ((long long)KT * (NC / 8)));
      const T* x = static_cast<const T*>(a.xs) + b * a.xs_st[0];
      *reinterpret_cast<uint4*>(a.b_t + (((size_t)b * KT + row) * NC + 8 * c)) =
          interleaved8<T, true>(x, a.xs_st[1], a.xs_st[2], row, c, segs, a.N, a.CI);
      continue;
    }
    r -= n_b;
    {  // one table quad: row k of t1 (k < P1) or of t2
      const int j = (int)(r % Q);
      const int k = (int)(r / Q);
      const float4 o = k < a.P1 ? table_quad<T>(a.t1, a.P1, k, j, a.NJ)
                                : table_quad<T>(a.t2, a.RB, k - a.P1, j, a.NJ);
      reinterpret_cast<float4*>(a.tq)[r] = o;
    }
  }
}

// f(kernel) for the instance that takes `units` units: G = units up to 4,
// else the chunked G = 4 one
#define DAU_K3_DISPATCH(CALL)                                      \
  switch (units) {                                                 \
    case 1: return CALL((apply_phi_gemm_kernel<T, 1, false>));     \
    case 2: return CALL((apply_phi_gemm_kernel<T, 2, false>));     \
    case 3: return CALL((apply_phi_gemm_kernel<T, 3, false>));     \
    case 4: return CALL((apply_phi_gemm_kernel<T, 4, false>));     \
    default: return CALL((apply_phi_gemm_kernel<T, 4, true>));     \
  }

// y (B, 2N, CO) f32 -> parts (4, B, C8) bf16, Yre hi, Yre lo, Yim hi, Yim
// lo (`forward.split_bf16`: hi = y rounded, lo = the rest rounded), column
// n*CO + co of row b, zero from N*CO to C8 (N*CO rounded up to 8). One
// thread writes 8 columns of one (b, re/im) row of a hi part and its lo.
__global__ void __launch_bounds__(PREP_THREADS)
split_kernel(const float* __restrict__ y, __nv_bfloat16* __restrict__ parts, int B, int N, int CO,
             int C8) {
  const long long chunks = (long long)B * 2 * (C8 / 8);
  const int C = N * CO;
  for (long long i = blockIdx.x * (long long)PREP_THREADS + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * PREP_THREADS) {
    const int c0 = (int)(i % (C8 / 8)) * 8;
    const int h = (int)((i / (C8 / 8)) % 2);
    const int b = (int)(i / (2 * (C8 / 8)));
    const float* row = y + ((size_t)b * 2 + h) * C;  // Yre or Yim of bin b: (N, CO)
    __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float v = c0 + l < C ? row[c0 + l] : 0.f;
      hi[l] = __float2bfloat16_rn(v);
      lo[l] = __float2bfloat16_rn(v - __bfloat162float(hi[l]));
    }
    const size_t at = ((size_t)2 * h * B + b) * C8 + c0;
    *reinterpret_cast<uint4*>(parts + at) = *reinterpret_cast<const uint4*>(hi);
    *reinterpret_cast<uint4*>(parts + at + (size_t)B * C8) = *reinterpret_cast<const uint4*>(lo);
  }
}

template <typename T>
int ranges_of(int units, int B, int N2, int CO, int NJ) {
#define DAU_K3_RANGES(KERNEL) tapgemm::ranges<T>(KERNEL, B, N2, CO, NJ)
  DAU_K3_DISPATCH(DAU_K3_RANGES)
#undef DAU_K3_RANGES
}

template <typename T>
int launch_of(const CUtensorMap& map, const uint32_t* rec, const float4* tq, float* y, int B,
              int N2, int CO, int CI, int units, int P1, int RB, int NJ, int R, cudaStream_t st) {
#define DAU_K3_LAUNCH(KERNEL)                                                              \
  -(int)tapgemm::launch<T>(KERNEL, B, N2, CO, NJ, R, st, map, rec, tq, y, B, N2, CO, CI, \
                           units, P1, RB, NJ)
  DAU_K3_DISPATCH(DAU_K3_LAUNCH)
#undef DAU_K3_LAUNCH
}

}  // namespace

extern "C" {

// Dynamic shared memory of K3's products kernel at NJ exponents, or -1
// where dtype (0 f32, 1 bf16) or NJ (2 .. 256) has no instance.
long long dau_apply_phi_smem_bytes(int dtype, int NJ) {
  if (NJ < 2 || NJ > NJ_MAX) return -1;
  if (dtype == 0) return tapgemm::layout<float>(NJ).bytes;
  if (dtype == 1) return tapgemm::layout<__nv_bfloat16>(NJ).bytes;
  return -1;
}

// Ranges of the products kernel's groups of bins so its grid fills the
// card in whole waves, for G units (the instance takes 4 a pass past 4).
// Returns the count (>= 1), or -cudaError.
int dau_apply_phi_ranges(int dtype, int G, int B, int N, int CO, int NJ) {
  if (B <= 0 || N <= 0 || CO <= 0 || G < 1 || NJ < 2 || NJ > NJ_MAX)
    return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return ranges_of<float>(G, B, 2 * N, CO, NJ);
  if (dtype == 1) return ranges_of<__nv_bfloat16>(G, B, 2 * N, CO, NJ);
  return -(int)cudaErrorInvalidValue;
}

// K3's operands: xs (B, 2N, CI) in dtype (0 f32, 1 bf16) with element
// strides xs_strides[0..2]; aw, a (NJ, G, CI, CO) in onehot_dtype (0 f32, 1
// bf16) with element strides oh_strides[0..3] (aw) and [4..7] (a); t1 (2*P1,
// NJ), t2 (2*RB, NJ) f32 contiguous. Writes b_t (B, KT, NC) bf16 (KT =
// ceil(CI/16)*32 for bf16, *192 for f32; NC = 2N rounded up to 8), rec
// (PLANES, G, CI, CO) u32 (3 planes for bf16, 5 for f32) and tq (P1 + RB,
// NJ-1, 4) f32. Returns a cudaError_t.
int dau_apply_phi_operands_launch(const void* xs, const long long* xs_strides, const void* aw,
                                  const void* a, const long long* oh_strides, int onehot_dtype,
                                  const void* t1, const void* t2, void* b_t, void* rec, void* tq,
                                  int dtype, int B, int N, int CI, int CO, int G, int P1, int RB,
                                  int NJ, void* stream) {
  if (B <= 0 || N <= 0 || CI <= 0 || CO <= 0 || G < 1 || B != P1 * RB || NJ < 2 ||
      NJ > NJ_MAX || (dtype != 0 && dtype != 1) || (onehot_dtype != 0 && onehot_dtype != 1))
    return (int)cudaErrorInvalidValue;
  OpArgs o;
  o.xs = xs;
  o.aw = aw;
  o.a = a;
  for (int i = 0; i < 3; ++i) o.xs_st[i] = xs_strides[i];
  for (int i = 0; i < 4; ++i) {
    o.aw_st[i] = oh_strides[i];
    o.a_st[i] = oh_strides[4 + i];
  }
  o.t1 = static_cast<const float*>(t1);
  o.t2 = static_cast<const float*>(t2);
  o.b_t = static_cast<__nv_bfloat16*>(b_t);
  o.rec = static_cast<uint32_t*>(rec);
  o.tq = static_cast<float*>(tq);
  o.B = B, o.N = N, o.CI = CI, o.CO = CO, o.G = G, o.P1 = P1, o.RB = RB, o.NJ = NJ;
  const long long segs = dtype == 0 ? 6 : 1;
  const long long total = (long long)G * CI * CO +
                          (long long)B * ((CI + 15) / 16 * segs * 32) * ((2 * N + 7) / 8) +
                          (long long)(P1 + RB) * (NJ - 1);
  int sms = 0;
  cudaError_t e = dau_hopper::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long want = (total + PREP_THREADS - 1) / PREP_THREADS;
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DAU_K3_OPERANDS(TT, EE) apply_phi_operands_kernel<TT, EE><<<grid, PREP_THREADS, 0, st>>>(o)
  if (dtype == 0 && onehot_dtype == 0)
    DAU_K3_OPERANDS(float, float);
  else if (dtype == 0)
    DAU_K3_OPERANDS(float, __nv_bfloat16);
  else if (onehot_dtype == 0)
    DAU_K3_OPERANDS(__nv_bfloat16, float);
  else
    DAU_K3_OPERANDS(__nv_bfloat16, __nv_bfloat16);
#undef DAU_K3_OPERANDS
  return (int)cudaGetLastError();
}

// K3's products kernel: b_t, rec, tq from the operand kernel; y (B, 2N, CO)
// f32, [Yre; Yim] rows; R ranges of groups of bins (dau_apply_phi_ranges).
// Returns a cudaError_t.
int dau_apply_phi_launch(const void* b_t, const void* rec, const void* tq, void* y, int dtype,
                         int G, int B, int N, int CI, int CO, int P1, int RB, int NJ, int R,
                         void* stream) {
  if (B <= 0 || N <= 0 || CI <= 0 || CO <= 0 || G < 1 || P1 <= 0 || RB <= 0 || B != P1 * RB ||
      NJ < 2 || NJ > NJ_MAX || R < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int segs = dtype == 0 ? 6 : 1;
  const cuuint64_t nc = (cuuint64_t)(2 * N + 7) / 8 * 8;
  const cuuint64_t kt = (cuuint64_t)(CI + 15) / 16 * segs * 32;
  const cuuint64_t dims[3] = {nc, kt, (cuuint64_t)B};
  const cuuint64_t strides[2] = {nc * 2, nc * 2 * kt};
  const cuuint32_t box[3] = {(cuuint32_t)tapgemm::NT, (cuuint32_t)segs * 32, 1};
  CUtensorMap map;
  cudaError_t e = dau_hopper::make_map(&map, b_t, 3, dims, strides, box,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* rr = static_cast<const uint32_t*>(rec);
  const float4* q = static_cast<const float4*>(tq);
  float* out = static_cast<float*>(y);
  const int r = dtype == 0 ? launch_of<float>(map, rr, q, out, B, 2 * N, CO, CI, G, P1, RB, NJ,
                                              R, st)
                           : launch_of<__nv_bfloat16>(map, rr, q, out, B, 2 * N, CO, CI, G, P1,
                                                      RB, NJ, R, st);
  return -r;
}

// Y's bf16 hi/lo parts for the closing launch: y (B, 2N, CO) f32 from the
// products kernel; parts (4, B, C8) bf16, C8 = N*CO rounded up to 8 (see
// `split_kernel`). Returns a cudaError_t.
int dau_apply_phi_split_launch(const void* y, void* parts, int B, int N, int CO, void* stream) {
  if (B <= 0 || N <= 0 || CO <= 0) return (int)cudaErrorInvalidValue;
  const int C8 = (N * CO + 7) / 8 * 8;
  int sms = 0;
  cudaError_t e = dau_hopper::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long want = ((long long)B * 2 * (C8 / 8) + PREP_THREADS - 1) / PREP_THREADS;
  const int grid = (int)(want < 16LL * sms ? want : 16LL * sms);
  split_kernel<<<grid, PREP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<__nv_bfloat16*>(parts), B, N, CO, C8);
  return (int)cudaGetLastError();
}

}  // extern "C"
