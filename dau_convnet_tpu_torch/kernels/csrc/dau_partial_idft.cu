// The partial inverse DFT of the Fourier engine for Hopper (sm_90a): K7.
//
// Replaces dau_convnet_tpu/kernels/spectral.py::partial_idft (the Pallas
// kernel `_idft_kernel`). It computes
//
//   table[p, c] = sum_k C[k,p] * tre[k,c] - S[k,p] * tim[k,c]
//
// as one GEMM on the tensor cores, out = A @ [tre; tim], with A the (P, 2B)
// matrix [C^T, -S^T] that the wrapper (`spectral.py`) builds once per
// matrices and caches, bf16 operands, f32 sums, and the (P, C) table written
// in f32 or bf16. f32 operands arrive split into bf16 hi + lo parts: the
// K dimension is a list of segments, each one (bins x C) spectra tensor
// against one (P x B) block of A, e.g. tre_hi.A_hi + tre_lo.A_hi +
// tre_hi.A_lo + (the same for tim). The fused apply-phi (K3) closes with
// this kernel on its f32 spectra.
//
// Bound: at AlexNet conv4 (B = 153, P = 81, C = M*S*F = 442,368, bf16) the
// kernel reads 271 MB of spectra and writes a 72 MB table for 21.9 GFLOP:
// bound by bytes (~0.10 ms at 3.35 TB/s). Design:
//   - persistent blocks walk the (P/128 x C/256) output tiles, p fastest, so
//     neighbouring blocks share a column tile of spectra in L2;
//   - a producer warp streams, per 64 bins of a segment, the A tile (128 p x
//     64 bins, K-major) and the spectra tile (64 bins x 256 c, c contiguous:
//     MN-major) by TMA, 128-byte swizzled, into a ring of STAGES stages; TMA
//     reads the bins past B (the K tail, 153 -> 192) and columns past C as
//     zeros;
//   - two consumer warpgroups (64 p each) issue 4 wgmma m64n256k16 per stage
//     into 128 f32 sums per thread, and store their tile straight from the
//     registers (the padded rows p >= P are not stored); the producer is
//     already loading the next tile's stages meanwhile.

#include "dau_hopper_gemm.cuh"

namespace {

using namespace dau_hopper;

constexpr int PB = 128;       // positions p per tile: 2 warpgroups x 64
constexpr int NC = 256;       // columns c per tile: the wgmma N
constexpr int KT = 64;        // bins per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int MAX_SEGS = 6;
constexpr int MAX_SPECTRA = 4;

struct Segments {
  int count;
  int spectra[MAX_SEGS];  // which spectra tensor (map) the segment reads
  int acol[MAX_SEGS];     // the first column of its block of A
};

struct Shared {
  __nv_bfloat16 a[STAGES][PB][KT];            // K-major, swizzled
  __nv_bfloat16 b[STAGES][NC / 64][KT][64];   // MN-major, swizzled, 64 c per block
  Ring<STAGES> ring;
};

constexpr uint32_t STAGE_BYTES = (PB * KT + KT * NC) * 2;

struct SpectraMaps {
  CUtensorMap m[MAX_SPECTRA];
};

__device__ __forceinline__ void store2(float* o, float x, float y, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(x, y);
  } else {
    o[0] = x;
    if (second) o[1] = y;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float x, float y, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
  } else {
    o[0] = __float2bfloat16_rn(x);
    if (second) o[1] = __float2bfloat16_rn(y);
  }
}

template <typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
partial_idft_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ SpectraMaps spectra, const Segments segs,
                    Tout* __restrict__ out, int P, int C, int ktiles) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(align1024(smem_raw));

  const int ptiles = (P + PB - 1) / PB;
  const int tiles = ptiles * ((C + NC - 1) / NC);
  const int steps = segs.count * ktiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) sm.ring.init(128 * CONSUMERS);
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer warp
    if (lane == 0) {
      RingPos<STAGES> pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int p0 = (tile % ptiles) * PB;
        const int c0 = (tile / ptiles) * NC;
        for (int s = 0; s < steps; ++s) {
          const int g = s / ktiles;
          const int k0 = (s % ktiles) * KT;
          const CUtensorMap* bmap = &spectra.m[segs.spectra[g]];
          uint64_t* full = pos.acquire(sm.ring, STAGE_BYTES);
          tma_load_2d(&sm.a[pos.stage], &a_map, full, segs.acol[g] + k0, p0);
#pragma unroll
          for (int h = 0; h < NC / 64; ++h)
            tma_load_2d(&sm.b[pos.stage][h], bmap, full, c0 + 64 * h, k0);
          pos.next();
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool paired = C % 2 == 0;
  RingPos<STAGES> pos;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = (tile % ptiles) * PB;
    const int c0 = (tile / ptiles) * NC;
    float acc[NC / 2];
#pragma unroll
    for (int v = 0; v < NC / 2; ++v) acc[v] = 0.f;
    int pending = -1;  // the stage whose wgmmas may still be reading it
    for (int s = 0; s < steps; ++s) {
      pos.wait_full(sm.ring);
      // A: 64 rows of 128 bytes from row 64*wg; B: 64-wide column blocks
      // 64 rows x 128 bytes apart
      const uint64_t da = make_desc(&sm.a[pos.stage][wg * 64][0], 16, 1024, kSwizzle128);
      const uint64_t db = make_desc(&sm.b[pos.stage][0][0][0], KT * 128, 1024, kSwizzle128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_m64n256<0, 1>(acc, desc_advance(da, 32 * kk), desc_advance(db, 2048 * kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (pending >= 0) mbar_arrive(&sm.ring.empty[pending]);
      pending = pos.stage;
      pos.next();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) mbar_arrive(&sm.ring.empty[pending]);

    const int prow = p0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = prow + 8 * h;
      if (p >= P) continue;
      Tout* o = out + (size_t)p * C;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = c0 + 8 * j + 2 * (lane % 4);
        if (col < C)
          store2(o + col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], paired, col + 1 < C);
      }
    }
  }
}

template <typename Tout>
cudaError_t launch(const CUtensorMap& a_map, const SpectraMaps& maps, const Segments& segs,
                   void* out, int P, int C, int ktiles, cudaStream_t stream) {
  const size_t smem = sizeof(Shared) + 1024;
  int sms = 0;
  cudaError_t e = set_smem(partial_idft_kernel<Tout>, smem);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int tiles = ((P + PB - 1) / PB) * ((C + NC - 1) / NC);
  partial_idft_kernel<Tout><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(
      a_map, maps, segs, static_cast<Tout*>(out), P, C, ktiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (a_rows, a_cols) bf16, a_rows a multiple of 128 and a_cols of 64, rows
// past P zero; its column blocks are `bp` (a multiple of 64) wide, bins past
// B zero. spectra: n_spectra (B, ldc) bf16 tensors (ldc >= C, a multiple of
// 8). Segment g multiplies spectra[seg_spectra[g]] by the block of A from
// column seg_acol[g]. out: (P, C) in dtype_out (0 f32, 1 bf16). Returns a
// cudaError_t.
int dau_partial_idft_launch(const void* a, int a_rows, int a_cols, const void* const* spectra,
                            int n_spectra, long long ldc, const int* seg_spectra,
                            const int* seg_acol, int n_segs, int bp, void* out, int dtype_out,
                            int B, int P, long long C, void* stream) {
  if (n_segs < 1 || n_segs > MAX_SEGS || n_spectra < 1 || n_spectra > MAX_SPECTRA ||
      bp % KT != 0 || a_rows % PB != 0 || a_rows < P || ldc % 8 != 0 || ldc < C || C <= 0 ||
      C > 0x7fffffff || P <= 0 || B <= 0 || B > bp)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)a_cols, (cuuint64_t)a_rows};
  const cuuint64_t a_strides[1] = {(cuuint64_t)a_cols * 2};
  const cuuint32_t a_box[2] = {KT, PB};
  cudaError_t e = make_map(&a_map, a, 2, a_dims, a_strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return (int)e;
  SpectraMaps maps;
  const cuuint64_t b_dims[2] = {(cuuint64_t)ldc, (cuuint64_t)B};
  const cuuint64_t b_strides[1] = {(cuuint64_t)ldc * 2};
  const cuuint32_t b_box[2] = {64, KT};
  for (int i = 0; i < n_spectra; ++i) {
    e = make_map(&maps.m[i], spectra[i], 2, b_dims, b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return (int)e;
  }
  Segments segs;
  segs.count = n_segs;
  for (int g = 0; g < n_segs; ++g) {
    if (seg_spectra[g] < 0 || seg_spectra[g] >= n_spectra || seg_acol[g] % KT != 0 ||
        seg_acol[g] + bp > a_cols)
      return (int)cudaErrorInvalidValue;
    segs.spectra[g] = seg_spectra[g];
    segs.acol[g] = seg_acol[g];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_out == 0)
    return (int)launch<float>(a_map, maps, segs, out, P, (int)C, bp / KT, st);
  if (dtype_out == 1)
    return (int)launch<__nv_bfloat16>(a_map, maps, segs, out, P, (int)C, bp / KT, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
