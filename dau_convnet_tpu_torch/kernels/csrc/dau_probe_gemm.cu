// The probe GEMM for Hopper (sm_90a): the counterpart of the Pallas dot
// probes P1, P2, P5 and P6 (benchmarks/mosaic_probe.py::t_3d_dot,
// t_3d_dot_batched, t_batched_dot, t_batched_dot_4d). It computes
//
//   out[z, m, n] = sum_k A[z, m, k] * B[z, k, n]
//
// strided-batched over z, bf16 A and B, f32 sums and a row-major f32 out.
// A is K-major (each row m holds its K values contiguously: P1, P5, P6) or
// M-major (each row k holds its M values contiguously, A stored as its
// transpose: P2's T[a] is (K, M)); B is N-major. An operand whose batch
// stride is 0 is one matrix shared by every z (P2's D).
//
// Bound: at the probes' shapes the operands are a few MB, and the f32 out
// dominates the bytes (P5: 30 MB of 40 MB, 0.96 GFLOP): bound by bytes,
// 3-12 us at 3.35 TB/s, about what one launch costs. The probe asks what
// the tensor cores reach at the per-bin GEMM shapes (M = 81-384, K = 64 or
// 153, batch 1-153), so the design is K7's mainloop with both majors for A:
//   - one block a (128 m x 128 n) tile of one z; a producer warp streams
//     the A tile (K-major: 128 m x 64 k; M-major: two 64 k x 64 m boxes)
//     and the B tile (two 64 k x 64 n boxes, n contiguous) by TMA,
//     128-byte swizzled, into a ring of STAGES stages; TMA reads rows,
//     columns and k past the tensor's edge (M = 81, K = 153, N = 81) as
//     zeros;
//   - two consumer warpgroups (64 m each) issue, per k16 step, two wgmma
//     m64n64k16 (A K-major or, transposed, M-major from shared memory; B
//     MN-major) into 64 f32 sums per thread, and store them straight from
//     the registers, rows m >= M and columns n >= N not stored.
// Tuning it (a persistent grid, larger tiles for N = 16,384) is later work.

#include "dau_hopper_gemm.cuh"

namespace {

using namespace dau_hopper;

constexpr int BM = 128;       // rows m per tile: 2 warpgroups x 64
constexpr int BN = 128;       // columns n per tile: 2 wgmma n64 products
constexpr int KT = 64;        // k per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;

struct Shared {
  // A: K-major [BM][KT], or M-major [BM / 64][KT][64]; 16 KB either way
  __nv_bfloat16 a[STAGES][BM * KT];
  __nv_bfloat16 b[STAGES][BN / 64][KT][64];  // MN-major, 64 n per box
  Ring<STAGES> ring;
};

constexpr uint32_t STAGE_BYTES = (BM * KT + KT * BN) * 2;

__device__ __forceinline__ void store2(float* o, float x, float y, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(x, y);
  } else {
    o[0] = x;
    if (second) o[1] = y;
  }
}

// TA = 0: A K-major; TA = 1: A M-major (wgmma's transposed A).
template <int TA>
__global__ void __launch_bounds__(THREADS, 2)
probe_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, float* __restrict__ out, int M,
                  int N, int ktiles, int a_batched, int b_batched) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(align1024(smem_raw));

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int z = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) sm.ring.init(128 * CONSUMERS);
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer warp
    if (lane == 0) {
      const int za = a_batched ? z : 0;
      const int zb = b_batched ? z : 0;
      RingPos<STAGES> pos;
      for (int s = 0; s < ktiles; ++s) {
        const int k0 = s * KT;
        uint64_t* full = pos.acquire(sm.ring, STAGE_BYTES);
        if (TA == 0) {
          tma_load_3d(&sm.a[pos.stage][0], &a_map, full, k0, m0, za);
        } else {
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
            tma_load_3d(&sm.a[pos.stage][h * 64 * KT], &a_map, full, m0 + 64 * h, k0, za);
        }
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_3d(&sm.b[pos.stage][h], &b_map, full, n0 + 64 * h, k0, zb);
        pos.next();
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc0[32], acc1[32];  // columns n0 + 0..63 and n0 + 64..127
#pragma unroll
  for (int v = 0; v < 32; ++v) acc0[v] = acc1[v] = 0.f;
  RingPos<STAGES> pos;
  int pending = -1;  // the stage whose wgmmas may still be reading it
  for (int s = 0; s < ktiles; ++s) {
    pos.wait_full(sm.ring);
    // A: this warpgroup's 64 rows m, 8192 bytes in (K-major: 64 rows of
    // 128 bytes; M-major: the second 64 k x 64 m box)
    const uint64_t da = TA == 0
        ? make_desc(&sm.a[pos.stage][wg * 64 * KT], 16, 1024, kSwizzle128)
        : make_desc(&sm.a[pos.stage][wg * 64 * KT], KT * 128, 1024, kSwizzle128);
    const uint64_t db0 = make_desc(&sm.b[pos.stage][0][0][0], KT * 128, 1024, kSwizzle128);
    const uint64_t db1 = make_desc(&sm.b[pos.stage][1][0][0], KT * 128, 1024, kSwizzle128);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // a k16 step: 32 bytes along a K-major row, 16 rows of 128 bytes
      // down an MN-major box
      const uint64_t dak = desc_advance(da, TA == 0 ? 32 * kk : 2048 * kk);
      wgmma_m64n64<TA, 1>(acc0, dak, desc_advance(db0, 2048 * kk));
      wgmma_m64n64<TA, 1>(acc1, dak, desc_advance(db1, 2048 * kk));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (pending >= 0) mbar_arrive(&sm.ring.empty[pending]);
    pending = pos.stage;
    pos.next();
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  if (pending >= 0) mbar_arrive(&sm.ring.empty[pending]);

  const bool paired = N % 2 == 0;
  float* o = out + (size_t)z * M * N;
  const int mrow = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mrow + 8 * h;
    if (m >= M) continue;
    float* orow = o + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < N)
        store2(orow + col, acc0[4 * j + 2 * h], acc0[4 * j + 2 * h + 1], paired, col + 1 < N);
      if (col + 64 < N)
        store2(orow + col + 64, acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1], paired,
               col + 65 < N);
    }
  }
}

template <int TA>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, float* out, int batch,
                   int M, int N, int K, int a_batched, int b_batched, cudaStream_t stream) {
  const size_t smem = sizeof(Shared) + 1024;
  cudaError_t e = set_smem(probe_gemm_kernel<TA>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  probe_gemm_kernel<TA><<<grid, THREADS, smem, stream>>>(a_map, b_map, out, M, N,
                                                        (K + KT - 1) / KT, a_batched, b_batched);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: bf16, a_major 0 (K-major: a[z][m][k] at z*a_bstride + m*lda + k) or 1
// (M-major: at z*a_bstride + k*lda + m); b: bf16, b[z][k][n] at
// z*b_bstride + k*ldb + n; a batch stride of 0 shares one matrix over z.
// Leading dimensions and nonzero batch strides in elements, multiples of 8
// (TMA's 16-byte global strides); a and b 16-byte aligned. out: (batch, M,
// N) f32, contiguous. Returns a cudaError_t.
int dau_probe_gemm_launch(const void* a, int a_major, long long lda, long long a_bstride,
                          const void* b, long long ldb, long long b_bstride, void* out,
                          int batch, int M, int N, int K, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 1 || (a_major != 0 && a_major != 1) ||
      lda % 8 != 0 || ldb % 8 != 0 || a_bstride % 8 != 0 || b_bstride % 8 != 0 ||
      lda < (a_major ? M : K) || ldb < N || a_bstride < 0 || b_bstride < 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int za = a_bstride ? batch : 1;
  const int zb = b_bstride ? batch : 1;
  // the map's third stride must be a valid one even where one matrix is
  // shared (its only z is 0)
  const long long a_rows = a_major ? K : M;
  const long long a_z = a_bstride ? a_bstride : lda * a_rows;
  const long long b_z = b_bstride ? b_bstride : ldb * K;

  CUtensorMap a_map, b_map;
  cudaError_t e;
  if (a_major == 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)za};
    const cuuint64_t strides[2] = {(cuuint64_t)lda * 2, (cuuint64_t)a_z * 2};
    const cuuint32_t box[3] = {KT, BM, 1};
    e = make_map(&a_map, a, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)M, (cuuint64_t)K, (cuuint64_t)za};
    const cuuint64_t strides[2] = {(cuuint64_t)lda * 2, (cuuint64_t)a_z * 2};
    const cuuint32_t box[3] = {64, KT, 1};
    e = make_map(&a_map, a, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e != cudaSuccess) return (int)e;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)zb};
    const cuuint64_t strides[2] = {(cuuint64_t)ldb * 2, (cuuint64_t)b_z * 2};
    const cuuint32_t box[3] = {64, KT, 1};
    e = make_map(&b_map, b, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int ab = a_bstride != 0, bb = b_bstride != 0;
  return a_major == 0 ? (int)launch<0>(a_map, b_map, o, batch, M, N, K, ab, bb, st)
                      : (int)launch<1>(a_map, b_map, o, batch, M, N, K, ab, bb, st);
}

}  // extern "C"
