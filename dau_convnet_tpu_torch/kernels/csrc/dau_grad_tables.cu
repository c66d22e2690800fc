// DAU parameter-gradient position table for Hopper (sm_90a), K6.
//
// Replaces dau_convnet_tpu/kernels/backward.py::grad_tables_pallas (the
// Pallas kernel `_table_kernel`). It computes the same function, not the
// same blocks:
//
//   table[m,s,f,ky,kx] = sum_n sum_{i,j} xb[m,n,s,i+ky-c,j+kx-c] * err[n,f,i,j]
//
// c = ks/2, xb zero outside the image, bf16 operands and f32 sums; the table
// is written position-major, (ks*ks, F, M*S) f32, and the wrapper
// (`backward.py`) returns its (M, S, F, ks, ks) view. f32 operands reach the
// kernel split by the wrapper into three bf16 parts whose six products are
// concatenated along N.
//
// Bound: per position p = (ky, kx) the table is a GEMM, F x (M*S), over
// K = (n, i, j): 2*ks^2*M*S*F*N*H*W operations (1.18 TFLOP per AlexNet-DAU
// step at M = 3) on a few MB of input, so the tensor cores bound it. Design:
//   - the wrapper lays both operands out chunk-major, (C/8, N, H, W*8) with
//     eight channels innermost, so one TMA box (channels x rows x columns)
//     lands in shared memory already in wgmma's no-swizzle MN-major layout:
//     8x8 core matrices of 128 bytes, one image column per 16-byte K row.
//     TMA reads coordinates outside the tensor as zeros: the halo, the 13 ->
//     16 (27 -> 32) column padding, rows past the image and the ragged
//     channel edge cost no copy and no mask;
//   - one block per (128 f, 64 planes ms, kernel row ky, group of T = 3
//     kernel columns kx). Its producer warp streams R = 4 image rows per
//     stage into a ring of STAGES = 5 stages: the err tile (R rows x 16
//     columns x 128 f) and the xb rows the T taps meet (R x (16 + T - 1)
//     columns x 64 ms). Its two consumer warpgroups (64 f each) issue R * T
//     wgmma m64n64k16 per stage, tap kx reading the staged xb row from its
//     K row kx - kx0 on (a descriptor 16 bytes further per tap): each err
//     tile and xb row is staged once for the T taps of the block;
//   - image rows whose xb row lies outside the image are not streamed;
//   - every table entry is summed by one block in one fixed order: no
//     atomics, and a step is deterministic;
//   - the tensor cores' f32 sums round toward zero. Summed in one wgmma
//     chain over all N*H*W/16 k16 steps of a tap, a table whose sums cancel
//     (the error a train-mode BatchNorm hands back has zero mean per
//     channel) drifted by ~7e-4 of max|table| at CIFAR conv1's 6 x 128
//     images of 32x32 (f32 input) and by ~2e-4 at its 128 (bf16). So each
//     instance runs one chain per FOLD stages, an inner loop of its own,
//     and after the loop adds the chain's sums, rounded to nearest on the
//     FP32 units (as K4 folds its taps), to the earlier chains' sums, which
//     wait in shared memory, a column per thread (96 KB, paid for with one
//     stage of the ring): FOLD is 4 (16 k16 steps) for f32 input, 32 for
//     bf16, where 8 times the steps per chain still drift ~1e-5 (emulated
//     in tests/test_torch_gemm_operands.py). The 9 warps leave a thread 168
//     registers: a second set of 96 for the sums spills. Folded inside the
//     stage loop, behind a branch, the bf16 instance took 1.9x its one-chain
//     time (into the table in global memory there); folded into the table
//     after each chain's loop, 1.6x (L2 latency at every fold, the table's
//     bytes three times over where it is large).
// Why these sizes: one row per stage pays a barrier round trip and two TMA
// issues for every T small wgmmas; T = 9 taps with their 144 f32 sums per
// thread does not fit the registers beside the pipeline, and ptxas then
// serializes the wgmmas.

#include "dau_hopper_gemm.cuh"

namespace {

using namespace dau_hopper;

constexpr int FB = 128;                // output channels f per block: 2 warpgroups x 64
constexpr int NB = 64;                 // planes ms per block: the wgmma N
constexpr int KC = 16;                 // image columns j per row of a stage: the wgmma K
// stages per wgmma chain, the kernel's FOLD, for f32 and for bf16 input
constexpr int FOLD_F32 = 4;
constexpr int FOLD_BF16 = 32;
constexpr int T = 3;                   // kernel columns kx per block
constexpr int R = 4;                   // image rows per stage
constexpr int STAGES = 5;
constexpr int KB = KC + T - 1;         // xb columns staged per row
constexpr int CONSUMERS = 2;           // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;

constexpr uint32_t round128(uint32_t v) { return (v + 127) / 128 * 128; }
constexpr uint32_t A_BYTES = FB * R * KC * 2;
constexpr uint32_t B_BYTES = NB * R * KB * 2;

struct Shared {
  uint8_t a[STAGES][round128(A_BYTES)];  // err: [f/8][row][column][8 f]
  uint8_t b[STAGES][round128(B_BYTES)];  // xb:  [ms/8][row][column][8 ms]
  float sum[T * NB / 2][CONSUMERS * 128];  // the folded chains, a column per thread
  Ring<STAGES> ring;
};

template <int FOLD>
__global__ void __launch_bounds__(THREADS, 1)
grad_tables_kernel(const __grid_constant__ CUtensorMap err_map,
                   const __grid_constant__ CUtensorMap xb_map, float* __restrict__ table, int F,
                   int MS, int N, int H, int W, int ks) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(align1024(smem_raw));

  const int c = ks / 2;
  const int groups = (ks + T - 1) / T;
  const int ky = blockIdx.z / groups;
  const int kx0 = (blockIdx.z % groups) * T;
  const int f0 = blockIdx.x * FB;
  const int ms0 = blockIdx.y * NB;
  const int i_lo = max(0, c - ky);
  const int rows = max(0, min(H, H + c - ky) - i_lo);  // err rows whose xb row is inside
  const int row_groups = (rows + R - 1) / R;           // the last may run past: zeros
  const int chunks = (W + KC - 1) / KC;
  const int steps = N * row_groups * chunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) sm.ring.init(128 * CONSUMERS);
  __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the producer warp
    if (lane == 0) {
      RingPos<STAGES> pos;
      for (int s = 0; s < steps; ++s) {
        const int jc = s % chunks;
        const int g = s / chunks;
        const int i = i_lo + R * (g % row_groups);
        const int n = g / row_groups;
        uint64_t* full = pos.acquire(sm.ring, A_BYTES + B_BYTES);
        tma_load_4d(sm.a[pos.stage], &err_map, full, jc * KC * 8, i, n, f0 / 8);
        tma_load_4d(sm.b[pos.stage], &xb_map, full, (jc * KC - c + kx0) * 8, i + ky - c, n,
                    ms0 / 8);
        pos.next();
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[T][NB / 2];  // the wgmma chain's sums; after the last, the table's
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) acc[t][v] = 0.f;

  RingPos<STAGES> pos;
  for (int s0 = 0; s0 < steps; s0 += FOLD) {  // one wgmma chain of up to FOLD stages
    const int s1 = min(steps, s0 + FOLD);
    int pending = -1;  // the stage whose wgmmas may still be reading it
    for (int s = s0; s < s1; ++s) {
      pos.wait_full(sm.ring);
      // chunk strides R*KC*16 (err) and R*KB*16 (xb) bytes; row r of the
      // stage r*KC*16 (r*KB*16) bytes into its chunk, tap t 16*t bytes further
      const uint64_t da = make_desc(&sm.a[pos.stage][wg * 8 * R * KC * 16], 128, R * KC * 16,
                                    kNoSwizzle);
      const uint64_t db = make_desc(sm.b[pos.stage], 128, R * KB * 16, kNoSwizzle);
#pragma unroll
      for (int t = 0; t < T; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < T; ++t)
          wgmma_m64n64<1, 1>(acc[t], desc_advance(da, r * KC * 16),
                             desc_advance(db, (r * KB + t) * 16), r > 0 || s > s0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done
#pragma unroll
      for (int t = 0; t < T; ++t) fence_regs(acc[t]);
      if (pending >= 0) mbar_arrive(&sm.ring.empty[pending]);
      pending = pos.stage;
      pos.next();
    }
    wgmma_wait<0>();  // the chain is done: free its last stage, fold it
#pragma unroll
    for (int t = 0; t < T; ++t) fence_regs(acc[t]);
    mbar_arrive(&sm.ring.empty[pending]);
    if (s0 > 0) {  // add the earlier chains' sums
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int v = 0; v < NB / 2; ++v)
          acc[t][v] = sm.sum[t * NB / 2 + v][threadIdx.x] + acc[t][v];
    }
    if (s1 < steps) {  // and keep them for the next chain's fold
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int v = 0; v < NB / 2; ++v) sm.sum[t * NB / 2 + v][threadIdx.x] = acc[t][v];
    }
  }

  // table[(ky*ks + kx), f, ms]: 4 lanes write 8 consecutive ms of one f row
  // (zeros where no image row meets this kernel row)
  const int frow = f0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int kx = kx0 + t;
    if (kx >= ks) break;
    float* out = table + (size_t)(ky * ks + kx) * F * MS;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int col = ms0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = frow + 8 * h;
        if (f >= F) continue;
        float* o = out + (size_t)f * MS;
        if (col < MS) o[col] = acc[t][4 * j + 2 * h];
        if (col + 1 < MS) o[col + 1] = acc[t][4 * j + 2 * h + 1];
      }
    }
  }
}

// (C/8, N, H, W*8) bf16, chunk-major: the box is `cols` image columns of R
// rows of one image, for `chunks` channel chunks.
cudaError_t chunk_map(CUtensorMap* map, const void* base, int C, int N, int H, int W, int cols,
                      int chunks) {
  const cuuint64_t dims[4] = {(cuuint64_t)W * 8, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)(C + 7) / 8};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 16, (cuuint64_t)H * W * 16,
                                 (cuuint64_t)N * H * W * 16};
  const cuuint32_t box[4] = {(cuuint32_t)cols * 8, R, 1, (cuuint32_t)chunks};
  return make_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

extern "C" {

// err_t: (F8/8, N, H, W*8) and xb_t: (MS8/8, N, H, W*8), bf16, chunk-major
// (channel c at chunk c/8, lane c%8; F8, MS8 = F, MS rounded up to 8; the
// (m, s) planes in m-major order ms = m*S + s); table: (ks*ks, F, MS) f32;
// dtype: the input's before the split, 0 f32 (the instance that folds its
// wgmma chain every FOLD_F32 stages) or 1 bf16 (every FOLD_BF16). Returns a
// cudaError_t.
int dau_grad_tables_launch(const void* err_t, const void* xb_t, void* table, int F, int MS, int N,
                           int H, int W, int ks, int dtype, void* stream) {
  if (ks < 1 || ks % 2 == 0 || F <= 0 || MS <= 0 || N <= 0 || H <= 0 || W <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap err_map, xb_map;
  cudaError_t e = chunk_map(&err_map, err_t, F, N, H, W, KC, FB / 8);
  if (e != cudaSuccess) return (int)e;
  e = chunk_map(&xb_map, xb_t, MS, N, H, W, KB, NB / 8);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(Shared) + 1024;
  const dim3 grid((F + FB - 1) / FB, (MS + NB - 1) / NB, ks * ((ks + T - 1) / T));
  if (dtype == 0) {
    e = set_smem(grad_tables_kernel<FOLD_F32>, smem);
    if (e != cudaSuccess) return (int)e;
    grad_tables_kernel<FOLD_F32><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        err_map, xb_map, static_cast<float*>(table), F, MS, N, H, W, ks);
  } else {
    e = set_smem(grad_tables_kernel<FOLD_BF16>, smem);
    if (e != cudaSuccess) return (int)e;
    grad_tables_kernel<FOLD_BF16><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        err_map, xb_map, static_cast<float*>(table), F, MS, N, H, W, ks);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
