// DAU aggregation on a pre-blurred input for Hopper (sm_90a), K4.
//
// Replaces dau_convnet_tpu/kernels/forward.py::aggregate_forward_pallas (the
// Pallas kernel `_agg_kernel`, run by `_run_aggregate`). It computes the
// same function, not the same blocks:
//
//   y[n,f,i,j] = sum_s sum_{ky,kx} K[p,f,s] * xb[n,s,i+ky-c,j+kx-c]
//
// p = ky*ks + kx, c = ks/2, xb zero outside the image, bf16 operands, f32
// sums, y written in xb's dtype. The wrapper (`forward.py`) synthesizes K
// and lays both operands out (`aggregate_forward_operands`): K as (ks*ks, F,
// S8) bf16, s innermost; xb chunk-major, (S8/8, N, H, W*8), eight channels
// per 16-byte pixel. f32 input reaches the kernel split into three bf16
// parts stacked along s, xb as [x1, x1, x2, x1, x2, x3] against K as [K1,
// K2, K1, K3, K2, K1]: six products that keep each f32 product to ~2^-24.
//
// Bound: on the row-strided flat plane of the Pallas kernel (row stride Wp
// = W + ks - 1, output q = i*Wp + j) the aggregation is ks^2 GEMMs,
// y[f,q] += K_p[f,:] . xb[:, q + ky*Wp + kx]: 2*ks^2*S*F*H*W operations per
// image (conv4, N = 32: 129 GFLOP) on a few MB, so the tensor cores bound
// it. Design:
//   - pixels are wgmma's N, 136 flat positions per warpgroup, two
//     warpgroups per block (272 positions: one 13x13 image, 265 flat
//     positions, in one block; 27x27, 937 positions, in four); output
//     channels are wgmma's M, 64 per block, shared by both warpgroups;
//   - the producer warp stages, per group of 64 input channels and band of
//     kyb tap rows, the padded rows of xb the band's taps reach: one 5-D
//     TMA box (8 channels x Wp columns x rows x 8 channel chunks) from
//     column c0 - c, row r0 - c + b*kyb (c0 the first output column of the
//     block's column strip, 0 where the plane has one strip). TMA
//     reads the halo, the columns between rows and the ragged channels as
//     zeros, so the wrapper copies no padding. In shared memory a chunk is
//     the flat padded plane, one pixel per 16 bytes: wgmma's no-swizzle
//     K-major layout (SBO = 128), in which tap (ky, kx) is the same
//     descriptor 16*((ky - b*kyb)*Wp + kx) bytes on. The window stays for
//     all the band's taps (the next one loads meanwhile where the shared
//     memory holds two). Up to ks = 17 at the AlexNet-DAU planes one band
//     holds all ks tap rows; at ks = 33 and 65 no window of all of them fits
//     the shared memory, and the plan takes the tallest band that does;
//   - K streams through a ring of STAGES stages, one tap's 64 f x 64 s
//     tile (8 KB, 128-byte swizzled as in K7) per stage; each stage feeds
//     four m64n136k16 per warpgroup;
//   - the sums stay in registers (68 per thread, and 68 more into which
//     they are folded every few taps: the tensor cores' f32 sums round
//     toward zero, and a run of 5,832 k16 steps, conv4 in f32 unfolded,
//     drifted by 1.1e-4 of max|y|) and are stored straight to (N, F, H,
//     W); the flat plane's dead columns (j >= W) and rows past the image
//     are not stored;
//   - each output is summed by one block in one fixed order: no atomics;
//   - a box side holds at most 256 pixels: where a padded row W + ks - 1
//     exceeds it, the plan cuts the output columns into strips of Wc
//     columns (Wc + ks - 1 <= 256), each staged as its own flat plane of
//     row stride Wp = Wc + ks - 1, the zeros out of bounds still the halo.
// What it costs: the flat layout computes Wp columns per W valid ones (62%
// useful at 13x13, 77% at 27x27, before the tile's round-up), and every
// block streams its 64-channel F tile of K once: 81 * S * 128 bytes (conv4:
// 4 MB per block, from L2).
// The consumer side, the K producer and the plan live in dau_aggregate.cuh,
// which K5 (dau_forward_fused.cu) shares; what is K4's own is the window's
// TMA load.

#include "dau_aggregate.cuh"

namespace {

using namespace dau_agg;

constexpr int THREADS = CONSUMERS * 128 + 32;

template <typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
aggregate_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap xb_map, Tout* __restrict__ out, int F,
                 int S8, int H, int W, int ks, int kyb, int bands, int wc, int wp, int tiles,
                 int rows, int nxb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a = align1024(smem_raw);  // [STAGES][64 f][64 s], swizzled
  const uint32_t plane = (uint32_t)rows * wp * 16;
  const uint32_t window = round128(8 * plane);
  uint8_t* xb = a + STAGES * A_BYTES;  // [nxb][8 chunks][rows][Wp][8 s]
  Ring<STAGES>& ring = *reinterpret_cast<Ring<STAGES>*>(xb + nxb * window);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(&ring + 1);  // [2]
  uint64_t* xempty = xfull + 2;                               // [2]

  const int c = ks / 2;
  const int windows = (S8 + SG - 1) / SG * bands;
  const int f0 = blockIdx.x * FB;
  const int strip = blockIdx.y / tiles;
  const int q0 = (blockIdx.y - strip * tiles) * QB;  // in the strip's plane
  const int c0 = strip * wc;     // the strip's first output column
  const int n = blockIdx.z;
  const int r0 = q0 / wp;        // the first padded row the window holds
  const int off = q0 - r0 * wp;  // q0's pixel in the window

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], 128 * CONSUMERS);
    }
    ring.init(128 * CONSUMERS);  // fences the inits above too
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4 * CONSUMERS) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      // window wi: group wi / bands, band wi % bands, whose rows start kyb
      // padded rows below the previous band's
      auto load_window = [&](int wi) {
        const int slot = wi % nxb;
        const int g = wi / bands;
        mbar_wait(&xempty[slot], ((wi / nxb) & 1) ^ 1);
        mbar_expect_tx(&xfull[slot], 8 * plane);
        tma_load_5d(xb + slot * window, &xb_map, &xfull[slot], 0, c0 - c,
                    r0 - c + (wi - g * bands) * kyb, n, g * 8);
      };
      // with two windows, window wi + 1 is loaded during window wi, once the
      // consumers have passed its first tap (and so freed window wi - 1);
      // with one, after window wi's last K tile is issued
      load_window(0);
      produce_k(a, ring, &k_map, windows, ks, kyb, bands, f0, [&](int wi, int i, int taps) {
        const int prefetch_at = nxb == 2 ? min(STAGES, taps - 1) : taps - 1;
        if (i == prefetch_at && wi + 1 < windows) load_window(wi + 1);
      });
    }
    return;
  }
  consume<Tout>(a, xb, window, plane, ring, xfull, xempty, out + c0, F, S8, H, W, ks, kyb, bands,
                wp, nxb, f0, q0, n, off, min(wc, W - c0));
}

template <typename Tout>
cudaError_t launch(const CUtensorMap& k_map, const CUtensorMap& xb_map, void* out, int N, int S8,
                   int F, int H, int W, int ks, const Plan& p, cudaStream_t stream) {
  cudaError_t e = set_smem(aggregate_kernel<Tout>, p.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((F + FB - 1) / FB, p.tiles * p.strips, N);
  aggregate_kernel<Tout><<<grid, THREADS, p.smem, stream>>>(
      k_map, xb_map, static_cast<Tout*>(out), F, S8, H, W, ks, p.kyb, p.bands, p.wc, p.wp,
      p.tiles, p.rows, p.nxb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch at (H, W, ks) takes, or -1 where no
// strip and band of its staged window fits (the wrapper refuses such a
// shape first, through `forward.aggregate_plan`).
long long dau_aggregate_smem_bytes(int H, int W, int ks) {
  if (H <= 0 || W <= 0 || ks < 1 || ks % 2 == 0) return -1;
  const Plan p = make_plan(H, W, ks);
  return p.smem ? (long long)p.smem : -1;
}

// xb_t: (S8/8, N, H, W*8) bf16, chunk-major (channel s at chunk s/8, lane
// s%8); kern: (ks*ks, F, S8) bf16, s innermost; S8 a multiple of 8, the
// stacked channels past S zero in both. out: (N, F, H, W), f32 (dtype 0) or
// bf16 (dtype 1). Returns a cudaError_t.
int dau_aggregate_launch(const void* xb_t, const void* kern, void* out, int dtype, int N, int S8,
                         int F, int H, int W, int ks, void* stream) {
  if (N <= 0 || S8 <= 0 || S8 % 8 != 0 || F <= 0 || H <= 0 || W <= 0 || ks < 1 || ks % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(H, W, ks);
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, xb_map;
  cudaError_t e = make_k_map(&k_map, kern, S8, F, ks);
  if (e != cudaSuccess) return (int)e;
  const cuuint64_t x_dims[5] = {8, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N,
                                (cuuint64_t)S8 / 8};
  const cuuint64_t x_strides[4] = {16, (cuuint64_t)W * 16, (cuuint64_t)H * W * 16,
                                   (cuuint64_t)N * H * W * 16};
  const cuuint32_t x_box[5] = {8, (cuuint32_t)p.wp, (cuuint32_t)p.rows, 1, SG / 8};
  e = make_map(&xb_map, xb_t, 5, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(k_map, xb_map, out, N, S8, F, H, W, ks, p, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(k_map, xb_map, out, N, S8, F, H, W, ks, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
