// The aggregation mainloop shared by K4 (dau_aggregate.cu, a pre-blurred
// input staged by TMA) and K5 (dau_forward_fused.cu, the raw input blurred
// into the staged window by producer warps).
//
// Both compute, per block of FB output channels x QB flat positions of one
// image, y[f,q] = sum_p K_p[f,:] . xb[:, q + ky*Wp + kx] on the row-strided
// flat plane (row stride Wp = W + ks - 1, output q = i*Wp + j, tap p = ky*ks
// + kx): ks^2 GEMMs on the tensor cores, bf16 operands, f32 sums.
//   - column strips: a staged row is one TMA box side, at most 256 pixels,
//     so where W + ks - 1 (K4) or K5's raw row exceeds it, the output
//     columns are cut into strips of Wc columns, each its own flat plane of
//     row stride Wp = Wc + ks - 1 whose padded rows start at image column
//     c0 - ks/2 (c0 the strip's first output column); a block's tile lies
//     in one strip. One strip (Wc = W) wherever the row fits: the plane of
//     the kernels before strips, at every AlexNet-DAU plane;
//   - the staged window: per group of SG = 64 input channels and band of
//     kyb tap rows, 8 chunks of 8 channels, each the flat padded plane of
//     the rows the block's taps of that band reach, one 16-byte pixel of 8
//     channels per row of wgmma's no-swizzle K-major layout (SBO = 128):
//     tap (ky, kx) of band b is the same descriptor 16*((ky - b*kyb)*Wp +
//     kx) bytes on. Pixels outside the image (the halo, the columns between
//     rows, the rows past the image) hold zeros. Windows go in (group,
//     band) order; window i sits in slot i % nxb, its "full" barrier
//     completes when it is staged, its "empty" barrier when the 256
//     consumer threads are done with it. One band (kyb = ks) covers every
//     tap row where the window fits; a larger ks (the tiers 33 and 65)
//     takes several bands, so a window holds the reach of kyb tap rows,
//     not of all ks;
//   - K streams through a ring of STAGES stages, one tap's 64 f x 64 s tile
//     (8 KB, 128-byte swizzled) per stage, loaded by TMA from a (ks*ks, F,
//     S8) bf16 tensor in (group, tap) order, which is also (group, band,
//     tap); each stage feeds four m64n136k16 per warpgroup;
//   - the sums stay in registers (68 per thread, folded every few taps of a
//     group, counted across its bands, into 68 more) and are stored
//     straight to (N, F, H, W); the flat plane's dead columns (j >=
//     min(Wc, W - c0)) and rows past the image are not stored;
//   - each output is summed by one block in one fixed order: no atomics,
//     whatever the number of bands;
//   - K5 runs two blocks as a cluster, which write each other's windows:
//     the consumers then wait for a window at cluster scope and free it in
//     both blocks (`consume<..., true>`).

#pragma once

#include "dau_hopper_gemm.cuh"

namespace dau_agg {

using namespace dau_hopper;

constexpr int FB = 64;                 // output channels per block: the wgmma M
constexpr int NP = 136;                // flat positions per warpgroup: the wgmma N
constexpr int CONSUMERS = 2;           // warpgroups
constexpr int QB = CONSUMERS * NP;     // flat positions per block
constexpr int SG = 64;                 // input channels per window: one 128-byte K row
constexpr int STAGES = 6;
// taps summed on the tensor cores between folds: the bf16 output rounds
// away what 27 taps drift; the f32 path, whose output feeds ReLUs and
// max-pools in an f32 training step, folds every 3
constexpr int FOLD_BF16 = 27;
constexpr int FOLD_F32 = 3;
constexpr uint32_t A_BYTES = FB * SG * 2;
constexpr size_t MAX_SMEM = 232448;    // 227 KB per block

__host__ __device__ constexpr uint32_t round128(uint32_t v) { return (v + 127) / 128 * 128; }

// The staged window of a launch: the strip width wc and the strips, the
// padded row (wp = wc + ks - 1) and the tiles of one strip's plane, padded
// rows per window, the tap rows per band (kyb) and the bands, the bytes of
// one chunk (a flat plane of rows x wp pixels) and of a window (8 chunks),
// the windows in flight and the dynamic shared memory. smem = 0: no plan.
// (`kernels/forward.py` mirrors the plans of this file and of
// dau_forward_fused.cu.)
struct Plan {
  int wc, strips, wp, tiles, rows, nxb, kyb, bands;
  uint32_t plane, window;
  size_t smem;
};

// The shared memory of the K ring, nxb windows and their barriers (K5 adds
// its own buffers after them).
inline size_t smem_for(int nxb, uint32_t window) {
  return 1024 + STAGES * A_BYTES + nxb * round128(window) + sizeof(Ring<STAGES>) + 4 * 8;
}

// The window's geometry at (H, ks) for a strip of Wc columns with bands of
// kyb tap rows, without the strips, nxb and smem: the rows that a tile's QB
// positions reach through kyb tap rows and all ks tap columns.
inline Plan window_plan(int H, int Wc, int ks, int kyb) {
  Plan p{};
  p.wc = Wc;
  p.wp = Wc + ks - 1;
  p.kyb = kyb;
  p.bands = (ks + kyb - 1) / kyb;
  const int flat = (H - 1) * p.wp + Wc;  // the output positions a block may own
  p.tiles = (flat + QB - 1) / QB;
  for (int t = 0; t < p.tiles; ++t) {
    const int off = (t * QB) % p.wp;  // the tile's first column in its first row
    const int rows = (off + QB + (kyb - 1) * p.wp + ks - 1 + p.wp - 1) / p.wp;
    p.rows = rows > p.rows ? rows : p.rows;
  }
  p.plane = (uint32_t)p.rows * p.wp * 16;
  p.window = 8 * p.plane;
  return p;
}

// K4's plan: strips of the widest Wc whose padded row fits a TMA box side
// (256 pixels; Wc = W, one strip, where W + ks - 1 fits), then the largest
// kyb whose window fits, two windows where they fit, else one (kyb = ks
// where that fits: one band). A window of more than 256 rows takes thinner
// bands; ks > 256 has no plan.
inline Plan make_plan(int H, int W, int ks) {
  Plan p{};
  const int wc = W + ks - 1 <= 256 ? W : 257 - ks;
  for (int kyb = ks; kyb >= 1 && wc >= 1; --kyb) {
    p = window_plan(H, wc, ks, kyb);
    p.strips = (W + wc - 1) / wc;
    if (p.rows > 256) continue;
    for (p.nxb = 2; p.nxb >= 1; --p.nxb)
      if (smem_for(p.nxb, p.window) <= MAX_SMEM) {
        p.smem = smem_for(p.nxb, p.window);
        return p;
      }
  }
  p.nxb = 0;
  p.smem = 0;
  return p;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The two consumer warpgroups (warps 0-7) of a block: for every window
// (group of SG input channels, band of kyb tap rows), wait for it, run the
// band's taps against the K ring and free it; then store the block's
// outputs. `xb` is the first window slot, `window` the (128-rounded) bytes
// between slots; q0 is the block's first flat position, off its pixel in
// the window; `out` points at the strip's first output column, wv is its
// output columns (min(Wc, W - c0)). kPeer: another block of the cluster may write this
// block's windows too (K5), so the window barriers are waited on at cluster
// scope, and where peer_xempty (a shared::cluster address of the peer
// block's xempty) is not 0 each window is also freed there.
template <typename Tout, bool kPeer = false>
__device__ __forceinline__ void consume(uint8_t* a, uint8_t* xb, uint32_t window, uint32_t plane,
                                        Ring<STAGES>& ring, uint64_t* xfull, uint64_t* xempty,
                                        Tout* __restrict__ out, int F, int S8, int H, int W,
                                        int ks, int kyb, int bands, int wp, int nxb, int f0,
                                        int q0, int n, int off, int wv,
                                        uint32_t peer_xempty = 0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int taps = ks * ks;
  const int windows = (S8 + SG - 1) / SG * bands;
  constexpr int fold = sizeof(Tout) == 4 ? FOLD_F32 : FOLD_BF16;
  const int wg = warp / 4;
  float acc[NP / 2];  // the wgmmas' sums since the last fold
  float sum[NP / 2];  // the folded sums
#pragma unroll
  for (int v = 0; v < NP / 2; ++v) acc[v] = sum[v] = 0.f;

  RingPos<STAGES> pos;
  int pending = -1;  // the K stage whose wgmmas may still be reading it
  for (int wi = 0; wi < windows; ++wi) {
    const int g = wi / bands;
    const int ky0 = (wi - g * bands) * kyb;  // the band's first tap row
    const int slot = wi % nxb;
    mbar_wait<kPeer>(&xfull[slot], (wi / nxb) & 1);
    __syncwarp();
    const int ksteps = min(SG, S8 - g * SG + 15) / 16;  // k16 steps with channels left
    // the warpgroup's first flat position; chunk pairs 2*plane apart
    const uint64_t db0 =
        make_desc(xb + slot * window + 16 * (off + wg * NP), plane, 128, kNoSwizzle);
    const int p_end = min(ks, ky0 + kyb) * ks;  // one past the band's last tap
    for (int p = ky0 * ks; p < p_end; ++p) {
      const int ky = p / ks;
      const uint64_t db = desc_advance(db0, 16 * ((ky - ky0) * wp + p - ky * ks));
      pos.wait_full(ring);
      const uint64_t da = make_desc(a + pos.stage * A_BYTES, 16, 1024, kSwizzle128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SG / 16; ++kk)
        if (kk < ksteps)
          wgmma_m64n136<0, 0>(acc, desc_advance(da, 32 * kk), desc_advance(db, 2 * plane * kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous group is done
      fence_regs(acc);
      if (pending >= 0) mbar_arrive(&ring.empty[pending]);
      pending = pos.stage;
      pos.next();
      // the tensor cores round each running f32 sum toward zero, a bias
      // that grows with the number of k16 steps summed into it: every
      // `fold` taps of the group (counted across its bands) the partial
      // sums are added into `sum` on the FMA units (rounded to nearest) and
      // restarted from zero
      const bool fold_now = (p + 1) % fold == 0 || p + 1 == taps;
      if (fold_now || p + 1 == p_end) {  // and the band's window is freed after its last tap
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&ring.empty[pending]);
        pending = -1;
        if (fold_now) {
#pragma unroll
          for (int v = 0; v < NP / 2; ++v) {
            sum[v] += acc[v];
            acc[v] = 0.f;
          }
        }
      }
    }
    mbar_arrive(&xempty[slot]);  // the wait at the band's last tap covered every wgmma on it
    if constexpr (kPeer) {
      if (peer_xempty != 0) mbar_arrive_cluster(peer_xempty + 8 * slot);
    }
  }

  // sum[4j + 2h + e]: channel frow + 8h, flat position qb + 8j + 2*(lane%4) + e
  const int frow = f0 + (warp % 4) * 16 + lane / 4;
  const int qb = q0 + wg * NP;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = qb + 8 * j + 2 * (lane % 4) + e;
      const int i = q / wp;
      const int jj = q - i * wp;
      if (i >= H || jj >= wv) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = frow + 8 * h;
        if (f < F)
          store_out(out + (((size_t)n * F + f) * H + i) * W + jj, sum[4 * j + 2 * h + e]);
      }
    }
  }
}

// The K producer: one lane streams the K tiles (64 f x 64 s, from F tile
// f0) of every window's taps through the ring: for group g and band b, the
// taps of tap rows b*kyb .. min(ks, (b+1)*kyb) - 1. `between(wi, i, n)`
// runs after the i-th of the n taps of window wi is issued (K4 loads its
// next window from there).
template <typename Between>
__device__ __forceinline__ void produce_k(uint8_t* a, Ring<STAGES>& ring, const CUtensorMap* k_map,
                                          int windows, int ks, int kyb, int bands, int f0,
                                          Between between) {
  RingPos<STAGES> pos;
  for (int wi = 0; wi < windows; ++wi) {
    const int g = wi / bands;
    const int p0 = (wi - g * bands) * kyb * ks;
    const int p1 = min(ks * ks, p0 + kyb * ks);
    for (int p = p0; p < p1; ++p) {
      uint64_t* full = pos.acquire(ring, A_BYTES);
      tma_load_3d(a + pos.stage * A_BYTES, k_map, full, g * SG, f0, p);
      pos.next();
      between(wi, p - p0, p1 - p0);
    }
  }
}

// K's tensor map: (ks*ks, F, S8) bf16, s innermost, boxes of 64 s x 64 f of
// one tap, 128-byte swizzled.
inline cudaError_t make_k_map(CUtensorMap* k_map, const void* kern, int S8, int F, int ks) {
  const cuuint64_t k_dims[3] = {(cuuint64_t)S8, (cuuint64_t)F, (cuuint64_t)ks * ks};
  const cuuint64_t k_strides[2] = {(cuuint64_t)S8 * 2, (cuuint64_t)F * S8 * 2};
  const cuuint32_t k_box[3] = {SG, FB, 1};
  return make_map(k_map, kern, 3, k_dims, k_strides, k_box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace dau_agg
