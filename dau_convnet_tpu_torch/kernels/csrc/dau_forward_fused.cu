// Fused DAU forward for Hopper (sm_90a), K5: the Gaussian blur and the
// displaced aggregation in one kernel, the blurred planes kept in shared
// memory.
//
// Replaces dau_convnet_tpu/kernels/forward.py::dau_forward_fused_pallas (the
// Pallas kernel `_fused_kernel`). It computes the same function, not the
// same blocks:
//
//   xb[n,s]    = blur(x[n,s]) with the full kb x kb filter under zero
//                padding, in f32, and zero OUTSIDE the image (the
//                aggregation reads zeros there, not the blur of the padding);
//   y[n,f,i,j] = sum_s sum_{ky,kx} K[p,f,s] * xb[n,s,i+ky-c,j+kx-c],
//
// p = ky*ks + kx, c = ks/2, K the synthesized aggregation kernel, which the
// wrapper (`forward.py`) builds in K4's layout: (ks*ks, F, S8) bf16, s
// innermost. bf16 x: the blurred values are rounded once to bf16 (as the
// 'pallas' engine's bf16 depthwise blur rounds them before K4). f32 x: the
// blurred values are split in three bf16 parts (`split_bf16_3`'s arithmetic,
// in registers) and stacked along s as K4 stacks them, [x1, x1, x2, x1, x2,
// x3] against K's [K1, K2, K1, K3, K2, K1] over 6S channels. The wrapper's
// copy of x stacks six copies of x the same way, so the lane of stacked
// channel sc blurs source channel sc % S and keeps part sc / S of the split
// (parts straddle the 8-channel chunks where S is not a multiple of 8: each
// lane finds its own).
//
// Bound: the dense aggregation, 2*ks^2*S*F*H*W operations per image (394
// GFLOP per AlexNet-DAU request of 32) on a few MB, so the tensor cores bound
// it; the blur adds 2*kb^2*S*H*W on the FMA units per F tile. Design: K4's
// mainloop (dau_aggregate.cuh: two consumer warpgroups of m64n136k16 wgmmas
// over shifted descriptors of one staged flat window, K streamed per tap by
// TMA through a 6-stage ring, folded f32 sums, the store that skips dead
// columns), with another producer of the window:
//   - warp 8's lane 0 streams K by TMA, as in K4;
//   - warps 9-11 (96 threads) write the window of each group of 64 input
//     channels themselves, rc chunks of 8 channels at a time: (a) one 5-D
//     TMA box stages the chunks' raw pixels, the image rows the window
//     holds with a kb/2 halo, zero outside the image (TMA cannot read x in
//     place: a bf16 row of 13 pixels is 26 bytes, and its strides must be
//     multiples of 16, so the wrapper makes one chunk-major copy of x, as
//     K4's wrapper does of xb); with two raw buffers the next box loads
//     while this one is blurred, and each thread frees a buffer on its own
//     barrier, so one done early goes on to the next box; (b) the blur
//     items of all boxes are dealt round-robin, each 4 consecutive output
//     pixels x 8 channels blurred in f32 (a raw pixel is read once per filter row
//     and feeds all four; the filter rows sit in shared memory zero-padded
//     so no tap needs a bound check; consecutive threads take consecutive
//     rows, whose odd pitch keeps the 16-byte reads off each other's
//     banks); (c, d) it writes only the pixels inside the image, one
//     16-byte pixel of 8 channels per store, into the flat padded plane of
//     wgmma's no-swizzle K-major layout; the halo, the columns between rows
//     and the rows past the image hold the zeros written once at the
//     start; (e) `fence.proxy.async` before the window's full barrier makes
//     the stores visible to wgmma;
//   - with two windows the blur of the next window runs during the wgmmas
//     of this one;
//   - where ks is too large for one window of all its tap rows (the tiers
//     33 and 65), K4's plan cuts the taps into bands of kyb tap rows, one
//     window per (group, band): the blur warps blur the raw rows each band
//     reaches (with the kb - 1 halo rows) and write zeros into the window
//     rows outside the image, which move from band to band;
//   - where a raw row (W + kb - 1, odd) is wider than a TMA box side (256
//     pixels), the output columns are cut into strips of Wc columns, each
//     window a flat plane of row stride Wc + ks - 1 from image column c0 -
//     ks/2 (c0 the strip's first output column): the raw box holds the
//     image columns the window reaches and the blur's halo, from column
//     max(c0 - ks/2, 0) - kb/2; window columns outside the image keep the
//     zeros written at the start, as they are the same for all the
//     block's windows;
//   - the blur warps are the kernel's bottleneck: every F tile of the same
//     pixels needs the same window. Where the F tiles pair up, two
//     neighbouring tiles run as a cluster of two blocks, and each block
//     blurs half of every window's chunks and stores each pixel into its own
//     window and, through distributed shared memory, into its peer's; each
//     window's full barrier waits for the blur threads of both blocks and
//     its empty barrier for the consumers of both.
// What it costs beyond K4: the blur is redone for each pair of F tiles and
// for the halo rows a tile's window shares with its neighbours (conv2,
// 27x27: 17 rows per ~7.8 output rows); f32 x blurs each source chunk once
// per stacked part (6x).

#include "dau_aggregate.cuh"

namespace {

using namespace dau_agg;

constexpr int BLUR = 96;                             // blur threads: warps 9-11
constexpr int THREADS = CONSUMERS * 128 + 32 + BLUR;  // + the K warp
constexpr int TPX = 4;         // output columns per blur thread
constexpr int FPAD = 3;        // zeros on each side of a filter row (TPX - 1)

// K4's window plus the raw buffers: vr image rows per window at most, rr
// raw rows (vr and the halo) of rwp pixels (the width and the halo, rounded
// up to an odd number: the blur threads of a warp read the same column of
// consecutive rows, and an odd pitch of 16-byte pixels puts each 8 of them
// on distinct banks), rc raw chunks per TMA box, nbuf raw buffers, `raw`
// bytes per raw chunk, `filt` bytes of padded filter rows. The column
// strips: one (Wc = W) where the raw row of the plane fits a TMA box side
// (256 pixels), else the widest Wc whose raw row (Wc + ks - 1 + kb - 1,
// odd) does, narrowed further where no band's buffers fit; a strip's raw
// row holds the image columns its window reaches, at most min(W, Wc + ks -
// 1), and the blur's halo. Then, as K4's plan, the largest band of kyb tap
// rows whose buffers fit (kyb = ks where they do).
struct FusedPlan {
  Plan win;
  int vr, rr, rwp, rc, nbuf;
  uint32_t raw, filt;
};

// The plan for strips of wc columns; win.nxb = 0 where no band fits.
inline FusedPlan fused_plan_at(int H, int W, int wc, int ks, int kb, int in_bytes) {
  FusedPlan p{};
  for (int kyb = ks; kyb >= 1; --kyb) {
    p = FusedPlan{};
    p.win = window_plan(H, wc, ks, kyb);
    p.win.strips = (W + wc - 1) / wc;
    for (int t = 0; t < p.win.tiles; ++t)
      for (int b = 0; b < p.win.bands; ++b) {
        // the image row of the window's first row
        const int top = (t * QB) / p.win.wp - ks / 2 + b * kyb;
        const int lo = top > 0 ? top : 0;
        const int hi = top + p.win.rows < H ? top + p.win.rows : H;
        p.vr = hi - lo > p.vr ? hi - lo : p.vr;
      }
    p.rr = p.vr + kb - 1;
    p.rwp = ((W < p.win.wp ? W : p.win.wp) + kb - 1) | 1;
    p.raw = (uint32_t)p.rr * p.rwp * 8 * in_bytes;
    p.filt = (uint32_t)(kb * (kb + 2 * FPAD) * 4 + 15) / 16 * 16;
    if (p.rr > 256) continue;
    for (p.win.nxb = 2; p.win.nxb >= 1; --p.win.nxb)
      for (p.nbuf = 2; p.nbuf >= 1; --p.nbuf)
        for (p.rc = 8; p.rc >= 1; p.rc /= 2) {
          const size_t smem = smem_for(p.win.nxb, p.win.window) +
                              p.nbuf * round128(p.rc * p.raw) + p.filt + 4 * 8;
          if (smem <= MAX_SMEM) {
            p.win.smem = smem;
            return p;
          }
        }
  }
  p.win.nxb = 0;
  return p;
}

// The widest strip whose raw row fits a TMA box side; where its buffers fit
// at no band, the widest narrower one that fits, by bisection (narrower
// strips take less shared memory).
inline FusedPlan make_fused_plan(int H, int W, int ks, int kb, int in_bytes) {
  const int wc = ((W + kb - 1) | 1) <= 256 ? W : 257 - ks - kb;
  if (wc < 1) return FusedPlan{};
  FusedPlan p = fused_plan_at(H, W, wc, ks, kb, in_bytes);
  int lo = 1, hi = p.win.nxb ? 0 : wc - 1;
  while (lo <= hi) {
    const int mid = (lo + hi) / 2;
    const FusedPlan q = fused_plan_at(H, W, mid, ks, kb, in_bytes);
    if (q.win.nxb == 0) {
      hi = mid - 1;
    } else {
      p = q;
      lo = mid + 1;
    }
  }
  return p;
}

// a raw pixel of 8 channels widened to f32
__device__ __forceinline__ void load_raw(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The bf16 part `piece` (0, 1, 2) of v: split_bf16_3's t1, t2, t3.
__device__ __forceinline__ uint32_t bf16_part(float v, int piece) {
  __nv_bfloat16 t = __float2bfloat16_rn(v);
  if (piece > 0) {
    const float r = v - __bfloat162float(t);
    t = __float2bfloat16_rn(r);
    if (piece > 1) t = __float2bfloat16_rn(r - __bfloat162float(t));
  }
  return (uint32_t)__bfloat16_as_ushort(t);
}

// Makes this thread's generic-proxy shared-memory stores, its own block's
// and the peer's, visible to the async proxy (wgmma) once the barriers it
// arrives on next complete.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_forward_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap x_map, const float* __restrict__ filt,
                     T* __restrict__ out, int F, int S, int parts, int S8, int H, int W, int ks,
                     int kb, int kyb, int bands, int wc, int wp, int tiles, int rows, int nxb,
                     int rc, int nbuf, int rr, int rwp, int csize) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a = align1024(smem_raw);  // [STAGES][64 f][64 s], swizzled
  const uint32_t plane = (uint32_t)rows * wp * 16;
  const uint32_t window = round128(8 * plane);
  uint8_t* xb = a + STAGES * A_BYTES;  // [nxb][8 chunks][rows][Wp][8 s] bf16
  const int raw_px = rr * rwp;                     // pixels of one raw chunk
  const uint32_t raw_bytes = rc * raw_px * 8 * sizeof(T);  // of one TMA box
  uint8_t* raw = xb + nxb * window;  // [nbuf][rc][rr][rwp][8] in T, 128-aligned buffers
  const int fl = kb + 2 * FPAD;      // a padded filter row
  float* fp = reinterpret_cast<float*>(raw + nbuf * round128(raw_bytes));  // [kb][fl]
  Ring<STAGES>& ring = *reinterpret_cast<Ring<STAGES>*>(
      reinterpret_cast<uint8_t*>(fp) + (kb * fl * 4 + 15) / 16 * 16);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(&ring + 1);  // [2]
  uint64_t* xempty = xfull + 2;                               // [2]
  uint64_t* rawfull = xfull + 4;                              // [2]
  uint64_t* rawempty = xfull + 6;                             // [2]

  const int c = ks / 2;
  const int windows = (S8 + SG - 1) / SG * bands;  // (group, band) windows
  const int f0 = blockIdx.x * FB;
  const int strip = blockIdx.y / tiles;
  const int q0 = (blockIdx.y - strip * tiles) * QB;  // in the strip's plane
  const int c0 = strip * wc;     // the strip's first output column
  const int n = blockIdx.z;
  const int r0 = q0 / wp;        // the first padded row the window holds
  const int off = q0 - r0 * wp;  // q0's pixel in the window
  const int warp = threadIdx.x / 32;
  // csize 2: this block and its peer (the next or previous F tile of the
  // same pixels) each blur half of every window's chunks into both blocks
  const uint32_t rank = csize > 1 ? cluster_rank() : 0;
  const uint32_t peer = rank ^ 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], BLUR * csize);
      mbar_init(&xempty[i], 128 * CONSUMERS * csize);
      mbar_init(&rawfull[i], 1);
      mbar_init(&rawempty[i], BLUR);
    }
    ring.init(128 * CONSUMERS);  // fences the inits above too
  }
  for (int i = threadIdx.x; i < kb * fl; i += THREADS) {
    const int k = i % fl - FPAD;
    fp[i] = k >= 0 && k < kb ? filt[i / fl * kb + k] : 0.f;
  }
  for (uint32_t i = threadIdx.x * 16; i < nxb * window; i += THREADS * 16)
    *reinterpret_cast<uint4*>(xb + i) = make_uint4(0, 0, 0, 0);
  // the peer writes into these windows and arrives on these barriers only
  // once both blocks are past this point
  if (csize > 1)
    cluster_sync();
  else
    __syncthreads();

  if (warp == 4 * CONSUMERS) {  // the K warp
    if (threadIdx.x % 32 == 0)
      produce_k(a, ring, &k_map, windows, ks, kyb, bands, f0, [](int, int, int) {});
    return;
  }
  if (warp < 4 * CONSUMERS) {
    consume<T, true>(a, xb, window, plane, ring, xfull, xempty, out + c0, F, S8, H, W, ks, kyb,
                     bands, wp, nxb, f0, q0, n, off, min(wc, W - c0),
                     csize > 1 ? cluster_map(xempty, peer) : 0);
    return;
  }

  // ---- the blur warps
  const int bt = threadIdx.x - (4 * CONSUMERS + 1) * 32;
  const int cb = kb / 2;

  // band b's window starts at image row r0 - c + b*kyb; rows lo .. hi - 1
  // of it lie inside the image
  auto band_top = [&](int b) { return r0 - c + b * kyb; };
  auto band_lo = [&](int b) { return max(band_top(b), 0); };
  auto band_hi = [&](int b) { return min(band_top(b) + rows, H); };
  // with one band every window holds the same rows, and the rows outside
  // the image keep the zeros written at the start; with several, a slot's
  // rows move from window to window, so the blur threads cover every row
  // and write zeros outside the image
  const int nrows = bands > 1 ? rows : band_hi(0) - band_lo(0);
  // the image columns the window holds, x_lo .. x_lo + bw - 1 (all W where
  // the plane has one strip), at window column wx0 on
  const int x_lo = max(c0 - c, 0);
  const int bw = min(c0 - c + wp, W) - x_lo;
  const int wx0 = x_lo - (c0 - c);
  const int spans = (bw + TPX - 1) / TPX;  // blur items per row
  const int stacked = parts * S;
  const int batches = 8 / rc;  // raw boxes per window
  // the chunks this block blurs: those of its rank; with one chunk per box,
  // the boxes of its rank
  const bool split = rc >= csize;
  const int own = split ? rc / csize : 1;              // chunks blurred per box
  const int boxes = split ? batches : batches / csize;  // boxes loaded per window
  const int total = windows * boxes;
  const int blur_items = own * spans * nrows;
  // the k-th box this block loads (of all boxes: window k / boxes; of the
  // stack, chunks j * rc .. j * rc + rc - 1, group j / batches)
  auto box_of = [&](int k) {
    return k / boxes / bands * batches + (split ? k % boxes : k % boxes * csize + (int)rank);
  };
  // (a) box k: image rows lo - cb .. lo - cb + rr - 1 of its window's band,
  // columns x_lo - cb .. x_lo - cb + rwp - 1, into buffer k % nbuf once
  // every blur thread is done with box k - nbuf
  auto load_box = [&](int k) {
    uint64_t* bar = &rawfull[k % nbuf];
    mbar_wait(&rawempty[k % nbuf], ((k / nbuf) & 1) ^ 1);
    mbar_expect_tx(bar, raw_bytes);
    tma_load_5d(raw + (k % nbuf) * round128(raw_bytes), &x_map, bar, 0, x_lo - cb,
                band_lo(k / boxes % bands) - cb, n, box_of(k) * rc);
  };
  if (bt == 0)
    for (int k = 0; k < nbuf - 1 && k < total; ++k) load_box(k);
  for (int wi = 0; wi < windows; ++wi) {
    const int slot = wi % nxb;
    const int g = wi / bands;
    const int b = wi - g * bands;
    const int top = band_top(b);
    const int lo = band_lo(b);
    const int hi = band_hi(b);
    const int first_row = bands > 1 ? top : lo;  // the image row of item row 0
    uint8_t* win = xb + slot * window;
    const uint32_t peer_win = csize > 1 ? cluster_map(win, peer) : 0;
    mbar_wait<true>(&xempty[slot], ((wi / nxb) & 1) ^ 1);
    for (int kk = 0; kk < boxes; ++kk) {
      const int k = wi * boxes + kk;
      const int b0 = box_of(k) % batches * rc;  // the box's first chunk in the window
      if (bt == 0 && k + nbuf - 1 < total) load_box(k + nbuf - 1);
      mbar_wait(&rawfull[k % nbuf], (k / nbuf) & 1);
      const T* box = reinterpret_cast<const T*>(raw + (k % nbuf) * round128(raw_bytes));
      // (b-d) blur TPX output pixels x 8 channels per item in f32, write the
      // pixels inside the image into the window (zeros in the rows outside
      // it); consecutive threads take consecutive rows, and the items of
      // all boxes are dealt round-robin as one sequence, so a box whose
      // items do not fill the last round leaves no thread idle
      const int first = (bt - k * blur_items % BLUR + BLUR) % BLUR;
      for (int it = first; it < blur_items; it += BLUR) {
        const int oi = it / (spans * nrows);
        const int ci = split ? oi * csize + (int)rank : 0;  // the chunk's place in the box
        const int rem = it - oi * spans * nrows;
        const int col0 = rem / nrows * TPX;  // from image column x_lo
        const int row = first_row + rem - rem / nrows * nrows;  // its image row
        const int chunk = b0 + ci;
        const int base = (g * 8 + chunk) * 8;
        const int ncol = bw - col0 < TPX ? bw - col0 : TPX;
        const uint32_t at = chunk * plane + ((row - top) * wp + col0 + wx0) * 16;
        float acc[TPX][8];
#pragma unroll
        for (int o = 0; o < TPX; ++o)
#pragma unroll
          for (int l = 0; l < 8; ++l) acc[o][l] = 0.f;
        if (base < stacked && row >= lo && row < hi) {
          const T* rp = box + ((size_t)ci * raw_px + (row - lo) * rwp + col0) * 8;
          for (int dy = 0; dy < kb; ++dy) {
            const float* frow = fp + dy * fl;
            // wt[o] = filt[dy][jj - o] at raw column jj: frow[jj - o + FPAD],
            // whose first FPAD entries are zeros, so it starts at zero
            float wt[TPX] = {};
            const T* rrow = rp + (size_t)dy * rwp * 8;
#pragma unroll 4
            for (int jj = 0; jj < kb + ncol - 1; ++jj) {  // the raw columns it needs
#pragma unroll
              for (int o = TPX - 1; o > 0; --o) wt[o] = wt[o - 1];
              wt[0] = frow[jj + FPAD];
              float px[8];
              load_raw(rrow + jj * 8, px);
#pragma unroll
              for (int o = 0; o < TPX; ++o)
#pragma unroll
                for (int l = 0; l < 8; ++l) acc[o][l] = fmaf(wt[o], px[l], acc[o][l]);
            }
          }
        }
        int piece[8];
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const int part = base + l < stacked ? (base + l) / S : 0;
          piece[l] = part == 2 || part == 4 ? 1 : part == 5 ? 2 : 0;  // [x1, x1, x2, x1, x2, x3]
        }
#pragma unroll
        for (int o = 0; o < TPX; ++o) {
          if (o >= ncol) break;
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = bf16_part(acc[o][2 * i], piece[2 * i]) |
                   (bf16_part(acc[o][2 * i + 1], piece[2 * i + 1]) << 16);
          const uint4 px = make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(win + at + 16 * o) = px;
          if (csize > 1) st_cluster_v4(peer_win + at + 16 * o, px);
        }
      }
      // box k's buffer is free again for this thread; a thread done early
      // goes on to the next box without waiting for the others
      mbar_arrive(&rawempty[k % nbuf]);
    }
    // (e) hand the window, in this block and the peer, to the wgmmas (the
    // async proxy)
    fence_proxy_async();
    mbar_arrive(&xfull[slot]);
    if (csize > 1) mbar_arrive_cluster(cluster_map(&xfull[slot], peer));
  }
  // the peer's consumers free these windows remotely: stay until they have,
  // so that no arrival lands on a block that has exited
  if (csize > 1)
    for (int wi = windows > nxb ? windows - nxb : 0; wi < windows; ++wi)
      mbar_wait<true>(&xempty[wi % nxb], (wi / nxb) & 1);
}

template <typename T>
cudaError_t launch(const CUtensorMap& k_map, const void* x_t, const float* filt, void* out,
                   int N, int S, int parts, int S8, int F, int H, int W, int ks, int kb,
                   int csize, const FusedPlan& p, cudaStream_t stream) {
  // x_t: (S8/8, N, H, W*8) in T, 8 channels per pixel
  CUtensorMap x_map;
  const cuuint64_t e = sizeof(T) * 8;  // bytes per pixel
  const cuuint64_t dims[5] = {8, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)S8 / 8};
  const cuuint64_t strides[4] = {e, (cuuint64_t)W * e, (cuuint64_t)H * W * e,
                                 (cuuint64_t)N * H * W * e};
  const cuuint32_t box[5] = {8, (cuuint32_t)p.rwp, (cuuint32_t)p.rr, 1, (cuuint32_t)p.rc};
  cudaError_t err = make_map(&x_map, x_t, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                             sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err != cudaSuccess) return err;
  err = set_smem(fused_forward_kernel<T>, p.win.smem);
  if (err != cudaSuccess) return err;
  const int ftiles = (F + FB - 1) / FB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ftiles, p.win.tiles * p.win.strips, N);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.win.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_forward_kernel<T>, k_map, x_map, filt,
                           static_cast<T*>(out), F, S, parts, S8, H, W, ks, kb, p.win.kyb,
                           p.win.bands, p.win.wc, p.win.wp, p.win.tiles, p.win.rows, p.win.nxb,
                           p.rc, p.nbuf, p.rr, p.rwp, csize);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid(int H, int W, int ks, int kb) {
  return H > 0 && W > 0 && ks >= 1 && ks % 2 == 1 && kb >= 1 && kb % 2 == 1;
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch at (H, W, ks, kb) on f32 (dtype 0) or
// bf16 (dtype 1) x takes, or -1 where no plan fits (the wrapper raises).
long long dau_forward_fused_smem_bytes(int H, int W, int ks, int kb, int dtype) {
  if (!valid(H, W, ks, kb) || (dtype != 0 && dtype != 1)) return -1;
  const FusedPlan p = make_fused_plan(H, W, ks, kb, dtype == 0 ? 4 : 2);
  return p.win.nxb ? (long long)p.win.smem : -1;
}

// x_t: x chunk-major, (S8/8, N, H, W*8), f32 (dtype 0) or bf16 (dtype 1),
// its channels stacked as K's (bf16 x: S; f32 x: six copies of x, 6S),
// the channels past the stack zero; filt: (kb, kb) f32; kern: (ks*ks, F, S8)
// bf16, s innermost, K4's layout (f32 x: the three-way split stacked over
// 6S channels), S8 a multiple of 8; out: (N, F, H, W) in x's dtype; csize:
// blocks per cluster, 2 (neighbouring F tiles share their blur; the tile
// count must be even) or 1 (each block blurs alone), the wrapper's choice
// (`fused_cluster_size`). Returns a cudaError_t.
int dau_forward_fused_launch(const void* x_t, const void* filt, const void* kern, void* out,
                             int dtype, int N, int S, int F, int H, int W, int ks, int kb, int S8,
                             int csize, void* stream) {
  const int parts = dtype == 0 ? 6 : 1;
  if (N <= 0 || S <= 0 || F <= 0 || !valid(H, W, ks, kb) || (dtype != 0 && dtype != 1) ||
      S8 % 8 != 0 || S8 < parts * S || (csize != 1 && csize != 2) ||
      ((F + FB - 1) / FB) % csize != 0)
    return (int)cudaErrorInvalidValue;
  const FusedPlan p = make_fused_plan(H, W, ks, kb, dtype == 0 ? 4 : 2);
  if (p.win.nxb == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap k_map;
  cudaError_t e = make_k_map(&k_map, kern, S8, F, ks);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(filt);
  if (dtype == 0)
    return (int)launch<float>(k_map, x_t, f, out, N, S, parts, S8, F, H, W, ks, kb, csize, p,
                              st);
  return (int)launch<__nv_bfloat16>(k_map, x_t, f, out, N, S, parts, S8, F, H, W, ks, kb, csize,
                                    p, st);
}

}  // extern "C"
