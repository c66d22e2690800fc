// The one-hot tap gather probe for Hopper: the counterpart of P7
// (benchmarks/mosaic_probe.py::t_gather_loop). It computes the probe's own
// reference (mosaic_probe.py:222-224; its Pallas body does not trace, see
// kernels/probe_kernels.py)
//
//   out[m, s, g, f] = sum_p [tgt[s, g, f] == p] * iw[s, g, f] * tab[p, m, s, f]
//
// over p in [0, P): one read of tab where tgt holds an integer in [0, P),
// else 0. The Pallas kernel walks all P slabs of the table in VMEM (a
// fori_loop of P masked multiply-adds); here one thread an output reads the
// one slab its target names, so the sum of P terms, all zero but one, is
// that one product, rounded once as the reference rounds it.
//
// Bound: bytes. At the probe's shape (tab 81 x 3 x 128 x 128 f32, 15.9 MB;
// 98,304 outputs) the data needs one 4-byte word of tab per output whose
// target is an integer in range (every one, at the probe's targets), and
// the rest of tab not at all: with tgt, iw and out that is 1.05 MB, ~0.31
// us at 3.35 TB/s, well under one launch. f is the fastest index, so a
// warp's 32 threads read 32 neighbouring f of tgt, iw and out; their tab
// reads land on as many slabs as the warp has distinct targets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
probe_gather_kernel(const float* __restrict__ tab, const float* __restrict__ tgt,
                    const float* __restrict__ iw, float* __restrict__ out, int P, int M, int S,
                    int G, int F) {
  const long long total = (long long)M * S * G * F;
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int f = (int)(i % F);
    const long long r = i / F;
    const int g = (int)(r % G);
    const int s = (int)((r / G) % S);
    const int m = (int)(r / ((long long)G * S));
    const long long sgf = ((long long)s * G + g) * F + f;
    const float t = tgt[sgf];
    float v = 0.f;
    // the reference's mask: tgt equal to one of 0 .. P-1 (a NaN or a
    // fraction equals none)
    if (t >= 0.f && t < (float)P) {
      const int p = (int)t;
      if ((float)p == t) v = iw[sgf] * tab[(((long long)p * M + m) * S + s) * F + f];
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// tab: (P, M, S, F) f32; tgt, iw: (S, G, F) f32; out: (M, S, G, F) f32; all
// contiguous. Returns a cudaError_t.
int dau_probe_gather_launch(const float* tab, const float* tgt, const float* iw, float* out,
                            int P, int M, int S, int G, int F, void* stream) {
  if (P < 1 || M < 1 || S < 1 || G < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)M * S * G * F;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  probe_gather_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, tgt, iw, out, P, M, S, G, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
