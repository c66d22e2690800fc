// DAU aggregation on a pre-blurred input (K4). Replaces
// dau_convnet_tpu/kernels/forward.py::aggregate_forward_pallas (the Pallas
// kernel `_agg_kernel`, run by `_run_aggregate`). It is K5's aggregation
// loop with the blur stage left out: the kernel, its bound and its design
// are described in dau_forward.cuh (BLUR = false).

#include "dau_forward.cuh"

extern "C" {

// Shared-memory bytes the kernel needs for a plan.
long long dau_aggregate_smem_bytes(int ks, int ft, int rt, int cg) {
  return dau_fwd::smem_bytes(ks, 1, ft, rt, cg, false);
}

// xb: (N, S, H, W) f32 (dtype 0) or bf16 (dtype 1), contiguous, already
// blurred; kern: (S, ks*ks, fk) f32 with fk = F padded with zeros to a
// multiple of ft; out: (N, F, H, W) in xb's dtype. ft must be a multiple of
// 8; (ft / 8) * rt * cg <= threads <= 256. Returns a cudaError_t.
int dau_aggregate_launch(const void* xb, const void* kern, void* out, int dtype, int N, int S,
                         int F, int fk, int H, int W, int ks, int ft, int rt, int cg,
                         int threads, long long smem, void* stream) {
  return dau_fwd::dispatch<false>(xb, nullptr, kern, out, dtype, N, S, F, fk, H, W, 1, ks, ft,
                                  rt, cg, threads, smem, stream);
}

}  // extern "C"
