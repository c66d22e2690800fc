// Fused DAU forward (K5): Gaussian blur + displaced aggregation in one pass,
// with the blurred planes kept in shared memory. Replaces
// dau_convnet_tpu/kernels/forward.py::dau_forward_fused_pallas; the kernel,
// its bound and its design are described in dau_forward.cuh.

#include "dau_forward.cuh"

extern "C" {

// Shared-memory bytes the kernel needs for a plan; the wrapper checks it
// against the card's limit before launching.
long long dau_forward_fused_smem_bytes(int ks, int kb, int ft, int rt, int cg) {
  return dau_fwd::smem_bytes(ks, kb, ft, rt, cg);
}

// x: (N, S, H, W) f32 (dtype 0) or bf16 (dtype 1), contiguous; filt: (kb, kb)
// f32; kern: (S, ks*ks, fk) f32 with fk = F padded with zeros to a multiple of
// ft; out: (N, F, H, W) in x's dtype. ft must be a multiple of 8;
// (ft / 8) * rt * cg <= threads <= 256. Returns a cudaError_t.
int dau_forward_fused_launch(const void* x, const void* filt, const void* kern, void* out,
                             int dtype, int N, int S, int F, int fk, int H, int W, int kb,
                             int ks, int ft, int rt, int cg, int threads, long long smem,
                             void* stream) {
  return dau_fwd::dispatch(x, filt, kern, out, dtype, N, S, F, fk, H, W, kb, ks, ft, rt,
                                 cg, threads, smem, stream);
}

}  // extern "C"
