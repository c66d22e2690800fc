// The streaming probes for Hopper: the counterparts of P3
// (benchmarks/mosaic_probe.py::t_vmem), P4 (t_grid_overhead) and P8
// (benchmarks/pallas_ladder.py::run_copy). Each moves bytes and computes
// next to nothing, so each is bound by the memory rate (3.35 TB/s on an
// H100 SXM) or, at small sizes, by what one launch costs.
//
//   - P3 `scale_colsum`: out[0, j] = sum_i 2 * x[i, j]. The Pallas kernel
//     holds 2x in a VMEM scratch of total_mb (up to 60 MB: the question was
//     whether VMEM holds it) and sums its columns. A block has at most 227
//     KB of shared memory, so here the scratch lies in device memory:
//     `scale_kernel` writes 2x into it, `colsum_partial_kernel` sums each
//     column over a band of rows per block, and `colsum_final_kernel` sums
//     the bands in order (no atomics: the sums come out the same every
//     run). What the card answers instead: whether the scratch's round trip
//     stays in the 50 MB L2 (24 MB) or spills to HBM (40, 60 MB), by its
//     time at each size.
//   - P4 `add_one`: y = x + 1 in bf16 over a (32768, 512) array, 8 values
//     (16 bytes) a thread a step; block b takes the b-th contiguous share
//     of the array, so `blocks` plays the part of the Pallas grid. The
//     TPU's grid steps run in order on one core; the GPU's counterpart of a
//     step's cost is a launch's, measured by the wrapper's callers over 16
//     and 256 launches on row slices.
//   - P8 `copy_tiles`: a (rows, cols) bf16 copy, block b the b-th tile of
//     `ch` columns (all rows), as the Pallas grid of (B, ch) blocks; 16
//     bytes a thread, four loads in flight before their stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scale_kernel(const float4* __restrict__ x, float4* __restrict__ scratch, long long n4) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 v = x[i];
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
    scratch[i] = v;
  }
}

// partial[b, j] = sum over the rows [b * band, (b + 1) * band) of scratch[., j]
__global__ void __launch_bounds__(THREADS)
colsum_partial_kernel(const float* __restrict__ scratch, float* __restrict__ partial, int rows,
                      int cols, int band) {
  const int r0 = blockIdx.x * band;
  const int r1 = min(rows, r0 + band);
  for (int j = threadIdx.x; j < cols; j += THREADS) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) s += scratch[(long long)r * cols + j];
    partial[(long long)blockIdx.x * cols + j] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
colsum_final_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts,
                    int cols) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += partial[(long long)b * cols + j];
  out[j] = s;
}

__device__ __forceinline__ uint32_t add_one2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  const float2 f = __bfloat1622float2(v);
  v = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
  return *reinterpret_cast<uint32_t*>(&v);
}

// y = x + 1 over n8 vectors of 8 bf16; block b the b-th contiguous share
__global__ void __launch_bounds__(THREADS)
add_one_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long n8) {
  const long long share = (n8 + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * share;
  const long long hi = min(n8, lo + share);
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
    uint4 v = x[i];
    v.x = add_one2(v.x);
    v.y = add_one2(v.y);
    v.z = add_one2(v.z);
    v.w = add_one2(v.w);
    y[i] = v;
  }
}

// block b copies columns [b * ch8, (b + 1) * ch8) of every row, in vectors
// of 8 bf16; cols8 vectors a row
__global__ void __launch_bounds__(THREADS)
copy_tiles_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int rows,
                  long long cols8, int ch8) {
  const long long c0 = (long long)blockIdx.x * ch8;
  const int w = (int)min((long long)ch8, cols8 - c0);
  const long long total = (long long)rows * w;
  constexpr int U = 4;
  for (long long base = threadIdx.x; base < total; base += U * THREADS) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < total) v[u] = x[(i / w) * cols8 + c0 + i % w];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < total) y[(i / w) * cols8 + c0 + i % w] = v[u];
    }
  }
}

inline int grid_for(long long work, int per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return (int)(blocks > 65535LL * 16 ? 65535LL * 16 : blocks);
}

}  // namespace

extern "C" {

// x: (rows, cols) f32 contiguous, cols a multiple of 4; scratch: (rows,
// cols) f32; partial: (parts, cols) f32; out: (cols,) f32. Three launches
// on the stream: 2x into scratch, per-band column sums, their sum. Returns
// a cudaError_t.
int dau_probe_scale_colsum_launch(const float* x, float* scratch, float* partial, float* out,
                                  int rows, int cols, int parts, void* stream) {
  if (rows < 1 || cols < 1 || cols % 4 != 0 || parts < 1 || parts > rows ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n4 = (long long)rows * cols / 4;
  scale_kernel<<<grid_for(n4, THREADS * 4), THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(scratch), n4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int band = (rows + parts - 1) / parts;
  colsum_partial_kernel<<<(rows + band - 1) / band, THREADS, 0, st>>>(scratch, partial, rows,
                                                                      cols, band);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_final_kernel<<<(cols + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, out, (rows + band - 1) / band, cols);
  return (int)cudaGetLastError();
}

// x, y: n bf16, n a multiple of 8, 16-byte aligned; `blocks` blocks.
int dau_probe_add_one_launch(const void* x, void* y, long long n, int blocks, void* stream) {
  if (n < 8 || n % 8 != 0 || blocks < 1 || blocks > 65535 * 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  add_one_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n / 8);
  return (int)cudaGetLastError();
}

// x, y: (rows, cols) bf16 contiguous, cols and ch multiples of 8, 16-byte
// aligned; one block per tile of ch columns.
int dau_probe_copy_tiles_launch(const void* x, void* y, int rows, long long cols, int ch,
                                void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0 || ch < 8 || ch % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (cols + ch - 1) / ch;
  if (tiles > 65535LL * 16) return (int)cudaErrorInvalidValue;
  copy_tiles_kernel<<<(unsigned)tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), rows, cols / 8, ch / 8);
  return (int)cudaGetLastError();
}

// The limits the P3 question turns on: the dynamic shared memory a block
// can opt into, the L2's size, and the SM count, of the current device.
int dau_probe_device_limits(int* smem_optin, int* l2_bytes, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // extern "C"
