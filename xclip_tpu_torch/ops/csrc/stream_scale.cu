// Streaming copy-and-scale of a bf16 tensor, the port's bandwidth probe
// kernel:
//
//   o = bf16(float(x) * s)      s = float(bf16(scale)), 1.0 for the probe's 1.0001
//
// x and o: n bf16 elements, any n, any 2-byte-aligned pointers. The product
// is taken in fp32 and rounded to nearest even to bf16, which is how
// torch.mul computes a bf16 product and what XLA's bf16 multiply gives.
//
// Replaces: tools/probe_mosaic.py:main's `kernel` (o_ref[...] = x_ref[...] *
// bf16(1.0001)) launched through `pallas_scale = pl.pallas_call(...)`, a grid
// of 64 blocks of (128, 8192) rows over an (8192, 8192) bf16 array.
//
// What bounds it on the H100: one read of x and one write of o, 4 bytes per
// element and one multiply, so bytes over 3.35 TB/s (80.1 us at the probe's
// 8192 x 8192). The Pallas grid walks row blocks in order through VMEM; here
// a grid-stride loop spreads 16-byte vectors (8 bf16 per thread per
// iteration) over enough blocks to fill every SM, neighbouring threads on
// neighbouring addresses, so each warp moves 512 contiguous bytes per load.
// A pointer off a 16-byte boundary takes the scalar loop, and so do the last
// n % 8 elements of the vector path. Nothing is cached or staged: each byte
// is touched once.

#include "common.cuh"

namespace xk {
namespace {

constexpr int SCALE_THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 8 x 256 threads: the SM's 2048-thread limit

__device__ __forceinline__ __nv_bfloat162 scale2(__nv_bfloat162 v, float s) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(f.x * s, f.y * s);
}

__global__ void __launch_bounds__(SCALE_THREADS)
    stream_scale_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ o,
                        int64_t n, float s, bool vec_ok) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * SCALE_THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * SCALE_THREADS + threadIdx.x;
  int64_t done = 0;
  if (vec_ok) {
    const int64_t n_vec = n / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (int64_t i = tid; i < n_vec; i += stride) {
      uint4 v = xv[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = scale2(h[j], s);
      ov[i] = v;
    }
    done = n_vec * 8;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    o[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * s);
}

}  // namespace
}  // namespace xk

// C interface, bound with ctypes by xclip_tpu_torch/ops/stream_scale.py.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xk_stream_scale(const void* x, void* out, long long n, float scale, void* stream) {
  using namespace xk;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_ok = aligned16(x) && aligned16(out);
  const long long work = vec_ok ? (n + 7) / 8 : n;  // vectors (or elements) to spread
  const long long needed = (work + SCALE_THREADS - 1) / SCALE_THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  stream_scale_kernel<<<blocks, SCALE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, scale, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
