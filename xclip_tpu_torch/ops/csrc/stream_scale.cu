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
// 8192 x 8192). Reaching that takes many bytes in flight on every SM, so:
//
// - Each thread issues VECS_PER_THREAD loads of 16 bytes (8 bf16) before
//   its first store: 64 bytes of a thread in flight at once, 128 KB per SM
//   at its 2048 threads. Loads take the read-only path without an L1 line
//   (ld.global.nc.L1::no_allocate), stores are evict-first (st.global.cs):
//   nothing is reused.
// - The grid is sized to the work, one block per THREADS x VECS_PER_THREAD
//   vectors (32 KB), no stride loop; a warp's load j covers 512 contiguous
//   bytes. Vectors past n / 8 are masked; block 0 scales the last n % 8
//   elements.
// - x or o off a 16-byte boundary takes a scalar grid-stride loop instead:
//   correct, slow, and on no path of the port (its tensors are allocated on
//   16-byte boundaries; views with offsets that are not multiples of 8
//   elements reach it).
//
// A ring of 1D bulk copies (TMA) through shared memory was measured against
// this design on the H100 and lost by about 6 %: PERF.md §6 has its design
// and times.
//
// xk_stream_scale_geometry() reports the vector kernel's block shape and
// how many of its blocks an SM holds, so that tests can place lengths on
// its block and wave boundaries.

#include <climits>

#include "common.cuh"
#include "ptx.cuh"

namespace xk {
namespace {

constexpr int THREADS = 512;
constexpr int VECS_PER_THREAD = 4;

constexpr int SCALAR_THREADS = 256;
constexpr int SCALAR_BLOCKS_PER_SM = 8;  // 8 x 256 threads: the SM's 2048-thread limit

__device__ __forceinline__ __nv_bfloat16 scale1(__nv_bfloat16 v, float s) {
  return __float2bfloat16_rn(__bfloat162float(v) * s);
}

__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
    stream_scale_vec(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ o, int64_t n, float s) {
  const int64_t nv = n / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * VECS_PER_THREAD + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(o);
  uint4 v[VECS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < VECS_PER_THREAD; ++j)
    if (base + j * THREADS < nv) v[j] = load_stream(xv + base + j * THREADS);
#pragma unroll
  for (int j = 0; j < VECS_PER_THREAD; ++j)
    if (base + j * THREADS < nv) store_stream(ov + base + j * THREADS, scale8(v[j], s));
  if (blockIdx.x == 0)
    for (int64_t i = nv * 8 + threadIdx.x; i < n; i += THREADS) o[i] = scale1(x[i], s);
}

__global__ void __launch_bounds__(SCALAR_THREADS)
    stream_scale_scalar(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ o, int64_t n, float s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * SCALAR_THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * SCALAR_THREADS + threadIdx.x; i < n; i += stride)
    o[i] = scale1(x[i], s);
}

}  // namespace
}  // namespace xk

// C interface, bound with ctypes by xclip_tpu_torch/ops/stream_scale.py.

// Threads per block, 16-byte loads per thread and resident blocks per SM of
// the vector kernel on the current device; returns the occupancy query's
// CUDA error (0 = answered).
extern "C" int xk_stream_scale_geometry(int* threads, int* vecs_per_thread, int* blocks_per_sm) {
  using namespace xk;
  *threads = THREADS;
  *vecs_per_thread = VECS_PER_THREAD;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stream_scale_vec, THREADS, 0));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xk_stream_scale(const void* x, void* out, long long n, float scale, void* stream) {
  using namespace xk;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto ob = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (aligned16(x) && aligned16(out)) {
    const long long per_block = static_cast<long long>(THREADS) * VECS_PER_THREAD;
    const long long blocks = (n / 8 + per_block - 1) / per_block;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    stream_scale_vec<<<static_cast<int>(blocks < 1 ? 1 : blocks), THREADS, 0, st>>>(xb, ob, n, scale);
  } else {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long needed = (n + SCALAR_THREADS - 1) / SCALAR_THREADS;
    const long long cap = static_cast<long long>(sms) * SCALAR_BLOCKS_PER_SM;
    stream_scale_scalar<<<static_cast<int>(needed < cap ? needed : cap), SCALAR_THREADS, 0, st>>>(xb, ob, n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
