// Flash attention forward on (B, H, L, D) tensors, online softmax:
//
//     o = softmax(q k^T * sm_scale [+ causal mask]) v
//
// IO in T (float, bf16 or fp16); scores, running max/sum and the output
// accumulator stay in fp32 registers and never reach device memory.
//
// Replaces: xclip_tpu/ops/flash_attention.py:_flash_kernel (reached through
// flash_attention / flash_mha). Same algorithm: q is scaled on load, keys
// past L and (with `causal`) keys above the diagonal are masked, key tiles
// entirely above the diagonal are skipped, o = acc / max(l, 1e-30).
//
// What bounds it on the H100: on the text tower's shape (L = 77, D = 64,
// 8 heads, 2048 prompts per chunk) attention does ~2 L D FLOPs per byte of
// q/k/v/o, i.e. ~77 FLOP/byte in bf16: below the ~295 FLOP/byte ridge, so
// the floor is the bytes of q, k, v and o. The Pallas kernel uses one
// 77-row block (min(128, L)); here one block of 64 threads owns 64 query
// rows of one (batch, head), one row per thread with q and the accumulator
// in registers. K/V tiles of BKV keys are converted to fp32 into shared
// memory once and read by all threads as broadcasts; the online-softmax
// rescale is done once per 16-key chunk. Query and key tails are masked.
// This is the simple correct version: SIMT fp32 FMAs, no tensor cores yet,
// so it sits well above its bytes bound; mma.sync/wgmma is later work.

#include <math.h>

#include "common.cuh"

namespace xk {
namespace {

constexpr int BQ = 64;  // query rows (= threads) per block
constexpr int CH = 16;  // keys per online-softmax rescale

template <typename T, int N>
__device__ __forceinline__ void load_row_f32(float* dst, const T* __restrict__ src, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec_ok) {
#pragma unroll
    for (int c = 0; c < N; c += VEC) {
      alignas(16) T tmp[VEC];
      *reinterpret_cast<uint4*>(tmp) = *reinterpret_cast<const uint4*>(src + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[c + e] = to_f32(tmp[e]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) dst[c] = to_f32(src[c]);
  }
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int L, float sm_scale, bool causal, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(D % VEC == 0, "head dim must hold whole 16-byte vectors");
  static_assert(BKV % CH == 0, "key tile must hold whole chunks");
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;  // (batch, head)
  const int q0 = blockIdx.y * BQ;
  const int row = q0 + threadIdx.x;

  float qr[D];
  float acc[D];
  if (row < L) {
    load_row_f32<T, D>(qr, q + base + static_cast<int64_t>(row) * D, vec_ok);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] *= sm_scale;
    acc[d] = 0.f;
  }
  float m = -1e30f;  // running max (the Pallas kernel's NEG_INF)
  float l = 0.f;     // running sum of exp

  // key tiles entirely above this block's last row are skipped
  const int kv_end = causal ? min(L, q0 + BQ) : L;
  for (int kt = 0; kt < kv_end; kt += BKV) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = threadIdx.x; idx < BKV * (D / VEC); idx += BQ) {
      const int r = idx / (D / VEC);
      const int c = (idx % (D / VEC)) * VEC;
      const int key = kt + r;
      if (key < L) {
        const int64_t off = base + static_cast<int64_t>(key) * D + c;
        load_row_f32<T, VEC>(&Ks[r][c], k + off, vec_ok);
        load_row_f32<T, VEC>(&Vs[r][c], v + off, vec_ok);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          Ks[r][c + e] = 0.f;
          Vs[r][c + e] = 0.f;
        }
      }
    }
    __syncthreads();

    const int n_keys = min(BKV, kv_end - kt);
    for (int c0 = 0; c0 < n_keys; c0 += CH) {
      float s[CH];
      float cmax = m;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int key = kt + c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[c0 + j][d]);
          dot = fmaf(qr[d], kv4.x, dot);
          dot = fmaf(qr[d + 1], kv4.y, dot);
          dot = fmaf(qr[d + 2], kv4.z, dot);
          dot = fmaf(qr[d + 3], kv4.w, dot);
        }
        const bool valid = c0 + j < n_keys && (!causal || key <= row);
        s[j] = valid ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // no valid key in the chunk: cmax == m, alpha == 1, every p == 0
      const float alpha = expf(m - cmax);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - cmax);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv4 = *reinterpret_cast<const float4*>(&Vs[c0 + j][d]);
          acc[d] = fmaf(p, vv4.x, acc[d]);
          acc[d + 1] = fmaf(p, vv4.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv4.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv4.w, acc[d + 3]);
        }
      }
      m = cmax;
    }
  }

  if (row < L) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* dst = o + base + static_cast<int64_t>(row) * D;
    if (vec_ok) {
#pragma unroll
      for (int c = 0; c < D; c += VEC) {
        alignas(16) T tmp[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) tmp[e] = from_f32<T>(acc[c + e] * inv);
        *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(tmp);
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) dst[d] = from_f32<T>(acc[d] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int L, int D, float sm_scale,
           bool causal, cudaStream_t stream) {
  const bool vec_ok = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((L + BQ - 1) / BQ));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  // head dim 64: the text tower of every RN config and of most ViT configs
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<T, 64, 64><<<grid, BQ, 0, stream>>>(qt, kt, vt, ot, L, sm_scale, causal, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace xk

// C interface, bound with ctypes by xclip_tpu_torch/ops/flash_attention.py.
// q, k, v, o: contiguous (BH, L, D). Returns cudaGetLastError() (0 = launched).
extern "C" int xk_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                                  int BH, int L, int D, float sm_scale, int causal, void* stream) {
  using namespace xk;
  if (BH <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, o, BH, L, D, sm_scale, causal != 0, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, o, BH, L, D, sm_scale, causal != 0, s);
    case kFloat16:
      return launch<__half>(q, k, v, o, BH, L, D, sm_scale, causal != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
