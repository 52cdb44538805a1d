// Fused 1x1 conv + folded BatchNorm (+ residual) (+ ReLU), forward:
//
//     out = [relu]((z @ w) * g + b [+ identity])
//
// z: (M, K), w: (K, C), identity/out: (M, C), all in the IO type T (float,
// bf16 or fp16); g, b: (C,) fp32. The product accumulates in fp32 and the
// epilogue runs in fp32 in the order y*g + b (+ id), then relu, with one
// cast at the store.
//
// Replaces: xclip_tpu/ops/fused_conv.py:_affine_act_kernel (K1) and
// _affine_act_id_kernel (K2), reached through _matmul_affine_act_fwd_impl.
// One kernel serves both; `identity` may be null.
//
// What bounds it on the H100: at the RN50 eval shapes (K <= 2048, C <= 2048,
// M up to 784,000) the arithmetic intensity is below the card's ~295
// FLOP/byte ridge for most layers, so the bound is the bytes of z, identity
// and out. The Pallas kernel keeps the whole (K, C) weight per program; at
// layer 4 that is 2 MB in bf16, far above 227 KB of shared memory, so this
// kernel tiles the output in 2-D (128 x 64 tiles) and loops over K in
// 32-deep slabs staged in shared memory. The pre-activation tile never goes
// to device memory: it is staged in shared memory (reusing the slab buffer)
// and the affine/residual/relu epilogue writes `out` once. Global loads and
// stores are 16-byte vectors where the row length and pointers allow it.
// The ragged M and C edges are masked, so M need not be a multiple of 8
// (the Pallas tiling refuses M = 250*7*7 = 12,250).
//
// bf16/fp16 use the tensor cores through WMMA (16x16x16, fp32 accumulate);
// fp32 uses register-tiled FMA (8x4 outputs per thread) so fp32 stays full
// precision (no TF32). Simple and correct first: no cp.async pipeline, TMA
// or wgmma yet.

#include "common.cuh"  // cuda_bf16.h / cuda_fp16.h before mma.h

#include <mma.h>

namespace xk {
namespace {

using namespace nvcuda;

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int THREADS = 256;
constexpr int LDC = BN + 4;  // fp32 staging of the pre-activation tile

// ROWS x COLS tile of a row-major (nrows, ncols) matrix into shared memory
// with leading dimension LD, zero-filled outside the matrix.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* smem, const T* __restrict__ g, int64_t row0, int col0,
                                          int64_t nrows, int ncols, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = COLS / VEC;
  static_assert(COLS % VEC == 0, "tile width must hold whole vectors");
  for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * VEC;
    const int64_t gr = row0 + r;
    const int gc = col0 + c;
    T* dst = smem + r * LD + c;
    if (vec_ok && gr < nrows && gc + VEC <= ncols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(g + gr * ncols + gc);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dst[e] = (gr < nrows && gc + e < ncols) ? g[gr * ncols + gc + e] : from_f32<T>(0.f);
    }
  }
}

// out tile = [relu](Cs * g + b [+ identity]) for rows m0.., channels n0..
template <typename T>
__device__ __forceinline__ void epilogue(const float* Cs, const float* __restrict__ g,
                                         const float* __restrict__ b, const T* __restrict__ identity,
                                         T* __restrict__ out, int64_t m0, int n0, int64_t M, int C,
                                         bool relu, bool vec_c) {
  constexpr int EV = 16 / sizeof(T);
  constexpr int GPR = BN / EV;
  for (int v = threadIdx.x; v < BM * GPR; v += THREADS) {
    const int r = v / GPR;
    const int c = (v % GPR) * EV;
    const int64_t gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= C) continue;
    const bool full = vec_c && gc + EV <= C;
    const int64_t base = gr * C + gc;
    float y[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e)
      y[e] = (gc + e < C) ? Cs[r * LDC + c + e] * g[gc + e] + b[gc + e] : 0.f;
    if (identity != nullptr) {
      alignas(16) T idv[EV];
      if (full) {
        *reinterpret_cast<uint4*>(idv) = *reinterpret_cast<const uint4*>(identity + base);
      } else {
#pragma unroll
        for (int e = 0; e < EV; ++e) idv[e] = (gc + e < C) ? identity[base + e] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) y[e] += to_f32(idv[e]);
    }
    alignas(16) T o[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) o[e] = from_f32<T>(relu ? fmaxf(y[e], 0.f) : y[e]);
    if (full) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e)
        if (gc + e < C) out[base + e] = o[e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: WMMA tensor cores. 8 warps as 4 (rows) x 2 (cols), each warp
// owns a 32 x 32 sub-tile = 2 x 2 fragments of 16 x 16.

template <typename T>
__global__ void __launch_bounds__(THREADS)
maa_wmma_kernel(const T* __restrict__ z, const T* __restrict__ w, const float* __restrict__ g,
                const float* __restrict__ b, const T* __restrict__ identity, T* __restrict__ out,
                int64_t M, int K, int C, bool relu, bool vec_a, bool vec_b, bool vec_c) {
  constexpr int BK = 32;
  constexpr int LDA = BK + 8;  // 16-byte row padding against bank conflicts
  constexpr int LDB = BN + 8;
  constexpr int A_BYTES = BM * LDA * sizeof(T);
  constexpr int B_BYTES = BK * LDB * sizeof(T);
  constexpr int C_BYTES = BM * LDC * sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK, LDA>(As, z, m0, k0, M, K, vec_a);
    load_tile<T, BK, BN, LDB>(Bs, w, k0, n0, K, C, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  epilogue<T>(Cs, g, b, identity, out, m0, n0, M, C, relu, vec_c);
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA. 16 x 16 threads; thread (tx, ty) owns rows
// ty + 16 i (i < 8) and channels tx + 16 j (j < 4) of the 128 x 64 tile.

__global__ void __launch_bounds__(THREADS)
maa_fp32_kernel(const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ identity, float* __restrict__ out,
                int64_t M, int K, int C, bool relu, bool vec_b, bool vec_c) {
  constexpr int BK = 16;
  constexpr int LDAT = BM + 4;  // A slab stored transposed: As[k][m]
  constexpr int LDB = BN + 4;
  constexpr int A_BYTES = BK * LDAT * sizeof(float);
  constexpr int B_BYTES = BK * LDB * sizeof(float);
  constexpr int C_BYTES = BM * LDC * sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK; v += THREADS) {
      const int r = v / BK;
      const int c = v % BK;
      const int64_t gr = m0 + r;
      const int gc = k0 + c;
      As[c * LDAT + r] = (gr < M && gc < K) ? z[gr * K + gc] : 0.f;
    }
    load_tile<float, BK, BN, LDB>(Bs, w, k0, n0, K, C, vec_b);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k * LDAT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
  epilogue<float>(Cs, g, b, identity, out, m0, n0, M, C, relu, vec_c);
}

template <typename T>
void launch_wmma(const void* z, const void* w, const float* g, const float* b, const void* identity,
                 void* out, int64_t M, int K, int C, bool relu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_a = K % VEC == 0 && aligned16(z);
  const bool vec_b = C % VEC == 0 && aligned16(w);
  const bool vec_c = C % VEC == 0 && aligned16(out) && (identity == nullptr || aligned16(identity));
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN));
  maa_wmma_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(w), g, b, static_cast<const T*>(identity),
      static_cast<T*>(out), M, K, C, relu, vec_a, vec_b, vec_c);
}

}  // namespace
}  // namespace xk

// C interface, bound with ctypes by xclip_tpu_torch/ops/fused_conv.py.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xk_matmul_affine_act(int dtype, const void* z, const void* w, const void* g,
                                    const void* b, const void* identity, void* out, long long M,
                                    int K, int C, int relu, void* stream) {
  using namespace xk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (M <= 0 || K <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kFloat32: {
      const bool vec_b = C % 4 == 0 && aligned16(w);
      const bool vec_c = C % 4 == 0 && aligned16(out) && (identity == nullptr || aligned16(identity));
      dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN));
      maa_fp32_kernel<<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(z), static_cast<const float*>(w), gf, bf,
          static_cast<const float*>(identity), static_cast<float*>(out), M, K, C, relu != 0, vec_b,
          vec_c);
      break;
    }
    case kBFloat16:
      launch_wmma<__nv_bfloat16>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s);
      break;
    case kFloat16:
      launch_wmma<__half>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
