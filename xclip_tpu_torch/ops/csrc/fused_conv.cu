// 1x1-conv matmuls of the ModifiedResNet bottleneck, forward. Two kernels
// share one tiled main loop and differ in their epilogue:
//
//   K1/K2  out = [relu]((z @ w) * g + b [+ identity])
//   K3     y = z @ w,  s1 = sum_rows(z @ w),  s2 = sum_rows((z @ w)^2)
//
// z: (M, K), w: (K, C), identity/out/y: (M, C), all in the IO type T (float,
// bf16 or fp16); g, b, s1, s2: (C,) fp32. The product accumulates in fp32.
// K1/K2 run their epilogue in fp32 in the order y*g + b (+ id), then relu,
// with one cast at the store. K3 writes y once in T and sums the fp32
// accumulators, not the rounded y, as the Pallas kernel does.
//
// Replaces: xclip_tpu/ops/fused_conv.py:_affine_act_kernel (K1) and
// _affine_act_id_kernel (K2), reached through _matmul_affine_act_fwd_impl
// (one kernel serves both; `identity` may be null), and _matmul_stats_kernel
// (K3), reached through _matmul_stats_fwd_impl.
//
// What bounds them on the H100: at the RN50 shapes (K <= 2048, C <= 2048,
// M up to 784,000) the arithmetic intensity is below the card's ~295
// FLOP/byte ridge for most layers, so the bound is the bytes of z, identity
// and out/y. The Pallas kernels keep the whole (K, C) weight per program; at
// layer 4 that is 2 MB in bf16, far above 227 KB of shared memory, so these
// kernels tile the output in 2-D (128 x 64 tiles) and loop over K in slabs
// staged in shared memory. The fp32 tile never goes to device memory: it is
// staged in shared memory (reusing the slab buffer) and the epilogue writes
// the output once. Global loads and stores are 16-byte vectors where the row
// length and pointers allow it. The ragged M and C edges are masked, so M
// need not be a multiple of 8 (the Pallas tiling refuses M = 250*7*7).
//
// K3's column sums: the Pallas grid runs in order and carries s1/s2 across
// grid steps; blocks here run in parallel, so each block writes the sums of
// its 128 rows to a (tiles, C) partial buffer and a second small kernel adds
// the partials of each column in a fixed order. No float atomics: the BN
// statistics are the same from run to run.
//
// bf16/fp16 use the tensor cores through WMMA (16x16x16, fp32 accumulate);
// fp32 uses register-tiled FMA (8x4 outputs per thread) so fp32 stays full
// precision (no TF32). Simple and correct first: no cp.async pipeline, TMA
// or wgmma yet.

#include "common.cuh"  // cuda_bf16.h / cuda_fp16.h before mma.h

#include <mma.h>

#include <type_traits>

namespace xk {
namespace {

using namespace nvcuda;

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int THREADS = 256;
constexpr int LDC = BN + 4;  // fp32 staging of the tile
// every main loop's slab buffers fit in the fp32 staging buffer they share
constexpr int SMEM_BYTES = BM * LDC * sizeof(float);

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

// ---------------------------------------------------------------------------
// Main loops: the fp32 tile (z @ w)[m0:m0+BM, n0:n0+BN] into Cs (BM x LDC,
// in smem), rows and channels outside the matrix zero. Both end synchronised.

// bf16 / fp16: WMMA tensor cores. 8 warps as 4 (rows) x 2 (cols), each warp
// owns a 32 x 32 sub-tile = 2 x 2 fragments of 16 x 16.
template <typename T>
__device__ __forceinline__ void wmma_tile(const T* __restrict__ z, const T* __restrict__ w, int64_t M,
                                          int K, int C, int64_t m0, int n0, bool vec_a, bool vec_b,
                                          unsigned char* smem) {
  constexpr int BK = 32;
  constexpr int LDA = BK + 8;  // 16-byte row padding against bank conflicts
  constexpr int LDB = BN + 8;
  constexpr int A_BYTES = BM * LDA * sizeof(T);
  static_assert(A_BYTES + BK * LDB * sizeof(T) <= SMEM_BYTES, "slabs exceed the staging buffer");
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

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
}

// fp32: register-tiled FMA. 16 x 16 threads; thread (tx, ty) owns rows
// ty + 16 i (i < 8) and channels tx + 16 j (j < 4) of the 128 x 64 tile.
__device__ __forceinline__ void fma_tile(const float* __restrict__ z, const float* __restrict__ w,
                                         int64_t M, int K, int C, int64_t m0, int n0, bool vec_b,
                                         unsigned char* smem) {
  constexpr int BK = 16;
  constexpr int LDAT = BM + 4;  // A slab stored transposed: As[k][m]
  constexpr int LDB = BN + 4;
  constexpr int A_BYTES = BK * LDAT * sizeof(float);
  static_assert(A_BYTES + BK * LDB * sizeof(float) <= SMEM_BYTES, "slabs exceed the staging buffer");
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

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
}

template <typename T>
__device__ __forceinline__ void product_tile(const T* __restrict__ z, const T* __restrict__ w, int64_t M,
                                             int K, int C, int64_t m0, int n0, bool vec_a, bool vec_b,
                                             unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value) {
    fma_tile(z, w, M, K, C, m0, n0, vec_b, smem);
  } else {
    wmma_tile<T>(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  }
}

// ---------------------------------------------------------------------------
// K1/K2 epilogue: out tile = [relu](Cs * g + b [+ identity])

template <typename T>
__device__ __forceinline__ void affine_epilogue(const float* Cs, const float* __restrict__ g,
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
maa_kernel(const T* __restrict__ z, const T* __restrict__ w, const float* __restrict__ g,
           const float* __restrict__ b, const T* __restrict__ identity, T* __restrict__ out, int64_t M,
           int K, int C, bool relu, bool vec_a, bool vec_b, bool vec_c) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  product_tile<T>(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  affine_epilogue<T>(reinterpret_cast<const float*>(smem), g, b, identity, out, m0, n0, M, C, relu, vec_c);
}

// ---------------------------------------------------------------------------
// K3: y tile stored once in T; per-column sums of the fp32 tile over its
// valid rows into partial[0][tile][c] and partial[1][tile][c].

constexpr int PARTS = THREADS / BN;  // row groups summed per column
constexpr int ROWS_PER_PART = BM / PARTS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ms_kernel(const T* __restrict__ z, const T* __restrict__ w, T* __restrict__ y, float* __restrict__ partial,
          int64_t M, int K, int C, bool vec_a, bool vec_b, bool vec_c) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][PARTS][BN];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  product_tile<T>(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  const float* Cs = reinterpret_cast<const float*>(smem);

  constexpr int EV = 16 / sizeof(T);
  constexpr int GPR = BN / EV;
  for (int v = threadIdx.x; v < BM * GPR; v += THREADS) {
    const int r = v / GPR;
    const int c = (v % GPR) * EV;
    const int64_t gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= C) continue;
    const int64_t base = gr * C + gc;
    alignas(16) T o[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) o[e] = from_f32<T>(gc + e < C ? Cs[r * LDC + c + e] : 0.f);
    if (vec_c && gc + EV <= C) {
      *reinterpret_cast<uint4*>(y + base) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e)
        if (gc + e < C) y[base + e] = o[e];
    }
  }

  // each column summed by PARTS threads over ROWS_PER_PART rows each, then
  // the parts added in order: a fixed summation order
  const int col = threadIdx.x % BN;
  const int part = threadIdx.x / BN;
  const int64_t rows_left = M - m0;
  const int rows = rows_left < BM ? static_cast<int>(rows_left) : BM;
  const int r_end = min(rows, (part + 1) * ROWS_PER_PART);
  float s1 = 0.f, s2 = 0.f;
  for (int r = part * ROWS_PER_PART; r < r_end; ++r) {
    const float v = Cs[r * LDC + col];
    s1 += v;
    s2 += v * v;
  }
  red[0][part][col] = s1;
  red[1][part][col] = s2;
  __syncthreads();
  const int gc = n0 + threadIdx.x;
  if (threadIdx.x < BN && gc < C) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      a += red[0][p][threadIdx.x];
      q += red[1][p][threadIdx.x];
    }
    const int64_t tiles = gridDim.x;
    partial[static_cast<int64_t>(blockIdx.x) * C + gc] = a;
    partial[(tiles + blockIdx.x) * C + gc] = q;
  }
}

// s1[c] = sum over tiles of partial[0][t][c], s2 likewise from partial[1].
// Block (32, 32): 32 columns; each thread row sums the tiles y, y+32, ...
// in order, then row 0 adds the 32 thread rows in order.
constexpr int SUM_COLS = 32;
constexpr int SUM_ROWS = 32;

__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
column_sum_kernel(const float* __restrict__ partial, int64_t tiles, int C, float* __restrict__ s1,
                  float* __restrict__ s2) {
  __shared__ float red[2][SUM_ROWS][SUM_COLS + 1];
  const int c = blockIdx.x * SUM_COLS + threadIdx.x;
  float a = 0.f, q = 0.f;
  if (c < C) {
    for (int64_t t = threadIdx.y; t < tiles; t += SUM_ROWS) {
      a += partial[t * C + c];
      q += partial[(tiles + t) * C + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = a;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float sa = 0.f, sq = 0.f;
    for (int i = 0; i < SUM_ROWS; ++i) {
      sa += red[0][i][threadIdx.x];
      sq += red[1][i][threadIdx.x];
    }
    s1[c] = sa;
    s2[c] = sq;
  }
}

// vector-path flags: 16-byte loads of z rows and w rows, 16-byte stores
struct VecFlags {
  bool a, b, c;
};

template <typename T>
VecFlags vec_flags(const void* z, const void* w, int K, int C, const void* out, const void* identity) {
  constexpr int VEC = 16 / sizeof(T);
  return {K % VEC == 0 && aligned16(z), C % VEC == 0 && aligned16(w),
          C % VEC == 0 && aligned16(out) && (identity == nullptr || aligned16(identity))};
}

dim3 tile_grid(int64_t M, int C) {
  return dim3(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN));
}

template <typename T>
void launch_maa(const void* z, const void* w, const float* g, const float* b, const void* identity,
                void* out, int64_t M, int K, int C, bool relu, cudaStream_t stream) {
  const VecFlags v = vec_flags<T>(z, w, K, C, out, identity);
  maa_kernel<T><<<tile_grid(M, C), THREADS, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(w), g, b, static_cast<const T*>(identity),
      static_cast<T*>(out), M, K, C, relu, v.a, v.b, v.c);
}

template <typename T>
cudaError_t launch_ms(const void* z, const void* w, void* y, float* s1, float* s2, float* partial,
                      int64_t M, int K, int C, cudaStream_t stream) {
  const VecFlags v = vec_flags<T>(z, w, K, C, y, nullptr);
  const dim3 grid = tile_grid(M, C);
  ms_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(z), static_cast<const T*>(w),
                                             static_cast<T*>(y), partial, M, K, C, v.a, v.b, v.c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<(C + SUM_COLS - 1) / SUM_COLS, dim3(SUM_COLS, SUM_ROWS), 0, stream>>>(
      partial, grid.x, C, s1, s2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace xk

// C interface, bound with ctypes by xclip_tpu_torch/ops/fused_conv.py.
// Each returns cudaGetLastError() after its launches (0 = launched).

extern "C" int xk_matmul_affine_act(int dtype, const void* z, const void* w, const void* g,
                                    const void* b, const void* identity, void* out, long long M,
                                    int K, int C, int relu, void* stream) {
  using namespace xk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (M <= 0 || K <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kFloat32:
      launch_maa<float>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s);
      break;
    case kBFloat16:
      launch_maa<__nv_bfloat16>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s);
      break;
    case kFloat16:
      launch_maa<__half>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial: fp32 scratch of 2 * ceil(M / 128) * C floats, allocated by the caller.
extern "C" int xk_matmul_stats(int dtype, const void* z, const void* w, void* y, void* s1, void* s2,
                               void* partial, long long M, int K, int C, void* stream) {
  using namespace xk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* s1f = static_cast<float*>(s1);
  float* s2f = static_cast<float*>(s2);
  float* pf = static_cast<float*>(partial);
  if (M <= 0 || K <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(launch_ms<float>(z, w, y, s1f, s2f, pf, M, K, C, s));
    case kBFloat16:
      return static_cast<int>(launch_ms<__nv_bfloat16>(z, w, y, s1f, s2f, pf, M, K, C, s));
    case kFloat16:
      return static_cast<int>(launch_ms<__half>(z, w, y, s1f, s2f, pf, M, K, C, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
