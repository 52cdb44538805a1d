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
// FLOP/byte ridge for most layers, so in bf16/fp16 the bound is the bytes
// of z, identity and out/y; in fp32, off the tensor cores (67 TFLOP/s), it
// is the FMAs, and the fp32 loop is built to keep the FMA pipes fed. The
// Pallas kernels keep the whole (K, C) weight per program; at layer 4 that
// is 2 MB in bf16, far above 227 KB of shared memory, so these
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
// bf16/fp16 use the tensor cores through WMMA (16x16x16, fp32 accumulate;
// no cp.async pipeline, TMA or wgmma yet). fp32 stays full precision (no
// TF32): a register-tiled FMA loop, 8 x 8 outputs per thread from float4
// shared loads, fed by a two-stage cp.async pipeline (fma_tile).

#include "common.cuh"  // cuda_bf16.h / cuda_fp16.h before mma.h
#include "ptx.cuh"

#include <mma.h>

#include <type_traits>

namespace xk {
namespace {

using namespace nvcuda;

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int THREADS = 256;  // the WMMA loop's block; fp32 blocks have FMA_THREADS
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

// fp32: register-tiled FMA on FMA_THREADS = 128 threads as 16 (rows) x 8
// (channels). Thread (tx, ty) owns rows ty + 16 i (i < 8) and channels
// 4 tx + j and 32 + 4 tx + j (j < 4) of the 128 x 64 tile: an 8 x 8
// micro-tile. Per 4 k steps it reads 8 float4 of A (one per row, along k)
// and 8 float4 of B for 256 FMAs. Within a warp the A rows are 4
// consecutive rows (LDA32 = 20 puts them in distinct banks) shared by 8
// lanes, and the B reads are 128 contiguous bytes shared by 4 lanes: no bank
// conflicts. The A slab is kept untransposed so that both slabs arrive by
// 16-byte cp.async, two stages deep: slab s + 1 loads while slab s is used.
// Each output sums its k terms in order with fmaf: full fp32, no TF32.
// With 8 x 8 outputs a thread the SM's shared-memory pipe (128 bytes a
// clock) is about as busy as its 128 FMA lanes; a wider micro-tile loads
// less per FMA but runs out of registers (8 x 16 on 64 threads needs all
// 255 and is slower).
constexpr int FMA_THREADS = 128;
constexpr int FBK = 16;                 // k per slab
constexpr int LDA32 = FBK + 4;          // As[m][k]
constexpr int LDB32 = BN + 4;           // Bs[k][n]
constexpr int FSTAGE_FLOATS = BM * LDA32 + FBK * LDB32;
static_assert(2 * FSTAGE_FLOATS * sizeof(float) <= SMEM_BYTES, "slabs exceed the staging buffer");

// slab k0 of z (BM x FBK) and w (FBK x BN) into one stage, zero outside the
// matrices; 16-byte cp.async where rows allow (vec_a: K % 4 == 0 and z
// aligned; vec_b: C % 4 == 0 and w aligned), else plain loads and stores
__device__ __forceinline__ void fma_load_slab(float* As, float* Bs, const float* __restrict__ z,
                                              const float* __restrict__ w, int64_t M, int K, int C, int64_t m0,
                                              int n0, int k0, bool vec_a, bool vec_b) {
  for (int v = threadIdx.x; v < BM * (FBK / 4); v += FMA_THREADS) {
    const int r = v / (FBK / 4);
    const int c = (v % (FBK / 4)) * 4;
    const int64_t gr = m0 + r;
    const int gc = k0 + c;
    float* dst = As + r * LDA32 + c;
    if (vec_a) {
      const bool ok = gr < M && gc < K;
      cp_async16(dst, ok ? z + gr * K + gc : z, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (gr < M && gc + e < K) ? z[gr * K + gc + e] : 0.f;
    }
  }
  for (int v = threadIdx.x; v < FBK * (BN / 4); v += FMA_THREADS) {
    const int r = v / (BN / 4);
    const int c = (v % (BN / 4)) * 4;
    const int gr = k0 + r;
    const int gc = n0 + c;
    float* dst = Bs + r * LDB32 + c;
    if (vec_b) {
      const bool ok = gr < K && gc < C;
      cp_async16(dst, ok ? w + static_cast<int64_t>(gr) * C + gc : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = (gr < K && gc + e < C) ? w[static_cast<int64_t>(gr) * C + gc + e] : 0.f;
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma_tile(const float* __restrict__ z, const float* __restrict__ w, int64_t M,
                                         int K, int C, int64_t m0, int n0, bool vec_a, bool vec_b,
                                         unsigned char* smem) {
  float* stages = reinterpret_cast<float*>(smem);
  float* Cs = stages;  // reused after the K loop
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int slabs = (K + FBK - 1) / FBK;
  fma_load_slab(stages, stages + BM * LDA32, z, w, M, K, C, m0, n0, 0, vec_a, vec_b);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      float* nxt = stages + ((s + 1) & 1) * FSTAGE_FLOATS;
      fma_load_slab(nxt, nxt + BM * LDA32, z, w, M, K, C, m0, n0, (s + 1) * FBK, vec_a, vec_b);
    }
    cp_async_commit();
    cp_async_wait<1>();  // slab s has landed
    __syncthreads();
    const float* As = stages + (s & 1) * FSTAGE_FLOATS;
    const float* Bs = As + BM * LDA32;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA32 + kk);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kk + kq) * LDB32 + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kk + kq) * LDB32 + 32 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], kq);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before slab s + 2 overwrites it
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = Cs + (ty + 16 * i) * LDC;
    *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
}

// threads per block: 256 for the WMMA main loop, 128 for the fp32 one
template <typename T>
struct Threads {
  static constexpr int value = THREADS;
};
template <>
struct Threads<float> {
  static constexpr int value = FMA_THREADS;
};

template <typename T>
__device__ __forceinline__ void product_tile(const T* __restrict__ z, const T* __restrict__ w, int64_t M,
                                             int K, int C, int64_t m0, int n0, bool vec_a, bool vec_b,
                                             unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value) {
    fma_tile(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
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
  for (int v = threadIdx.x; v < BM * GPR; v += Threads<T>::value) {
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
__global__ void __launch_bounds__(Threads<T>::value)
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

template <typename T>
__global__ void __launch_bounds__(Threads<T>::value)
ms_kernel(const T* __restrict__ z, const T* __restrict__ w, T* __restrict__ y, float* __restrict__ partial,
          int64_t M, int K, int C, bool vec_a, bool vec_b, bool vec_c) {
  constexpr int PARTS = Threads<T>::value / BN;  // row groups summed per column
  constexpr int ROWS_PER_PART = BM / PARTS;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][PARTS][BN];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  product_tile<T>(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  const float* Cs = reinterpret_cast<const float*>(smem);

  constexpr int EV = 16 / sizeof(T);
  constexpr int GPR = BN / EV;
  for (int v = threadIdx.x; v < BM * GPR; v += Threads<T>::value) {
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
  maa_kernel<T><<<tile_grid(M, C), Threads<T>::value, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(w), g, b, static_cast<const T*>(identity),
      static_cast<T*>(out), M, K, C, relu, v.a, v.b, v.c);
}

template <typename T>
cudaError_t launch_ms(const void* z, const void* w, void* y, float* s1, float* s2, float* partial,
                      int64_t M, int K, int C, cudaStream_t stream) {
  const VecFlags v = vec_flags<T>(z, w, K, C, y, nullptr);
  const dim3 grid = tile_grid(M, C);
  ms_kernel<T><<<grid, Threads<T>::value, 0, stream>>>(static_cast<const T*>(z), static_cast<const T*>(w),
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
