// 1x1-conv matmuls of the ModifiedResNet bottleneck, forward. Two kernels
// per route share the route's tiled main loop and differ in their epilogue:
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
// of z, identity and out/y (the operations at K >= 1024 of the late
// layers); in fp32, off the tensor cores (67 TFLOP/s), it is the FMAs. The
// Pallas kernels keep the whole (K, C) weight per program; at layer 4 that
// is 2 MB in bf16, far above 227 KB of shared memory, so these kernels tile
// the output in 2-D (128 rows per block) and loop over K in slabs staged
// in shared memory. The ragged M, K and C edges are zero-filled or masked,
// so M need not be a multiple of 8 (the Pallas tiling refuses M = 250*7*7).
//
// bf16/fp16 (wgmma_tile): Hopper's warpgroup products. A block is two
// warpgroups over a 128 x TN output tile (TN = 64 or 128, narrow_tile),
// each warpgroup 64 rows, wgmma m64nTNk16 with fp32 accumulators in
// registers and both operands read from shared memory. Slabs of 64 k (one
// 128-byte row of 16-bit values, the 128-byte-swizzle layout wgmma reads)
// stream through a ring of 3 stages filled by 16-byte cp.async: two slabs
// are in flight while one is multiplied, and at TN = 128 the ring (96 KB)
// leaves room for two blocks per SM, whose barriers and epilogues
// interleave (a 4-stage ring, 128 KB, holds one block per SM and was
// slower: PERF.md section 6). The copies write the
// swizzled layout themselves: rows that are not whole 16-byte vectors
// (K or C not a multiple of 8, or a pointer off a 16-byte boundary) fill the
// same chunks with scalar loads, so every input goes through the one main
// loop and gives the same bits. Blocks are ordered with the column tiles of
// one row band adjacent, so z is read from device memory about once. The
// epilogues work from the accumulator registers and stage the tile in T in
// shared memory (the ring, no longer needed), so that identity loads and
// output stores are 16-byte vectors.
//
// fp32 stays full precision (no TF32): a register-tiled FMA loop, 8 x 8
// outputs per thread from float4 shared loads, fed by a two-stage cp.async
// pipeline (fma_tile); the fp32 tile is staged in shared memory and the
// epilogue writes the output once.
//
// K3's column sums: the Pallas grid runs in order and carries s1/s2 across
// grid steps; blocks here run in parallel, so each block writes the sums of
// its 128 rows to a (tiles, C) partial buffer and a second small kernel adds
// the partials of each column in a fixed order. No float atomics: the BN
// statistics are the same from run to run. Both routes use 128-row tiles;
// the wrapper sizes the partial buffer from xk_matmul_stats_tile_m().

#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace xk {
namespace {

constexpr int BM = 128;  // output rows per block (both routes): one partial-sum row of K3 each

// ---------------------------------------------------------------------------
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
constexpr int BN = 64;   // output channels per fp32 block
constexpr int LDC = BN + 4;  // fp32 staging of the tile
// both slab stages fit in the fp32 staging buffer they share
constexpr int SMEM_BYTES = BM * LDC * sizeof(float);
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

// the fp32 tile (z @ w)[m0:m0+BM, n0:n0+BN] into Cs (BM x LDC, in smem),
// rows and channels outside the matrix zero; ends synchronised
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

// fp32 K1/K2 epilogue: out tile = [relu](Cs * g + b [+ identity])
__device__ __forceinline__ void affine_epilogue(const float* Cs, const float* __restrict__ g,
                                                const float* __restrict__ b, const float* __restrict__ identity,
                                                float* __restrict__ out, int64_t m0, int n0, int64_t M, int C,
                                                bool relu, bool vec_c) {
  constexpr int EV = 4;
  constexpr int GPR = BN / EV;
  for (int v = threadIdx.x; v < BM * GPR; v += FMA_THREADS) {
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
      alignas(16) float idv[EV];
      if (full) {
        *reinterpret_cast<uint4*>(idv) = *reinterpret_cast<const uint4*>(identity + base);
      } else {
#pragma unroll
        for (int e = 0; e < EV; ++e) idv[e] = (gc + e < C) ? identity[base + e] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) y[e] += idv[e];
    }
    alignas(16) float o[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) o[e] = relu ? fmaxf(y[e], 0.f) : y[e];
    if (full) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e)
        if (gc + e < C) out[base + e] = o[e];
    }
  }
}

__global__ void __launch_bounds__(FMA_THREADS)
maa_f32_kernel(const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ g,
               const float* __restrict__ b, const float* __restrict__ identity, float* __restrict__ out, int64_t M,
               int K, int C, bool relu, bool vec_a, bool vec_b, bool vec_c) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  fma_tile(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  affine_epilogue(reinterpret_cast<const float*>(smem), g, b, identity, out, m0, n0, M, C, relu, vec_c);
}

// fp32 K3: y tile stored once; per-column sums of the fp32 tile over its
// valid rows into partial[0][tile][c] and partial[1][tile][c].
__global__ void __launch_bounds__(FMA_THREADS)
ms_f32_kernel(const float* __restrict__ z, const float* __restrict__ w, float* __restrict__ y,
              float* __restrict__ partial, int64_t M, int K, int C, bool vec_a, bool vec_b, bool vec_c) {
  constexpr int PARTS = FMA_THREADS / BN;  // row groups summed per column
  constexpr int ROWS_PER_PART = BM / PARTS;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][PARTS][BN];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  fma_tile(z, w, M, K, C, m0, n0, vec_a, vec_b, smem);
  const float* Cs = reinterpret_cast<const float*>(smem);

  constexpr int EV = 4;
  constexpr int GPR = BN / EV;
  for (int v = threadIdx.x; v < BM * GPR; v += FMA_THREADS) {
    const int r = v / GPR;
    const int c = (v % GPR) * EV;
    const int64_t gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= C) continue;
    const int64_t base = gr * C + gc;
    alignas(16) float o[EV];
#pragma unroll
    for (int e = 0; e < EV; ++e) o[e] = gc + e < C ? Cs[r * LDC + c + e] : 0.f;
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

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma on two consumer warpgroups, fed by a cp.async ring.
// Shared memory, from a 1024-byte-aligned base: STAGES stages of
// [A: BM rows x 128 bytes][B: TN / 64 atoms of 64 k-rows x 128 bytes], all
// in the 128-byte swizzle (ptx.cuh). After the main loop the same bytes
// hold the output tile in T (rows of TN + 8 values: the 16-byte pad keeps
// the accumulator-layout accesses free of bank conflicts) and K3's
// per-warp column sums.

constexpr int WG_THREADS = 128;
constexpr int THREADS16 = 2 * WG_THREADS;  // warpgroup g owns rows 64 g .. 64 g + 63
constexpr int WARPS16 = THREADS16 / 32;    // each warp owns 16 rows
constexpr int BK16 = 64;                   // k per slab: one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int ATOM_BYTES = 8 * ROW_BYTES;  // 8 swizzled rows
constexpr int STAGES = 3;                  // STAGES - 1 slabs in flight
constexpr int A_STAGE_BYTES = BM * ROW_BYTES;
constexpr int B_ATOM_BYTES = BK16 * ROW_BYTES;  // 64 k-rows of one 64-column atom

template <int TN>
__host__ __device__ constexpr int stage_bytes() {
  return A_STAGE_BYTES + (TN / 64) * B_ATOM_BYTES;
}
template <int TN>
__host__ __device__ constexpr int out_ld() {
  return TN + 8;
}
template <int TN>
__host__ __device__ constexpr int epilogue_bytes() {
  return BM * out_ld<TN>() * 2 + 2 * WARPS16 * TN * static_cast<int>(sizeof(float));
}

template <int TN>
size_t smem16_bytes(int K) {
  const int slabs = (K + BK16 - 1) / BK16;
  const int ring = (slabs < STAGES ? slabs : STAGES) * stage_bytes<TN>();  // slab s uses stage s % STAGES
  return static_cast<size_t>(ring > epilogue_bytes<TN>() ? ring : epilogue_bytes<TN>()) + 1024;  // + alignment
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// 8 values of row `row` of a row-major (rows, cols) matrix from column
// `col`, zero outside it, as one 16-byte shared-memory chunk
template <typename T>
__device__ __forceinline__ void chunk_scalar(unsigned char* dst, const T* __restrict__ g, int64_t row, int col,
                                             int64_t rows, int cols) {
  alignas(16) T v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (row < rows && col + e < cols) ? g[row * cols + col + e] : from_f32<T>(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// slab k0 of z (BM x 64) and w (64 x TN) into one ring stage, swizzled,
// zero outside the matrices. vec_a (K % 8 == 0, z 16-byte aligned) and
// vec_b (C % 8 == 0, w aligned): one 16-byte cp.async per chunk, zero-filled
// when the chunk lies outside; otherwise scalar loads of the same chunk.
template <typename T, int TN>
__device__ __forceinline__ void load_slab16(unsigned char* stage, const T* __restrict__ z,
                                            const T* __restrict__ w, int64_t M, int K, int C, int64_t m0, int n0,
                                            int k0, bool vec_a, bool vec_b) {
#pragma unroll
  for (int it = 0; it < BM * 8 / THREADS16; ++it) {
    const int v = threadIdx.x + it * THREADS16;
    const int r = v >> 3, c = v & 7;
    const int64_t gr = m0 + r;
    const int gk = k0 + 8 * c;
    unsigned char* dst = stage + r * ROW_BYTES + ((c ^ (r & 7)) << 4);
    if (vec_a) {
      const bool ok = gr < M && gk < K;
      cp_async16(dst, ok ? z + gr * K + gk : z, ok);
    } else {
      chunk_scalar<T>(dst, z, gr, gk, M, K);
    }
  }
  constexpr int CPR = TN / 8;  // chunks per B row
  unsigned char* Bs = stage + A_STAGE_BYTES;
#pragma unroll
  for (int it = 0; it < BK16 * CPR / THREADS16; ++it) {
    const int v = threadIdx.x + it * THREADS16;
    const int kr = v / CPR, cc = v % CPR;
    const int gk = k0 + kr;
    const int gc = n0 + 8 * cc;
    unsigned char* dst = Bs + (cc >> 3) * B_ATOM_BYTES + kr * ROW_BYTES + (((cc & 7) ^ (kr & 7)) << 4);
    if (vec_b) {
      const bool ok = gk < K && gc < C;
      cp_async16(dst, ok ? w + static_cast<int64_t>(gk) * C + gc : w, ok);
    } else {
      chunk_scalar<T>(dst, w, gk, gc, K, C);
    }
  }
}

// acc = (z @ w)[m0 + 64 g .. + 64, n0 .. n0 + TN] for this thread's
// warpgroup g, in the wgmma accumulator layout; slab s + STAGES - 1 is
// copied while slab s is multiplied. Every slab gets one barrier: after it
// slab s has landed for all threads, and the products of slab s - 1, which
// each warpgroup waited for, have retired, so its stage can be refilled.
// Ends with every copy landed and the block synchronised: the ring is free.
template <typename T, int TN>
__device__ __forceinline__ void wgmma_tile(const T* __restrict__ z, const T* __restrict__ w, int64_t M, int K,
                                           int C, int64_t m0, int n0, bool vec_a, bool vec_b, unsigned char* ring,
                                           float (&acc)[TN / 2]) {
  const int wg = threadIdx.x / WG_THREADS;
  const int slabs = (K + BK16 - 1) / BK16;
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < slabs) load_slab16<T, TN>(ring + p * stage_bytes<TN>(), z, w, M, K, C, m0, n0, p * BK16, vec_a, vec_b);
    cp_async_commit();  // one group per slab, empty past the last
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab s have landed
    fence_proxy_async();
    __syncthreads();
    unsigned char* stage = ring + (s % STAGES) * stage_bytes<TN>();
    const uint64_t da = smem_desc_sw128(stage + wg * 64 * ROW_BYTES, 16, ATOM_BYTES);
    const uint64_t db = smem_desc_sw128(stage + A_STAGE_BYTES, B_ATOM_BYTES, ATOM_BYTES);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk)  // 16 k: 32 bytes along A's rows, 16 rows down B
      wgmma_ss<T, TN>(acc, da + ((kk * 32) >> 4), db + ((kk * 16 * ROW_BYTES) >> 4));
    wgmma_commit();
    const int next = s + STAGES - 1;  // into the stage of slab s - 1
    if (next < slabs)
      load_slab16<T, TN>(ring + (next % STAGES) * stage_bytes<TN>(), z, w, M, K, C, m0, n0, next * BK16, vec_a,
                         vec_b);
    cp_async_commit();
    wgmma_wait<0>();
    fence_operands(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the (BM, TN) tile of a row-major (M, C) matrix at (m0, n0) into Os (rows
// of out_ld values), zero outside; 16-byte loads where `vec` and the chunk
// is whole
template <typename T, int TN>
__device__ __forceinline__ void tile_in(T* Os, const T* __restrict__ src, int64_t m0, int n0, int64_t M, int C,
                                        bool vec) {
  constexpr int CPR = TN / 8;
  for (int v = threadIdx.x; v < BM * CPR; v += THREADS16) {
    const int r = v / CPR, c = 8 * (v % CPR);
    const int64_t gr = m0 + r;
    const int gc = n0 + c;
    unsigned char* dst = reinterpret_cast<unsigned char*>(Os + r * out_ld<TN>() + c);
    if (vec && gr < M && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + gr * C + gc);
    } else {
      chunk_scalar<T>(dst, src, gr, gc, M, C);
    }
  }
}

// Os into the (M, C) matrix at (m0, n0), masked to it
template <typename T, int TN>
__device__ __forceinline__ void tile_out(T* __restrict__ dst, const T* Os, int64_t m0, int n0, int64_t M, int C,
                                         bool vec) {
  constexpr int CPR = TN / 8;
  for (int v = threadIdx.x; v < BM * CPR; v += THREADS16) {
    const int r = v / CPR, c = 8 * (v % CPR);
    const int64_t gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= C) continue;
    const T* src = Os + r * out_ld<TN>() + c;
    if (vec && gc + 8 <= C) {
      *reinterpret_cast<uint4*>(dst + gr * C + gc) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < C; ++e) dst[gr * C + gc + e] = src[e];
    }
  }
}

// this thread's first accumulator row in the tile and first column pair
__device__ __forceinline__ int acc_row() { return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x % 4); }

// Blocks walk the tiles with the column tiles of a row band adjacent.
template <typename T, int TN>
__global__ void __launch_bounds__(THREADS16, 2)
maa16_kernel(const T* __restrict__ z, const T* __restrict__ w, const float* __restrict__ g,
             const float* __restrict__ b, const T* __restrict__ identity, T* __restrict__ out, int64_t M, int K,
             int C, int col_tiles, bool relu, bool vec_a, bool vec_b, bool vec_c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * TN;
  float acc[TN / 2];
  wgmma_tile<T, TN>(z, w, M, K, C, m0, n0, vec_a, vec_b, ring, acc);

  T* Os = reinterpret_cast<T*>(ring);
  if (identity != nullptr) {
    tile_in<T, TN>(Os, identity, m0, n0, M, C, vec_c);
    __syncthreads();
  }
  const int row = acc_row();
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + acc_col();
    const int gc = n0 + c;
    const float g0 = gc < C ? g[gc] : 0.f, g1 = gc + 1 < C ? g[gc + 1] : 0.f;
    const float b0 = gc < C ? b[gc] : 0.f, b1 = gc + 1 < C ? b[gc + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* o = reinterpret_cast<uint32_t*>(Os + (row + 8 * h) * out_ld<TN>() + c);
      float y0 = acc[4 * j + 2 * h] * g0 + b0;
      float y1 = acc[4 * j + 2 * h + 1] * g1 + b1;
      if (identity != nullptr) {  // the identity value this thread overwrites
        const float2 id = unpack2<T>(*o);
        y0 += id.x;
        y1 += id.y;
      }
      if (relu) {
        y0 = fmaxf(y0, 0.f);
        y1 = fmaxf(y1, 0.f);
      }
      *o = pack2<T>(y0, y1);
    }
  }
  __syncthreads();
  tile_out<T, TN>(out, Os, m0, n0, M, C, vec_c);
}

// K3: y stored once in T; each column of the fp32 accumulators summed over
// the tile's rows in a fixed order: a thread's two rows, the 8 lanes of a
// column by butterfly shuffles, then the 8 warps in order. Rows past M were
// zero-filled, so their accumulators are 0 and add nothing.
template <typename T, int TN>
__global__ void __launch_bounds__(THREADS16, 2)
ms16_kernel(const T* __restrict__ z, const T* __restrict__ w, T* __restrict__ y, float* __restrict__ partial,
            int64_t M, int K, int C, int col_tiles, bool vec_a, bool vec_b, bool vec_c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int64_t mt = blockIdx.x / col_tiles;
  const int64_t m0 = mt * BM;
  const int n0 = (blockIdx.x % col_tiles) * TN;
  float acc[TN / 2];
  wgmma_tile<T, TN>(z, w, M, K, C, m0, n0, vec_a, vec_b, ring, acc);

  T* Os = reinterpret_cast<T*>(ring);
  float* red = reinterpret_cast<float*>(ring + BM * out_ld<TN>() * sizeof(T));  // [2][WARPS16][TN]
  const int warp = threadIdx.x / 32;
  const int row = acc_row();
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + acc_col();
    const float a0 = acc[4 * j], a1 = acc[4 * j + 1];      // row `row`
    const float b0 = acc[4 * j + 2], b1 = acc[4 * j + 3];  // row `row` + 8
    float s0 = a0 + b0, s1 = a1 + b1;
    float q0 = a0 * a0 + b0 * b0, q1 = a1 * a1 + b1 * b1;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (threadIdx.x % 32 < 4) {
      red[warp * TN + c] = s0;
      red[warp * TN + c + 1] = s1;
      red[(WARPS16 + warp) * TN + c] = q0;
      red[(WARPS16 + warp) * TN + c + 1] = q1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(Os + (row + 8 * h) * out_ld<TN>() + c) =
          pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  const int gc = n0 + threadIdx.x;
  if (threadIdx.x < TN && gc < C) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int p = 0; p < WARPS16; ++p) {
      a += red[p * TN + threadIdx.x];
      q += red[(WARPS16 + p) * TN + threadIdx.x];
    }
    const int64_t tiles = (M + BM - 1) / BM;
    partial[mt * C + gc] = a;
    partial[(tiles + mt) * C + gc] = q;
  }
  tile_out<T, TN>(y, Os, m0, n0, M, C, vec_c);
}

// ---------------------------------------------------------------------------
// K3's second pass: s1[c] = sum over tiles of partial[0][t][c], s2 likewise
// from partial[1]. Block (32, 32): 32 columns; each thread row sums the
// tiles y, y+32, ... in order, then row 0 adds the 32 thread rows in order.
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

// 64-channel tiles where the layer is narrow (C <= 128) or shallow (K <=
// 256, bytes-bound): three blocks fit on an SM (80 registers, a 72 KB
// ring) and hide more of the memory latency than two. 128-channel tiles
// on the deep layers, where each z slab in shared memory feeds twice the
// products. The split was measured on the RN50 shapes (PERF.md section 6).
bool narrow_tile(int K, int C) { return C <= 128 || K <= 256; }

dim3 f32_grid(int64_t M, int C) {
  return dim3(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN));
}

// the 16-bit kernels' launch: grid, dynamic shared memory and its opt-in
template <int TN, typename Kernel>
cudaError_t launch16(Kernel kernel, int64_t M, int K, int C, int* col_tiles, dim3* grid, size_t* smem) {
  *col_tiles = (C + TN - 1) / TN;
  const int64_t blocks = (M + BM - 1) / BM * *col_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks));
  *smem = smem16_bytes<TN>(K);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
}

template <typename T, int TN>
cudaError_t launch_maa16(const void* z, const void* w, const float* g, const float* b, const void* identity,
                         void* out, int64_t M, int K, int C, bool relu, cudaStream_t stream) {
  const VecFlags v = vec_flags<T>(z, w, K, C, out, identity);
  int col_tiles;
  dim3 grid;
  size_t smem;
  cudaError_t err = launch16<TN>(maa16_kernel<T, TN>, M, K, C, &col_tiles, &grid, &smem);
  if (err != cudaSuccess) return err;
  maa16_kernel<T, TN><<<grid, THREADS16, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(w), g, b, static_cast<const T*>(identity),
      static_cast<T*>(out), M, K, C, col_tiles, relu, v.a, v.b, v.c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_maa(const void* z, const void* w, const float* g, const float* b, const void* identity,
                       void* out, int64_t M, int K, int C, bool relu, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const VecFlags v = vec_flags<float>(z, w, K, C, out, identity);
    maa_f32_kernel<<<f32_grid(M, C), FMA_THREADS, 0, stream>>>(
        static_cast<const float*>(z), static_cast<const float*>(w), g, b, static_cast<const float*>(identity),
        static_cast<float*>(out), M, K, C, relu, v.a, v.b, v.c);
    return cudaGetLastError();
  } else if (narrow_tile(K, C)) {
    return launch_maa16<T, 64>(z, w, g, b, identity, out, M, K, C, relu, stream);
  } else {
    return launch_maa16<T, 128>(z, w, g, b, identity, out, M, K, C, relu, stream);
  }
}

template <typename T, int TN>
cudaError_t launch_ms16(const void* z, const void* w, void* y, float* partial, int64_t M, int K, int C,
                        cudaStream_t stream) {
  const VecFlags v = vec_flags<T>(z, w, K, C, y, nullptr);
  int col_tiles;
  dim3 grid;
  size_t smem;
  cudaError_t err = launch16<TN>(ms16_kernel<T, TN>, M, K, C, &col_tiles, &grid, &smem);
  if (err != cudaSuccess) return err;
  ms16_kernel<T, TN><<<grid, THREADS16, smem, stream>>>(static_cast<const T*>(z), static_cast<const T*>(w),
                                                          static_cast<T*>(y), partial, M, K, C, col_tiles, v.a,
                                                          v.b, v.c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ms(const void* z, const void* w, void* y, float* s1, float* s2, float* partial, int64_t M,
                      int K, int C, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const VecFlags v = vec_flags<float>(z, w, K, C, y, nullptr);
    ms_f32_kernel<<<f32_grid(M, C), FMA_THREADS, 0, stream>>>(static_cast<const float*>(z),
                                                              static_cast<const float*>(w), static_cast<float*>(y),
                                                              partial, M, K, C, v.a, v.b, v.c);
    err = cudaGetLastError();
  } else if (narrow_tile(K, C)) {
    err = launch_ms16<T, 64>(z, w, y, partial, M, K, C, stream);
  } else {
    err = launch_ms16<T, 128>(z, w, y, partial, M, K, C, stream);
  }
  if (err != cudaSuccess) return err;
  column_sum_kernel<<<(C + SUM_COLS - 1) / SUM_COLS, dim3(SUM_COLS, SUM_ROWS), 0, stream>>>(
      partial, (M + BM - 1) / BM, C, s1, s2);
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
      return static_cast<int>(launch_maa<float>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s));
    case kBFloat16:
      return static_cast<int>(launch_maa<__nv_bfloat16>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s));
    case kFloat16:
      return static_cast<int>(launch_maa<__half>(z, w, gf, bf, identity, out, M, K, C, relu != 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// rows per partial-sum row of xk_matmul_stats (the output tile's height)
extern "C" int xk_matmul_stats_tile_m() { return xk::BM; }

// partial: fp32 scratch of 2 * ceil(M / xk_matmul_stats_tile_m()) * C
// floats, allocated by the caller.
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
