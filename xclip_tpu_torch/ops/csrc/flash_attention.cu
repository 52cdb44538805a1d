// Flash attention forward on (B, H, L, D) tensors, online softmax:
//
//     o = softmax(q k^T * sm_scale [+ causal mask]) v
//
// IO in T (float, bf16 or fp16); scores, running max/sum and the output
// accumulator stay in fp32 registers and never reach device memory.
//
// Replaces: xclip_tpu/ops/flash_attention.py:_flash_kernel (reached through
// flash_attention / flash_mha). The same function: q k^T is scaled by
// sm_scale in fp32, keys past L and (with `causal`) keys above the diagonal
// are masked, key tiles above a query slab's last row are skipped, and
// o = acc / max(l, 1e-30). The running max starts at -1e30 (the Pallas
// kernel's NEG_INF) and masked scores are -inf, so a row whose keys in a
// tile are all masked keeps alpha = 1 and adds p = 0: no 0 * inf.
//
// What bounds it on the H100: on the text tower's shape (L = 77, D = 64,
// 8 heads, 2048 prompts per chunk) attention does ~2 L D FLOPs per byte of
// q/k/v/o, about 77 FLOP/byte in bf16, below the ~295 FLOP/byte ridge: the
// floor is the bytes of q, k, v and o. So the design moves each byte once
// and keeps enough of them in flight:
//
// - Products on the tensor cores, in FlashAttention-2's layout: each warp
//   owns a 16-row query slab whose A fragments stay in registers for the
//   whole key loop. bf16/fp16 use mma.sync m16n8k16 with fp32 accumulators:
//   K is read with ldmatrix and V with ldmatrix.trans from shared memory
//   held in the IO type; S stays in registers, its row max and sum are
//   reduced across the lane quad with shuffles, and P is repacked in
//   registers into the A fragments of P V.
// - fp32 stays fp32 (no plain TF32): mma.sync m16n8k8 on tf32 with each
//   operand split into a high and a low tf32 part and three products per
//   tile ("3xTF32", ptx.cuh), which leaves out only lo*lo, about 2^-22 of
//   each product. P V takes P straight from the S accumulators: the m16n8
//   accumulator holds keys 2t and 2t+1 where the tf32 A fragment wants
//   columns t and t+4, so the keys of each 8-key step are taken in that
//   permuted order, and V's rows are read in the same order.
// - Query tiling fitted to L. A block has one warp per 16-row slab, up to
//   8 warps, and the slabs of one (batch, head) are spread evenly over as
//   few blocks as that allows. At L = 77 one block of 5 warps covers 80
//   rows; at 197 and 257 (ViT) two blocks of 7 and three of 6 warps.
// - K and V stream through two 64-key stages of shared memory, each row
//   copied by 16-byte cp.async (zero-filled past L), the next stage loading
//   while the current one is used. The ring is cut to L where L <= 128, so
//   at L = 77 q, k and v of a (batch, head) are in flight at once in 34.6 KB
//   (bf16). Rows are padded to break ldmatrix bank conflicts.
// - Causal: a slab stops at the 16-key chunk that holds its last row, so
//   only chunks on the diagonal are masked. Any L works, from 1 upwards:
//   longer sequences loop over key tiles with the online softmax.
// - The output goes through the slab's rows of shared memory so that the
//   global stores are 16-byte vectors. Pointers off a 16-byte boundary
//   (views) take scalar loads and stores instead of cp.async.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace xk {
namespace {

constexpr int D = 64;          // head dim, the only one instantiated
constexpr int SLAB = 16;       // query rows per warp: the mma's M
constexpr int BKV = 64;        // keys per shared-memory stage
constexpr int CHUNKS = BKV / 16;  // 16-key chunks per stage
constexpr int MAX_WARPS = 8;
constexpr float NEG_BIG = -1e30f;

// shared-memory row length in elements: 16 bytes of padding per row
template <typename T>
__host__ __device__ constexpr int row_len() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// q rows, then the K and V rings of `ring` rows each
template <typename T>
constexpr size_t smem_bytes(int warps, int ring) {
  return static_cast<size_t>(warps * SLAB + 2 * ring) * row_len<T>() * sizeof(T);
}

// rows [row0, row0 + nrows) of one (L, D) matrix into smem rows 0.., rows
// at or past L zeroed (so that P = 0 never multiplies stale values)
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0, int nrows, int L,
                                          bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = row_len<T>();
  for (int i = threadIdx.x; i < nrows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int row = row0 + r;
    const bool valid = row < L;
    T* d = dst + r * LD + c;
    const T* s = src + static_cast<int64_t>(valid ? row : 0) * D + c;
    if (vec_ok) {
      cp_async16(d, s, valid);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = valid ? s[e] : from_f32<T>(0.f);
    }
  }
}

// A fragments of a warp's 16 x 64 query slab, held for the whole key loop
template <typename T>
struct QFrag {
  uint32_t a[D / 16][4];  // per 16-dim k-step, via ldmatrix
  __device__ __forceinline__ void load(const T* Qw, int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldmatrix_x4(a[ks], Qw + (lane & 15) * row_len<T>() + ks * 16 + (lane >> 4) * 8);
  }
};
// fp32: the slab stays in shared memory and is read and split per chunk;
// 32 more registers a thread would halve the blocks an SM holds
template <>
struct QFrag<float> {
  const float* q;
  __device__ __forceinline__ void load(const float* Qw, int lane) { q = Qw; }
};

// s[jj] = q k^T for the 16 keys of chunk Kc (two n8 tiles)
template <typename T>
__device__ __forceinline__ void scores(float (&s)[2][4], const QFrag<T>& qf, const T* Kc, int lane) {
  constexpr int LD = row_len<T>();
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[jj][i] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane / 4, t = lane % 4;
    const float* qr = qf.q + g * LD + t;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const Split a[4] = {split_tf32(qr[ks * 8]), split_tf32(qr[8 * LD + ks * 8]), split_tf32(qr[ks * 8 + 4]),
                          split_tf32(qr[8 * LD + ks * 8 + 4])};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* kr = Kc + (8 * jj + g) * LD + ks * 8 + t;
        const Split b[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
        mma_1688_3xtf32(s[jj], a, b);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, Kc + ((lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 + ((lane >> 3) & 1) * 8);
      mma_16816<T>(s[0], qf.a[ks], kb[0], kb[1]);
      mma_16816<T>(s[1], qf.a[ks], kb[2], kb[3]);
    }
  }
}

// acc += p v for the 16 keys of chunk Vc; p in the layout of `scores`
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[2][4], const T* Vc, int lane) {
  constexpr int LD = row_len<T>();
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // A columns t and t+4 are keys 2t and 2t+1 of this 8-key step
      const Split a[4] = {split_tf32(p[jj][0]), split_tf32(p[jj][2]), split_tf32(p[jj][1]),
                          split_tf32(p[jj][3])};
      const float* vr = Vc + (8 * jj + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const Split b[2] = {split_tf32(vr[nd * 8]), split_tf32(vr[LD + nd * 8])};
        mma_1688_3xtf32(acc[nd], a, b);
      }
    }
  } else {
    const uint32_t a[4] = {pack2<T>(p[0][0], p[0][1]), pack2<T>(p[0][2], p[0][3]), pack2<T>(p[1][0], p[1][1]),
                           pack2<T>(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, Vc + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
      mma_16816<T>(acc[2 * dp], a, vb[0], vb[1]);
      mma_16816<T>(acc[2 * dp + 1], a, vb[2], vb[3]);
    }
  }
}

// at most 128 registers a thread: at L = 77 (5 warps) three blocks fit an SM
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                 int L, int ring, float scale_log2, bool causal, bool vec_ok) {
  constexpr int LD = row_len<T>();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  // chunks per online-softmax step: the whole stage, or half of it in fp32,
  // whose split operands leave no room under 128 registers for 64 scores
  constexpr int STEP = std::is_same<T, float>::value ? CHUNKS / 2 : CHUNKS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bq = (blockDim.x / 32) * SLAB;
  // tile `it` of keys sits at row (it & 1) * BKV of a ring of min(2 BKV,
  // L rounded up to 16) rows: at L <= 128 the ring holds exactly the sequence
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [bq][LD]
  T* Ks = Qs + bq * LD;                    // [ring][LD]
  T* Vs = Ks + ring * LD;                  // [ring][LD]

  const int64_t base = static_cast<int64_t>(blockIdx.x) * L * D;  // (batch, head)
  const int q0 = blockIdx.y * bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * SLAB;  // this warp's first query row
  T* Qw = Qs + warp * SLAB * LD;

  // keys the block needs, and keys this warp needs (causal: up to its last row)
  const int kv_end = causal ? min(L, q0 + bq) : L;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  const int warp_keys = r0 >= L ? 0 : (causal ? min(L, r0 + SLAB) : L);
  auto load_tile = [&](int it) {
    const int kt = it * BKV;
    const int rows = min(BKV, (kv_end - kt + 15) / 16 * 16);  // whole 16-key chunks
    const int st = (it & 1) * BKV * LD;
    load_rows<T>(Ks + st, k + base, kt, rows, L, vec_ok);
    load_rows<T>(Vs + st, v + base, kt, rows, L, vec_ok);
  };

  load_rows<T>(Qs, q + base, q0, bq, L, vec_ok);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();

  QFrag<T> qf;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG};  // running max of the row pair (g, g + 8), log2 units
  float l[2] = {0.f, 0.f};          // this lane's part of the running sums

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and tile `it` have landed
    __syncthreads();
    const int kt = it * BKV;
    const int nc = warp_keys > kt ? min(CHUNKS, (warp_keys - kt + 15) / 16) : 0;  // warp-uniform
    if (nc > 0 && it == 0) qf.load(Qw, lane);
    const T* Kt = Ks + (it & 1) * BKV * LD;
    const T* Vt = Vs + (it & 1) * BKV * LD;
    // one online-softmax step per STEP chunks (warp-uniform). Not unrolled:
    // in 16-bit it is one trip, and two unrolled fp32 steps spill
#pragma unroll 1
    for (int c0 = 0; c0 < CHUNKS; c0 += STEP) {
      if (c0 >= nc) break;
      const int ns = min(STEP, nc - c0);
      const int k0 = kt + c0 * 16;  // first key of the step
      float s[STEP][2][4];
#pragma unroll
      for (int c = 0; c < STEP; ++c)
        if (c < ns) scores<T>(s[c], qf, Kt + (c0 + c) * 16 * LD, lane);

      // scale into log2 units, mask, row max over the step
      const bool need_mask = k0 + ns * 16 > L || (causal && k0 + ns * 16 - 1 > r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < STEP; ++c) {
        if (c >= ns) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[c][jj][i] * scale_log2;
            if (need_mask) {
              const int key = k0 + c * 16 + jj * 8 + 2 * t + (i & 1);
              const int row = r0 + g + (i >> 1) * 8;
              if (key >= L || (causal && key > row)) x = -INFINITY;
            }
            s[c][jj][i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        const float alpha = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][2 * h] *= alpha;
          acc[j][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int c = 0; c < STEP; ++c) {
        if (c >= ns) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(s[c][jj][i] - m[i >> 1]);
            s[c][jj][i] = p;
            l[i >> 1] += p;
          }
        accumulate<T>(acc, s[c], Vt + (c0 + c) * 16 * LD, lane);
      }
    }
    __syncthreads();  // the stage is consumed before the next load overwrites it
  }
  if (warp_keys == 0) return;

  // o = acc / max(l, 1e-30), staged through this warp's query rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* dst = Qw + (g + 8 * h) * LD + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[8 * j] = from_f32<T>(acc[j][2 * h] * inv);
      dst[8 * j + 1] = from_f32<T>(acc[j][2 * h + 1] * inv);
    }
  }
  __syncwarp();
  for (int i = lane; i < SLAB * VPR; i += 32) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int row = r0 + r;
    if (row >= L) break;  // rows are in order: the rest are past L too
    T* dst = o + base + static_cast<int64_t>(row) * D + c;
    const T* src = Qw + r * LD + c;
    if (vec_ok) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = src[e];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int L, int head_dim, float sm_scale,
           bool causal, cudaStream_t stream) {
  // head dim 64: the text tower of every RN config and of most ViT configs
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  // one warp per 16-row slab; a (batch, head)'s slabs spread evenly over blocks of at most MAX_WARPS
  const int slabs = (L + SLAB - 1) / SLAB;
  const int blocks = (slabs + MAX_WARPS - 1) / MAX_WARPS;
  const int warps = (slabs + blocks - 1) / blocks;
  const int ring = min(2 * BKV, (L + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<T>(MAX_WARPS, 2 * BKV)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(blocks));
  flash_fwd_kernel<T><<<grid, warps * 32, smem_bytes<T>(warps, ring), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), L, ring,
      scale_log2, causal, vec_ok);
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
