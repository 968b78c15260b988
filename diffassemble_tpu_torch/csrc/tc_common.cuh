// Device helpers shared by the tensor-core attention kernels
// (masked_attention_fwd_tc.cu, masked_attention_bwd_tc.cu,
// masked_attention_fwd_tc_f32.cu, masked_attention_bwd_tc_f32.cu):
// asynchronous copies, the staging of a mask block, ldmatrix fragment loads
// and the mma.sync.m16n8k16 product with bf16 operands and f32 accumulators;
// for float32, the split of an operand into two TF32 halves, 32-bit fragment
// loads and the mma.sync.m16n8k8 product with TF32 operands (3xTF32); the
// shared-memory opt-in of a launch. Included by each source, which is built
// into its own library; ops/cuda_attention.py hashes this header with every
// source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;      // bf16 of padding per staged row (16 bytes)
constexpr int kMaskPad = 4;  // bytes of padding per staged mask row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global → shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The (query rows [q0, q0 + BM) × keys [k0, k0 + BN)) block of one graph's
// mask into shared memory (row stride BN + kMaskPad): by 4-byte cp.async when
// every mask row starts 4-byte aligned, else by byte loads; entries past n
// are 0.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void load_mask(int8_t* dst, const int8_t* __restrict__ mask_b, int q0,
                                          int k0, int n) {
  constexpr int kLd = BN + kMaskPad;
  if ((n & 3) == 0) {
    constexpr int kWords = BN / 4;
    for (int idx = threadIdx.x; idx < BM * kWords; idx += THREADS) {
      const int r = idx / kWords, c = 4 * (idx % kWords);
      const int row = q0 + r, key = k0 + c;
      const bool valid = row < n && key < n;  // a word is wholly in or out: n % 4 == 0
      cp_async4(dst + r * kLd + c, mask_b + (valid ? (size_t)row * n + key : 0), valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int row = q0 + r, key = k0 + c;
      dst[r * kLd + c] = (row < n && key < n) ? mask_b[(size_t)row * n + key] : (int8_t)0;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a·b: a 16×16 (row), b 16×8 (col), d 16×8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) → the bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) − hi).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of a 16×16 block from the accumulators of its
// two 16×8 halves: the m16n8 accumulator layout is the m16k16 A layout.
__device__ __forceinline__ void to_a(const float (&c0)[4], const float (&c1)[4],
                                     uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// The same A fragment rounded once to bf16 (no lo half).
__device__ __forceinline__ void to_a(const float (&c0)[4], const float (&c1)[4],
                                     uint32_t (&a)[4]) {
  a[0] = as_u32(__floats2bfloat162_rn(c0[0], c0[1]));
  a[1] = as_u32(__floats2bfloat162_rn(c0[2], c0[3]));
  a[2] = as_u32(__floats2bfloat162_rn(c1[0], c1[1]));
  a[3] = as_u32(__floats2bfloat162_rn(c1[2], c1[3]));
}

// Rows [row0, row0 + ROWS) of one head of a (B, N, H, DH) tensor into shared
// memory (row stride DH + kPad), by 16-byte cp.async from a block of THREADS
// threads; rows past n are zero.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          size_t node_stride, int row0, int n) {
  constexpr int kChunks = DH / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * (DH + kPad) + c * 8,
               src + base + (size_t)(valid ? row : 0) * node_stride + c * 8, valid);
  }
}

// A fragment of the warp's 16 rows × columns [col, col + 16) of a staged tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LD + col + (lane >> 4) * 8);
}

// B fragments of two 8-row n-tiles (rows [row0, row0 + 16)) × 16 columns
// [col, col + 16) of a tile stored [n][k]: {b0, b1} of the first, {b2, b3}
// of the second.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int row0, int col) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LD + col + ((lane >> 3) & 1) * 8);
}

// B fragments of a tile stored [k][n]: k rows [row0, row0 + 16) × two 8-column
// n-tiles at [col, col + 16), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int row0,
                                             int col) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col + (lane >> 4) * 8);
}

// ---------------------------------------------------------------- float32

constexpr int kPadF32 = 4;  // floats of padding per staged f32 row (16 bytes)

// Rows [row0, row0 + ROWS) of one head of a (B, N, H, DH) f32 tensor into
// shared memory (row stride LD), by 16-byte cp.async from a block of THREADS
// threads; rows past n are zero.
template <int DH, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src, size_t base,
                                              size_t node_stride, int row0, int n) {
  constexpr int kChunks = DH / 4;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * LD + c * 4, src + base + (size_t)(valid ? row : 0) * node_stride + c * 4, valid);
  }
}

// x → hi = tf32(x), lo = tf32(x − hi): each rounded to nearest (ties away
// from zero) at 10 mantissa bits, the low 13 bits cleared; hi + lo carries
// ~21 of x's 24 bits, and 0 splits into (0, 0).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a·b: a 16×8 (row), b 8×8 (col), TF32 operands, d 16×8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: lo·hi + hi·lo + hi·hi into one f32 accumulator (the
// small terms first; lo·lo, ~2^-22 of the product, is left out).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// The m16n8k8 fragments, with g = lane / 4 and t = lane % 4: A holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k = t, n = g),
// (k = t + 4, n = g); the accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). Each is loaded from shared memory by 32-bit loads (ldmatrix
// moves 16-bit elements) and split on the way. With row strides LD ≡ 4
// (mod 8) floats every load below falls in 32 distinct banks.

// A fragment (hi, lo) of the warp's 16 rows [row0, row0 + 16) × 8 columns
// [col, col + 8) of a staged f32 tile.
template <int LD>
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile,
                                            int row0, int col) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (row0 + (lane >> 2)) * LD + col + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LD], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LD + 4], hi[3], lo[3]);
}

// B fragment (hi, lo) of a tile stored [n][k]: the 8-row n-tile [row0,
// row0 + 8) × 8 columns of k [col, col + 8).
template <int LD>
__device__ __forceinline__ void load_b_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* tile,
                                            int row0, int col) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (row0 + (lane >> 2)) * LD + col + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// An accumulator fragment (16 rows × 8 columns) as the A fragment of the
// next product, its columns taken as k in the order 0, 2, 4, 6, 1, 3, 5, 7:
// each thread's (g, 2t) and (g, 2t + 1) become its (g, t) and (g, t + 4), so
// no value leaves its thread. The B fragment of that product reads its k
// rows in the same order (load_b_tf32_kn).
__device__ __forceinline__ void acc_to_a_tf32(const float (&c)[4], uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// B fragment (hi, lo) of a tile stored [k][n] for an A from acc_to_a_tf32:
// k rows [row0, row0 + 8) in that order × the 8 columns [col, col + 8).
template <int LD>
__device__ __forceinline__ void load_b_tf32_kn(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                               const float* tile, int row0, int col) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (row0 + 2 * (lane & 3)) * LD + col + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[LD], hi[1], lo[1]);
}

// Dynamic shared memory above 48 KB has to be opted into once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// That opt-in, and the carveout that lets two blocks of over 100 KB share an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A launch's shape out of the grid's range, or a type other than `want`
// (1: bfloat16, 0: float32).
bool bad_shape(int batch, int n, int heads, int dtype, int want = 1) {
  return batch <= 0 || n <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || dtype != want;
}

}  // namespace
