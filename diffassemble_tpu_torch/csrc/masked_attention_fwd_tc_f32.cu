// Fused masked multi-head graph attention, forward, on Hopper's tensor cores
// in float32 (sm_90a, 3xTF32).
//
// The tensor-core route of the forward for float32 inputs. Replaces the TPU
// kernel `_attn_kernel` of the JAX package's ops/pallas_attention.py
// (launched by `_flash_fwd`) and computes the same function as its
// counterparts in masked_attention_fwd.cu (CUDA cores) and
// masked_attention_fwd_tc.cu (bf16):
//
//   S   = q·kᵀ/√Dh in f32, masked entries left out of the max (−1e9 floor)
//   m   = max(−1e9, max over edges of S),  l = Σ over edges of exp(S − m)
//   O   = Σ over edges of exp(S − m)·v / max(l, 1e−30)          (f32)
//   L   = m + log(max(l, 1e−30))                                 (f32)
//
// Inputs and O are f32, (B, N, H, Dh) contiguous and read as they are (every
// row starts 16-byte aligned: the caller checks the base pointers); the mask
// is (B, N, N) int8 (or bool bytes), shared across heads; L is (B, H, N) f32.
// Instantiated at Dh 32 and 144, the main paths' widths, for graphs of more
// than 32 nodes: smaller graphs take the small-graph forward
// (masked_attention_fwd_small.cu), other widths and misaligned inputs the
// CUDA-core forward.
//
// What bounds it on an H100: at the training shapes (B = 8, H = 8, N = 908)
// it does 4·B·H·N²·Dh operations against 4 bytes·4·B·N·H·Dh + B·N² mask
// bytes + 4·B·H·N for L, 186 (Dh 32) to 216 (Dh 144) operations per byte,
// above the TF32 ridge (495 TFLOP/s over 3.35 TB/s, ~148): the TF32
// tensor-core rate bounds it (chip_smoke.py:bound_ms counts every f32 product
// at that rate), and 3xTF32 does each product three times. The CUDA cores'
// f32 rate is 67 TFLOP/s. What the design does about it (the FlashAttention-2
// forward of masked_attention_fwd_tc.cu on mma.sync.m16n8k8 with TF32
// operands, with the f32 helpers that masked_attention_bwd_tc_f32.cu uses):
//
// - Precision: the f32 gate (1e-5 relative plus 1e-5 of max|v|) is not met
//   by one TF32 product (~11 bits). Every product's operands are split into
//   hi = tf32(x) and lo = tf32(x − hi) (cvt.rna) as each fragment is loaded,
//   and lo·hi + hi·lo + hi·hi go into an f32 accumulator (3xTF32, ~2^-21
//   relative a product; tests/test_torch_attention_fwd_f32.py emulates the
//   operands' rounding on the CPU).
// - The tensor cores add to their f32 accumulator rounding close to toward
//   zero (chip_smoke.py --only f32_rounding reads it on the card). O sums
//   N/8 k-steps of three products, ~340 at N = 908, the chain that puts the
//   f32 dQ at up to 0.8 of its gate. Here each key tile's P·V goes into a
//   zeroed fragment, one 8-column n-tile of O at a time (P's fragments of the
//   tile stay in registers), and joins O by one f32 FFMA, O ← alpha·O + tile,
//   in place of the rescale O ← alpha·O the online softmax needs anyway: the
//   tensor cores' chain is one tile long (BN/8 k-steps).
// - Q: a block of 16·WARPS query rows (16 a warp) stages them once by 16-byte
//   cp.async. At Dh 32 each warp keeps its A fragments in registers, split
//   once (hi and lo: 32 a thread); at Dh 144 they would take 144 beside O's
//   72, so Q stays in shared memory and is split again at every k-step.
// - K and V tiles and the (query block × key tile) block of the mask arrive
//   into a double buffer by cp.async, so the next tile loads while this one
//   computes; rows past n are zero-filled (source size 0) and masked. The
//   mask comes by 4-byte cp.async when n % 4 == 0 (N = 908, 152 and 44 all
//   are), by byte loads otherwise.
// - S = Q·Kᵀ: K enters as the B operand by 32-bit shared loads (ldmatrix
//   moves 16-bit elements only). The online softmax runs in the S
//   accumulators, as in the bf16 kernel: the four lanes of a row reduce the
//   tile's max with two xor shuffles, the running max m starts at −1e9,
//   alpha = exp(m − m_new) rescales O and the thread's part of the row sum
//   (reduced across the four lanes once, at the end). P stays in f32: the
//   plain version rounds nothing.
// - P·V: the S accumulator is the A fragment of P·V with its k order permuted
//   (0, 2, 4, 6, 1, 3, 5, 7; tc_common.cuh:acc_to_a_tf32), and V enters as B
//   read in the same order (load_b_tf32_kn): no shuffle and no shared-memory
//   round trip for P.
// - Exact zeros: a masked entry is never exponentiated, so p = 0 exactly and
//   0 splits into (0, 0): an empty row gives O = 0 and the plain version's L
//   bit for bit, −1e9 + log(1e-30).
// - Shared memory: rows are padded to Dh + 4 floats (≡ 4 mod 8), so every
//   fragment load, row-major and permuted-transposed alike, falls in 32
//   distinct banks. A 64-row f32 tile at Dh 144 is 37,888 bytes: there the
//   key tiles are 16 rows (78 KB a block, two blocks an SM); at Dh 32 they
//   are 64 (55 KB, four blocks an SM).
// - Block size: 64 or 32 query rows, chosen at launch from the grid as the
//   bf16 kernel does at Dh 32 (block_rows below), so that a B = 1 request
//   fills the SMs.
//
// wgmma takes TF32 operands only K-major, so P·V would need V transposed in
// shared memory first; that warp-specialised version is later work (ROADMAP
// Queue 2).

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr unsigned kFullMask = 0xffffffffu;

// keys per staged tile by head width (shared memory: see the note above)
__host__ __device__ constexpr int key_tile(int dh) { return dh <= 32 ? 64 : 16; }
// whether a warp keeps Q's split fragments in registers (registers: see the note above)
__host__ __device__ constexpr bool q_in_registers(int dh) { return dh <= 32; }

template <int DH, int WARPS>
constexpr int smem_bytes() {
  return (16 * WARPS + 2 * 2 * key_tile(DH)) * (DH + kPadF32) * 4 +
         2 * 16 * WARPS * (key_tile(DH) + kMaskPad);
}

template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
masked_attention_fwd_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const int8_t* __restrict__ mask,
                                   float* __restrict__ o, float* __restrict__ lse, int n, int heads,
                                   float scale) {
  constexpr int kThreads = WARPS * 32;
  constexpr int BM = 16 * WARPS;  // query rows of the block
  constexpr int BN = key_tile(DH);
  constexpr int kLd = DH + kPadF32;
  constexpr int kMaskLd = BN + kMaskPad;
  constexpr int kNT = BN / 8;  // 8-key n-tiles of S, and k-steps of P·V
  constexpr int kDT = DH / 8;  // 8-column n-tiles of O, and k-steps of S
  constexpr bool kQRegs = q_in_registers(DH);
  static_assert(DH % 8 == 0 && BN % 8 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                        // [BM][kLd]
  float* kv_s = q_s + BM * kLd;                                       // [2 stages][K, V][BN][kLd]
  int8_t* m_s = reinterpret_cast<int8_t*>(kv_s + 2 * 2 * BN * kLd);  // [2 stages][BM][kMaskLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;

  load_rows_f32<DH, kLd, BM, kThreads>(q_s, q, base, node_stride, q0, n);
  cp_async_commit();
  load_rows_f32<DH, kLd, BN, kThreads>(kv_s, k, base, node_stride, 0, n);
  load_rows_f32<DH, kLd, BN, kThreads>(kv_s + BN * kLd, v, base, node_stride, 0, n);
  load_mask<BM, BN, kThreads>(m_s, mask_b, q0, 0, n);
  cp_async_commit();
  cp_async_wait<1>();  // Q has arrived; the first tile may still be in flight
  __syncthreads();
  uint32_t q_hi[kQRegs ? kDT : 1][4], q_lo[kQRegs ? kDT : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) load_a_tf32<kLd>(q_hi[ks], q_lo[ks], q_s, warp * 16, ks * 8);
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this thread's part of their sums

  const int tiles = (n + BN - 1) / BN;
  for (int it = 0; it < tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < tiles) {  // the next tile loads while this one computes
      const int k1 = (it + 1) * BN;
      float* next = kv_s + (stage ^ 1) * 2 * BN * kLd;
      load_rows_f32<DH, kLd, BN, kThreads>(next, k, base, node_stride, k1, n);
      load_rows_f32<DH, kLd, BN, kThreads>(next + BN * kLd, v, base, node_stride, k1, n);
      load_mask<BM, BN, kThreads>(m_s + (stage ^ 1) * BM * kMaskLd, mask_b, q0, k1, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* k_t = kv_s + stage * 2 * BN * kLd;
    const float* v_t = k_t + BN * kLd;
    const int8_t* m_t = m_s + stage * BM * kMaskLd;

    // S = Q·Kᵀ for the warp's 16 rows × BN keys, 8 columns of the head a k-step
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a_hi[e] = q_hi[ks][e];
          a_lo[e] = q_lo[ks][e];
        }
      } else {
        load_a_tf32<kLd>(a_hi, a_lo, q_s, warp * 16, ks * 8);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32<kLd>(b_hi, b_lo, k_t, j * 8, ks * 8);
        mma_3xtf32(s[j], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // online softmax, row by row (entries 2i and 2i + 1 of each n-tile)
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* m_row = m_t + (warp * 16 + g + 8 * i) * kMaskLd + 2 * t;
      bool ex[kNT], ey[kNT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const char2 e2 = *reinterpret_cast<const char2*>(m_row + j * 8);
        ex[j] = e2.x != 0;
        ey[j] = e2.y != 0;
        s[j][2 * i] *= scale;
        s[j][2 * i + 1] *= scale;
        mx = fmaxf(mx, fmaxf(ex[j] ? s[j][2 * i] : kNegInf, ey[j] ? s[j][2 * i + 1] : kNegInf));
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      alpha[i] = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {  // a masked entry is never exponentiated
        s[j][2 * i] = ex[j] ? expf(s[j][2 * i] - m_new) : 0.f;
        s[j][2 * i + 1] = ey[j] ? expf(s[j][2 * i + 1] - m_new) : 0.f;
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l_r[i] = l_r[i] * alpha[i] + sum;
      m_r[i] = m_new;
    }

    // O ← alpha·O + P̃·V, one 8-column n-tile of O at a time: the tile's
    // products (its BN keys, 8 a k-step) into a zeroed fragment, then one FFMA
    uint32_t p_hi[kNT][4], p_lo[kNT][4];
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) acc_to_a_tf32(s[ks], p_hi[ks], p_lo[ks]);
#pragma unroll
    for (int nd = 0; nd < kDT; ++nd) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kNT; ++ks) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32_kn<kLd>(b_hi, b_lo, v_t, ks * 8, nd * 8);
        mma_3xtf32(pv, p_hi[ks], p_lo[ks], b_hi, b_lo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(alpha[e >> 1], acc[nd][e], pv[e]);
    }
    __syncthreads();  // this tile's buffers are free again
  }

  const size_t bh = ((size_t)b * heads + h) * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(kFullMask, l, 1);
    l += __shfl_xor_sync(kFullMask, l, 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
    const float denom = fmaxf(l, 1e-30f);
    float* out = o + base + (size_t)row * node_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      *reinterpret_cast<float2*>(out + j * 8) = make_float2(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
    if (t == 0) lse[bh + row] = m_r[i] + logf(denom);
  }
}

// Query rows a block owns: 64, or 32 where a 64-row grid would leave SMs idle
// (B = 1, H = 8, N = 908: 15 × 8 = 120 blocks for 132 SMs), the bf16
// kernel's rule at Dh 32 (masked_attention_fwd_tc.cu:block_rows).
int block_rows(int batch, int n, int heads) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)((n + 63) / 64) * heads * batch >= sms ? 64 : 32;
}

template <int DH, int WARPS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, WARPS>();
  static const cudaError_t prepared = prepare(masked_attention_fwd_tc_f32_kernel<DH, WARPS>, bytes);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((n + 16 * WARPS - 1) / (16 * WARPS), heads, batch);
  masked_attention_fwd_tc_f32_kernel<DH, WARPS><<<grid, WARPS * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int8_t*>(mask), static_cast<float*>(o), static_cast<float*>(lse), n, heads,
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_rows(int rows, const void* q, const void* k, const void* v, const void* mask,
                        void* o, void* lse, int batch, int n, int heads, float scale,
                        cudaStream_t st) {
  return rows == 64 ? launch<DH, 4>(q, k, v, mask, o, lse, batch, n, heads, scale, st)
                    : launch<DH, 2>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
}

}  // namespace

// The same C interface as masked_attention_fwd.cu's; dtype must be 0
// (float32) and head_dim 32 or 144. Returns the cudaError_t of the launch.
extern "C" int masked_attention_fwd_tc_f32(const void* q, const void* k, const void* v,
                                           const void* mask, void* o, void* lse, int batch, int n,
                                           int heads, int head_dim, int dtype, float scale,
                                           void* stream) {
  if (bad_shape(batch, n, heads, dtype, 0)) return (int)cudaErrorInvalidValue;
  const int rows = block_rows(batch, n, heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_rows<32>(rows, q, k, v, mask, o, lse, batch, n, heads, scale, st);
  if (head_dim == 144)
    return (int)launch_rows<144>(rows, q, k, v, mask, o, lse, batch, n, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}
