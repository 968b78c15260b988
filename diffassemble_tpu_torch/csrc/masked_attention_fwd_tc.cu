// Fused masked multi-head graph attention, forward, on Hopper's tensor cores
// (sm_90a, bf16).
//
// The tensor-core route of the forward. Replaces the TPU kernel
// `_attn_kernel` of the JAX package's ops/pallas_attention.py (launched by
// `_flash_fwd`) and computes the same function as its CUDA-core counterpart
// in masked_attention_fwd.cu:
//
//   S   = q·kᵀ/√Dh in f32, masked entries left out of the max (−1e9 floor)
//   m   = max(−1e9, max over edges of S),  l = Σ over edges of exp(S − m)
//   O   = Σ over edges of exp(S − m)·v / max(l, 1e−30)          (bf16)
//   L   = m + log(max(l, 1e−30))                                 (f32)
//
// Inputs and O are bf16, (B, N, H, Dh) contiguous and read as they are (every
// row starts 16-byte aligned: the caller checks the base pointers); the mask
// is (B, N, N) int8 (or bool bytes), shared across heads; L is (B, H, N) f32.
// Instantiated at Dh 32 and 144, the main paths' widths (the kernel is a
// template on the width, any multiple of 16); float32 takes
// masked_attention_fwd_tc_f32.cu there, other widths the CUDA-core route.
//
// What bounds it on an H100: at the main paths' shapes (B = 1 or 8, H = 8,
// N = 908) it does 4·B·H·N²·Dh operations against 2 bytes·4·B·N·H·Dh + B·N²
// mask bytes + 4·B·H·N for L, 315 (Dh 32) to 413 (Dh 144) operations per
// byte, above the card's ~295 bf16 ridge: the tensor-core rate bounds it
// (PERF.md §6). What the design does about it (the FlashAttention-2 forward
// on mma.sync.m16n8k16 with bf16 operands and f32 accumulators, the
// structure of the dQ kernel in masked_attention_bwd_tc.cu without dO and dP):
//
// - A block of 16·WARPS query rows (16 a warp) stages them once by 16-byte
//   cp.async and keeps their A fragments in registers; K and V tiles and the
//   (query block × key tile) block of the mask arrive into a double buffer by
//   cp.async, so the next tile loads while this one computes. Rows past n are
//   zero-filled (source size 0) and masked: N = 908 leaves a ragged last tile.
// - S = Q·Kᵀ comes from ldmatrix fragments into f32 accumulators and is
//   scaled by 1/√Dh there. The online softmax runs in those registers: the
//   four lanes of a row reduce the tile's max with two xor shuffles, the
//   running max m starts at −1e9 as in the CUDA-core kernel, alpha =
//   exp(m − m_new) rescales the O accumulators and the thread's part of the
//   row sum (reduced across the four lanes once, at the end). A masked entry
//   is never exponentiated: p = 0 exactly, and an empty row gives O = 0 and
//   the plain version's L bit for bit.
// - P·V: the S accumulators repack into the A fragment of P·V, each p̃ =
//   exp(S − m) rounded once to bf16 (the plain version rounds the normalised
//   P once; the error of either is well inside the bf16 gate, emulated in
//   tests/test_torch_attention_fwd_tc.py), and V enters as the B operand through
//   ldmatrix.trans: no shared-memory round trip for P.
// - Registers: at Dh 144 the O accumulators are 72 f32 a thread and Q's
//   fragments 36; 32-key tiles keep S at 16 (64-key tiles at Dh 32).
// - Mask: rows are N bytes, 4-byte but not 16-byte aligned at N = 908, so
//   the mask tile comes by 4-byte cp.async when n % 4 == 0, by byte loads
//   otherwise.
// - Block size: 64 or 32 query rows, chosen at launch from the width and the
//   grid (block_rows below); 16 rows are instantiated for timing.
//
// A wgmma/TMA warp-specialised version is later work (ROADMAP Queue 2).

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr unsigned kFullMask = 0xffffffffu;

// keys per staged tile by head width (registers: see the note above)
__host__ __device__ constexpr int key_tile(int dh) { return dh <= 32 ? 64 : 32; }

template <int DH, int WARPS>
constexpr int smem_bytes() {
  return (16 * WARPS + 2 * 2 * key_tile(DH)) * (DH + kPad) * 2 +
         2 * 16 * WARPS * (key_tile(DH) + kMaskPad);
}

template <int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
masked_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int8_t* __restrict__ mask,
                               bf16* __restrict__ o, float* __restrict__ lse, int n, int heads,
                               float scale) {
  constexpr int kThreads = WARPS * 32;
  constexpr int BM = 16 * WARPS;  // query rows of the block
  constexpr int BN = key_tile(DH);
  constexpr int kLd = DH + kPad;
  constexpr int kMaskLd = BN + kMaskPad;
  constexpr int kNT = BN / 8;   // 8-key n-tiles of S
  constexpr int kDT = DH / 8;   // 8-column n-tiles of O
  constexpr int kKS = DH / 16;  // k-steps of S
  static_assert(DH % 16 == 0 && BN % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                         // [BM][kLd]
  bf16* kv_s = q_s + BM * kLd;                                       // [2 stages][K, V][BN][kLd]
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

  load_rows<DH, BM, kThreads>(q_s, q, base, node_stride, q0, n);
  cp_async_commit();
  load_rows<DH, BN, kThreads>(kv_s, k, base, node_stride, 0, n);
  load_rows<DH, BN, kThreads>(kv_s + BN * kLd, v, base, node_stride, 0, n);
  load_mask<BM, BN, kThreads>(m_s, mask_b, q0, 0, n);
  cp_async_commit();
  cp_async_wait<1>();  // Q has arrived; the first tile may still be in flight
  __syncthreads();
  uint32_t qf[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) load_a<kLd>(qf[ks], q_s, warp * 16, ks * 16);

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
      bf16* next = kv_s + (stage ^ 1) * 2 * BN * kLd;
      load_rows<DH, BN, kThreads>(next, k, base, node_stride, k1, n);
      load_rows<DH, BN, kThreads>(next + BN * kLd, v, base, node_stride, k1, n);
      load_mask<BM, BN, kThreads>(m_s + (stage ^ 1) * BM * kMaskLd, mask_b, q0, k1, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_t = kv_s + stage * 2 * BN * kLd;
    const bf16* v_t = k_t + BN * kLd;
    const int8_t* m_t = m_s + stage * BM * kMaskLd;

    // S = Q·Kᵀ for the warp's 16 rows × BN keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4];
        load_b<kLd>(bk, k_t, np * 16, ks * 16);
        mma(s[2 * np], qf[ks], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }

    // online softmax, row by row (entries 2i and 2i + 1 of each n-tile)
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
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {  // a masked entry is never exponentiated
        s[j][2 * i] = ex[j] ? expf(s[j][2 * i] - m_new) : 0.f;
        s[j][2 * i + 1] = ey[j] ? expf(s[j][2 * i + 1] - m_new) : 0.f;
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
      m_r[i] = m_new;
    }

    // O += P̃·V, P̃ rounded once to bf16
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t a[4];
      to_a(s[2 * ks], s[2 * ks + 1], a);
#pragma unroll
      for (int nd = 0; nd < kDT / 2; ++nd) {
        uint32_t bv[4];
        load_b_trans<kLd>(bv, v_t, ks * 16, nd * 16);
        mma(acc[2 * nd], a, bv[0], bv[1]);
        mma(acc[2 * nd + 1], a, bv[2], bv[3]);
      }
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
    bf16* out = o + base + (size_t)row * node_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
    if (t == 0) lse[bh + row] = m_r[i] + logf(denom);
  }
}

// Query rows a block owns, from 64-, 32- and 16-row blocks timed on the H100
// (PERF.md §6): 64, except at Dh 32 where a 64-row grid would leave SMs idle
// (B = 1: 15 × 8 = 120 blocks for 132 SMs) and 32-row blocks are faster.
// Smaller blocks re-read K and V more often: at Dh 144 that costs more than
// the idle SMs, and 16-row blocks lost everywhere.
int block_rows(int batch, int n, int heads, int head_dim) {
  if (head_dim > 32) return 64;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)((n + 63) / 64) * heads * batch >= sms ? 64 : 32;
}

template <int DH, int WARPS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, WARPS>();
  static const cudaError_t opted = allow_smem(masked_attention_fwd_tc_kernel<DH, WARPS>, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + 16 * WARPS - 1) / (16 * WARPS), heads, batch);
  masked_attention_fwd_tc_kernel<DH, WARPS><<<grid, WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int8_t*>(mask), static_cast<bf16*>(o), static_cast<float*>(lse), n, heads,
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_rows(int rows, const void* q, const void* k, const void* v, const void* mask,
                        void* o, void* lse, int batch, int n, int heads, float scale,
                        cudaStream_t st) {
  switch (rows) {
    case 64: return launch<DH, 4>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
    case 32: return launch<DH, 2>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
    case 16: return launch<DH, 1>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// masked_attention_fwd's C interface plus the query rows of a block (64, 32
// or 16; 0 = block_rows' choice, as masked_attention_fwd_tc takes). dtype
// must be 1 (bfloat16) and head_dim 32 or 144. Returns the cudaError_t of
// the launch.
extern "C" int masked_attention_fwd_tc_rows(const void* q, const void* k, const void* v,
                                            const void* mask, void* o, void* lse, int batch, int n,
                                            int heads, int head_dim, int dtype, float scale,
                                            int rows, void* stream) {
  if (bad_shape(batch, n, heads, dtype)) return (int)cudaErrorInvalidValue;
  if (rows == 0) rows = block_rows(batch, n, heads, head_dim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_rows<32>(rows, q, k, v, mask, o, lse, batch, n, heads, scale, st);
  if (head_dim == 144)
    return (int)launch_rows<144>(rows, q, k, v, mask, o, lse, batch, n, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masked_attention_fwd_tc(const void* q, const void* k, const void* v,
                                       const void* mask, void* o, void* lse, int batch, int n,
                                       int heads, int head_dim, int dtype, float scale,
                                       void* stream) {
  return masked_attention_fwd_tc_rows(q, k, v, mask, o, lse, batch, n, heads, head_dim, dtype,
                                      scale, 0, stream);
}

// The query rows of a block masked_attention_fwd_tc launches for this shape.
extern "C" int masked_attention_fwd_tc_block_rows(int batch, int n, int heads, int head_dim) {
  return block_rows(batch, n, heads, head_dim);
}
