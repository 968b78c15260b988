// Fused masked multi-head graph attention, backward, on Hopper's tensor cores
// (sm_90a, bf16).
//
// The tensor-core route of the two backward kernels. Each replaces one TPU
// kernel of the JAX package's ops/pallas_attention.py (both launched by
// `_flash_bwd`) and computes the same function as its CUDA-core counterpart
// in masked_attention_bwd.cu:
//
//   masked_attention_bwd_dq_tc   replaces `_bwd_dq_kernel`:
//     P   = exp(q·kᵀ/√Dh − L) on edges, 0 elsewhere
//     dQ  = (P ∘ (dO·vᵀ − Δ))·k/√Dh
//   masked_attention_bwd_dkv_tc  replaces `_bwd_dkv_kernel`:
//     dV  = Pᵀ·dO
//     dK  = (P ∘ (dO·vᵀ − Δ))ᵀ·q/√Dh
//
// with L the forward's per-row log-sum-exp and Δ = rowsum(dO ∘ O) in f32.
// Inputs and outputs are bf16, (B, N, H, Dh) contiguous and read as they are
// (every row starts 16-byte aligned: the caller checks the base pointers);
// L and Δ are (B, H, N) f32; the mask is the untransposed (B, N, N) int8 (or
// bool bytes), shared across heads. Instantiated at Dh 32 and 144, the main
// path's widths; other widths take the CUDA-core route, and float32 its own
// tensor-core kernels (masked_attention_bwd_tc_f32.cu, 3xTF32) on graphs of
// more than 32 nodes.
//
// What bounds them on an H100: at the training shapes (B = 8, H = 8,
// N = 908) the dQ kernel does 6·B·H·N²·Dh operations and the dK/dV kernel
// 8·B·H·N²·Dh against ~2 bytes·B·N·H·Dh per tensor plus B·N² mask bytes,
// hundreds of operations per byte: the tensor-core rate bounds them (PERF.md
// §6). What the design does about it (the FlashAttention-2 structure on
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators):
//
// - dQ: a block of 4 warps owns 64 query rows (16 a warp), staged once in
//   shared memory as bf16, and loops over key tiles. S = Q·Kᵀ and
//   dP = dO·Vᵀ come from ldmatrix fragments (Q and dO as A, K and V as B);
//   P and dS are formed in the accumulator registers, only on edges, and the
//   accumulator fragment repacks into the A fragment of dQ += dS·K, which
//   reads K through ldmatrix.trans: no shared-memory round trip.
// - dK/dV: a block owns 64 keys and loops over query tiles: Sᵀ = K·Qᵀ,
//   dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q with dO and Q through
//   ldmatrix.trans. The (query tile × 64 keys) block of the untransposed
//   mask is staged in shared memory; each thread reads the entries of its
//   own accumulator fragment.
// - Precision: S and dP take the bf16 inputs as they are. P and dS are f32;
//   rounding them once to bf16 breaks the bf16 gate (one bf16 ulp of the
//   output plus 1e-4 of its largest entry), so each enters its product as a
//   pair hi = bf16(x), lo = bf16(x − hi): two MMAs into one f32 accumulator,
//   accurate to ~2^-16 relative (tests/test_torch_attention_bwd.py emulates
//   both roundings).
// - Exact zeros: a masked entry is never exponentiated, so P = dS = 0
//   exactly, and the pair of 0 is (0, 0): empty query rows get dQ = 0 and
//   unattended keys dK = dV = 0.
// - Copies: the other side's tiles arrive by 16-byte cp.async into a double
//   buffer, so the next tile loads while this one computes; rows past n are
//   zero-filled (source size 0) and masked. Shared rows are padded by 16
//   bytes, so the 8 row addresses of each ldmatrix fall in distinct banks.
// - No atomics: each block owns its output rows; results are deterministic.
// - The copy, fragment and MMA helpers are in tc_common.cuh, shared with the
//   tensor-core forward.
//
// A wgmma/TMA warp-specialised version is later work (ROADMAP Queue 2).

#include "tc_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kOwn = 16 * kWarps;  // rows a block owns (dQ: queries, dK/dV: keys), 16 a warp

// The other side's tile (keys for dQ, queries for dK/dV) by head width,
// timed on the H100 (PERF.md §6): at Dh 144 a 64-row tile spills registers
// in dK/dV and takes one block per SM in dQ (121 KB of shared memory), so
// both take 32 rows there (80 KB, two blocks per SM, no spill).
constexpr int dq_tile(int dh) { return dh <= 32 ? 64 : 32; }
constexpr int dkv_tile(int dh) { return dh <= 32 ? 64 : 32; }

template <int DH, int BN>
constexpr int dq_smem_bytes() {
  return (2 * kOwn + 2 * 2 * BN) * (DH + kPad) * 2 + kOwn * (BN + kMaskPad);
}

template <int DH, int BM>
constexpr int dkv_smem_bytes() {
  return (2 * kOwn + 2 * 2 * BM) * (DH + kPad) * 2 + 2 * BM * 4 + BM * (kOwn + kMaskPad);
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const int8_t* __restrict__ mask,
                                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dq, int n,
                                  int heads, float scale) {
  constexpr int kLd = DH + kPad;
  constexpr int kMaskLd = BN + kMaskPad;
  constexpr int kNT = BN / 8;  // 8-key n-tiles of S and dP
  constexpr int kDT = DH / 8;  // 8-column n-tiles of dQ
  static_assert(DH % 16 == 0 && BN % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);                  // [kOwn][kLd]
  bf16* do_s = q_s + kOwn * kLd;                              // [kOwn][kLd]
  bf16* kv_s = do_s + kOwn * kLd;                             // [2 stages][K, V][BN][kLd]
  int8_t* m_s = reinterpret_cast<int8_t*>(kv_s + 2 * 2 * BN * kLd);  // [kOwn][kMaskLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const int q0 = blockIdx.x * kOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const size_t bh = ((size_t)b * heads + h) * n;

  load_rows<DH, kOwn, kThreads>(q_s, q, base, node_stride, q0, n);
  load_rows<DH, kOwn, kThreads>(do_s, dout, base, node_stride, q0, n);
  load_rows<DH, BN, kThreads>(kv_s, k, base, node_stride, 0, n);
  load_rows<DH, BN, kThreads>(kv_s + BN * kLd, v, base, node_stride, 0, n);
  cp_async_commit();

  float l_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    l_r[i] = row < n ? lse[bh + row] : 0.f;
    d_r[i] = row < n ? delta[bh + row] : 0.f;
  }
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int tiles = (n + BN - 1) / BN;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < tiles) {  // the next tile loads while this one computes
      bf16* next = kv_s + ((it + 1) & 1) * 2 * BN * kLd;
      load_rows<DH, BN, kThreads>(next, k, base, node_stride, k0 + BN, n);
      load_rows<DH, BN, kThreads>(next + BN * kLd, v, base, node_stride, k0 + BN, n);
    }
    cp_async_commit();
    for (int idx = threadIdx.x; idx < kOwn * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      const int row = q0 + r, key = k0 + c;
      m_s[r * kMaskLd + c] = (row < n && key < n) ? mask_b[(size_t)row * n + key] : (int8_t)0;
    }
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_t = kv_s + (it & 1) * 2 * BN * kLd;
    const bf16* v_t = k_t + BN * kLd;

    // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 rows × BN keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t aq[4], ado[4];
      load_a<kLd>(aq, q_s, warp * 16, ks * 16);
      load_a<kLd>(ado, do_s, warp * 16, ks * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4], bv[4];
        load_b<kLd>(bk, k_t, np * 16, ks * 16);
        load_b<kLd>(bv, v_t, np * 16, ks * 16);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ado, bv[0], bv[1]);
        mma(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // dS = P∘(dP − Δ) in place of S; a masked entry is never exponentiated
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + 8 * (e >> 1), c = j * 8 + 2 * t + (e & 1);
        s[j][e] = m_s[r * kMaskLd + c] != 0
                      ? expf(s[j][e] * scale - l_r[e >> 1]) * (dp[j][e] - d_r[e >> 1])
                      : 0.f;
      }

    // dQ += dS·K, dS as a hi + lo pair of bf16
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t hi[4], lo[4];
      to_a(s[2 * ks], s[2 * ks + 1], hi, lo);
#pragma unroll
      for (int nd = 0; nd < kDT / 2; ++nd) {
        uint32_t bk[4];
        load_b_trans<kLd>(bk, k_t, ks * 16, nd * 16);
        mma(acc[2 * nd], hi, bk[0], bk[1]);
        mma(acc[2 * nd], lo, bk[0], bk[1]);
        mma(acc[2 * nd + 1], hi, bk[2], bk[3]);
        mma(acc[2 * nd + 1], lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this tile's buffers and the mask tile are free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
    bf16* out = dq + base + (size_t)row * node_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int DH, int BM>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const int8_t* __restrict__ mask,
                                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int n, int heads, float scale) {
  constexpr int kLd = DH + kPad;
  constexpr int kMaskLd = kOwn + kMaskPad;
  constexpr int kNT = BM / 8;  // 8-query n-tiles of Sᵀ and dPᵀ
  constexpr int kDT = DH / 8;  // 8-column n-tiles of dK and dV
  static_assert(DH % 16 == 0 && BM % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);             // [kOwn][kLd]
  bf16* v_s = k_s + kOwn * kLd;                          // [kOwn][kLd]
  bf16* qd_s = v_s + kOwn * kLd;                         // [2 stages][Q, dO][BM][kLd]
  float* l_s = reinterpret_cast<float*>(qd_s + 2 * 2 * BM * kLd);  // [BM]
  float* d_s = l_s + BM;                                 // [BM]
  int8_t* m_s = reinterpret_cast<int8_t*>(d_s + BM);     // [BM][kMaskLd], queries × keys

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const int j0 = blockIdx.x * kOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const size_t bh = ((size_t)b * heads + h) * n;

  load_rows<DH, kOwn, kThreads>(k_s, k, base, node_stride, j0, n);
  load_rows<DH, kOwn, kThreads>(v_s, v, base, node_stride, j0, n);
  load_rows<DH, BM, kThreads>(qd_s, q, base, node_stride, 0, n);
  load_rows<DH, BM, kThreads>(qd_s + BM * kLd, dout, base, node_stride, 0, n);
  cp_async_commit();

  float acc_k[kDT][4], acc_v[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int tiles = (n + BM - 1) / BM;
  for (int it = 0; it < tiles; ++it) {
    const int i0 = it * BM;
    if (it + 1 < tiles) {  // the next tile loads while this one computes
      bf16* next = qd_s + ((it + 1) & 1) * 2 * BM * kLd;
      load_rows<DH, BM, kThreads>(next, q, base, node_stride, i0 + BM, n);
      load_rows<DH, BM, kThreads>(next + BM * kLd, dout, base, node_stride, i0 + BM, n);
    }
    cp_async_commit();
    // the (query tile × 64 keys) block of the untransposed mask, read along keys
    for (int idx = threadIdx.x; idx < BM * kOwn; idx += kThreads) {
      const int r = idx / kOwn, c = idx % kOwn;
      const int row = i0 + r, key = j0 + c;
      m_s[r * kMaskLd + c] = (row < n && key < n) ? mask_b[(size_t)row * n + key] : (int8_t)0;
    }
    if (threadIdx.x < BM) {
      const int row = i0 + threadIdx.x;
      l_s[threadIdx.x] = row < n ? lse[bh + row] : 0.f;
      d_s[threadIdx.x] = row < n ? delta[bh + row] : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    const bf16* q_t = qd_s + (it & 1) * 2 * BM * kLd;
    const bf16* do_t = q_t + BM * kLd;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys × BM queries
    float st[kNT][4], dpt[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t ak[4], av[4];
      load_a<kLd>(ak, k_s, warp * 16, ks * 16);
      load_a<kLd>(av, v_s, warp * 16, ks * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[4], bdo[4];
        load_b<kLd>(bq, q_t, np * 16, ks * 16);
        load_b<kLd>(bdo, do_t, np * 16, ks * 16);
        mma(st[2 * np], ak, bq[0], bq[1]);
        mma(st[2 * np + 1], ak, bq[2], bq[3]);
        mma(dpt[2 * np], av, bdo[0], bdo[1]);
        mma(dpt[2 * np + 1], av, bdo[2], bdo[3]);
      }
    }

    // Pᵀ in place of Sᵀ and dSᵀ = Pᵀ∘(dPᵀ − Δ) in place of dPᵀ; a masked
    // entry (and a query or key past n) is never exponentiated
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 16 + g + 8 * (e >> 1), i = j * 8 + 2 * t + (e & 1);
        const bool edge = m_s[i * kMaskLd + key] != 0;
        const float p = edge ? expf(st[j][e] * scale - l_s[i]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = edge ? p * (dpt[j][e] - d_s[i]) : 0.f;
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ as hi + lo pairs of bf16
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      to_a(st[2 * ks], st[2 * ks + 1], p_hi, p_lo);
      to_a(dpt[2 * ks], dpt[2 * ks + 1], ds_hi, ds_lo);
#pragma unroll
      for (int nd = 0; nd < kDT / 2; ++nd) {
        uint32_t bdo[4], bq[4];
        load_b_trans<kLd>(bdo, do_t, ks * 16, nd * 16);
        mma(acc_v[2 * nd], p_hi, bdo[0], bdo[1]);
        mma(acc_v[2 * nd], p_lo, bdo[0], bdo[1]);
        mma(acc_v[2 * nd + 1], p_hi, bdo[2], bdo[3]);
        mma(acc_v[2 * nd + 1], p_lo, bdo[2], bdo[3]);
        load_b_trans<kLd>(bq, q_t, ks * 16, nd * 16);
        mma(acc_k[2 * nd], ds_hi, bq[0], bq[1]);
        mma(acc_k[2 * nd], ds_lo, bq[0], bq[1]);
        mma(acc_k[2 * nd + 1], ds_hi, bq[2], bq[3]);
        mma(acc_k[2 * nd + 1], ds_lo, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this tile's buffers, the mask tile and L, Δ are free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + warp * 16 + g + 8 * i;
    if (key >= n) continue;
    const size_t off = base + (size_t)key * node_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(acc_k[j][2 * i] * scale, acc_k[j][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dq, int batch,
                      int n, int heads, float scale, cudaStream_t stream) {
  constexpr int kTile = dq_tile(DH);
  constexpr int bytes = dq_smem_bytes<DH, kTile>();
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dq_tc_kernel<DH, kTile>, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kOwn - 1) / kOwn, heads, batch);
  masked_attention_bwd_dq_tc_kernel<DH, kTile><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq), n,
      heads, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int kTile = dkv_tile(DH);
  constexpr int bytes = dkv_smem_bytes<DH, kTile>();
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dkv_tc_kernel<DH, kTile>, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kOwn - 1) / kOwn, heads, batch);
  masked_attention_bwd_dkv_tc_kernel<DH, kTile><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// The same C interface as masked_attention_bwd.cu's; dtype must be 1
// (bfloat16) and head_dim 32 or 144. Each returns the cudaError_t of its launch.
extern "C" int masked_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                          const void* mask, const void* dout, const void* lse,
                                          const void* delta, void* dq, int batch, int n,
                                          int heads, int head_dim, int dtype, float scale,
                                          void* stream) {
  if (bad_shape(batch, n, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_dq<32>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  if (head_dim == 144)
    return (int)launch_dq<144>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masked_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                           const void* mask, const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int batch,
                                           int n, int heads, int head_dim, int dtype,
                                           float scale, void* stream) {
  if (bad_shape(batch, n, heads, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_dkv<32>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads, scale,
                               st);
  if (head_dim == 144)
    return (int)launch_dkv<144>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads, scale,
                                st);
  return (int)cudaErrorInvalidValue;
}
