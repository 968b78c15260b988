// Fused masked multi-head graph attention, backward, on Hopper's tensor cores
// in float32 (sm_90a, 3xTF32).
//
// The tensor-core route of the two backward kernels for float32 inputs. Each
// replaces one TPU kernel of the JAX package's ops/pallas_attention.py (both
// launched by `_flash_bwd`) and computes the same function as its
// counterparts in masked_attention_bwd.cu (CUDA cores) and
// masked_attention_bwd_tc.cu (bf16):
//
//   masked_attention_bwd_dq_tc_f32   replaces `_bwd_dq_kernel`:
//     P   = exp(q·kᵀ/√Dh − L) on edges, 0 elsewhere
//     dQ  = (P ∘ (dO·vᵀ − Δ))·k/√Dh
//   masked_attention_bwd_dkv_tc_f32  replaces `_bwd_dkv_kernel`:
//     dV  = Pᵀ·dO
//     dK  = (P ∘ (dO·vᵀ − Δ))ᵀ·q/√Dh
//
// with L the forward's per-row log-sum-exp and Δ = rowsum(dO ∘ O) in f32.
// Inputs and outputs are f32, (B, N, H, Dh) contiguous and read as they are
// (every row starts 16-byte aligned: the caller checks the base pointers);
// L and Δ are (B, H, N) f32; the mask is the untransposed (B, N, N) int8 (or
// bool bytes), shared across heads. Instantiated at Dh 32 and 144, the main
// paths' widths, for graphs of more than 32 nodes: smaller graphs take the
// fused small-graph kernel (masked_attention_bwd_small.cu), other widths and
// misaligned inputs the CUDA-core kernels.
//
// What bounds them on an H100: at the training shapes (B = 8, H = 8,
// N = 908) the dQ kernel does 6·B·H·N²·Dh operations and the dK/dV kernel
// 8·B·H·N²·Dh against ~4 bytes·B·N·H·Dh per tensor plus B·N² mask bytes,
// over a hundred operations per byte: the TF32 tensor-core rate (495
// TFLOP/s) bounds them, and 3xTF32 does each product three times (PERF.md
// §6). The CUDA cores' f32 rate is 67 TFLOP/s. What the design does about it:
//
// - Precision: the f32 gate (1e-5 relative plus 1e-5 of max|ref|) is not met
//   by one TF32 product (~11 bits). Every product's operands are split into
//   hi = tf32(x) and lo = tf32(x − hi) (cvt.rna), and lo·hi + hi·lo + hi·hi
//   go into one f32 accumulator through mma.sync.m16n8k8 with TF32 operands:
//   ~2^-21 relative a product (tests/test_torch_attention_bwd_f32.py
//   emulates the operands' rounding on the CPU). The tensor cores add each
//   product to the accumulator rounding close to toward zero (chip_smoke.py
//   --only f32_rounding reads it on the card): over the ~340 products a row
//   sums at N = 908 that bias puts dQ, dK and dV at up to ~0.8 of the f32
//   gate. Taking each k-step's products into a zeroed accumulator and the
//   running sum by f32 adds removes it (~0.1 of the gate), but needs a
//   temporary fragment per output tile in flight: here it spilled and took
//   up to 1.36x the time, so the sum stays in the tensor cores' accumulator
//   (ROADMAP Queue 2, K7b). The split is made as each fragment is loaded,
//   in registers.
// - dQ: a block of 4 warps owns 64 query rows (16 a warp), staged once in
//   shared memory, and loops over key tiles. S = Q·Kᵀ and dP = dO·Vᵀ read
//   Q and dO as A fragments and K and V as B fragments by 32-bit shared
//   loads; P and dS are formed in the accumulator registers, only on edges.
//   The accumulator fragment is the A fragment of dQ += dS·K with its k
//   order permuted (0, 2, 4, 6, 1, 3, 5, 7; tc_common.cuh:acc_to_a_tf32), and
//   K is read in the same order: no shuffle and no shared-memory round trip.
//   ldmatrix.trans, which the bf16 kernel reads K through, moves 16-bit
//   elements only, so here K's transposed fragment is two 32-bit loads.
// - dK/dV: a block owns 64 keys and loops over query tiles: Sᵀ = K·Qᵀ,
//   dPᵀ = V·dOᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read as B in the
//   permuted order. The (query tile × 64 keys) block of the untransposed
//   mask is staged in shared memory; each thread reads the entries of its
//   own accumulator fragment.
// - Shared memory doubles against bf16: a 64-row f32 tile at Dh 144 is
//   37,888 bytes with its padding. So at Dh 144 the other side's tiles are
//   16 rows, double-buffered (115 KB a block, two blocks an SM); at Dh 32
//   they are 64 rows (60 KB, three blocks an SM). Rows are padded to
//   Dh + 4 floats (≡ 4 mod 8): every fragment load, row-major and
//   permuted-transposed alike, falls in 32 distinct banks, and each row
//   stays 16-byte aligned for cp.async.
// - Registers: the dK and dV accumulators at Dh 144 are 144 a thread, as in
//   the bf16 kernel; the 16-row query tile keeps Sᵀ and dPᵀ at 16, so the
//   hi/lo halves fit without a spill (chip_smoke.py's build gate).
// - Exact zeros: a masked entry is never exponentiated, so P = dS = 0
//   exactly, and 0 splits into (0, 0): empty query rows get dQ = 0 and
//   unattended keys dK = dV = 0.
// - Copies: the other side's tiles arrive by 16-byte cp.async into a double
//   buffer, so the next tile loads while this one computes; rows past n are
//   zero-filled (source size 0) and masked.
// - No atomics: each block owns its output rows; results are deterministic.
//
// wgmma takes TF32 operands only K-major, so the transposed products
// (dS·K, Pᵀ·dO, dSᵀ·Q) would need transposed copies staged first; that
// warp-specialised version is later work (ROADMAP Queue 2).

#include "tc_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kOwn = 16 * kWarps;  // rows a block owns (dQ: queries, dK/dV: keys), 16 a warp

// The other side's tile (keys for dQ, queries for dK/dV) by head width.
constexpr int other_tile(int dh) { return dh <= 32 ? 64 : 16; }

template <int DH, int BN>
constexpr int dq_smem_bytes() {
  return (2 * kOwn + 2 * 2 * BN) * (DH + kPadF32) * 4 + kOwn * (BN + kMaskPad);
}

template <int DH, int BM>
constexpr int dkv_smem_bytes() {
  return (2 * kOwn + 2 * 2 * BM) * (DH + kPadF32) * 4 + 2 * BM * 4 + BM * (kOwn + kMaskPad);
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v, const int8_t* __restrict__ mask,
                                      const float* __restrict__ dout, const float* __restrict__ lse,
                                      const float* __restrict__ delta, float* __restrict__ dq, int n,
                                      int heads, float scale) {
  constexpr int kLd = DH + kPadF32;
  constexpr int kMaskLd = BN + kMaskPad;
  constexpr int kNT = BN / 8;  // 8-key n-tiles of S and dP, and k-steps of dQ += dS·K
  constexpr int kDT = DH / 8;  // 8-column n-tiles of dQ, and k-steps of S and dP
  static_assert(DH % 8 == 0 && BN % 8 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                        // [kOwn][kLd]
  float* do_s = q_s + kOwn * kLd;                                     // [kOwn][kLd]
  float* kv_s = do_s + kOwn * kLd;                                    // [2 stages][K, V][BN][kLd]
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

  load_rows_f32<DH, kLd, kOwn, kThreads>(q_s, q, base, node_stride, q0, n);
  load_rows_f32<DH, kLd, kOwn, kThreads>(do_s, dout, base, node_stride, q0, n);
  load_rows_f32<DH, kLd, BN, kThreads>(kv_s, k, base, node_stride, 0, n);
  load_rows_f32<DH, kLd, BN, kThreads>(kv_s + BN * kLd, v, base, node_stride, 0, n);
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
      float* next = kv_s + ((it + 1) & 1) * 2 * BN * kLd;
      load_rows_f32<DH, kLd, BN, kThreads>(next, k, base, node_stride, k0 + BN, n);
      load_rows_f32<DH, kLd, BN, kThreads>(next + BN * kLd, v, base, node_stride, k0 + BN, n);
    }
    cp_async_commit();
    for (int idx = threadIdx.x; idx < kOwn * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      const int row = q0 + r, key = k0 + c;
      m_s[r * kMaskLd + c] = (row < n && key < n) ? mask_b[(size_t)row * n + key] : (int8_t)0;
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* k_t = kv_s + (it & 1) * 2 * BN * kLd;
    const float* v_t = k_t + BN * kLd;

    // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 rows × BN keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) {
      uint32_t q_hi[4], q_lo[4], do_hi[4], do_lo[4];
      load_a_tf32<kLd>(q_hi, q_lo, q_s, warp * 16, ks * 8);
      load_a_tf32<kLd>(do_hi, do_lo, do_s, warp * 16, ks * 8);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32<kLd>(b_hi, b_lo, k_t, j * 8, ks * 8);
        mma_3xtf32(s[j], q_hi, q_lo, b_hi, b_lo);
        load_b_tf32<kLd>(b_hi, b_lo, v_t, j * 8, ks * 8);
        mma_3xtf32(dp[j], do_hi, do_lo, b_hi, b_lo);
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

    // dQ += dS·K, 8 keys a k-step, K read in the permuted k order
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      acc_to_a_tf32(s[ks], a_hi, a_lo);
#pragma unroll
      for (int nd = 0; nd < kDT; ++nd) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32_kn<kLd>(b_hi, b_lo, k_t, ks * 8, nd * 8);
        mma_3xtf32(acc[nd], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // this tile's buffers and the mask tile are free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
    float* out = dq + base + (size_t)row * node_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      *reinterpret_cast<float2*>(out + j * 8) =
          make_float2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int DH, int BM>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkv_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                       const float* __restrict__ v, const int8_t* __restrict__ mask,
                                       const float* __restrict__ dout, const float* __restrict__ lse,
                                       const float* __restrict__ delta, float* __restrict__ dk,
                                       float* __restrict__ dv, int n, int heads, float scale) {
  constexpr int kLd = DH + kPadF32;
  constexpr int kMaskLd = kOwn + kMaskPad;
  constexpr int kNT = BM / 8;  // 8-query n-tiles of Sᵀ and dPᵀ, and k-steps of dV and dK
  constexpr int kDT = DH / 8;  // 8-column n-tiles of dK and dV, and k-steps of Sᵀ and dPᵀ
  static_assert(DH % 8 == 0 && BM % 8 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);                 // [kOwn][kLd]
  float* v_s = k_s + kOwn * kLd;                               // [kOwn][kLd]
  float* qd_s = v_s + kOwn * kLd;                              // [2 stages][Q, dO][BM][kLd]
  float* l_s = qd_s + 2 * 2 * BM * kLd;                        // [BM]
  float* d_s = l_s + BM;                                       // [BM]
  int8_t* m_s = reinterpret_cast<int8_t*>(d_s + BM);           // [BM][kMaskLd], queries × keys

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

  load_rows_f32<DH, kLd, kOwn, kThreads>(k_s, k, base, node_stride, j0, n);
  load_rows_f32<DH, kLd, kOwn, kThreads>(v_s, v, base, node_stride, j0, n);
  load_rows_f32<DH, kLd, BM, kThreads>(qd_s, q, base, node_stride, 0, n);
  load_rows_f32<DH, kLd, BM, kThreads>(qd_s + BM * kLd, dout, base, node_stride, 0, n);
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
      float* next = qd_s + ((it + 1) & 1) * 2 * BM * kLd;
      load_rows_f32<DH, kLd, BM, kThreads>(next, q, base, node_stride, i0 + BM, n);
      load_rows_f32<DH, kLd, BM, kThreads>(next + BM * kLd, dout, base, node_stride, i0 + BM, n);
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
    const float* q_t = qd_s + (it & 1) * 2 * BM * kLd;
    const float* do_t = q_t + BM * kLd;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys × BM queries
    float st[kNT][4], dpt[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) {
      uint32_t k_hi[4], k_lo[4], v_hi[4], v_lo[4];
      load_a_tf32<kLd>(k_hi, k_lo, k_s, warp * 16, ks * 8);
      load_a_tf32<kLd>(v_hi, v_lo, v_s, warp * 16, ks * 8);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32<kLd>(b_hi, b_lo, q_t, j * 8, ks * 8);
        mma_3xtf32(st[j], k_hi, k_lo, b_hi, b_lo);
        load_b_tf32<kLd>(b_hi, b_lo, do_t, j * 8, ks * 8);
        mma_3xtf32(dpt[j], v_hi, v_lo, b_hi, b_lo);
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

    // dV += Pᵀ·dO and dK += dSᵀ·Q, 8 queries a k-step, dO and Q read in the
    // permuted k order
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) {
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      acc_to_a_tf32(st[ks], p_hi, p_lo);
      acc_to_a_tf32(dpt[ks], ds_hi, ds_lo);
#pragma unroll
      for (int nd = 0; nd < kDT; ++nd) {
        uint32_t b_hi[2], b_lo[2];
        load_b_tf32_kn<kLd>(b_hi, b_lo, do_t, ks * 8, nd * 8);
        mma_3xtf32(acc_v[nd], p_hi, p_lo, b_hi, b_lo);
        load_b_tf32_kn<kLd>(b_hi, b_lo, q_t, ks * 8, nd * 8);
        mma_3xtf32(acc_k[nd], ds_hi, ds_lo, b_hi, b_lo);
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
      *reinterpret_cast<float2*>(dk + off + j * 8) =
          make_float2(acc_k[j][2 * i] * scale, acc_k[j][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + j * 8) = make_float2(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dq, int batch,
                      int n, int heads, float scale, cudaStream_t stream) {
  constexpr int kTile = other_tile(DH);
  constexpr int bytes = dq_smem_bytes<DH, kTile>();
  static const cudaError_t prepared = prepare(masked_attention_bwd_dq_tc_f32_kernel<DH, kTile>, bytes);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((n + kOwn - 1) / kOwn, heads, batch);
  masked_attention_bwd_dq_tc_f32_kernel<DH, kTile><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int8_t*>(mask), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq), n,
      heads, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int kTile = other_tile(DH);
  constexpr int bytes = dkv_smem_bytes<DH, kTile>();
  static const cudaError_t prepared = prepare(masked_attention_bwd_dkv_tc_f32_kernel<DH, kTile>, bytes);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((n + kOwn - 1) / kOwn, heads, batch);
  masked_attention_bwd_dkv_tc_f32_kernel<DH, kTile><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int8_t*>(mask), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// The same C interface as masked_attention_bwd.cu's; dtype must be 0
// (float32) and head_dim 32 or 144. Each returns the cudaError_t of its launch.
extern "C" int masked_attention_bwd_dq_tc_f32(const void* q, const void* k, const void* v,
                                              const void* mask, const void* dout, const void* lse,
                                              const void* delta, void* dq, int batch, int n,
                                              int heads, int head_dim, int dtype, float scale,
                                              void* stream) {
  if (bad_shape(batch, n, heads, dtype, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_dq<32>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  if (head_dim == 144)
    return (int)launch_dq<144>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masked_attention_bwd_dkv_tc_f32(const void* q, const void* k, const void* v,
                                               const void* mask, const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int batch,
                                               int n, int heads, int head_dim, int dtype,
                                               float scale, void* stream) {
  if (bad_shape(batch, n, heads, dtype, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return (int)launch_dkv<32>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads, scale,
                               st);
  if (head_dim == 144)
    return (int)launch_dkv<144>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads, scale,
                                st);
  return (int)cudaErrorInvalidValue;
}
