// Fused masked multi-head graph attention, backward, for Hopper (sm_90a).
//
// Two kernels, each replacing one TPU kernel of the JAX package's
// ops/pallas_attention.py (both launched by `_flash_bwd`):
//
//   masked_attention_bwd_dq   replaces `_bwd_dq_kernel`:
//     P   = exp(q·kᵀ/√Dh − L) on edges, 0 elsewhere
//     dQ  = (P ∘ (dO·vᵀ − Δ))·k/√Dh
//   masked_attention_bwd_dkv  replaces `_bwd_dkv_kernel`:
//     dV  = Pᵀ·dO
//     dK  = (P ∘ (dO·vᵀ − Δ))ᵀ·q/√Dh
//
// with L the forward's per-row log-sum-exp (masked_attention_fwd.cu) and
// Δ = rowsum(dO ∘ O), computed by the caller in f32. They compute the same
// functions as the TPU kernels, not a block-by-block copy: the dQ kernel
// takes P from L instead of recomputing the row max and denominator (the
// same P; the TPU kernel recomputed because it had no L in hand), and the
// dK/dV kernel reads the untransposed mask, so no transposed copy is made.
//
// A masked entry is never exponentiated and contributes exactly 0: a query
// row with no edges gets dQ = 0, a key that no query attends gets dK = dV = 0,
// and nothing is NaN. The outputs are written in the input's type; every sum
// runs in f32. Each kernel owns its outputs (dQ by query rows, dK and dV by
// key rows), so there are no atomics and the results are deterministic.
//
// Layout: q, k, v, dO, dQ, dK and dV are (B, N, H, Dh) contiguous, the
// port's public layout, read as they are; L and Δ are (B, H, N) f32; the mask
// is (B, N, N) int8 (or bool bytes) shared across heads. The ragged last
// tile along N is masked in the kernel.
//
// What bounds them on an H100: at the training shapes (B = 8, H = 8,
// N = 908, Dh = 32 / 144, bf16) the dQ kernel does 6·B·H·N²·Dh operations
// (about 10.1 GFLOP at Dh = 32) and the dK/dV kernel 8·B·H·N²·Dh (about
// 13.5 GFLOP), against some 2 bytes·B·N·H·Dh per tensor plus B·N² mask bytes:
// hundreds of operations per byte, far above the card's ~295 bf16 ridge, so
// the bound is the tensor-core rate. These kernels are the CUDA-core route:
// their products run on the CUDA cores in f32. They serve the calls, in
// either type, at the head widths that the tensor-core kernels
// (masked_attention_bwd_tc.cu in bf16, masked_attention_bwd_tc_f32.cu in
// float32) are not instantiated for, and inputs off a 16-byte boundary, on
// graphs of more than 32 nodes (masked_attention_bwd_small.cu takes the
// smaller ones). What the design
// does: one block of 4 warps per (16-row tile, head, batch) of the rows it
// owns, a loop over 32-row tiles of the other side staged in shared memory
// as f32 (+1 column of padding, so lane j reads row j without bank
// conflicts), each warp owning 4 rows and each lane one row of the staged
// tile for the scores, then 32-column slices of the head width for the
// outputs. The kernels are templated on the number of 32-column slots a
// lane holds (1 to 9) and take the head width at run time, so every width
// from 1 to 288 runs; the last slot is partly idle when the width is not a
// multiple of 32. The main path's widths, 32 and 144, are also instantiated
// with the width fixed at compile time: a run-time width cost them 12-27%
// (PERF.md §6). Shared memory (dynamic) is sized from the width: 12.5 KB at
// Dh 32, 56 KB at Dh 144, 109 KB at Dh 288.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockOwn = kWarps * kRowsPerWarp;  // rows a block owns (dQ: queries, dK/dV: keys)
constexpr int kBlockOther = 32;                   // rows of the other side per staged tile (= warp size)
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + rows) of one head of a (B, N, H, dh) tensor into f32
// shared memory with row stride `ld`; rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           size_t base, size_t node_stride, int row0, int rows,
                                           int n, int dh) {
  for (int idx = threadIdx.x; idx < rows * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh;
    const int row = row0 + r;
    dst[r * ld + d] = row < n ? to_f32(src[base + (size_t)row * node_stride + d]) : 0.f;
  }
}

constexpr int dq_smem_bytes(int dh) {
  return (2 * kBlockOwn * dh + 2 * kBlockOther * (dh + 1)) * (int)sizeof(float);
}

constexpr int dkv_smem_bytes(int dh) {
  return dq_smem_bytes(dh) + 2 * kBlockOther * (int)sizeof(float) + kBlockOther * kBlockOwn;
}

// DH > 0 fixes the head width at compile time (the main path's 32 and 144);
// DH = 0 takes it at run time from `head_dim`.
template <typename T, int SLOTS, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int8_t* __restrict__ mask,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dq, int n,
                               int heads, int head_dim, float scale) {
  constexpr int kSlots = SLOTS;
  const int dh = DH > 0 ? DH : head_dim;
  const int ld = dh + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBlockOwn][dh]
  float* do_s = q_s + kBlockOwn * dh;         // [kBlockOwn][dh]
  float* k_s = do_s + kBlockOwn * dh;         // [kBlockOther][ld]
  float* v_s = k_s + kBlockOther * ld;       // [kBlockOther][ld]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kBlockOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * dh;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * dh;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const float* lse_bh = lse + ((size_t)b * heads + h) * n;
  const float* delta_bh = delta + ((size_t)b * heads + h) * n;

  stage_rows<T>(q_s, dh, q, base, node_stride, q0, kBlockOwn, n, dh);
  stage_rows<T>(do_s, dh, dout, base, node_stride, q0, kBlockOwn, n, dh);

  float l_row[kRowsPerWarp], d_row[kRowsPerWarp], acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    l_row[r] = row < n ? lse_bh[row] : 0.f;
    d_row[r] = row < n ? delta_bh[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockOther) {
    __syncthreads();  // the previous tile has been consumed (and q_s, do_s are staged)
    stage_rows<T>(k_s, ld, k, base, node_stride, k0, kBlockOther, n, dh);
    stage_rows<T>(v_s, ld, v, base, node_stride, k0, kBlockOther, n, dh);
    __syncthreads();

    // scores and dP of this warp's rows against key k0 + lane
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) {
      const float kd = k_s[lane * ld + d];
      const float vd = v_s[lane * ld + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        s[r] = fmaf(q_s[row * dh + d], kd, s[r]);
        dp[r] = fmaf(do_s[row * dh + d], vd, dp[r]);
      }
    }

    const int key = k0 + lane;
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + warp * kRowsPerWarp + r;
      const bool edge = row < n && key < n && mask_b[(size_t)row * n + key] != 0;
      // a masked entry is never exponentiated
      ds[r] = edge ? expf(s[r] * scale - l_row[r]) * (dp[r] - d_row[r]) : 0.f;
    }

    // acc += dS·K over the tile: lane owns columns lane, lane+32, ...
#pragma unroll 4
    for (int j = 0; j < kBlockOther; ++j) {
      float kj[kSlots];
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int d = lane + 32 * c;
        kj[c] = d < dh ? k_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFullMask, ds[r], j);
#pragma unroll
        for (int c = 0; c < kSlots; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) dq[base + (size_t)row * node_stride + d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int SLOTS, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int8_t* __restrict__ mask,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk,
                                T* __restrict__ dv, int n, int heads, int head_dim, float scale) {
  constexpr int kSlots = SLOTS;
  const int dh = DH > 0 ? DH : head_dim;
  const int ld = dh + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                               // [kBlockOwn][dh]
  float* v_s = k_s + kBlockOwn * dh;               // [kBlockOwn][dh]
  float* q_s = v_s + kBlockOwn * dh;               // [kBlockOther][ld]
  float* do_s = q_s + kBlockOther * ld;           // [kBlockOther][ld]
  float* l_s = do_s + kBlockOther * ld;           // [kBlockOther]
  float* d_s = l_s + kBlockOther;                  // [kBlockOther]
  int8_t* m_s = reinterpret_cast<int8_t*>(d_s + kBlockOther);  // [kBlockOther][kBlockOwn]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kBlockOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * dh;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * dh;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const float* lse_bh = lse + ((size_t)b * heads + h) * n;
  const float* delta_bh = delta + ((size_t)b * heads + h) * n;

  stage_rows<T>(k_s, dh, k, base, node_stride, j0, kBlockOwn, n, dh);
  stage_rows<T>(v_s, dh, v, base, node_stride, j0, kBlockOwn, n, dh);

  float acc_k[kRowsPerWarp][kSlots], acc_v[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kBlockOther) {
    __syncthreads();  // the previous tile has been consumed (and k_s, v_s are staged)
    stage_rows<T>(q_s, ld, q, base, node_stride, i0, kBlockOther, n, dh);
    stage_rows<T>(do_s, ld, dout, base, node_stride, i0, kBlockOther, n, dh);
    if (threadIdx.x < kBlockOther) {
      const int row = i0 + threadIdx.x;
      l_s[threadIdx.x] = row < n ? lse_bh[row] : 0.f;
      d_s[threadIdx.x] = row < n ? delta_bh[row] : 0.f;
    }
    // the (query tile × key tile) block of the untransposed mask, read along keys
    for (int idx = threadIdx.x; idx < kBlockOther * kBlockOwn; idx += kThreads) {
      const int i = idx / kBlockOwn, jj = idx % kBlockOwn;
      const int row = i0 + i, key = j0 + jj;
      m_s[idx] = (row < n && key < n) ? mask_b[(size_t)row * n + key] : (int8_t)0;
    }
    __syncthreads();

    // scores and dPᵀ of this warp's keys against query i0 + lane
    float s[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dpt[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) {
      const float qd = q_s[lane * ld + d];
      const float dod = do_s[lane * ld + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int own = warp * kRowsPerWarp + r;
        s[r] = fmaf(k_s[own * dh + d], qd, s[r]);
        dpt[r] = fmaf(v_s[own * dh + d], dod, dpt[r]);
      }
    }

    const float l_i = l_s[lane], d_i = d_s[lane];
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool edge = m_s[lane * kBlockOwn + warp * kRowsPerWarp + r] != 0;
      // a masked entry (and a query or key past n) is never exponentiated
      p[r] = edge ? expf(s[r] * scale - l_i) : 0.f;
      ds[r] = p[r] * (dpt[r] - d_i);
    }

    // acc_v += Pᵀ·dO, acc_k += dSᵀ·Q over the tile: lane owns columns lane, lane+32, ...
#pragma unroll 4
    for (int i = 0; i < kBlockOther; ++i) {
      float qi[kSlots], doi[kSlots];
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int d = lane + 32 * c;
        qi[c] = d < dh ? q_s[i * ld + d] : 0.f;
        doi[c] = d < dh ? do_s[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pi = __shfl_sync(kFullMask, p[r], i);
        const float dsi = __shfl_sync(kFullMask, ds[r], i);
#pragma unroll
        for (int c = 0; c < kSlots; ++c) {
          acc_v[r][c] = fmaf(pi, doi[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsi, qi[c], acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = j0 + warp * kRowsPerWarp + r;
    if (key >= n) continue;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        const size_t off = base + (size_t)key * node_stride + d;
        dk[off] = from_f32<T>(acc_k[r][c] * scale);
        dv[off] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

// Dynamic shared memory above 48 KB has to be opted into once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int SLOTS, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dq, int batch,
                      int n, int heads, int dh, float scale, cudaStream_t stream) {
  // opted into once, for the widest head this instantiation takes
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dq_kernel<T, SLOTS, DH>,
                                              dq_smem_bytes(DH > 0 ? DH : 32 * SLOTS));
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kBlockOwn - 1) / kBlockOwn, heads, batch);
  masked_attention_bwd_dq_kernel<T, SLOTS, DH><<<grid, kThreads, dq_smem_bytes(dh), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), n,
      heads, dh, scale);
  return cudaGetLastError();
}

template <typename T, int SLOTS, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int n, int heads, int dh, float scale, cudaStream_t stream) {
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dkv_kernel<T, SLOTS, DH>,
                                              dkv_smem_bytes(DH > 0 ? DH : 32 * SLOTS));
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kBlockOwn - 1) / kBlockOwn, heads, batch);
  masked_attention_bwd_dkv_kernel<T, SLOTS, DH><<<grid, kThreads, dkv_smem_bytes(dh), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), n, heads, dh, scale);
  return cudaGetLastError();
}

constexpr int kMaxSlots = 9;  // head widths up to 9 · 32 = 288

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return batch <= 0 || n <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || head_dim <= 0 ||
         head_dim > 32 * kMaxSlots;
}

// The main path's widths compiled in; any other width by its number of slots.
#define BWD_DISPATCH(LAUNCH, ...)                                                     \
  if (head_dim == 32) return (int)LAUNCH<T, 1, 32>(__VA_ARGS__);                     \
  if (head_dim == 144) return (int)LAUNCH<T, 5, 144>(__VA_ARGS__);                   \
  switch ((head_dim + 31) / 32) {                                                    \
    case 1: return (int)LAUNCH<T, 1, 0>(__VA_ARGS__);                                \
    case 2: return (int)LAUNCH<T, 2, 0>(__VA_ARGS__);                                \
    case 3: return (int)LAUNCH<T, 3, 0>(__VA_ARGS__);                                \
    case 4: return (int)LAUNCH<T, 4, 0>(__VA_ARGS__);                                \
    case 5: return (int)LAUNCH<T, 5, 0>(__VA_ARGS__);                                \
    case 6: return (int)LAUNCH<T, 6, 0>(__VA_ARGS__);                                \
    case 7: return (int)LAUNCH<T, 7, 0>(__VA_ARGS__);                                \
    case 8: return (int)LAUNCH<T, 8, 0>(__VA_ARGS__);                                \
    case 9: return (int)LAUNCH<T, 9, 0>(__VA_ARGS__);                                \
    default: return (int)cudaErrorInvalidValue;                                      \
  }

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                const void* lse, const void* delta, void* dq, int batch, int n, int heads,
                int head_dim, float scale, cudaStream_t st) {
  BWD_DISPATCH(launch_dq, q, k, v, mask, dout, lse, delta, dq, batch, n, heads, head_dim, scale, st)
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* mask, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, int batch, int n,
                 int heads, int head_dim, float scale, cudaStream_t st) {
  BWD_DISPATCH(launch_dkv, q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads, head_dim,
               scale, st)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 1 to 288. Each returns the
// cudaError_t of its launch.
extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dq, int batch, int n, int heads,
                                       int head_dim, int dtype, float scale, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, head_dim,
                              scale, st);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads,
                                      head_dim, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masked_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* mask, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int batch, int n,
                                        int heads, int head_dim, int dtype, float scale,
                                        void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads,
                               head_dim, scale, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads,
                                       head_dim, scale, st);
  return (int)cudaErrorInvalidValue;
}
