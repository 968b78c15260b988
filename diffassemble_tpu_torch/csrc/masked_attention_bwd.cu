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
// the bound is the tensor-core rate. This first design is the simple, correct
// one: its products run on the CUDA cores in f32 (no wgmma/TMA yet), so it
// sits well above that bound; making it fast is later work. What the design
// does: one block of 4 warps per (16-row tile, head, batch) of the rows it
// owns, a loop over 32-row tiles of the other side staged in shared memory
// as f32 (+1 column of padding, so lane j reads row j without bank
// conflicts), each warp owning 4 rows and each lane one row of the staged
// tile for the scores, then a 32-column slice of the head width for the
// outputs. At Dh = 144 the head width is split across the lanes as the
// forward does (5 slots of 32 columns, the last half used). Shared memory is
// 12.5 KB (Dh 32) to 56 KB (Dh 144) a block, taken as dynamic shared memory.

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

// Rows [row0, row0 + rows) of one head of a (B, N, H, DH) tensor into f32
// shared memory with row stride `ld`; rows past n are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           size_t base, size_t node_stride, int row0, int rows,
                                           int n) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int row = row0 + r;
    dst[r * ld + d] = row < n ? to_f32(src[base + (size_t)row * node_stride + d]) : 0.f;
  }
}

template <int DH>
constexpr int dq_smem_bytes() {
  return (2 * kBlockOwn * DH + 2 * kBlockOther * (DH + 1)) * (int)sizeof(float);
}

template <int DH>
constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<DH>() + 2 * kBlockOther * (int)sizeof(float) + kBlockOther * kBlockOwn;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int8_t* __restrict__ mask,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dq, int n,
                               int heads, float scale) {
  constexpr int kSlots = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBlockOwn][DH]
  float* do_s = q_s + kBlockOwn * DH;         // [kBlockOwn][DH]
  float* k_s = do_s + kBlockOwn * DH;         // [kBlockOther][kLd]
  float* v_s = k_s + kBlockOther * kLd;       // [kBlockOther][kLd]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kBlockOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const float* lse_bh = lse + ((size_t)b * heads + h) * n;
  const float* delta_bh = delta + ((size_t)b * heads + h) * n;

  stage_rows<T, DH>(q_s, DH, q, base, node_stride, q0, kBlockOwn, n);
  stage_rows<T, DH>(do_s, DH, dout, base, node_stride, q0, kBlockOwn, n);

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
    stage_rows<T, DH>(k_s, kLd, k, base, node_stride, k0, kBlockOther, n);
    stage_rows<T, DH>(v_s, kLd, v, base, node_stride, k0, kBlockOther, n);
    __syncthreads();

    // scores and dP of this warp's rows against key k0 + lane
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = k_s[lane * kLd + d];
      const float vd = v_s[lane * kLd + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        s[r] = fmaf(q_s[row * DH + d], kd, s[r]);
        dp[r] = fmaf(do_s[row * DH + d], vd, dp[r]);
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
        kj[c] = d < DH ? k_s[j * kLd + d] : 0.f;
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
      if (d < DH) dq[base + (size_t)row * node_stride + d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int8_t* __restrict__ mask,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk,
                                T* __restrict__ dv, int n, int heads, float scale) {
  constexpr int kSlots = (DH + 31) / 32;
  constexpr int kLd = DH + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                               // [kBlockOwn][DH]
  float* v_s = k_s + kBlockOwn * DH;               // [kBlockOwn][DH]
  float* q_s = v_s + kBlockOwn * DH;               // [kBlockOther][kLd]
  float* do_s = q_s + kBlockOther * kLd;           // [kBlockOther][kLd]
  float* l_s = do_s + kBlockOther * kLd;           // [kBlockOther]
  float* d_s = l_s + kBlockOther;                  // [kBlockOther]
  int8_t* m_s = reinterpret_cast<int8_t*>(d_s + kBlockOther);  // [kBlockOther][kBlockOwn]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kBlockOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const float* lse_bh = lse + ((size_t)b * heads + h) * n;
  const float* delta_bh = delta + ((size_t)b * heads + h) * n;

  stage_rows<T, DH>(k_s, DH, k, base, node_stride, j0, kBlockOwn, n);
  stage_rows<T, DH>(v_s, DH, v, base, node_stride, j0, kBlockOwn, n);

  float acc_k[kRowsPerWarp][kSlots], acc_v[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kBlockOther) {
    __syncthreads();  // the previous tile has been consumed (and k_s, v_s are staged)
    stage_rows<T, DH>(q_s, kLd, q, base, node_stride, i0, kBlockOther, n);
    stage_rows<T, DH>(do_s, kLd, dout, base, node_stride, i0, kBlockOther, n);
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
    for (int d = 0; d < DH; ++d) {
      const float qd = q_s[lane * kLd + d];
      const float dod = do_s[lane * kLd + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int own = warp * kRowsPerWarp + r;
        s[r] = fmaf(k_s[own * DH + d], qd, s[r]);
        dpt[r] = fmaf(v_s[own * DH + d], dod, dpt[r]);
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
        qi[c] = d < DH ? q_s[i * kLd + d] : 0.f;
        doi[c] = d < DH ? do_s[i * kLd + d] : 0.f;
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
      if (d < DH) {
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

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dq, int batch,
                      int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<DH>();
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dq_kernel<T, DH>, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kBlockOwn - 1) / kBlockOwn, heads, batch);
  masked_attention_bwd_dq_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), n,
      heads, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<DH>();
  static const cudaError_t opted = allow_smem(masked_attention_bwd_dkv_kernel<T, DH>, bytes);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((n + kBlockOwn - 1) / kBlockOwn, heads, batch);
  masked_attention_bwd_dkv_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), n, heads, scale);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n, int heads) {
  return batch <= 0 || n <= 0 || heads <= 0 || batch > 65535 || heads > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
extern "C" int masked_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dq, int batch, int n, int heads,
                                       int head_dim, int dtype, float scale, void* stream) {
  if (bad_shape(batch, n, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return (int)launch_dq<float, 32>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  if (dtype == 0 && head_dim == 144)
    return (int)launch_dq<float, 144>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads, scale, st);
  if (dtype == 1 && head_dim == 32)
    return (int)launch_dq<__nv_bfloat16, 32>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads,
                                             scale, st);
  if (dtype == 1 && head_dim == 144)
    return (int)launch_dq<__nv_bfloat16, 144>(q, k, v, mask, dout, lse, delta, dq, batch, n, heads,
                                              scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int masked_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* mask, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int batch, int n,
                                        int heads, int head_dim, int dtype, float scale,
                                        void* stream) {
  if (bad_shape(batch, n, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return (int)launch_dkv<float, 32>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads,
                                      scale, st);
  if (dtype == 0 && head_dim == 144)
    return (int)launch_dkv<float, 144>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n, heads,
                                       scale, st);
  if (dtype == 1 && head_dim == 32)
    return (int)launch_dkv<__nv_bfloat16, 32>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n,
                                              heads, scale, st);
  if (dtype == 1 && head_dim == 144)
    return (int)launch_dkv<__nv_bfloat16, 144>(q, k, v, mask, dout, lse, delta, dk, dv, batch, n,
                                               heads, scale, st);
  return (int)cudaErrorInvalidValue;
}
