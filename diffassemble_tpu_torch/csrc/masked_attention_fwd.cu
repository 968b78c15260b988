// Fused masked multi-head graph attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of
// the JAX package's ops/pallas_attention.py (launched by `_flash_fwd`). It
// computes the same function, not a block-by-block copy:
//
//   S   = q·kᵀ/√Dh in f32, masked entries set to −1e9
//   m   = max_j S_ij,  denom = Σ_j exp(S_ij − m)·mask_ij
//   O_i = Σ_j exp(S_ij − m)·mask_ij·v_j / max(denom, 1e−30)
//   L_i = m + log(max(denom, 1e−30))            (consumed by a later backward)
//
// Masked entries contribute exactly 0 (they are never exponentiated), and a
// row with no edges gives O = 0 and L = −1e9 + log(1e−30), as in JAX.
//
// Layout: q, k, v and O are (B, N, H, Dh) contiguous — the port's public
// layout, read as it is, with no permute or padding copy; mask is (B, N, N)
// int8 (or bool bytes) shared across heads; L is (B, H, N) f32. The ragged
// last tile along N is masked in the kernel.
//
// What bounds it on an H100: at the serving shapes (B = 1, H = 8, N = 908,
// Dh = 32 / 144, bf16) the function does 4·B·H·N²·Dh operations against
// about 2 bytes·4·B·N·H·Dh + B·N² bytes of traffic, i.e. 315 (Dh = 32) to
// 413 (Dh = 144) operations per byte, above the card's ~295 bf16 ridge: the
// bound is the tensor-core rate.
// This first design is the simple, correct one: it runs the two products on
// the CUDA cores in f32 (no wgmma/TMA yet), so it sits well above that bound;
// making it fast is later work. What the design does: one block per
// (16-row query tile, head, batch); K/V tiles of 32 keys are staged in shared
// memory as f32, each warp owns 4 query rows, each lane one key of the tile
// for the scores and a 32-column slice of the head width for the output, and
// an online softmax over the key tiles keeps the (N, N) scores out of device
// memory. At Dh = 144 the head width is split across the lanes (5 slots of
// 32 columns, the last half used), so each thread holds 4×5 accumulators and
// register pressure stays low; shared memory is 46,208 bytes per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per staged tile (= warp size)
constexpr float kNegInf = -1e9f;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
masked_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int8_t* __restrict__ mask,
                            T* __restrict__ o, float* __restrict__ lse, int n, int heads,
                            float scale) {
  constexpr int kSlots = (DH + 31) / 32;  // 32-column slices of the head width per lane
  __shared__ float q_s[kBlockQ][DH];
  __shared__ float k_s[kBlockK][DH + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float v_s[kBlockK][DH];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t node_stride = (size_t)heads * DH;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * DH;
  const int8_t* mask_b = mask + (size_t)b * n * n;

  for (int idx = tid; idx < kBlockQ * DH; idx += kWarps * 32) {
    const int r = idx / DH, d = idx % DH;
    const int row = q0 + r;
    q_s[r][d] = row < n ? to_f32(q[base + (size_t)row * node_stride + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;  // the max over masked entries alone, as in JAX
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kBlockK * DH; idx += kWarps * 32) {
      const int j = idx / DH, d = idx % DH;
      const int key = k0 + j;
      const size_t off = base + (size_t)key * node_stride + d;
      k_s[j][d] = key < n ? to_f32(k[off]) : 0.f;
      v_s[j][d] = key < n ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(q_s[warp * kRowsPerWarp + r][d], kd, s[r]);
    }

    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + warp * kRowsPerWarp + r;
      const bool edge = row < n && key < n && mask_b[(size_t)row * n + key] != 0;
      const float sc = s[r] * scale;
      const float m_new = fmaxf(m[r], warp_max(edge ? sc : kNegInf));
      const float alpha = expf(m[r] - m_new);
      p[r] = edge ? expf(sc - m_new) : 0.f;  // a masked entry is never exponentiated
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int c = 0; c < kSlots; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }

    // acc += P·V over the tile: lane owns columns lane, lane+32, ...
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kSlots];
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < DH ? v_s[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFullMask, p[r], j);
#pragma unroll
        for (int c = 0; c < kSlots; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= n) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) o[base + (size_t)row * node_stride + d] = from_f32<T>(acc[r][c] / denom);
    }
    if (lane == 0) lse[((size_t)b * heads + h) * n + row] = m[r] + logf(denom);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
            int batch, int n, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  masked_attention_fwd_kernel<T, DH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse), n, heads,
      scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                    void* o, void* lse, int batch, int n, int heads, int head_dim,
                                    int dtype, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32) {
    launch<float, 32>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
  } else if (dtype == 0 && head_dim == 144) {
    launch<float, 144>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
  } else if (dtype == 1 && head_dim == 32) {
    launch<__nv_bfloat16, 32>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
  } else if (dtype == 1 && head_dim == 144) {
    launch<__nv_bfloat16, 144>(q, k, v, mask, o, lse, batch, n, heads, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
