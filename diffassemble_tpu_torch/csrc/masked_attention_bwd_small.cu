// Fused masked multi-head graph attention, backward, for small graphs
// (N <= 32 nodes), for Hopper (sm_90a).
//
// One kernel replacing both backward TPU kernels of the JAX package's
// ops/pallas_attention.py (`_bwd_dq_kernel` and `_bwd_dkv_kernel`, launched
// by `_flash_bwd`) where a graph has at most 32 nodes, as the 3D family's do
// (one node a part: N = 8 and 20):
//
//   masked_attention_bwd_small:
//     Δ   = rowsum(dO ∘ O)                      (in f32, in the block)
//     P   = exp(q·kᵀ/√Dh − L) on edges, 0 elsewhere
//     dS  = P ∘ (dO·vᵀ − Δ)
//     dQ  = dS·k/√Dh,   dK = dSᵀ·q/√Dh,   dV = Pᵀ·dO
//
// with L the forward's per-row log-sum-exp. It computes the same functions
// as the two TPU kernels (and as masked_attention_bwd.cu's pair with the
// caller's Δ), not a block-by-block copy: P and dS are computed once for all
// three outputs, and Δ is computed in the block, so the caller launches
// nothing before it.
//
// A masked entry is never exponentiated and contributes exactly 0: a query
// row with no edges gets dQ = 0, a key that no query attends gets dK = dV = 0,
// and nothing is NaN. Every sum runs in f32 in a fixed order; each output
// element is written by one thread, so there are no atomics and the results
// are deterministic. The outputs are written in the input's type.
//
// Layout: q, k, v, dO, O, dQ, dK and dV are (B, N, H, Dh) contiguous, the
// port's public layout, read as they are; L is (B, H, N) f32; the mask is
// (B, N, N) int8 (or bool bytes) shared across heads. Widths 1 to 288, f32
// and bf16, any 2-byte alignment (odd widths put bf16 rows off 4-byte
// boundaries, so every global access is one element).
//
// What bounds it on an H100: nothing the card's peaks describe. A head's
// work at N = 20 and Dh 271 is about 0.2 MFLOP over ~87 KB; the whole launch
// at B = 16, H = 8 moves ~11 MB, ~3.3 µs at 3.35 TB/s, and its operations
// are ~0.1 µs on the CUDA cores. What held the CUDA-core pair back at these
// sizes was latency: lanes and rows idle in 32-row tiles, dot products that
// were one lane's serial chain over the whole head width, S, P and dP
// computed twice, and Δ's launches before them. This design aims at
// latency:
//   - one block of 16 warps per (head, batch) holds the head's whole graph:
//     q, k, v and dO of all N rows staged once as f32 in shared memory
//     (rows past N zero), O read once from device memory for Δ; sized from N
//     and Dh at launch (161 KB at N = 32, Dh 288; 92 KB at N = 20, Dh 271),
//     above 48 KB by opting in;
//   - short chains: lanes split the head width (lane l takes columns l,
//     l + 32, ...) for Δ, S and dP, each finished by a 5-step shuffle
//     reduction: depth ~Dh/32 + 5 instead of Dh;
//   - only the attended rectangle: the block finds the last query row with
//     an edge and the last attended key (the 3D graphs put their padding
//     parts last) and computes S and dP for the attended pairs inside it,
//     a warp a pair; rows past it are written as zeros;
//   - P and dS once, in three N×N f32 tiles (dS, dSᵀ and Pᵀ, zero off the
//     edges), whose rows the output products read as float4 broadcasts;
//   - the outputs by (output, 4 rows, 32 columns) items, a warp each: a lane
//     sums 4 rows of one column over the attended extent, reading each row
//     of k, q or dO once for 4 outputs.
// Every access to a staged row walks 32 consecutive columns of one row and
// every tile read is a broadcast, so no row needs padding against bank
// conflicts. No tensor cores, on purpose: the graph is smaller than one
// mma.sync/wgmma tile (wgmma takes 64 rows, these graphs have at most 32),
// and the f32 route must hold its 1e-5 gate, which a bf16 or TF32 product
// would not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNodes = 32;
constexpr int kMaxHeadDim = 288;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // output rows a lane sums together
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// three (r4 × r4) tiles, four (r4 × dh) staged matrices, L and Δ, the
// warps' extents, then the mask's bytes; r4 = N rounded up to 4
int smem_bytes(int n, int dh) {
  const int r4 = round4(n);
  return (3 * r4 * r4 + 4 * r4 * dh + 2 * r4 + 2 * kWarps) * (int)sizeof(float) + n * n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const int8_t* __restrict__ mask,
                                  const T* __restrict__ dout, const T* __restrict__ o,
                                  const float* __restrict__ lse, T* __restrict__ dq,
                                  T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                                  int dh, float scale) {
  const int r4 = round4(n);  // rows of every staged matrix and tile, zero past n
  extern __shared__ float4 smem4[];  // 16-byte aligned: the tiles are read as float4
  float* ds_s = reinterpret_cast<float*>(smem4);  // [r4][r4] dS: query rows, key columns
  float* dst_s = ds_s + r4 * r4;                  // [r4][r4] dSᵀ: key rows, query columns
  float* pt_s = dst_s + r4 * r4;                  // [r4][r4] Pᵀ
  float* q_s = pt_s + r4 * r4;                    // [r4][dh]
  float* k_s = q_s + r4 * dh;                     // [r4][dh]
  float* v_s = k_s + r4 * dh;                     // [r4][dh]
  float* do_s = v_s + r4 * dh;                    // [r4][dh]
  float* l_s = do_s + r4 * dh;                    // [r4] L
  float* d_s = l_s + r4;                          // [r4] Δ
  int* ext_s = reinterpret_cast<int*>(d_s + r4);  // [2][kWarps] each warp's extents
  int8_t* m_s = reinterpret_cast<int8_t*>(ext_s + 2 * kWarps);  // [n][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t node_stride = (size_t)heads * dh;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * dh;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  const float* lse_bh = lse + ((size_t)b * heads + h) * n;

  // 1. Stage q, k, v and dO, a warp a row, and Δ of the row on the way.
  for (int r = warp; r < r4; r += kWarps) {
    float delta = 0.f;
    if (r < n) {
      const size_t off = base + (size_t)r * node_stride;
      for (int d = lane; d < dh; d += 32) {
        q_s[r * dh + d] = to_f32(q[off + d]);
        k_s[r * dh + d] = to_f32(k[off + d]);
        v_s[r * dh + d] = to_f32(v[off + d]);
        const float g = to_f32(dout[off + d]);
        do_s[r * dh + d] = g;
        delta = fmaf(g, to_f32(o[off + d]), delta);
      }
    } else {
      for (int d = lane; d < dh; d += 32)
        q_s[r * dh + d] = k_s[r * dh + d] = v_s[r * dh + d] = do_s[r * dh + d] = 0.f;
    }
    delta = warp_sum(delta);
    if (lane == 0) {
      d_s[r] = delta;
      l_s[r] = r < n ? lse_bh[r] : 0.f;
    }
  }
  // the tiles start at 0: their entries off the edges stay exactly 0
  for (int idx = tid; idx < 3 * r4 * r4; idx += kThreads) ds_s[idx] = 0.f;
  // the mask, and the attended rectangle: 1 + the last query row with an
  // edge, 1 + the last key a query attends
  int qm = 0, km = 0;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int8_t m = mask_b[idx];
    m_s[idx] = m;
    if (m != 0) {
      qm = max(qm, idx / n + 1);
      km = max(km, idx % n + 1);
    }
  }
  qm = __reduce_max_sync(kFullMask, qm);
  km = __reduce_max_sync(kFullMask, km);
  if (lane == 0) {
    ext_s[warp] = qm;
    ext_s[kWarps + warp] = km;
  }
  __syncthreads();
  int qmax = 0, kmax = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qmax = max(qmax, ext_s[w]);
    kmax = max(kmax, ext_s[kWarps + w]);
  }

  // 2. P and dS of each attended pair, a warp a pair.
  const int pairs = qmax * kmax;
  for (int p = warp; p < pairs; p += kWarps) {
    const int i = p / kmax, j = p - i * kmax;
    if (m_s[i * n + j] == 0) continue;  // the whole warp's pair: a masked entry is never exponentiated
    const float* qi = q_s + i * dh;
    const float* kj = k_s + j * dh;
    const float* gi = do_s + i * dh;
    const float* vj = v_s + j * dh;
    float s = 0.f, dp = 0.f;
#pragma unroll 3
    for (int d = lane; d < dh; d += 32) {
      s = fmaf(qi[d], kj[d], s);
      dp = fmaf(gi[d], vj[d], dp);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    if (lane == 0) {
      const float pij = expf(s * scale - l_s[i]);
      const float dsij = pij * (dp - d_s[i]);
      ds_s[i * r4 + j] = dsij;
      dst_s[j * r4 + i] = dsij;
      pt_s[j * r4 + i] = pij;
    }
  }
  __syncthreads();

  // 3. dQ = dS·k/√Dh, dK = dSᵀ·q/√Dh and dV = Pᵀ·dO over the attended
  // rectangle, a warp an (output, 4 rows, 32 columns) item.
  const int chunks = (dh + 31) / 32;
  const int gq = (qmax + kRows - 1) / kRows;  // row groups of dQ
  const int gk = (kmax + kRows - 1) / kRows;  // row groups of dK and of dV
  const int items = (gq + 2 * gk) * chunks;
  for (int item = warp; item < items; item += kWarps) {
    int g = item / chunks;
    const int d = (item - g * chunks) * 32 + lane;
    const float* coef;
    const float* src;
    T* dst;
    int terms;
    float sc;
    if (g < gq) {
      coef = ds_s, src = k_s, dst = dq, terms = kmax, sc = scale;
    } else if ((g -= gq) < gk) {
      coef = dst_s, src = q_s, dst = dk, terms = qmax, sc = scale;
    } else {
      g -= gk;
      coef = pt_s, src = do_s, dst = dv, terms = qmax, sc = 1.f;
    }
    if (d >= dh) continue;
    const int row0 = g * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int t = 0; t < terms; t += 4) {  // rows past terms are zero in the tile
      const float b0 = src[(t + 0) * dh + d];
      const float b1 = src[(t + 1) * dh + d];
      const float b2 = src[(t + 2) * dh + d];
      const float b3 = src[(t + 3) * dh + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(coef + (row0 + r) * r4 + t);
        acc[r] = fmaf(a.x, b0, acc[r]);
        acc[r] = fmaf(a.y, b1, acc[r]);
        acc[r] = fmaf(a.z, b2, acc[r]);
        acc[r] = fmaf(a.w, b3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < n) dst[base + (size_t)row * node_stride + d] = from_f32<T>(acc[r] * sc);
    }
  }
  // rows past the rectangle have no edges: exactly 0
  const int zq = min(n, gq * kRows), zk = min(n, gk * kRows);
  for (int idx = tid; idx < (n - zq) * dh; idx += kThreads)
    dq[base + (size_t)(zq + idx / dh) * node_stride + idx % dh] = from_f32<T>(0.f);
  for (int idx = tid; idx < (n - zk) * dh; idx += kThreads) {
    const size_t off = base + (size_t)(zk + idx / dh) * node_stride + idx % dh;
    dk[off] = from_f32<T>(0.f);
    dv[off] = from_f32<T>(0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* dout,
           const void* o, const void* lse, void* dq, void* dk, void* dv, int batch, int n,
           int heads, int dh, float scale, cudaStream_t stream) {
  // dynamic shared memory above 48 KB: opted into once, for the largest graph and head
  static const cudaError_t opted =
      cudaFuncSetAttribute(masked_attention_bwd_small_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(kMaxNodes, kMaxHeadDim));
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid(heads, batch);
  masked_attention_bwd_small_kernel<T><<<grid, kThreads, smem_bytes(n, dh), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<const T*>(dout), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), n, heads, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; n 1 to 32; head_dim 1 to 288. Returns
// the cudaError_t of the launch.
extern "C" int masked_attention_bwd_small(const void* q, const void* k, const void* v,
                                          const void* mask, const void* dout, const void* o,
                                          const void* lse, void* dq, void* dk, void* dv,
                                          int batch, int n, int heads, int head_dim, int dtype,
                                          float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > kMaxNodes || heads <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, dout, o, lse, dq, dk, dv, batch, n, heads, head_dim,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, dout, o, lse, dq, dk, dv, batch, n, heads,
                                 head_dim, scale, st);
  return (int)cudaErrorInvalidValue;
}
