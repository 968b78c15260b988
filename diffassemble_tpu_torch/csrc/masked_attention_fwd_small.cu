// Masked multi-head graph attention, forward, for small graphs (N <= 32
// nodes), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of the JAX package's
// ops/pallas_attention.py (launched by `_flash_fwd`) where a graph has at
// most 32 nodes, as the 3D family's do (one node a part: N = 8 and 20), off
// the tensor-core route. It computes the same function as the TPU kernel
// (and as masked_attention_fwd.cu), not a block-by-block copy:
//
//   S   = q·kᵀ/√Dh in f32, masked entries set to −1e9
//   m   = max_j S_ij,  denom = max(Σ_j exp(S_ij − m)·mask_ij, 1e−30)
//   P   = exp(S − m)·mask / denom, rounded to v's type (the TPU kernel's
//         probs.astype(v.dtype))
//   O   = P·v, summed in f32, written in the input's type
//   L_i = m + log(denom)                        (consumed by the backward)
//
// A masked entry is never exponentiated and contributes exactly 0: a query
// row with no edges gets O = 0 and L = −1e9 + log(1e−30), the plain
// version's value in f32, and nothing is NaN. Every sum runs in f32 in a
// fixed order and each output element is written by one thread, so there
// are no atomics and the results are deterministic.
//
// Layout: q, k, v and O are (B, N, H, Dh) contiguous, the port's public
// layout, read as they are; L is (B, H, N) f32; the mask is (B, N, N) int8
// (or bool bytes) shared across heads. Widths 1 to 288, f32 and bf16, any
// 2-byte alignment (odd widths put bf16 rows off 4-byte boundaries, so every
// global access is one element).
//
// What bounds it on an H100: nothing the card's peaks describe. At B = 16,
// H = 8, N = 8, Dh 264 (a 3D held-out call's wide layer) the launch reads
// ~1.1 MB of q, k and v over the attended rows and writes ~0.5 MB of O,
// ~0.5 µs at 3.35 TB/s; its ~4 MFLOP are nothing. What held the CUDA-core
// forward back at these sizes was latency: 16-row query blocks and 32-key
// tiles mostly of padding, one lane's serial dot product over the whole head
// width, and staging with an integer division per element. This design aims
// at latency, as masked_attention_bwd_small.cu does:
//   - one block of 16 warps per (head, batch) holds the head's whole graph;
//     it reads the mask first and finds the attended rectangle: the last
//     query row with an edge and the last attended key (the 3D graphs put
//     their padding parts last); rows past it get O = 0 and the plain
//     version's L for a row with no edges, without a product;
//   - q over the rectangle's query rows, k and v over its keys are staged
//     once as f32 in shared memory, a warp a row, each lane's elements all
//     loaded before any is stored (one memory latency a row, not one an
//     element); sized from N and Dh at launch (113 KB at N = 32, Dh 288;
//     66 KB at N = 20, Dh 271; 25 KB at N = 8, Dh 264), above 48 KB by
//     opting in;
//   - short chains: lanes split the head width (lane l takes columns l,
//     l + 32, ...), each score finished by a 5-step shuffle reduction:
//     depth ~Dh/32 + 5 instead of Dh; a warp takes two attended pairs at
//     once, two independent chains;
//   - the softmax of a row in one warp, a key a lane: one warp_max and one
//     warp_sum (the graph is one tile: no online rescaling); P, normalised
//     and rounded, overwrites S in a small shared tile, zero off the edges;
//   - O = P·v by (4 rows, 32 columns) items, a warp each: lanes over
//     columns, the 4 rows' P read as float4 broadcasts, each row of v read
//     once for 4 outputs.
// Every access to a staged row walks consecutive columns of one row and
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
constexpr int kSlots = kMaxHeadDim / 32;  // columns a lane holds of one row
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;  // output rows a lane sums together
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

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// the (r4 × r4) S/P tile, three (r4 × dh) staged matrices, the warps'
// extents, then the mask's bytes; r4 = N rounded up to 4
int smem_bytes(int n, int dh) {
  const int r4 = round4(n);
  return (r4 * r4 + 3 * r4 * dh + 2 * kWarps) * (int)sizeof(float) + n * n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const int8_t* __restrict__ mask,
                                  T* __restrict__ o, float* __restrict__ lse, int n, int heads,
                                  int dh, float scale) {
  const int r4 = round4(n);  // rows of every staged matrix and of the tile
  extern __shared__ float4 smem4[];  // 16-byte aligned: the tile is read as float4
  float* p_s = reinterpret_cast<float*>(smem4);  // [r4][r4] S, then P: query rows, key columns
  float* q_s = p_s + r4 * r4;                    // [r4][dh]
  float* k_s = q_s + r4 * dh;                    // [r4][dh]
  float* v_s = k_s + r4 * dh;                    // [r4][dh]
  int* ext_s = reinterpret_cast<int*>(v_s + r4 * dh);           // [2][kWarps] each warp's extents
  int8_t* m_s = reinterpret_cast<int8_t*>(ext_s + 2 * kWarps);  // [n][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t node_stride = (size_t)heads * dh;
  const size_t base = (size_t)b * n * node_stride + (size_t)h * dh;
  const int8_t* mask_b = mask + (size_t)b * n * n;
  float* lse_bh = lse + ((size_t)b * heads + h) * n;

  // 1. The mask, and the attended rectangle: 1 + the last query row with an
  // edge, 1 + the last key a query attends.
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
  const int k4 = round4(kmax);  // the keys the product walks, 4 at a time

  // 2. Stage q over the rectangle's rows and k, v over its keys (v zero on
  // rows kmax to k4, which the product reads with P = 0), a warp a row; rows
  // past the rectangle have no edges: O = 0 and L of an empty row.
  for (int r = warp; r < r4; r += kWarps) {
    const bool sq = r < qmax, skv = r < kmax, zv = !skv && r < k4, zo = r >= qmax && r < n;
    if (!(sq || skv || zv || zo)) continue;  // the whole warp's row
    const size_t off = base + (size_t)r * node_stride;
    float qv[kSlots], kv[kSlots], vv[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {  // every load of the row before any store
      const int d = lane + 32 * c;
      qv[c] = sq && d < dh ? to_f32(q[off + d]) : 0.f;
      kv[c] = skv && d < dh ? to_f32(k[off + d]) : 0.f;
      vv[c] = skv && d < dh ? to_f32(v[off + d]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int d = lane + 32 * c;
      if (d >= dh) break;
      if (sq) q_s[r * dh + d] = qv[c];
      if (skv) k_s[r * dh + d] = kv[c];
      if (skv || zv) v_s[r * dh + d] = vv[c];
      if (zo) o[off + d] = from_f32<T>(0.f);
    }
    if (zo && lane == 0) lse_bh[r] = kNegInf + logf(1e-30f);
  }
  __syncthreads();

  // 3. S of each attended pair in the rectangle, a warp two pairs at a time.
  const int pairs = qmax * kmax;
  for (int p = warp; p < pairs; p += 2 * kWarps) {
    const int i = p / kmax, j = p - i * kmax;
    const int p2 = p + kWarps;
    const bool two = p2 < pairs;
    const int i2 = two ? p2 / kmax : i, j2 = two ? p2 - i2 * kmax : j;
    const bool e = m_s[i * n + j] != 0, e2 = two && m_s[i2 * n + j2] != 0;
    if (!(e || e2)) continue;  // the whole warp's pairs: a masked entry is never computed
    const float* qi = q_s + i * dh;
    const float* kj = k_s + j * dh;
    const float* qi2 = q_s + i2 * dh;
    const float* kj2 = k_s + j2 * dh;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int d = lane + 32 * c;
      if (d >= dh) break;
      s = fmaf(qi[d], kj[d], s);
      s2 = fmaf(qi2[d], kj2[d], s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      if (e) p_s[i * r4 + j] = s * scale;
      if (e2) p_s[i2 * r4 + j2] = s2 * scale;
    }
  }
  __syncthreads();

  // 4. The softmax of each rectangle row, a warp a row, a key a lane: P over
  // S in place (0 off the edges and on keys kmax to k4), and L.
  for (int i = warp; i < qmax; i += kWarps) {
    const bool e = lane < kmax && m_s[i * n + lane] != 0;
    const float s = e ? p_s[i * r4 + lane] : kNegInf;
    const float mx = warp_max(s);  // −1e9 over a row's masked entries, as the plain version's
    const float ex = e ? expf(s - mx) : 0.f;  // a masked entry is never exponentiated
    const float denom = fmaxf(warp_sum(ex), 1e-30f);
    if (lane < k4) p_s[i * r4 + lane] = to_f32(from_f32<T>(ex / denom));
    if (lane == 0) lse_bh[i] = mx + logf(denom);
  }
  __syncthreads();

  // 5. O = P·v over the rectangle, a warp a (4 rows, 32 columns) item.
  const int chunks = (dh + 31) / 32;
  const int items = (qmax + kRows - 1) / kRows * chunks;
  for (int item = warp; item < items; item += kWarps) {
    const int g = item / chunks;
    const int d = (item - g * chunks) * 32 + lane;
    if (d >= dh) continue;
    const int row0 = g * kRows;  // rows past qmax are computed from the tile's rest and not written
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int t = 0; t < k4; t += 4) {
      const float b0 = v_s[(t + 0) * dh + d];
      const float b1 = v_s[(t + 1) * dh + d];
      const float b2 = v_s[(t + 2) * dh + d];
      const float b3 = v_s[(t + 3) * dh + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(p_s + (row0 + r) * r4 + t);
        acc[r] = fmaf(a.x, b0, acc[r]);
        acc[r] = fmaf(a.y, b1, acc[r]);
        acc[r] = fmaf(a.z, b2, acc[r]);
        acc[r] = fmaf(a.w, b3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < qmax) o[base + (size_t)row * node_stride + d] = from_f32<T>(acc[r]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
           int batch, int n, int heads, int dh, float scale, cudaStream_t stream) {
  // dynamic shared memory above 48 KB: opted into once, for the largest graph and head
  static const cudaError_t opted =
      cudaFuncSetAttribute(masked_attention_fwd_small_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(kMaxNodes, kMaxHeadDim));
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid(heads, batch);
  masked_attention_fwd_small_kernel<T><<<grid, kThreads, smem_bytes(n, dh), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse), n, heads,
      dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; n 1 to 32; head_dim 1 to 288. The same
// arguments as masked_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int masked_attention_fwd_small(const void* q, const void* k, const void* v,
                                          const void* mask, void* o, void* lse, int batch, int n,
                                          int heads, int head_dim, int dtype, float scale,
                                          void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > kMaxNodes || heads <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, lse, batch, n, heads, head_dim, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, lse, batch, n, heads, head_dim, scale, st);
  return (int)cudaErrorInvalidValue;
}
