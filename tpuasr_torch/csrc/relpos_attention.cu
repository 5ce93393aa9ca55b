// Rel-pos self-attention forward: scores + mask + softmax + a.v, per
// (batch, head, tile of query rows).
//
// Replaces the TPU kernel `_fwd_kernel` / `_head_attn`
// (tpuasr/ops/attention_pallas.py:52-84, called from `_fused_fwd` :171):
//   s   = ((q + u) . k^T + (q + v) . p^T) * scale
//   a   = where(mask, softmax(where(mask, s, -1e9)), 0)
//   out = a . v
// with q, k, v in the module's [B, T|S, H*dk] layout, the batch-shared
// positional projection p [1, S, H*dk], and the u/v biases [H*dk]. A query
// row whose keys are all masked gives zeros (attention_pallas.py:67-69).
//
// What bounds it on an H100: at the flagship (T = S = 187 encoder frames of
// 8 s, 4 heads of dk 64) one call is about 0.2 GFLOP over 2-4 MB of q/k/v/p,
// a few microseconds of either; what a call really pays is latency: loads
// that wait, and a grid of a few hundred small blocks.
//
// Design: the Pallas kernel holds a whole [T, S] score block in VMEM; a
// Hopper block cannot, so this is flash style. One block of 4 warps takes 16
// query rows of one (batch, head) and stages q+u and q+v for them in shared
// memory (formed in the input type, as the reference does). It walks the
// keys in tiles of 32, one key per lane: the tile's [k | p] rows and v rows
// are staged in shared memory in fp32 ([k | p] with an odd row pitch, so the
// 32 lanes reading 32 different keys hit 32 banks). Each warp owns 4 query
// rows; a lane scores its key for all 4 rows, the warp keeps an online fp32
// max and sum per row, and the probabilities (rounded to v's type, as the
// reference casts them before its a.v product) are broadcast lane to lane
// to accumulate a.v in fp32 registers (ceil(dk / 32) values per lane per
// row; at dk 16 half the lanes idle through a.v).
// Masked keys contribute nothing; the mask is read through its strides, so
// a [B, 1, S] padding mask is never broadcast in device memory. Tensor-core
// products (mma/wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int DK>
__global__ void __launch_bounds__(kWarps * 32)
relpos_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ p, const T* __restrict__ v,
                  const T* __restrict__ ubias, const T* __restrict__ vbias,
                  const uint8_t* __restrict__ mask, T* __restrict__ out,
                  int t_len, int s_len, int n_head, long long msb,
                  long long mst, long long mss, float scale) {
  constexpr int kPitch = 2 * DK + 1;  // odd pitch: conflict-free key rows
  constexpr int kPerLane = (DK + 31) / 32;
  __shared__ float s_qu[kBQ][DK];
  __shared__ float s_qv[kBQ][DK];
  __shared__ float s_kp[kBK][kPitch];  // [k | p] of the tile's keys
  __shared__ float s_v[kBK][DK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * kRowsPerWarp;

  for (int i = tid; i < kBQ * DK; i += blockDim.x) {
    const int r = i / DK, d = i - r * DK, t = q0 + r;
    float qu = 0.f, qv = 0.f;
    if (t < t_len) {
      const float x = to_f(q[((size_t)b * t_len + t) * d_model + h * DK + d]);
      qu = round_to<T>(x + to_f(ubias[h * DK + d]));
      qv = round_to<T>(x + to_f(vbias[h * DK + d]));
    }
    s_qu[r][d] = qu;
    s_qv[r][d] = qv;
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int s0 = 0; s0 < s_len; s0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * DK; i += blockDim.x) {
      const int j = i / DK, d = i - j * DK, s = s0 + j;
      float kx = 0.f, px = 0.f, vx = 0.f;
      if (s < s_len) {
        const size_t off = ((size_t)b * s_len + s) * d_model + h * DK + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
        px = to_f(p[(size_t)s * d_model + h * DK + d]);
      }
      s_kp[j][d] = kx;
      s_kp[j][DK + d] = px;
      s_v[j][d] = vx;
    }
    __syncthreads();

    // scores of key s0 + lane against this warp's rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float kd = s_kp[lane][d], pd = s_kp[lane][DK + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        sc[r] = fmaf(s_qu[row0 + r][d], kd, sc[r]);
        sc[r] = fmaf(s_qv[row0 + r][d], pd, sc[r]);
      }
    }

    const int s = s0 + lane;
    float prob[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = q0 + row0 + r;
      const bool ok = s < s_len && t < t_len &&
                      mask[b * msb + t * mst + s * mss] != 0;
      const float x = ok ? sc[r] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(x));
      float pr = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {  // uniform over the warp
        pr = ok ? expf(x - m_new) : 0.f;
        corr = expf(m_run[r] - m_new);  // 0 while no key was valid yet
        m_run[r] = m_new;
      }
      l_run[r] = l_run[r] * corr + warp_sum(pr);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[r][i] *= corr;
      prob[r] = round_to<T>(pr);
    }

    // a . v over the tile: lane j's probability is broadcast to the warp
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        vj[i] = lane + 32 * i < DK ? s_v[j][lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, prob[r], j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    if (t >= t_len) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;  // all-masked row: 0
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (lane + 32 * i < DK)
        out[((size_t)b * t_len + t) * d_model + h * DK + lane + 32 * i] =
            from_f<T>(acc[r][i] * inv);
  }
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* p, const void* v,
                   const void* ub, const void* vb, const void* mask, void* out,
                   int batch, int t_len, int s_len, int n_head, long long msb,
                   long long mst, long long mss, float scale, cudaStream_t stream) {
  const dim3 grid((t_len + kBQ - 1) / kBQ, n_head, batch);
  relpos_fwd_kernel<T, DK><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(p),
      static_cast<const T*>(v), static_cast<const T*>(ub), static_cast<const T*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), t_len, s_len,
      n_head, msb, mst, mss, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, T, H*dk], k/v [B, S, H*dk], p [1, S, H*dk], biases [H*dk], all of
// one type (is_bf16: bf16, else fp32) and contiguous; mask bool read at
// b*msb + t*mst + s*mss (element strides, 0 to broadcast). dk is 16, 32 or
// 64.
int relpos_attention_fwd(const void* q, const void* k, const void* p,
                         const void* v, const void* ub, const void* vb,
                         const void* mask, void* out, int batch, int t_len,
                         int s_len, int n_head, int dk, long long msb,
                         long long mst, long long mss, float scale, int is_bf16,
                         void* stream) {
  if (batch == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (dk == 16) err = launch<__nv_bfloat16, 16>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
    if (dk == 32) err = launch<__nv_bfloat16, 32>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
    if (dk == 64) err = launch<__nv_bfloat16, 64>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
  } else {
    if (dk == 16) err = launch<float, 16>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
    if (dk == 32) err = launch<float, 32>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
    if (dk == 64) err = launch<float, 64>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, msb, mst, mss, scale, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
