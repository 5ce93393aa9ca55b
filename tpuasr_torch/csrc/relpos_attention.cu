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
//
// Backward: replaces the TPU kernel `_bwd_kernel` (attention_pallas.py:87-132,
// called from `_fused_bwd` :191). Per (batch, head), with a the fp32
// probabilities recomputed from the scores and do the output's gradient:
//   dv = a^T . do                     da = where(mask, do . v^T, 0)
//   ds = a * (da - rowsum(da * a)) * scale, dsc = ds rounded to the input type
//   dq = dsc . (k + p)                dk = dsc^T . (q + u)
//   dp = sum over the batch of dsc^T . (q + v)
//   du / dvb = sum over the batch of col . k / col . p, col = the column sums
//              of ds rounded to the input type
// at the JAX kernel's rounding points (do and v upcast, q+u, q+v and k+p
// formed in the input type), dq/dk/dv in the input type, dp/du/dvb fp32.
// What bounds it: 14 dk flops per head per unmasked pair (scores 4 dk, da,
// dv, dq 2 dk each, dk|dp 4 dk) over ~10 MB at the flagship's training shape
// (B 12, T = S = 191, 4 heads of 64, bf16): a few microseconds of either;
// like the forward it pays latency and CUDA-core products.
// Design: the TPU kernel keeps a whole [T, S] score block in VMEM and
// accumulates dp, du and dvb across a grid that runs in order over the
// batch. A Hopper block holds neither, and blocks run in no order, so the
// work splits flash-attention-2 style into two kernels on one stream:
// - `relpos_bwd_q_kernel`, a block per (batch, head, 16 query rows), laid
//   out as the forward (lane = key): a first sweep over the keys keeps the
//   online max, sum and rowsum(da * a) of each row and writes them to a
//   [B, H, T, 3] buffer; a second sweep forms ds and accumulates dq.
// - `relpos_bwd_kv_kernel`, a block per (batch, head, 16 keys), a warp per 4
//   keys, lane = query row in tiles of 32: it recomputes a and ds from the
//   row statistics, hands them lane to lane to accumulate dv, dk and this
//   batch's share of dp in registers (lane = feature), and sums each key's
//   ds column over all rows. dk and dv are written; dp, du and dvb, shared
//   by the batch (du, dvb by every key tile too), are added with fp32
//   atomics into zeroed buffers, so their summation order changes from run
//   to run (a few ulps of fp32).
// A fully masked query row has a = 0 and gives exactly zero gradient.

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

// ---------------------------------------------------------------- backward

constexpr int kBT = 32;          // query rows per tile of the key-side kernel
constexpr int kKeysPerWarp = 4;
constexpr int kBKV = kWarps * kKeysPerWarp;  // keys per key-side block

template <typename T, int DK>
__global__ void __launch_bounds__(kWarps * 32)
relpos_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ p, const T* __restrict__ v,
                    const T* __restrict__ ubias, const T* __restrict__ vbias,
                    const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ stats, int t_len, int s_len,
                    int n_head, long long msb, long long mst, long long mss, float scale) {
  constexpr int kPitch = 2 * DK + 1;  // odd pitches: lane j reads key j's row
  constexpr int kVPitch = DK + 1;
  constexpr int kPerLane = (DK + 31) / 32;
  __shared__ float s_qu[kBQ][DK];
  __shared__ float s_qv[kBQ][DK];
  __shared__ float s_do[kBQ][DK];
  __shared__ float s_kp[kBK][kPitch];  // [k | p] of the tile's keys
  __shared__ float s_v[kBK][kVPitch];
  __shared__ float s_ks[kBK][DK];      // k + p, rounded to the input type

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * kRowsPerWarp;

  for (int i = tid; i < kBQ * DK; i += blockDim.x) {
    const int r = i / DK, d = i - r * DK, t = q0 + r;
    float qu = 0.f, qv = 0.f, g = 0.f;
    if (t < t_len) {
      const size_t off = ((size_t)b * t_len + t) * d_model + h * DK + d;
      const float x = to_f(q[off]);
      qu = round_to<T>(x + to_f(ubias[h * DK + d]));
      qv = round_to<T>(x + to_f(vbias[h * DK + d]));
      g = to_f(dout[off]);
    }
    s_qu[r][d] = qu;
    s_qv[r][d] = qv;
    s_do[r][d] = g;
  }

  // scores x (scaled) and da of key s0 + lane against this warp's rows;
  // ok: the pair is inside the arrays and unmasked
  auto score = [&](int s0, float (&x)[kRowsPerWarp], float (&da)[kRowsPerWarp],
                   bool (&ok)[kRowsPerWarp]) {
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = da[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      const float kd = s_kp[lane][d], pd = s_kp[lane][DK + d], vd = s_v[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        sc[r] = fmaf(s_qu[row0 + r][d], kd, sc[r]);
        sc[r] = fmaf(s_qv[row0 + r][d], pd, sc[r]);
        da[r] = fmaf(s_do[row0 + r][d], vd, da[r]);
      }
    }
    const int s = s0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = q0 + row0 + r;
      ok[r] = s < s_len && t < t_len && mask[b * msb + t * mst + s * mss] != 0;
      x[r] = sc[r] * scale;
    }
  };
  auto stage = [&](int s0, bool with_sum) {
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
      if (with_sum) s_ks[j][d] = round_to<T>(kx + px);
    }
    __syncthreads();
  };

  // sweep 1: each row's max, sum and rowsum(da * a), online
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], d_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = d_run[r] = 0.f;
  }
  for (int s0 = 0; s0 < s_len; s0 += kBK) {
    stage(s0, false);
    float x[kRowsPerWarp], da[kRowsPerWarp];
    bool ok[kRowsPerWarp];
    score(s0, x, da, ok);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float m_new = fmaxf(m_run[r], warp_max(ok[r] ? x[r] : -INFINITY));
      float e = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {  // uniform over the warp
        e = ok[r] ? expf(x[r] - m_new) : 0.f;
        corr = expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      l_run[r] = l_run[r] * corr + warp_sum(e);
      d_run[r] = d_run[r] * corr + warp_sum(ok[r] ? e * da[r] : 0.f);
    }
  }
  float dsum[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    dsum[r] = l_run[r] > 0.f ? d_run[r] / l_run[r] : 0.f;
    const int t = q0 + row0 + r;
    if (lane == 0 && t < t_len) {
      float* st = stats + (((size_t)b * n_head + h) * t_len + t) * 3;
      st[0] = m_run[r];
      st[1] = l_run[r];
      st[2] = dsum[r];
    }
  }

  // sweep 2: ds, rounded, against k + p
  float acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[r][i] = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kBK) {
    stage(s0, true);
    float x[kRowsPerWarp], da[kRowsPerWarp], dsc[kRowsPerWarp];
    bool ok[kRowsPerWarp];
    score(s0, x, da, ok);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float a = ok[r] ? expf(x[r] - m_run[r]) / l_run[r] : 0.f;
      dsc[r] = ok[r] ? round_to<T>(a * (da[r] - dsum[r]) * scale) : 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        kj[i] = lane + 32 * i < DK ? s_ks[j][lane + 32 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dj = __shfl_sync(kFull, dsc[r], j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[r][i] = fmaf(dj, kj[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    if (t >= t_len) continue;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (lane + 32 * i < DK)
        dq[((size_t)b * t_len + t) * d_model + h * DK + lane + 32 * i] = from_f<T>(acc[r][i]);
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(kWarps * 32)
relpos_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ p, const T* __restrict__ v,
                     const T* __restrict__ ubias, const T* __restrict__ vbias,
                     const uint8_t* __restrict__ mask, const T* __restrict__ dout,
                     const float* __restrict__ stats, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, float* __restrict__ dp, float* __restrict__ du,
                     float* __restrict__ dvb, int t_len, int s_len, int n_head,
                     long long msb, long long mst, long long mss, float scale) {
  constexpr int kQPitch = DK + 1;  // odd pitch: lane t reads row t
  constexpr int kPerLane = (DK + 31) / 32;
  __shared__ float s_qu[kBT][kQPitch];
  __shared__ float s_qv[kBT][kQPitch];
  __shared__ float s_do[kBT][kQPitch];
  __shared__ float s_st[kBT][3];
  __shared__ float s_k[kBKV][DK];
  __shared__ float s_p[kBKV][DK];
  __shared__ float s_v[kBKV][DK];

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kBKV;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw = warp * kKeysPerWarp;  // this warp's first key in the block

  for (int i = tid; i < kBKV * DK; i += blockDim.x) {
    const int j = i / DK, d = i - j * DK, s = key0 + j;
    float kx = 0.f, px = 0.f, vx = 0.f;
    if (s < s_len) {
      const size_t off = ((size_t)b * s_len + s) * d_model + h * DK + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
      px = to_f(p[(size_t)s * d_model + h * DK + d]);
    }
    s_k[j][d] = kx;
    s_p[j][d] = px;
    s_v[j][d] = vx;
  }

  float acc_dv[kKeysPerWarp][kPerLane], acc_dk[kKeysPerWarp][kPerLane],
      acc_dp[kKeysPerWarp][kPerLane], col[kKeysPerWarp];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    col[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc_dv[j][i] = acc_dk[j][i] = acc_dp[j][i] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kBT) {
    __syncthreads();  // the previous tile is consumed (and the keys are staged)
    for (int i = tid; i < kBT * DK; i += blockDim.x) {
      const int r = i / DK, d = i - r * DK, t = t0 + r;
      float qu = 0.f, qv = 0.f, g = 0.f;
      if (t < t_len) {
        const size_t off = ((size_t)b * t_len + t) * d_model + h * DK + d;
        const float x = to_f(q[off]);
        qu = round_to<T>(x + to_f(ubias[h * DK + d]));
        qv = round_to<T>(x + to_f(vbias[h * DK + d]));
        g = to_f(dout[off]);
      }
      s_qu[r][d] = qu;
      s_qv[r][d] = qv;
      s_do[r][d] = g;
    }
    for (int i = tid; i < kBT * 3; i += blockDim.x) {
      const int r = i / 3, c = i - r * 3, t = t0 + r;
      s_st[r][c] = t < t_len ? stats[(((size_t)b * n_head + h) * t_len + t) * 3 + c]
                             : (c == 1 ? 1.f : 0.f);
    }
    __syncthreads();

    // lane = query row t0 + lane: a and ds against each of the warp's keys
    const int t = t0 + lane;
    const float m = s_st[lane][0], l = s_st[lane][1], dsum = s_st[lane][2];
    float a[kKeysPerWarp], dsc[kKeysPerWarp];
#pragma unroll
    for (int j = 0; j < kKeysPerWarp; ++j) {
      const int s = key0 + kw + j;
      float sc = 0.f, da = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        sc = fmaf(s_qu[lane][d], s_k[kw + j][d], sc);
        sc = fmaf(s_qv[lane][d], s_p[kw + j][d], sc);
        da = fmaf(s_do[lane][d], s_v[kw + j][d], da);
      }
      const bool ok = t < t_len && s < s_len && mask[b * msb + t * mst + s * mss] != 0;
      a[j] = ok ? expf(sc * scale - m) / l : 0.f;
      const float ds = ok ? a[j] * (da - dsum) * scale : 0.f;
      col[j] += ds;
      dsc[j] = round_to<T>(ds);
    }
    // the tile's rows, lane to lane: lane = feature d for the accumulators
#pragma unroll 4
    for (int r = 0; r < kBT; ++r) {
      float qu[kPerLane], qv[kPerLane], g[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        qu[i] = d < DK ? s_qu[r][d] : 0.f;
        qv[i] = d < DK ? s_qv[r][d] : 0.f;
        g[i] = d < DK ? s_do[r][d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const float aj = __shfl_sync(kFull, a[j], r), dj = __shfl_sync(kFull, dsc[j], r);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          acc_dv[j][i] = fmaf(aj, g[i], acc_dv[j][i]);
          acc_dk[j][i] = fmaf(dj, qu[i], acc_dk[j][i]);
          acc_dp[j][i] = fmaf(dj, qv[i], acc_dp[j][i]);
        }
      }
    }
  }

  float du_part[kPerLane], dvb_part[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) du_part[i] = dvb_part[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int s = key0 + kw + j;
    const float c = round_to<T>(warp_sum(col[j]));  // the key's ds column sum
    if (s >= s_len) continue;  // uniform over the warp
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d >= DK) continue;
      const size_t off = ((size_t)b * s_len + s) * d_model + h * DK + d;
      dk_out[off] = from_f<T>(acc_dk[j][i]);
      dv_out[off] = from_f<T>(acc_dv[j][i]);
      atomicAdd(dp + (size_t)s * d_model + h * DK + d, acc_dp[j][i]);
      du_part[i] = fmaf(c, s_k[kw + j][d], du_part[i]);
      dvb_part[i] = fmaf(c, s_p[kw + j][d], dvb_part[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d >= DK) continue;
    atomicAdd(du + h * DK + d, du_part[i]);
    atomicAdd(dvb + h * DK + d, dvb_part[i]);
  }
}

template <typename T, int DK>
cudaError_t launch_bwd(const void* q, const void* k, const void* p, const void* v,
                       const void* ub, const void* vb, const void* mask, const void* dout,
                       void* dq, void* dk, void* dv, void* dp, void* du, void* dvb,
                       void* stats, int batch, int t_len, int s_len, int n_head,
                       long long msb, long long mst, long long mss, float scale,
                       cudaStream_t stream) {
  const dim3 qgrid((t_len + kBQ - 1) / kBQ, n_head, batch);
  relpos_bwd_q_kernel<T, DK><<<qgrid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(p),
      static_cast<const T*>(v), static_cast<const T*>(ub), static_cast<const T*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(stats), t_len, s_len, n_head, msb, mst, mss, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((s_len + kBKV - 1) / kBKV, n_head, batch);
  relpos_bwd_kv_kernel<T, DK><<<kgrid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(p),
      static_cast<const T*>(v), static_cast<const T*>(ub), static_cast<const T*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dp), static_cast<float*>(du), static_cast<float*>(dvb), t_len,
      s_len, n_head, msb, mst, mss, scale);
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

// The backward of relpos_attention_fwd: + do [B, T, H*dk] (q's type) ->
// dq [B, T, H*dk], dk, dv [B, S, H*dk] in q's type; dp [1, S, H*dk], du,
// dvb [H*dk] fp32, zeroed by the caller (the kernels add into them); stats
// [B, H, T, 3] fp32 scratch (each row's max, sum and rowsum(da * a)).
// T, S >= 1.
int relpos_attention_bwd(const void* q, const void* k, const void* p, const void* v,
                         const void* ub, const void* vb, const void* mask,
                         const void* dout, void* dq, void* dk, void* dv, void* dp, void* du,
                         void* dvb, void* stats, int batch, int t_len, int s_len, int n_head,
                         int dk_, long long msb, long long mst, long long mss, float scale,
                         int is_bf16, void* stream) {
  if (batch == 0 || t_len == 0 || s_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_BWD(T, DK)                                                                 \
  err = launch_bwd<T, DK>(q, k, p, v, ub, vb, mask, dout, dq, dk, dv, dp, du, dvb, stats, \
                          batch, t_len, s_len, n_head, msb, mst, mss, scale, st)
  if (is_bf16) {
    if (dk_ == 16) TPUASR_BWD(__nv_bfloat16, 16);
    if (dk_ == 32) TPUASR_BWD(__nv_bfloat16, 32);
    if (dk_ == 64) TPUASR_BWD(__nv_bfloat16, 64);
  } else {
    if (dk_ == 16) TPUASR_BWD(float, 16);
    if (dk_ == 32) TPUASR_BWD(float, 32);
    if (dk_ == 64) TPUASR_BWD(float, 64);
  }
#undef TPUASR_BWD
  return static_cast<int>(err);
}

}  // extern "C"
