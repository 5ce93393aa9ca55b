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
// Two routes, one per input type.
//
// bf16 (training and bf16 serving): tensor cores, flash-attention-2 style.
// `relpos_fwd_tc_kernel`: a block takes 64 query rows of one (batch, head),
// 16 per warp (`launch_fwd_tc` says why 64), and forms [q+u | q+v] in bf16,
// as the reference does, as mma.sync A fragments in registers. It walks the
// keys in tiles of 64: the tile's [k | p] rows (the JAX kernel's own
// concatenation, so the scores are one product of depth 2 dk) and v rows are
// staged by cp.async into a double buffer, so the next tile's loads run
// under this tile's products (mma.sync.m16n8k16, bf16 operands from
// ldmatrix, fp32 accumulators). The online max and sum stay in registers;
// out is divided by the sum at the end and rounded to bf16.
// Rounding: the reference rounds the normalised a to bf16 before a.v. This
// kernel never holds a normalised a: without `out32` (serving, any call with
// no gradient to compute) it rounds the unnormalised probabilities
// p = 2^(s - running max) to bf16 as p.v's A operand. With `out32` and `lse`
// (the training forward, whose output the backward reads) p enters p.v as
// two bf16 operands, hi = bf16(p) and lo = bf16(p - hi), so o = a.v is kept
// to fp32 precision and written in fp32 beside the bf16 out, with each row's
// log-sum-exp of the masked scaled scores (fp32 [B, H, T]; -inf for a fully
// masked row). The backward's D = rowsum(do * o) needs that precision: real
// gradients are correlated with o, so da - D cancels and a bf16 error in o
// grows in du, dvb and dp past 2^-6 of their max on the trainer's own
// inputs. The lo products make 8 dk flops per pair of the function's 6, and
// run only then.
// The mask is read once, through its strides ([B, 1, S] included), into a
// bit per (row, key) in shared memory; a key tile no row of the block may
// attend is never loaded, and a warp skips the products of a tile none of
// its rows attends.
//
// fp32 (the card-vs-CPU checks: their tokens must equal the CPU's, and the
// forward is held to 1e-5, which TF32 would not keep): `relpos_fwd_kernel`,
// CUDA-core fp32 products. One block of 4 warps takes 16 query rows and
// stages q+u and q+v in shared memory; it walks the keys in tiles of 32, one
// key per lane ([k | p] with an odd row pitch, so the 32 lanes hit 32
// banks). Each warp owns 4 query rows; a lane scores its key for all 4 rows,
// the warp keeps an online fp32 max and sum per row, and the probabilities
// are broadcast lane to lane to accumulate a.v in fp32 registers.
// Masked keys contribute nothing on both routes; a fully masked row gives
// zeros.
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
// what a call pays is latency.
// Design: the TPU kernel keeps a whole [T, S] score block in VMEM and
// accumulates dp, du and dvb across a grid that runs in order over the
// batch. A Hopper block holds neither, and blocks run in no order, so the
// work splits flash-attention-2 style into two kernels on one stream.
//
// bf16 route, from the forward's fp32 output o and log-sum-exp L (one sweep
// per side, tensor cores as the forward; recomputing s and dP on both sides
// and dv's split p make 22 dk flops per pair against the function's 14):
// - `relpos_bwd_q_tc_kernel`, a block per (batch, head, 64 query rows). Its
//   prologue forms D = rowsum(do * o) in fp32 (= rowsum(da * a) to fp32
//   precision, since o = a.v) and writes it, and [q+u | q+v] for the key side ([B, H, T,
//   2 dk] bf16 scratch). One sweep over the keys recomputes s and
//   dP = do.v^T, p = exp(s scale - L), ds = p (dP - D) scale rounded to bf16,
//   and dq += ds.(k + p), k + p summed in bf16 (`_bwd_kernel` :118-119).
// - `relpos_bwd_kv_tc_kernel`, a block per (batch, head, 64 keys), holding
//   [k | p] and v as A fragments: one sweep over the query tiles recomputes
//   s^T and dP^T and accumulates dv += p^T.do (p as hi + lo bf16 operands,
//   as the forward's out32, so dv is the reference's fp32 a times do),
//   [dk | dp] += ds^T.[q+u | q+v] (one product of width 2 dk, as :123-126)
//   and each key's column sum of ds, rounded to bf16 for du and dvb
//   (:128-132).
// A fully masked row has L = -inf; its p is selected to 0 by the mask, never
// computed from exp(s - L), so it gives exactly zero gradient.
//
// fp32 route (CUDA-core fp32, as the forward's fp32 route):
// - `relpos_bwd_q_kernel`, a block per (batch, head, 16 query rows), laid
//   out as the forward (lane = key): a first sweep over the keys keeps the
//   online max, sum and rowsum(da * a) of each row and writes them to a
//   [B, H, T, 3] buffer; a second sweep forms ds and accumulates dq.
// - `relpos_bwd_kv_kernel`, a block per (batch, head, 16 keys), a warp per 4
//   keys, lane = query row in tiles of 32: it recomputes a and ds from the
//   row statistics, hands them lane to lane to accumulate dv, dk and this
//   batch's share of dp in registers (lane = feature), and sums each key's
//   ds column over all rows. A fully masked query row has a = 0 and gives
//   exactly zero gradient.
// On both routes dk and dv are written; dp, du and dvb, shared by the batch
// (du, dvb by every key tile too), are added with fp32 atomics into zeroed
// buffers (not per-batch buffers and a reduction), so their summation order,
// and their last bits, change from run to run (a few ulps of fp32).

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

// ------------------------------------------------- bf16 route: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // keys per tile (forward, query side); queries per tile (key side)
constexpr int kTcWarps = 4;  // a block: 16 query rows (or keys) per warp, 64 in all
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes device memory -> shared memory, in flight until
// cp_async_wait; zero-filled (nothing read) when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (.trans: each matrix transposed)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}

// d += a . b, a 16x16 (row-major fragments), b 16x8, bf16 operands, fp32 sums.
// Fragments (g = lane / 4, c = lane % 4): a {(g, 2c..), (g+8, 2c..), (g, 2c+8..),
// (g+8, 2c+8..)}, b {(k 2c.., n g), (k 2c+8.., n g)}, d {(g, 2c), (g, 2c+1),
// (g+8, 2c), (g+8, 2c+1)}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// round(x + y) per bf16 half, as a bf16 tensor sum rounds
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return pack_bf16(a.x + b.x, a.y + b.y);
}

// x0, x1 as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

__device__ __forceinline__ uint4 add_bf16x8(uint4 x, uint4 y) {
  return make_uint4(add_bf16x2(x.x, y.x), add_bf16x2(x.y, y.y), add_bf16x2(x.z, y.z),
                    add_bf16x2(x.w, y.w));
}

// the A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ const bf16* a_frag(const bf16* tile, int pitch, int r0, int k0,
                                              int lane) {
  return tile + (r0 + (lane & 15)) * pitch + k0 + ((lane >> 4) << 3);
}
// the B fragments of the n-tiles n0 and n0 + 8 at depth k0..k0+15 of a tile
// stored [n][k] (B = tile^T; ldsm4): {b0, b1} of n0, then of n0 + 8
__device__ __forceinline__ const bf16* b_frag(const bf16* tile, int pitch, int n0, int k0,
                                              int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + (((lane >> 3) & 1) << 3);
}
// the same for a tile stored [k][n] (B = tile; ldsm4_t)
__device__ __forceinline__ const bf16* bt_frag(const bf16* tile, int pitch, int n0, int k0,
                                               int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 + ((lane >> 4) << 3);
}

// The mask bits of a block's BQ = 64 query rows against every key: word w
// (keys 32 w .. 32 w + 31) of block row r at s_bits[w * BQ + r]; s_live[j] is
// set when a row of the block may attend a key of tile j. Warp w builds rows
// 16 w .. 16 w + 15, a ballot per row and word; each mask byte is read once.
__device__ void query_bits(const uint8_t* __restrict__ mask, long long mb, long long mst,
                           long long mss, int q0, int t_len, int s_len, int n_tiles,
                           uint32_t* s_bits, uint32_t* s_live) {
  constexpr int BQ = 16 * kTcWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < n_tiles; ++j) {
    uint32_t any = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = j * kTile + half * 32 + lane;
      bool ok[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int t = q0 + warp * 16 + r;
        ok[r] = t < t_len && s < s_len && mask[mb + t * mst + s * mss] != 0;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const uint32_t bits = __ballot_sync(kFull, ok[r]);
        if (lane == 0) s_bits[(2 * j + half) * BQ + warp * 16 + r] = bits;
        any |= bits;
      }
    }
    if (lane == 0 && any != 0) atomicOr(s_live + j, 1u);
  }
}

// [q + u | q + v] of BQ query rows from q0, formed in bf16 as the reference
// forms them, into s_q (pitch 2 dk + 8); rows past T are 0. With qc, the
// rows inside T are also written to qc ([T, 2 dk] of this (batch, head)).
template <int DK, int BQ>
__device__ void stage_qc(const bf16* __restrict__ q, const bf16* __restrict__ ubias,
                         const bf16* __restrict__ vbias, int b, int h, int q0, int t_len,
                         int d_model, bf16* s_q, bf16* __restrict__ qc) {
  constexpr int QP = 2 * DK + 8, CH = DK / 8;  // 16-byte chunks of a head's row
  for (int i = threadIdx.x; i < BQ * CH; i += blockDim.x) {
    const int r = i / CH, c8 = (i - r * CH) * 8, t = q0 + r;
    uint4 qu = make_uint4(0, 0, 0, 0), qv = qu;
    if (t < t_len) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(q + ((size_t)b * t_len + t) * d_model + h * DK + c8);
      qu = add_bf16x8(x, *reinterpret_cast<const uint4*>(ubias + h * DK + c8));
      qv = add_bf16x8(x, *reinterpret_cast<const uint4*>(vbias + h * DK + c8));
      if (qc != nullptr) {
        *reinterpret_cast<uint4*>(qc + (size_t)t * 2 * DK + c8) = qu;
        *reinterpret_cast<uint4*>(qc + (size_t)t * 2 * DK + DK + c8) = qv;
      }
    }
    *reinterpret_cast<uint4*>(s_q + r * QP + c8) = qu;
    *reinterpret_cast<uint4*>(s_q + r * QP + DK + c8) = qv;
  }
}

// the first tile j >= from with s_live[j] set, or n_tiles
__device__ __forceinline__ int next_live(const uint32_t* s_live, int from, int n_tiles) {
  while (from < n_tiles && s_live[from] == 0) ++from;
  return from;
}

// [k | p] (pitch 2 dk + 8) and v (pitch dk + 8) rows of the key tile at s0
// into shared memory, in flight; rows past S zero-filled
template <int DK>
__device__ __forceinline__ void load_keys(const bf16* __restrict__ k, const bf16* __restrict__ p,
                                          const bf16* __restrict__ v, int b, int h, int s0,
                                          int s_len, int d_model, bf16* s_kp, bf16* s_v) {
  constexpr int QP = 2 * DK + 8, VP = DK + 8, CH = DK / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += blockDim.x) {
    const int r = i / CH, c8 = (i - r * CH) * 8, s = s0 + r;
    const bool in = s < s_len;
    const int sc = in ? s : 0;
    const size_t off = ((size_t)b * s_len + sc) * d_model + h * DK + c8;
    cp_async16(s_kp + r * QP + c8, k + off, in);
    cp_async16(s_kp + r * QP + DK + c8, p + (size_t)sc * d_model + h * DK + c8, in);
    cp_async16(s_v + r * VP + c8, v + off, in);
  }
}

// this thread's mask bits over a 64-wide tile: rows (or keys) r and r + 8
__device__ __forceinline__ void tile_bits(const uint32_t* s_bits, int rows, int j, int r,
                                          uint64_t& m0, uint64_t& m1) {
  const uint32_t* lo = s_bits + 2 * j * rows;
  const uint32_t* hi = lo + rows;
  m0 = (uint64_t)hi[r] << 32 | lo[r];
  m1 = (uint64_t)hi[r + 8] << 32 | lo[r + 8];
}

template <int DK>
__global__ void __launch_bounds__(kTcWarps * 32)
relpos_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ p, const bf16* __restrict__ v,
                     const bf16* __restrict__ ubias, const bf16* __restrict__ vbias,
                     const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse, int t_len, int s_len,
                     int n_head, long long msb, long long mst, long long mss, float scale) {
  constexpr int BQ = 16 * kTcWarps, D2 = 2 * DK, QP = D2 + 8, VP = DK + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [BQ][QP]  [q+u | q+v]
  bf16* s_kp = s_q + BQ * QP;                 // [2][kTile][QP]  [k | p]
  bf16* s_v = s_kp + 2 * kTile * QP;          // [2][kTile][VP]
  const int n_tiles = cdiv(s_len, kTile);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_v + 2 * kTile * VP);  // [2 n_tiles][BQ]
  uint32_t* s_live = s_bits + 2 * n_tiles * BQ;                          // [n_tiles]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const float sl2 = scale * kLog2e;  // scores in log2 units
  const bool split = out32 != nullptr;  // p.v to fp32 precision (uniform over the grid)

  for (int i = tid; i < n_tiles; i += blockDim.x) s_live[i] = 0;
  __syncthreads();
  query_bits(mask, b * msb, mst, mss, q0, t_len, s_len, n_tiles, s_bits, s_live);
  stage_qc<DK, BQ>(q, ubias, vbias, b, h, q0, t_len, d_model, s_q, nullptr);
  __syncthreads();

  int j = next_live(s_live, 0, n_tiles);
  if (j < n_tiles) load_keys<DK>(k, p, v, b, h, j * kTile, s_len, d_model, s_kp, s_v);
  cp_async_commit();
  uint32_t qa[D2 / 16][4];
#pragma unroll
  for (int kk = 0; kk < D2 / 16; ++kk) ldsm4(qa[kk], a_frag(s_q, QP, warp * 16, kk * 16, lane));

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[DK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int buf = 0; j < n_tiles; buf ^= 1) {
    const int jn = next_live(s_live, j + 1, n_tiles);
    if (jn < n_tiles)
      load_keys<DK>(k, p, v, b, h, jn * kTile, s_len, d_model, s_kp + (buf ^ 1) * kTile * QP,
                    s_v + (buf ^ 1) * kTile * VP);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    uint64_t m0, m1;
    tile_bits(s_bits, BQ, j, warp * 16 + g, m0, m1);
    if (__any_sync(kFull, (m0 | m1) != 0)) {
      const bf16* kp = s_kp + buf * kTile * QP;
      const bf16* vt = s_v + buf * kTile * VP;
      float s[kTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D2 / 16; ++kk)
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t bb[4];
          ldsm4(bb, b_frag(kp, QP, np * 16, kk * 16, lane));
          mma16816(s[2 * np], qa[kk], bb[0], bb[1]);
          mma16816(s[2 * np + 1], qa[kk], bb[2], bb[3]);
        }
      // masked scaled scores (log2 units) and each row's new max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint64_t mm = e < 2 ? m0 : m1;
          const float x = (mm >> (nt * 8 + 2 * c + (e & 1))) & 1 ? s[nt][e] * sl2 : -INFINITY;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = m_new == -INFINITY ? 1.f : exp2f(m_run[r] - m_new);  // 0 before a first key
        m_run[r] = m_new;
      }
      // p = 2^(x - m): 0 where masked, and in a row with no key yet
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m_run[e >> 1];
          const float pv = mr == -INFINITY ? 0.f : exp2f(s[nt][e] - mr);
          s[nt][e] = pv;
          rs[e >> 1] += pv;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
      for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
      // o += p . v, with out32 p as the sum of two bf16 operands (hi + lo: 16
      // bits of p), else p rounded to bf16 (hi)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < DK / 16; ++np) {
          uint32_t bb[4];
          ldsm4_t(bb, bt_frag(vt, VP, np * 16, kk * 16, lane));
          mma16816(o[2 * np], hi, bb[0], bb[1]);
          mma16816(o[2 * np + 1], hi, bb[2], bb[3]);
          if (split) {
            mma16816(o[2 * np], lo, bb[0], bb[1]);
            mma16816(o[2 * np + 1], lo, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= t_len) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;  // all-masked row: 0
    const size_t row = ((size_t)b * t_len + t) * d_model + h * DK + 2 * c;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      const float o0 = o[nt][2 * r] * inv, o1 = o[nt][2 * r + 1] * inv;
      *reinterpret_cast<uint32_t*>(out + row + nt * 8) = pack_bf16(o0, o1);
      if (out32 != nullptr) *reinterpret_cast<float2*>(out32 + row + nt * 8) = make_float2(o0, o1);
    }
    if (lse != nullptr && c == 0)
      lse[((size_t)b * n_head + h) * t_len + t] =
          l_run[r] > 0.f ? (m_run[r] + log2f(l_run[r])) * kLn2 : -INFINITY;
  }
}

// dynamic shared memory above 48 KB needs the attribute before the launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Query rows per block: 64 (4 warps). 32 rows with 2 warps was timed against
// it on an H100 (700 W): at the training shape ([12, 191, 256], 144 blocks of
// 64 rows or 288 of 32) both took 0.0187 ms, at the 8 s serving shape
// ([4, 187, 256], 48 or 96 blocks) 0.0153 ms against 0.0151 ms for 32 rows.
// A block's chain of key tiles, not the count of blocks, sets the time; 64
// rows load each key tile half as often.
template <int DK>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* p, const void* v,
                          const void* ub, const void* vb, const void* mask, void* out,
                          void* out32, void* lse, int batch, int t_len, int s_len, int n_head,
                          long long msb, long long mst, long long mss, float scale,
                          cudaStream_t stream) {
  constexpr int BQ = 16 * kTcWarps, QP = 2 * DK + 8, VP = DK + 8;
  const int n_tiles = cdiv(s_len, kTile);
  const size_t smem = sizeof(bf16) * (BQ * QP + 2 * kTile * (QP + VP)) +
                      sizeof(uint32_t) * (2 * n_tiles * BQ + n_tiles);
  cudaError_t err = allow_smem(relpos_fwd_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(t_len, BQ), n_head, batch);
  relpos_fwd_tc_kernel<DK><<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
      static_cast<const bf16*>(v), static_cast<const bf16*>(ub), static_cast<const bf16*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(out32),
      static_cast<float*>(lse), t_len, s_len, n_head, msb, mst, mss, scale);
  return cudaGetLastError();
}


template <int DK>
__global__ void __launch_bounds__(kTcWarps * 32)
relpos_bwd_q_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ p, const bf16* __restrict__ v,
                       const bf16* __restrict__ ubias, const bf16* __restrict__ vbias,
                       const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                       const float* __restrict__ out32, const float* __restrict__ lse,
                       bf16* __restrict__ dq, float* __restrict__ dsum, bf16* __restrict__ qc,
                       int t_len, int s_len, int n_head, long long msb, long long mst,
                       long long mss, float scale) {
  constexpr int BQ = 16 * kTcWarps, D2 = 2 * DK, QP = D2 + 8, VP = DK + 8, CH = DK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [BQ][QP]  [q+u | q+v]
  bf16* s_do = s_q + BQ * QP;                 // [BQ][VP]
  bf16* s_kp = s_do + BQ * VP;                // [2][kTile][QP]  [k | p]
  bf16* s_v = s_kp + 2 * kTile * QP;          // [2][kTile][VP]
  bf16* s_ks = s_v + 2 * kTile * VP;          // [kTile][VP]  k + p in bf16
  float* s_l = reinterpret_cast<float*>(s_ks + kTile * VP);  // [BQ] L in log2 units
  float* s_d = s_l + BQ;                                      // [BQ] D
  const int n_tiles = cdiv(s_len, kTile);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_d + BQ);  // [2 n_tiles][BQ]
  uint32_t* s_live = s_bits + 2 * n_tiles * BQ;              // [n_tiles]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const float sl2 = scale * kLog2e;
  const size_t row0 = ((size_t)b * n_head + h) * t_len;  // this (batch, head) in [B, H, T]

  for (int i = tid; i < n_tiles; i += blockDim.x) s_live[i] = 0;
  __syncthreads();
  query_bits(mask, b * msb, mst, mss, q0, t_len, s_len, n_tiles, s_bits, s_live);
  stage_qc<DK, BQ>(q, ubias, vbias, b, h, q0, t_len, d_model, s_q, qc + row0 * D2);
  for (int i = tid; i < BQ * CH; i += blockDim.x) {
    const int r = i / CH, c8 = (i - r * CH) * 8, t = q0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (t < t_len)
      x = *reinterpret_cast<const uint4*>(dout + ((size_t)b * t_len + t) * d_model + h * DK + c8);
    *reinterpret_cast<uint4*>(s_do + r * VP + c8) = x;
  }
  __syncthreads();
  // D = rowsum(do * o) in fp32, o the forward's fp32 output: two lanes per
  // row, dk / 2 features each
  {
    const int r = warp * 16 + (lane >> 1), t = q0 + r, d0 = (lane & 1) * (DK / 2);
    float acc = 0.f;
    if (t < t_len) {
      const float* orow = out32 + ((size_t)b * t_len + t) * d_model + h * DK + d0;
#pragma unroll
      for (int i = 0; i < DK / 2; i += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(s_do + r * VP + d0 + i);
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = *reinterpret_cast<const float2*>(orow + i + 2 * w);
          const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[w]));
          acc = fmaf(a.x, z.x, acc);
          acc = fmaf(a.y, z.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if ((lane & 1) == 0) {
      s_d[r] = acc;
      s_l[r] = t < t_len ? lse[row0 + t] * kLog2e : 0.f;
      if (t < t_len) dsum[row0 + t] = acc;
    }
  }

  int j = next_live(s_live, 0, n_tiles);
  if (j < n_tiles) load_keys<DK>(k, p, v, b, h, j * kTile, s_len, d_model, s_kp, s_v);
  cp_async_commit();
  __syncthreads();
  uint32_t qa[D2 / 16][4], ga[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < D2 / 16; ++kk) ldsm4(qa[kk], a_frag(s_q, QP, warp * 16, kk * 16, lane));
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) ldsm4(ga[kk], a_frag(s_do, VP, warp * 16, kk * 16, lane));
  const float lr[2] = {s_l[warp * 16 + g], s_l[warp * 16 + g + 8]};
  const float dr[2] = {s_d[warp * 16 + g], s_d[warp * 16 + g + 8]};
  float acc[DK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int buf = 0; j < n_tiles; buf ^= 1) {
    const int jn = next_live(s_live, j + 1, n_tiles);
    if (jn < n_tiles)
      load_keys<DK>(k, p, v, b, h, jn * kTile, s_len, d_model, s_kp + (buf ^ 1) * kTile * QP,
                    s_v + (buf ^ 1) * kTile * VP);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kp = s_kp + buf * kTile * QP;
    const bf16* vt = s_v + buf * kTile * VP;
    for (int i = tid; i < kTile * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i - r * CH) * 8;
      *reinterpret_cast<uint4*>(s_ks + r * VP + c8) =
          add_bf16x8(*reinterpret_cast<const uint4*>(kp + r * QP + c8),
                     *reinterpret_cast<const uint4*>(kp + r * QP + DK + c8));
    }
    __syncthreads();
    uint64_t m0, m1;
    tile_bits(s_bits, BQ, j, warp * 16 + g, m0, m1);
    if (__any_sync(kFull, (m0 | m1) != 0)) {
#pragma unroll
      for (int sub = 0; sub < kTile / 32; ++sub) {  // 32 keys at a time
        float s[4][4], dp[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D2 / 16; ++kk)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm4(bb, b_frag(kp, QP, sub * 32 + np * 16, kk * 16, lane));
            mma16816(s[2 * np], qa[kk], bb[0], bb[1]);
            mma16816(s[2 * np + 1], qa[kk], bb[2], bb[3]);
          }
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm4(bb, b_frag(vt, VP, sub * 32 + np * 16, kk * 16, lane));
            mma16816(dp[2 * np], ga[kk], bb[0], bb[1]);
            mma16816(dp[2 * np + 1], ga[kk], bb[2], bb[3]);
          }
        // ds = p (dP - D) scale with p = 2^(s sl2 - L): 0 where masked
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = ((r ? m1 : m0) >> (sub * 32 + nt * 8 + 2 * c + (e & 1))) & 1;
            const float pr = ok ? exp2f(s[nt][e] * sl2 - lr[r]) : 0.f;
            s[nt][e] = pr * (dp[nt][e] - dr[r]) * scale;
          }
        // dq += ds . (k + p), ds rounded to bf16
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < DK / 16; ++np) {
            uint32_t bb[4];
            ldsm4_t(bb, bt_frag(s_ks, VP, np * 16, sub * 32 + kk * 16, lane));
            mma16816(acc[2 * np], da, bb[0], bb[1]);
            mma16816(acc[2 * np + 1], da, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= t_len) continue;
    bf16* row = dq + ((size_t)b * t_len + t) * d_model + h * DK;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * c) =
          pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

template <int DK>
__global__ void __launch_bounds__(kTcWarps * 32)
relpos_bwd_kv_tc_kernel(const bf16* __restrict__ k, const bf16* __restrict__ p,
                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dsum, const bf16* __restrict__ qc,
                        bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                        float* __restrict__ dp, float* __restrict__ du, float* __restrict__ dvb,
                        int t_len, int s_len, int n_head, long long msb, long long mst,
                        long long mss, float scale) {
  constexpr int BK = 16 * kTcWarps, D2 = 2 * DK, QP = D2 + 8, VP = DK + 8, CH = DK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_kp = reinterpret_cast<bf16*>(smem);  // [BK][QP]  [k | p] of the block's keys
  bf16* s_v = s_kp + BK * QP;                  // [BK][VP]
  bf16* s_q = s_v + BK * VP;                   // [2][kTile][QP]  [q+u | q+v] of a query tile
  bf16* s_do = s_q + 2 * kTile * QP;           // [2][kTile][VP]
  float* s_l = reinterpret_cast<float*>(s_do + 2 * kTile * VP);  // [2][kTile]
  float* s_d = s_l + 2 * kTile;                                   // [2][kTile]
  float* s_col = s_d + 2 * kTile;                                 // [BK]
  const int n_tiles = cdiv(t_len, kTile);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_col + BK);  // [2 n_tiles][BK]
  uint32_t* s_live = s_bits + 2 * n_tiles * BK;                // [n_tiles]

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * BK;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const float sl2 = scale * kLog2e;
  const size_t row0 = ((size_t)b * n_head + h) * t_len;

  load_keys<DK>(k, p, v, b, h, key0, s_len, d_model, s_kp, s_v);
  cp_async_commit();
  for (int i = tid; i < n_tiles; i += blockDim.x) s_live[i] = 0;
  __syncthreads();
  // the mask bits of every query row against the block's keys: word w
  // (queries 32 w .. 32 w + 31) of key r at s_bits[w * BK + r]
  const long long mb = b * msb;
  for (int w = warp; w < 2 * n_tiles; w += kTcWarps) {
    const int t = w * 32 + lane;
    uint32_t any = 0;
#pragma unroll 1
    for (int r0 = 0; r0 < BK; r0 += 16) {
      bool ok[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int s = key0 + r0 + r;
        ok[r] = t < t_len && s < s_len && mask[mb + t * mst + s * mss] != 0;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const uint32_t bits = __ballot_sync(kFull, ok[r]);
        if (lane == 0) s_bits[w * BK + r0 + r] = bits;
        any |= bits;
      }
    }
    if (lane == 0 && any != 0) atomicOr(s_live + w / 2, 1u);
  }
  __syncthreads();

  // the query tile at t0 into buffer `buf`, in flight; rows past T zero
  auto load_queries = [&](int t0, int buf) {
    bf16* sq = s_q + buf * kTile * QP;
    bf16* sg = s_do + buf * kTile * VP;
    for (int i = tid; i < kTile * 2 * CH; i += blockDim.x) {
      const int r = i / (2 * CH), c8 = (i - r * 2 * CH) * 8, t = t0 + r;
      const bool in = t < t_len;
      const int tc = in ? t : 0;
      cp_async16(sq + r * QP + c8, qc + (row0 + tc) * D2 + c8, in);
      if (c8 < DK)
        cp_async16(sg + r * VP + c8, dout + ((size_t)b * t_len + tc) * d_model + h * DK + c8, in);
    }
    for (int i = tid; i < kTile; i += blockDim.x) {
      const int t = t0 + i;
      const bool in = t < t_len;
      cp_async4(s_l + buf * kTile + i, lse + row0 + (in ? t : 0), in);
      cp_async4(s_d + buf * kTile + i, dsum + row0 + (in ? t : 0), in);
    }
  };

  int j = next_live(s_live, 0, n_tiles);
  if (j < n_tiles) load_queries(j * kTile, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the keys have landed
  __syncthreads();
  uint32_t ka[D2 / 16][4], va[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < D2 / 16; ++kk) ldsm4(ka[kk], a_frag(s_kp, QP, warp * 16, kk * 16, lane));
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) ldsm4(va[kk], a_frag(s_v, VP, warp * 16, kk * 16, lane));
  float dv[DK / 8][4], dkp[D2 / 8][4], col[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < D2 / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkp[nt][e] = 0.f;

  for (int buf = 0; j < n_tiles; buf ^= 1) {
    const int jn = next_live(s_live, j + 1, n_tiles);
    if (jn < n_tiles) load_queries(jn * kTile, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    uint64_t m0, m1;  // this thread's keys g and g + 8 of the warp, over the tile's queries
    tile_bits(s_bits, BK, j, warp * 16 + g, m0, m1);
    if (__any_sync(kFull, (m0 | m1) != 0)) {
      const bf16* sq = s_q + buf * kTile * QP;
      const bf16* sg = s_do + buf * kTile * VP;
      const float* sl = s_l + buf * kTile;
      const float* sd = s_d + buf * kTile;
#pragma unroll
      for (int q16 = 0; q16 < kTile; q16 += 16) {  // 16 queries at a time
        float st[2][4], gt[2][4];  // s^T and dP^T: keys x queries
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = gt[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D2 / 16; ++kk) {
          uint32_t bb[4];
          ldsm4(bb, b_frag(sq, QP, q16, kk * 16, lane));
          mma16816(st[0], ka[kk], bb[0], bb[1]);
          mma16816(st[1], ka[kk], bb[2], bb[3]);
        }
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          uint32_t bb[4];
          ldsm4(bb, b_frag(sg, VP, q16, kk * 16, lane));
          mma16816(gt[0], va[kk], bb[0], bb[1]);
          mma16816(gt[1], va[kk], bb[2], bb[3]);
        }
        // p^T and ds^T; the column (query) statistics L and D
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int q = q16 + nt * 8 + 2 * c;
          const float2 lq = *reinterpret_cast<const float2*>(sl + q);
          const float2 dq2 = *reinterpret_cast<const float2*>(sd + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l2 = (e & 1 ? lq.y : lq.x) * kLog2e, dd = e & 1 ? dq2.y : dq2.x;
            const bool ok = ((e < 2 ? m0 : m1) >> (q + (e & 1))) & 1;
            const float pr = ok ? exp2f(st[nt][e] * sl2 - l2) : 0.f;
            const float ds = pr * (gt[nt][e] - dd) * scale;
            col[e >> 1] += ds;
            st[nt][e] = pr;
            gt[nt][e] = ds;
          }
        }
        uint32_t pa[4], pl[4];  // p^T as hi + lo: dv from p to fp32 precision, as :109-110
        split_bf16(st[0][0], st[0][1], pa[0], pl[0]);
        split_bf16(st[0][2], st[0][3], pa[1], pl[1]);
        split_bf16(st[1][0], st[1][1], pa[2], pl[2]);
        split_bf16(st[1][2], st[1][3], pa[3], pl[3]);
        const uint32_t da[4] = {pack_bf16(gt[0][0], gt[0][1]), pack_bf16(gt[0][2], gt[0][3]),
                                pack_bf16(gt[1][0], gt[1][1]), pack_bf16(gt[1][2], gt[1][3])};
        // dv += p^T . do
#pragma unroll
        for (int np = 0; np < DK / 16; ++np) {
          uint32_t bb[4];
          ldsm4_t(bb, bt_frag(sg, VP, np * 16, q16, lane));
          mma16816(dv[2 * np], pa, bb[0], bb[1]);
          mma16816(dv[2 * np + 1], pa, bb[2], bb[3]);
          mma16816(dv[2 * np], pl, bb[0], bb[1]);
          mma16816(dv[2 * np + 1], pl, bb[2], bb[3]);
        }
        // [dk | dp] += ds^T . [q+u | q+v]
#pragma unroll
        for (int np = 0; np < D2 / 16; ++np) {
          uint32_t bb[4];
          ldsm4_t(bb, bt_frag(sq, QP, np * 16, q16, lane));
          mma16816(dkp[2 * np], da, bb[0], bb[1]);
          mma16816(dkp[2 * np + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    col[r] += __shfl_xor_sync(kFull, col[r], 1);
    col[r] += __shfl_xor_sync(kFull, col[r], 2);
    const int kr = warp * 16 + g + 8 * r, s = key0 + kr;
    if (c == 0) s_col[kr] = __bfloat162float(__float2bfloat16(col[r]));  // rounded as :128
    if (s >= s_len) continue;
    const size_t off = ((size_t)b * s_len + s) * d_model + h * DK + 2 * c;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dv_out + off + nt * 8) =
          pack_bf16(dv[nt][2 * r], dv[nt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dk_out + off + nt * 8) =
          pack_bf16(dkp[nt][2 * r], dkp[nt][2 * r + 1]);
      float* dprow = dp + (size_t)s * d_model + h * DK + nt * 8 + 2 * c;
      atomicAdd(dprow, dkp[DK / 8 + nt][2 * r]);
      atomicAdd(dprow + 1, dkp[DK / 8 + nt][2 * r + 1]);
    }
  }
  __syncthreads();
  // du / dvb += col . k / col . p over the block's keys (keys past S: 0)
  for (int i = tid; i < 2 * DK; i += blockDim.x) {
    const int which = i / DK, d = i - which * DK;
    float acc = 0.f;
    for (int kr = 0; kr < BK; ++kr)
      acc = fmaf(s_col[kr], __bfloat162float(s_kp[kr * QP + which * DK + d]), acc);
    atomicAdd((which ? dvb : du) + h * DK + d, acc);
  }
}

template <int DK>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* p, const void* v,
                          const void* ub, const void* vb, const void* mask, const void* dout,
                          const void* out, const void* lse, void* dq, void* dk, void* dv,
                          void* dp, void* du, void* dvb, void* dsum, void* qc, int batch,
                          int t_len, int s_len, int n_head, long long msb, long long mst,
                          long long mss, float scale, cudaStream_t stream) {
  constexpr int B64 = 16 * kTcWarps, QP = 2 * DK + 8, VP = DK + 8;
  int n_tiles = cdiv(s_len, kTile);
  size_t smem = sizeof(bf16) * (B64 * (QP + VP) + 2 * kTile * (QP + VP) + kTile * VP) +
                sizeof(float) * 2 * B64 + sizeof(uint32_t) * (2 * n_tiles * B64 + n_tiles);
  cudaError_t err = allow_smem(relpos_bwd_q_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  relpos_bwd_q_tc_kernel<DK><<<dim3(cdiv(t_len, B64), n_head, batch), kTcWarps * 32, smem,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
      static_cast<const bf16*>(v), static_cast<const bf16*>(ub), static_cast<const bf16*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(out), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      static_cast<float*>(dsum), static_cast<bf16*>(qc), t_len, s_len, n_head, msb, mst, mss,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  n_tiles = cdiv(t_len, kTile);
  smem = sizeof(bf16) * (B64 * (QP + VP) + 2 * kTile * (QP + VP)) +
         sizeof(float) * (4 * kTile + B64) + sizeof(uint32_t) * (2 * n_tiles * B64 + n_tiles);
  err = allow_smem(relpos_bwd_kv_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  relpos_bwd_kv_tc_kernel<DK><<<dim3(cdiv(s_len, B64), n_head, batch), kTcWarps * 32, smem,
                                stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(p), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<const bf16*>(qc), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dp), static_cast<float*>(du), static_cast<float*>(dvb), t_len, s_len,
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
// 64. bf16 only (the fp32 kernel reads neither): out32 and lse, both null or
// both set, fp32 [B, T, H*dk] for the output before its rounding to bf16 and
// fp32 [B, H, T] for each row's log-sum-exp, what the backward reads.
int relpos_attention_fwd(const void* q, const void* k, const void* p,
                         const void* v, const void* ub, const void* vb,
                         const void* mask, void* out, void* out32, void* lse, int batch,
                         int t_len, int s_len, int n_head, int dk, long long msb,
                         long long mst, long long mss, float scale, int is_bf16,
                         void* stream) {
  if (batch == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_FWD_TC(DK)                                                                   \
  err = launch_fwd_tc<DK>(q, k, p, v, ub, vb, mask, out, out32, lse, batch, t_len, s_len, \
                          n_head, msb, mst, mss, scale, st)
#define TPUASR_FWD(DK)                                                                    \
  err = launch<float, DK>(q, k, p, v, ub, vb, mask, out, batch, t_len, s_len, n_head, \
                          msb, mst, mss, scale, st)
  if (is_bf16) {
    if (dk == 16) TPUASR_FWD_TC(16);
    if (dk == 32) TPUASR_FWD_TC(32);
    if (dk == 64) TPUASR_FWD_TC(64);
  } else {
    if (dk == 16) TPUASR_FWD(16);
    if (dk == 32) TPUASR_FWD(32);
    if (dk == 64) TPUASR_FWD(64);
  }
#undef TPUASR_FWD_TC
#undef TPUASR_FWD
  return static_cast<int>(err);
}

// The backward of relpos_attention_fwd: + do [B, T, H*dk] (q's type) ->
// dq [B, T, H*dk], dk, dv [B, S, H*dk] in q's type; dp [1, S, H*dk], du,
// dvb [H*dk] fp32, zeroed by the caller (the kernels add into them).
// bf16: out (fp32 [B, T, H*dk], the output before rounding: out32) and lse
// [B, H, T] as relpos_attention_fwd wrote them; stats fp32 [B, H, T]
// scratch (each row's rowsum(do * out)), qc bf16 [B, H, T, 2 dk] scratch
// ([q+u | q+v]). fp32: out, lse and qc unread,
// stats [B, H, T, 3] fp32 scratch (each row's max, sum and rowsum(da * a)).
// T, S >= 1.
int relpos_attention_bwd(const void* q, const void* k, const void* p, const void* v,
                         const void* ub, const void* vb, const void* mask,
                         const void* dout, const void* out, const void* lse, void* dq, void* dk,
                         void* dv, void* dp, void* du, void* dvb, void* stats, void* qc,
                         int batch, int t_len, int s_len, int n_head, int dk_, long long msb,
                         long long mst, long long mss, float scale, int is_bf16, void* stream) {
  if (batch == 0 || t_len == 0 || s_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_BWD_TC(DK)                                                                    \
  err = launch_bwd_tc<DK>(q, k, p, v, ub, vb, mask, dout, out, lse, dq, dk, dv, dp, du, dvb, \
                          stats, qc, batch, t_len, s_len, n_head, msb, mst, mss, scale, st)
#define TPUASR_BWD(DK)                                                                        \
  err = launch_bwd<float, DK>(q, k, p, v, ub, vb, mask, dout, dq, dk, dv, dp, du, dvb, stats, \
                              batch, t_len, s_len, n_head, msb, mst, mss, scale, st)
  if (is_bf16) {
    if (dk_ == 16) TPUASR_BWD_TC(16);
    if (dk_ == 32) TPUASR_BWD_TC(32);
    if (dk_ == 64) TPUASR_BWD_TC(64);
  } else {
    if (dk_ == 16) TPUASR_BWD(16);
    if (dk_ == 32) TPUASR_BWD(32);
    if (dk_ == 64) TPUASR_BWD(64);
  }
#undef TPUASR_BWD_TC
#undef TPUASR_BWD
  return static_cast<int>(err);
}

}  // extern "C"
