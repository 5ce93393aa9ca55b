// CTC lattice over per-state emission log-probs: the alpha sweep (forward)
// and the beta sweep fused with the gradient (backward).
//
// Replaces the TPU kernels `_alpha_kernel` / `_ctc_forward`
// (tpuasr/ops/ctc_pallas.py:56-80, :140) and `_beta_grad_kernel` /
// `_ctc_bwd` (:83-131, :179). lp [B, T, S] holds the masked emission
// log-probs of the S = 2U+1 blank-interleaved states (-1e30 past the valid
// states); skip [B, S] says whether s-2 -> s is allowed; rows freeze from
// t_len on; final [B, S] marks the one or two final states. The log-add
// keeps the JAX package's convention: -1e30 stands in for -inf and the max is
// clamped there, so nothing turns into NaN.
//
// What bounds it on an H100: neither bytes nor flops. At the flagship's
// training shape (B 12, T' 191, S 65) each sweep reads or writes ~1-2 MB
// (under a microsecond at 3.35 TB/s) and does ~15 flops per cell, but each
// row's t_len steps depend on each other: the floor is t_len times the
// latency of one step, a shuffle, a few min/max and adds and two
// dependent MUFU instructions (ex2, then lg2). The design shortens that step
// and takes everything else off the chain.
//
// Two routes, chosen by shape alone in tpuasr_torch/ops/ctc.py `_ctc_plan`:
//
// - warp (S <= 32 * kMaxK = 256, U <= 127): one warp per utterance, a
//   block each. Lane l holds K = ceil(S / 32) states in registers,
//   contiguous (lK .. lK+K-1), so s-1 and s-2 (s+1 and s+2 backward) are
//   mostly the lane's own and two shuffles bring the rest from lane l-1
//   (l+1). On an H100 this beat a strided layout (s = l + 32k, 2K shuffles a
//   step) and two or four utterances a block. A step is the shuffles, one
//   three-term log-add m + e + log(1 + e^(x-m) + e^(y-m)), m the max clamped
//   at -1e30 (two exponentials and one log, one MUFU instruction each:
//   `ex2.approx.ftz` / `lg2.approx.ftz`, whose error is far inside the
//   tolerances), and no barrier. The skip and final flags are bitmasks in
//   registers. Emissions, and for the backward the alpha tape, come from
//   device memory through a shared-memory ring of two chunks of up to 32
//   frames (not the whole utterance: the ring bounds shared memory whatever
//   T), filled by cp.async a chunk ahead of the chain, so a step reads
//   shared memory and never waits on a global load. The chain runs only for
//   t < t_len: the alpha rows past it (copies of the last live row) and the
//   zero gradients past it are plain stores that nothing waits on. The
//   backward restarts at t_len - 1 from the final states and writes frame
//   t+1's gradient, g * exp(min(alpha + (beta - lp) - ll, 0)), from
//   registers carried over a step, beside frame t's chain. ll, the
//   log-sum-exp of the final states, is a warp reduction in a fixed order.
// - block (S > 256): one block per utterance, one thread per state (a
//   block-stride loop for S > 1024), the row double-buffered in shared
//   memory with one barrier a step, and the two-term log-add nested twice:
//   the first design, kept for label sequences the warp's registers do not
//   hold.
//
// Neither route uses atomics: two calls give the same bits.

#include "mma.cuh"

namespace {

constexpr float kNeg = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxK = 8;  // states a lane holds on the warp route

constexpr float kLog2e = 1.44269504088896341f, kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), kNeg);
  return m + log1pf(expf(fminf(a, b) - m));
}

// e^x and log(x) in one MUFU instruction each (ex2 / lg2, results below
// 2^-126 flushed to 0: they add nothing to a sum that holds a 1)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}
__device__ __forceinline__ float lg2_fast(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(e^a + e^b + e^c) + e: m, the largest clamped at -1e30, plus e, plus
// the log of m's own term (1) and the other two; the clamp sits beside the
// first max, and m + e beside the exponentials
__device__ __forceinline__ float logadd3(float a, float b, float c, float e) {
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float m = fmaxf(hi, fmaxf(c, kNeg));
  const float sum = 1.f + exp_fast(fminf(hi, c) - m) + exp_fast(lo - m);
  return fmaf(lg2_fast(sum), kLn2, m + e);
}

// Lane l holds states lK .. lK+K-1. alpha's neighbours from below: p1[k] =
// row[s-1], p2[k] = row[s-2] (-1e30 under state 0), the lane's own but for
// its first one or two, which one shuffle each brings from lane l-1
template <int K>
__device__ __forceinline__ void from_below(const float (&a)[K], int lane, float (&p1)[K],
                                           float (&p2)[K]) {
  const float u1 = __shfl_up_sync(kFull, a[K - 1], 1);
  float w1 = lane >= 1 ? u1 : kNeg, w2;
  if constexpr (K >= 2) {
    const float u2 = __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], 1);
    w2 = lane >= 1 ? u2 : kNeg;
  } else {
    const float u2 = __shfl_up_sync(kFull, a[0], 2);
    w2 = lane >= 2 ? u2 : kNeg;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p1[k] = k >= 1 ? a[k >= 1 ? k - 1 : 0] : w1;
    p2[k] = k >= 2 ? a[k >= 2 ? k - 2 : 0] : (k == 1 ? w1 : w2);
  }
}

// beta's neighbours from above: q1[k] = row[s+1], q2[k] = row[s+2] (-1e30
// past the last lane's states), the lane's own but for its last one or
// two, which one shuffle each brings from lane l+1
template <int K>
__device__ __forceinline__ void from_above(const float (&b)[K], int lane, float (&q1)[K],
                                           float (&q2)[K]) {
  const float d1 = __shfl_down_sync(kFull, b[0], 1);
  float w1 = lane <= 30 ? d1 : kNeg, w2;
  if constexpr (K >= 2) {
    const float d2 = __shfl_down_sync(kFull, b[K >= 2 ? 1 : 0], 1);
    w2 = lane <= 30 ? d2 : kNeg;
  } else {
    const float d2 = __shfl_down_sync(kFull, b[0], 2);
    w2 = lane <= 29 ? d2 : kNeg;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    q1[k] = k + 1 < K ? b[k + 1 < K ? k + 1 : 0] : w1;
    q2[k] = k + 2 < K ? b[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? w1 : w2);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// frames [c*ch, min(c*ch + ch, rows)) of one utterance's [T, S] array into
// ring buffer c & 1 (a buffer is ch rows of S floats), four bytes a copy (a
// row of S floats is 16-byte aligned only now and then)
__device__ __forceinline__ void stage_chunk(float* ring, const float* src, int c, int ch,
                                            int rows, int S, int lane) {
  const int lo = c * ch, n = (min(lo + ch, rows) - lo) * S;
  float* dst = ring + (size_t)(c & 1) * ch * S;
  const float* from = src + (size_t)lo * S;
  for (int i = lane; i < n; i += kWarp) cp_async4(dst + i, from + i, true);
}

template <int K>
__global__ void ctc_alpha_warp_kernel(const float* __restrict__ lp,
                                      const uint8_t* __restrict__ skip,
                                      const int* __restrict__ tlens,
                                      const uint8_t* __restrict__ fin,
                                      float* __restrict__ alpha, float* __restrict__ ll, int T,
                                      int S, int ch) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x, b = blockIdx.x;
  const float* lpb = lp + (size_t)b * T * S;
  float* ab = alpha + (size_t)b * T * S;
  // the first two chunks go out before t_len is known (a chunk may run past it)
  stage_chunk(ring, lpb, 0, ch, T, S, lane);
  cp_async_commit();
  if (T > ch) stage_chunk(ring, lpb, 1, ch, T, S, lane);
  cp_async_commit();
  const int tend = max(min(tlens[b], T), 1);  // rows the chain computes (row 0 always)
  const int nc = (tend + ch - 1) / ch;

  unsigned valid = 0, skips = 0, finals = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    if (s < S) {
      valid |= 1u << k;
      skips |= (skip[(size_t)b * S + s] ? 1u : 0u) << k;
      finals |= (fin[(size_t)b * S + s] ? 1u : 0u) << k;
    }
  }
  cp_async_wait<1>();
  __syncwarp();
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    a[k] = (valid >> k & 1) && s < 2 ? ring[s] : kNeg;
    if (valid >> k & 1) ab[s] = a[k];
  }
  int t = 1;
  for (int c = 0; c < nc; ++c) {
    if (c > 0) {  // chunk c has landed and every lane is done with chunk c-1's buffer
      cp_async_wait<0>();
      __syncwarp();
      if (c + 1 < nc) stage_chunk(ring, lpb, c + 1, ch, T, S, lane);
      cp_async_commit();
    }
    const int t_hi = min(c * ch + ch, tend);
    for (; t < t_hi; ++t) {
      const float* row = ring + (size_t)((c & 1) * ch + t - c * ch) * S;
      float e[K], p1[K], p2[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        e[k] = (valid >> k & 1) ? row[lane * K + k] : kNeg;
      from_below<K>(a, lane, p1, p2);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = logadd3(a[k], p1[k], (skips >> k & 1) ? p2[k] : kNeg, e[k]);
        a[k] = (valid >> k & 1) ? v : kNeg;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (valid >> k & 1) ab[(size_t)t * S + lane * K + k] = a[k];
    }
  }
  for (int r = tend; r < T; ++r) {  // frozen rows: the last live row again
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (valid >> k & 1) ab[(size_t)r * S + lane * K + k] = a[k];
  }
  // ll = logsumexp of the final states (one or two), clamped at -1e30
  float m = kNeg;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (finals >> k & 1) m = fmaxf(m, a[k]);
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (valid >> k & 1) sum += expf(((finals >> k & 1) ? a[k] : kNeg) - m);
  sum = warp_sum(sum);
  if (lane == 0) ll[b] = m + logf(sum);
}

template <int K>
__global__ void ctc_beta_grad_warp_kernel(const float* __restrict__ lp,
                                          const uint8_t* __restrict__ skip,
                                          const int* __restrict__ tlens,
                                          const uint8_t* __restrict__ fin,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ ll,
                                          const float* __restrict__ g,
                                          float* __restrict__ grad, int T, int S, int ch) {
  extern __shared__ float ring_lp[];
  const int lane = threadIdx.x, b = blockIdx.x;
  float* ring_al = ring_lp + (size_t)2 * ch * S;
  const size_t base = (size_t)b * T * S;
  const float* lpb = lp + base;
  const float* ab = alpha + base;
  float* gr = grad + base;
  const int tend = min(tlens[b], T);  // frames with a gradient (none if <= 0)
  const int nc = tend > 0 ? (tend + ch - 1) / ch : 0;
  if (nc > 0) {  // the chunks from the last frame down
    stage_chunk(ring_lp, lpb, nc - 1, ch, tend, S, lane);
    stage_chunk(ring_al, ab, nc - 1, ch, tend, S, lane);
    cp_async_commit();
    if (nc > 1) {
      stage_chunk(ring_lp, lpb, nc - 2, ch, tend, S, lane);
      stage_chunk(ring_al, ab, nc - 2, ch, tend, S, lane);
    }
    cp_async_commit();
  }
  unsigned valid = 0, skips2 = 0, finals = 0;  // skips2: s -> s+2 allowed
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    if (s < S) {
      valid |= 1u << k;
      skips2 |= (s + 2 < S && skip[(size_t)b * S + s + 2] ? 1u : 0u) << k;
      finals |= (fin[(size_t)b * S + s] ? 1u : 0u) << k;
    }
  }
  for (int r = max(tend, 0); r < T; ++r) {  // padded frames: no gradient
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (valid >> k & 1) gr[(size_t)r * S + lane * K + k] = 0.f;
  }
  if (nc == 0) return;
  const float llb = ll[b], gb = g[b];
  // grad[t, s] = g * d(ll)/d(lp[t, s]) = g * exp(alpha + (beta - lp) - ll)
  auto emit = [&](int t, const float(&beta)[K], const float(&e)[K], const float(&al)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (valid >> k & 1)
        gr[(size_t)t * S + lane * K + k] =
            gb * exp_fast(fminf(al[k] + (beta[k] - e[k]) - llb, 0.f));
  };
  cp_async_wait<1>();
  __syncwarp();
  int t = tend - 1;
  float beta[K], pe[K], pa[K];  // frame t+1's beta, emission and alpha, carried a step
  {
    const size_t r = (size_t)(((nc - 1) & 1) * ch + t - (nc - 1) * ch) * S;
#pragma unroll
    for (int k = 0; k < K; ++k) {  // the row's last frame: the final states
      const int s = lane * K + k;
      pe[k] = (valid >> k & 1) ? ring_lp[r + s] : kNeg;
      pa[k] = (valid >> k & 1) ? ring_al[r + s] : kNeg;
      beta[k] = (finals >> k & 1) ? pe[k] : kNeg;
    }
  }
  --t;
  for (int c = nc - 1; c >= 0; --c) {
    if (c < nc - 1) {  // chunk c has landed and every lane is done with chunk c+1's buffer
      cp_async_wait<0>();
      __syncwarp();
      if (c > 0) {
        stage_chunk(ring_lp, lpb, c - 1, ch, tend, S, lane);
        stage_chunk(ring_al, ab, c - 1, ch, tend, S, lane);
      }
      cp_async_commit();
    }
    for (; t >= c * ch; --t) {
      const size_t r = (size_t)((c & 1) * ch + t - c * ch) * S;
      float e[K], al[K], q1[K], q2[K], nb[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = lane * K + k;
        e[k] = (valid >> k & 1) ? ring_lp[r + s] : kNeg;
        al[k] = (valid >> k & 1) ? ring_al[r + s] : kNeg;
      }
      from_above<K>(beta, lane, q1, q2);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = logadd3(beta[k], q1[k], (skips2 >> k & 1) ? q2[k] : kNeg, e[k]);
        nb[k] = (valid >> k & 1) ? v : kNeg;
      }
      emit(t + 1, beta, pe, pa);  // off the chain: nothing below waits on it
#pragma unroll
      for (int k = 0; k < K; ++k) {
        beta[k] = nb[k];
        pe[k] = e[k];
        pa[k] = al[k];
      }
    }
  }
  emit(0, beta, pe, pa);
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const uint8_t* __restrict__ skip,
                                 const int* __restrict__ tlens,
                                 const uint8_t* __restrict__ fin,
                                 float* __restrict__ alpha, float* __restrict__ ll,
                                 int T, int S) {
  extern __shared__ float rows[];
  float* cur = rows;
  float* nxt = rows + S;
  const int b = blockIdx.x;
  const float* lpb = lp + (size_t)b * T * S;
  float* ab = alpha + (size_t)b * T * S;
  const uint8_t* sk = skip + (size_t)b * S;
  const int tl = tlens[b];

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float a = s < 2 ? lpb[s] : kNeg;
    cur[s] = a;
    ab[s] = a;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const bool active = t < tl;
    const float* lpt = lpb + (size_t)t * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float a = cur[s];
      if (active) {
        const float a1 = s >= 1 ? cur[s - 1] : kNeg;
        const float a2 = (s >= 2 && sk[s]) ? cur[s - 2] : kNeg;
        a = logaddexp(logaddexp(a, a1), a2) + lpt[s];
      }
      nxt[s] = a;
      ab[(size_t)t * S + s] = a;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (threadIdx.x == 0) {  // ll = logsumexp of the final states (one or two)
    const uint8_t* fb = fin + (size_t)b * S;
    float m = kNeg;
    for (int s = 0; s < S; ++s)
      if (fb[s]) m = fmaxf(m, cur[s]);
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += expf((fb[s] ? cur[s] : kNeg) - m);
    ll[b] = m + logf(sum);
  }
}

__global__ void ctc_beta_grad_kernel(const float* __restrict__ lp,
                                     const uint8_t* __restrict__ skip,
                                     const int* __restrict__ tlens,
                                     const uint8_t* __restrict__ fin,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ ll,
                                     const float* __restrict__ g,
                                     float* __restrict__ grad, int T, int S) {
  extern __shared__ float rows[];
  float* cur = rows;
  float* nxt = rows + S;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * T * S;
  const float* lpb = lp + base;
  const float* ab = alpha + base;
  float* gr = grad + base;
  const uint8_t* sk = skip + (size_t)b * S;
  const uint8_t* fb = fin + (size_t)b * S;
  const int tl = tlens[b];
  const float llb = ll[b], gb = g[b];

  // grad[t, s] = g * d(ll)/d(lp[t, s]) = g * exp(alpha + (beta - lp) - ll)
  auto emit = [&](int t, int s, float beta) {
    const size_t i = (size_t)t * S + s;
    gr[i] = t < tl ? gb * expf(fminf(ab[i] + (beta - lpb[i]) - llb, 0.f)) : 0.f;
  };

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float beta = fb[s] ? lpb[(size_t)(T - 1) * S + s] : kNeg;
    cur[s] = beta;
    emit(T - 1, s, beta);
  }
  __syncthreads();
  for (int t = T - 2; t >= 0; --t) {
    const float* lpt = lpb + (size_t)t * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float beta;
      if (t >= tl) {  // past the row's end: frozen
        beta = cur[s];
      } else if (t == tl - 1) {  // the row's last frame: restart at the final states
        beta = fb[s] ? lpt[s] : kNeg;
      } else {
        const float b1 = s + 1 < S ? cur[s + 1] : kNeg;
        const float b2 = (s + 2 < S && sk[s + 2]) ? cur[s + 2] : kNeg;
        beta = logaddexp(logaddexp(cur[s], b1), b2) + lpt[s];
      }
      nxt[s] = beta;
      emit(t, s, beta);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, int S, size_t* smem, int* threads) {
  *smem = 2 * sizeof(float) * (size_t)S;
  *threads = ((S + 31) / 32) * 32;
  if (*threads > 1024) *threads = 1024;
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

// the warp route's shared memory: a ring of two chunks of `ch` frames of
// `arrays` [T, S] arrays, within the 48 KB a block has without opting in
// (the plan never asks more)
cudaError_t ring_bytes(int S, int k, int ch, int arrays, size_t* smem) {
  if (k < 1 || k > kMaxK || kWarp * k < S || ch < 1) return cudaErrorInvalidValue;
  *smem = sizeof(float) * (size_t)arrays * 2 * ch * S;
  return *smem > 48 * 1024 ? cudaErrorInvalidValue : cudaSuccess;
}

// the warp route's kernel for k states a lane: one warp a block, a block an
// utterance
#define CTC_WARP_SWITCH(KERNEL, ...)                                       \
  switch (k) {                                                              \
    case 1: KERNEL<1><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 2: KERNEL<2><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 3: KERNEL<3><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 4: KERNEL<4><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 5: KERNEL<5><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 6: KERNEL<6><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 7: KERNEL<7><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
    case 8: KERNEL<8><<<B, kWarp, smem, st>>>(__VA_ARGS__); break;          \
  }

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp [B, T, S] fp32, skip [B, S] bool, tlens [B] int32, final [B, S] bool ->
// alpha [B, T, S] fp32, ll [B] fp32; all contiguous, T >= 1. k = 0: the block
// route; k = 1..8: the warp route with k states a lane (32k >= S) and ring
// chunks of ch frames.
int ctc_alpha(const void* lp, const void* skip, const void* tlens, const void* fin,
              void* alpha, void* ll, int B, int T, int S, int k, int ch, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lpf = static_cast<const float*>(lp);
  const uint8_t *sk = static_cast<const uint8_t*>(skip), *fb = static_cast<const uint8_t*>(fin);
  const int* tl = static_cast<const int*>(tlens);
  float *af = static_cast<float*>(alpha), *llf = static_cast<float*>(ll);
  int threads;
  size_t smem;
  cudaError_t err;
  if (k == 0) {
    err = configure(ctc_alpha_kernel, S, &smem, &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_alpha_kernel<<<B, threads, smem, st>>>(lpf, sk, tl, fb, af, llf, T, S);
    return static_cast<int>(cudaGetLastError());
  }
  err = ring_bytes(S, k, ch, 1, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CTC_WARP_SWITCH(ctc_alpha_warp_kernel, lpf, sk, tl, fb, af, llf, T, S, ch)
  return static_cast<int>(cudaGetLastError());
}

// + alpha [B, T, S], ll [B], g [B] (upstream gradient of ll) -> grad [B, T, S];
// k and ch as for ctc_alpha (a ring chunk holds lp and alpha).
int ctc_beta_grad(const void* lp, const void* skip, const void* tlens, const void* fin,
                  const void* alpha, const void* ll, const void* g, void* grad, int B,
                  int T, int S, int k, int ch, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lpf = static_cast<const float*>(lp);
  const uint8_t *sk = static_cast<const uint8_t*>(skip), *fb = static_cast<const uint8_t*>(fin);
  const int* tl = static_cast<const int*>(tlens);
  const float *af = static_cast<const float*>(alpha), *llf = static_cast<const float*>(ll);
  const float* gf = static_cast<const float*>(g);
  float* gr = static_cast<float*>(grad);
  int threads;
  size_t smem;
  cudaError_t err;
  if (k == 0) {
    err = configure(ctc_beta_grad_kernel, S, &smem, &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
    ctc_beta_grad_kernel<<<B, threads, smem, st>>>(lpf, sk, tl, fb, af, llf, gf, gr, T, S);
    return static_cast<int>(cudaGetLastError());
  }
  err = ring_bytes(S, k, ch, 2, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CTC_WARP_SWITCH(ctc_beta_grad_warp_kernel, lpf, sk, tl, fb, af, llf, gf, gr, T, S, ch)
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
