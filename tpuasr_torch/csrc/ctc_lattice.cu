// CTC lattice over per-state emission log-probs: the alpha sweep (forward)
// and the beta sweep fused with the gradient (backward).
//
// Replaces the TPU kernels `_alpha_kernel` / `_ctc_forward`
// (tpuasr/ops/ctc_pallas.py:56-80, :140-171) and `_beta_grad_kernel` /
// `_ctc_bwd` (:83-131, :179-201). lp [B, T, S] holds the masked emission
// log-probs of the S = 2U+1 blank-interleaved states (-1e30 past the valid
// states); skip [B, S] says whether s-2 -> s is allowed; rows freeze from
// t_len on; final [B, S] marks the one or two final states. The log-add
// keeps the JAX package's convention: -1e30 stands in for -inf and the max is
// clamped there, so nothing turns into NaN.
//
// What bounds it on an H100: neither bytes nor flops. At the flagship's
// training shape (B 12, T' 191, S 65) each sweep reads or writes ~1-2 MB
// (under a microsecond at 3.35 TB/s) and does ~10 flops per cell, but the T'
// steps depend on each other: the floor is T' times the latency of one step
// (a few shared-memory round trips and a barrier, roughly 1 us).
//
// Design: one block per utterance, one thread per state (a block-stride loop
// for S > 1024). The current row lives in shared memory, double-buffered, so
// each step needs one barrier: a thread reads s, s-1, s-2 (alpha) or s,
// s+1, s+2 (beta) of the current row and writes the next. The forward writes
// the alpha tape that the backward reads; the backward restarts at
// t = t_len - 1 from the final states and emits
// grad = g * exp(min(alpha + (beta - lp) - ll, 0)) as it goes (0 on padded
// frames), so beta is never stored. The batch fills only B of 132 SMs; the
// kernels are latency-bound either way, and a few utterances per block, or
// warp-shuffle shifts in place of shared memory, are later refinements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), kNeg);
  return m + log1pf(expf(fminf(a, b) - m));
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

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp [B, T, S] fp32, skip [B, S] bool, tlens [B] int32, final [B, S] bool ->
// alpha [B, T, S] fp32, ll [B] fp32; all contiguous, T >= 1.
int ctc_alpha(const void* lp, const void* skip, const void* tlens, const void* fin,
              void* alpha, void* ll, int B, int T, int S, void* stream) {
  if (B == 0 || S == 0) return 0;
  size_t smem;
  int threads;
  cudaError_t err = configure(ctc_alpha_kernel, S, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const int*>(tlens), static_cast<const uint8_t*>(fin),
      static_cast<float*>(alpha), static_cast<float*>(ll), T, S);
  return static_cast<int>(cudaGetLastError());
}

// + alpha [B, T, S], ll [B], g [B] (upstream gradient of ll) -> grad [B, T, S].
int ctc_beta_grad(const void* lp, const void* skip, const void* tlens, const void* fin,
                  const void* alpha, const void* ll, const void* g, void* grad, int B,
                  int T, int S, void* stream) {
  if (B == 0 || S == 0) return 0;
  size_t smem;
  int threads;
  cudaError_t err = configure(ctc_beta_grad_kernel, S, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_beta_grad_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const uint8_t*>(skip),
      static_cast<const int*>(tlens), static_cast<const uint8_t*>(fin),
      static_cast<const float*>(alpha), static_cast<const float*>(ll),
      static_cast<const float*>(g), static_cast<float*>(grad), T, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
