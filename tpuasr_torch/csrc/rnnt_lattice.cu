// RNN-T lattice over the masked blank/label log-probs: the alpha sweep with
// the log-likelihood (forward) and the beta sweep fused with the occupancy
// gradients (backward).
//
// Replaces the TPU kernels `_alpha_kernel` / `_rnnt_forward`
// (tpuasr/ops/rnnt_pallas.py:88-108, :173-190) and `_beta_grad_kernel` /
// `_rnnt_bwd` (:111-144, :197-215). blank [B, T, U+1] and label [B, T, U]
// are the joint's log-probs after the free-blank padding (blank 0 past t_len,
// label -1e30 past u_len or t_len), u_len [B] the label counts:
//   alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
//                           alpha[t, u-1] + label[t, u-1]),  alpha[0, 0] = 0
//   ll          = alpha[T-1, u_len] + blank[T-1, u_len]
//   beta[t, u]  = logaddexp(blank[t, u] + beta[t+1, u], label[t, u] + beta[t, u+1])
// with beta of the virtual row t = T equal to 0 at u_len (the terminal
// blank) and -1e30 elsewhere; the backward writes
//   gblank[t, u] = g * exp(min(alpha + blank + beta[t+1, u] - ll, 0))
//   glabel[t, u] = g * exp(min(alpha + label + beta[t, u+1] - ll, 0)).
// -1e30 stands in for -inf; every cell is clamped there, as the plain
// lattice (tpuasr_torch/ops/rnnt_lattice.py) clamps it, and its log-add is
// the plain lattice's torch.logaddexp: m + log1p(exp(-|a - b|)).
//
// What bounds it on an H100: neither bytes nor flops. At the flagship's
// training shape (B 12, T' 191, U+1 33) each sweep moves ~1 MB (a third of a
// microsecond at 3.35 TB/s) and does ~10 flops per cell, but the T + U
// anti-diagonals depend on each other: the floor is ~224 times the latency
// of one step (global loads, a few flops, a barrier).
//
// Design: the TPU kernel pads U+1 to 128 lanes and solves each frame's
// U-recurrence with a log2(U)-step doubling scan. Here every cell of an
// anti-diagonal n = t + u depends only on the diagonal before, so one block
// per utterance runs one thread per column u and sweeps the T + U
// diagonals, one barrier each. Thread u keeps its own column's last value
// (alpha[t-1, u], or beta[t+1, u] backward) in a register and reads its
// neighbour's (alpha[t, u-1], or beta[t, u+1]) from a double-buffered
// shared row. The forward writes the alpha tape the backward reads; the
// backward restarts from the terminal row and emits both gradients as it
// sweeps, so beta is never stored. U+1 is at most 1024 (one block). Only B
// of 132 SMs work: the kernels are latency-bound, and that is accepted
// here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxCols = 1024;

// torch.logaddexp's formula (the plain lattice's), clamped at -1e30
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return fmaxf(m + log1pf(expf(-fabsf(a - b))), kNeg);
}

__global__ void __launch_bounds__(kMaxCols)
rnnt_alpha_kernel(const float* __restrict__ blank, const float* __restrict__ label,
                  const int* __restrict__ ulens, float* __restrict__ alpha,
                  float* __restrict__ ll, int T, int U1) {
  __shared__ float rows[2][kMaxCols];
  const int b = blockIdx.x, u = threadIdx.x;
  const int U = U1 - 1;
  const float* bl = blank + (size_t)b * T * U1;
  const float* lb = label + (size_t)b * T * U;
  float* al = alpha + (size_t)b * T * U1;
  const int ul = ulens[b];
  if (u == 0 && (ul < 0 || ul > U)) ll[b] = NAN;  // no such column: loud

  float mine = kNeg;  // this column's value on the last diagonal (alpha[t-1, u])
  for (int n = 0; n < T + U1 - 1; ++n) {
    const float* prev = rows[(n + 1) & 1];
    float* cur = rows[n & 1];
    const int t = n - u;
    float val = kNeg;
    if (u < U1 && t >= 0 && t < T) {
      if (n == 0) {
        val = 0.f;  // alpha[0, 0]
      } else {
        const float from_blank = mine + (t >= 1 ? bl[(size_t)(t - 1) * U1 + u] : kNeg);
        const float from_label = u >= 1 ? prev[u - 1] + lb[(size_t)t * U + u - 1] : kNeg;
        val = logaddexp(from_blank, from_label);
      }
      al[(size_t)t * U1 + u] = val;
      if (t == T - 1 && u == ul) ll[b] = val + bl[(size_t)t * U1 + u];
    }
    if (u < U1) {
      cur[u] = val;
      mine = val;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxCols)
rnnt_beta_grad_kernel(const float* __restrict__ blank, const float* __restrict__ label,
                      const int* __restrict__ ulens, const float* __restrict__ alpha,
                      const float* __restrict__ ll, const float* __restrict__ g,
                      float* __restrict__ gblank, float* __restrict__ glabel, int T,
                      int U1) {
  __shared__ float rows[2][kMaxCols + 1];  // + a -1e30 slot right of column U
  const int b = blockIdx.x, u = threadIdx.x;
  const int U = U1 - 1;
  const size_t base1 = (size_t)b * T * U1, base = (size_t)b * T * U;
  const float* bl = blank + base1;
  const float* lb = label + base;
  const float* al = alpha + base1;
  float* gb = gblank + base1;
  float* gl = glabel + base;
  const int ul = ulens[b];
  const float llb = ll[b], gs = g[b];

  // the diagonals of the lattice extended by the virtual row t = T, from the
  // last (n = T + U) down to 0; beta[T, u] = 0 at u_len, else -1e30
  float mine = kNeg;  // beta of this column on the diagonal after (cell (t+1, u))
  if (u == 0) rows[0][U1] = rows[1][U1] = kNeg;  // the pad slots, never written
  __syncthreads();
  for (int n = T + U1 - 1, i = 0; n >= 0; --n, ++i) {
    const float* nxt = rows[i & 1];
    float* cur = rows[(i + 1) & 1];
    const int t = n - u;
    float val = kNeg;
    if (u < U1) {
      if (t == T) {
        val = (u == ul) ? 0.f : kNeg;
      } else if (t >= 0 && t < T) {
        const size_t c1 = (size_t)t * U1 + u;
        const float a = al[c1], bk = bl[c1];
        const float right = nxt[u + 1];  // beta[t, u+1] (-1e30 right of column U)
        const float lab = u < U ? lb[(size_t)t * U + u] : kNeg;
        gb[c1] = gs * expf(fminf(a + bk + mine - llb, 0.f));
        if (u < U) gl[(size_t)t * U + u] = gs * expf(fminf(a + lab + right - llb, 0.f));
        val = logaddexp(bk + mine, lab + right);
      }
      cur[u] = val;
      mine = val;
    }
    __syncthreads();
  }
}

int threads_for(int U1) { return ((U1 + 31) / 32) * 32; }

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blank [B, T, U1], label [B, T, U1-1] fp32, ulens [B] int32 -> alpha
// [B, T, U1] fp32, ll [B] fp32; all contiguous, T >= 1, 1 <= U1 <= 1024.
int rnnt_alpha(const void* blank, const void* label, const void* ulens, void* alpha,
               void* ll, int B, int T, int U1, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U1 < 1 || U1 > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_alpha_kernel<<<B, threads_for(U1), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const int*>(ulens), static_cast<float*>(alpha), static_cast<float*>(ll),
      T, U1);
  return static_cast<int>(cudaGetLastError());
}

// + alpha [B, T, U1], ll [B], g [B] (upstream gradient of ll) -> gblank
// [B, T, U1], glabel [B, T, U1-1] fp32.
int rnnt_beta_grad(const void* blank, const void* label, const void* ulens,
                   const void* alpha, const void* ll, const void* g, void* gblank,
                   void* glabel, int B, int T, int U1, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U1 < 1 || U1 > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  rnnt_beta_grad_kernel<<<B, threads_for(U1), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const int*>(ulens), static_cast<const float*>(alpha),
      static_cast<const float*>(ll), static_cast<const float*>(g),
      static_cast<float*>(gblank), static_cast<float*>(glabel), T, U1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
