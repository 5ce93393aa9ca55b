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
// lattice (tpuasr_torch/ops/rnnt_lattice.py) clamps it.
//
// What bounds it on an H100: neither bytes nor flops. At the flagship's
// training shape (B 12, T' 191, U+1 33) each sweep moves ~1 MB (a third of a
// microsecond at 3.35 TB/s) and does ~10-20 flops per cell, but each cell of
// an anti-diagonal n = t + u depends on two cells of diagonal n-1 (n+1
// backward): the floor is the T + U diagonals times the latency of one
// dependent step, and one warp an utterance issues everything else a step
// does in that step's shadow. The TPU kernel instead solves each frame's
// U-recurrence with a log2(U)-level doubling scan, T log2(U) dependent
// log-adds; the diagonal order has T + U steps of one log-add each.
//
// Two routes, chosen for each entry by U+1 alone in
// tpuasr_torch/ops/rnnt_lattice.py `_rnnt_plan`:
//
// - warp (up to U+1 = 32 * kMaxK = 256; the plan takes it while it beats
//   the block route, a crossover of its own for each entry): one warp per
//   utterance, a block each.
//   Lane l holds K = ceil((U+1) / 32) columns in registers, contiguous (lK ..
//   lK+K-1), each its value on the last diagonal. alpha's step: the cell
//   above (t-1, u) is the column's own register and the cell left (t, u-1)
//   its neighbour's, which is the lane's own but for its first column, whose
//   one `__shfl_up_sync` brings it from lane l-1; beta mirrors it (below,
//   right, `__shfl_down_sync`). The log-add is m + log(1 + e^-|x-y|), m =
//   max(x, y) clamped at -1e30: -|x - y| is min - max exactly, so the clamp
//   sits beside the exponential, off the chain, and `ex2.approx.ftz` /
//   `lg2.approx.ftz` make the exponential and the log one MUFU instruction
//   each. No barrier, no global load and no mask sits on the chain: a step
//   reads its terms from shared-memory rings (below) a step ahead, filled by
//   rows of the arrays in device memory (coalesced), and stores its cells
//   (the alpha tape; beta's two gradients, which reuse the step's two
//   log-add terms as alpha + term - ll) straight to device memory, stores
//   that nothing waits on. Beta is never stored. (The designs this was
//   chosen over, timed by tpuasr_torch/tools/rnnt_lattice_designs.py: PERF.md
//   §6.)
// - block (beyond the warp route, up to U+1 1024): one block per utterance,
//   one thread per
//   column, a barrier per diagonal, the neighbour through a double-buffered
//   shared row, the log-add torch.logaddexp's formula: the first design,
//   kept for label sequences where one warp's issue of a step's K columns
//   outlasts a barrier step of many warps.
//
// Neither route uses atomics: two calls give the same bits.

#include "lattice.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr int kMaxCols = 1024;

// torch.logaddexp's formula (the plain lattice's), clamped at -1e30: the
// block route's log-add
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return fmaxf(m + log1pf(expf(-fabsf(a - b))), kNeg);
}

// the warp route's log-add: log(e^x + e^y) = m + ln2 * log2(1 + e^-|x-y|),
// m = max(x, y) clamped at -1e30; when both sit at or below -1e30 the
// result is -1e30 (the sum is at most 2, its log 1)
__device__ __forceinline__ float logadd2(float x, float y) {
  const float m = fmaxf(fmaxf(x, y), kNeg);
  return fmaf(lg2_fast(1.f + exp_fast(-fabsf(x - y))), kLn2, m);
}

// ---------------------------------------------------------------------------
// The warp route's rings. An input ring has 4C slots (C = 1 << lc diagonals
// a chunk) of P = 32K floats, one per column a warp holds: slot n & (4C - 1)
// holds at column u what step n reads there, so lane l reads its K columns
// as one vector. A fill copies the real cells of one chunk and nothing
// else, by rows of the source arrays (a `Fill*` cursor), so that the lanes
// of a copy take consecutive columns (coalesced reads, no two lanes on one
// bank). Every other cell keeps what the ring was set to at the start
// (`ring_set`): the columns past U, and the cells a sweep meets before the
// lattice (before frame 0, or for beta past frame T-1), whose columns no
// earlier diagonal of their slot filled either; the cells it meets after
// the lattice feed no real cell. Chunks 0 and 1 are filled before the
// sweep; then each step of chunk i copies in a share of chunk i + 2, Q rows
// (Q = K or K + 1, the plan's: Q C covers a chunk's rows), in the shadow of
// the chain.
// ---------------------------------------------------------------------------

// 4 bytes to a shared address when p, else nothing (the word keeps its
// value); the address is a number, so no copy recomputes the ring's window
__device__ __forceinline__ void cp_async4_if(uint32_t dst, const float* src, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
      ::"r"(dst), "l"(src), "r"((int)p));
}

// v to a device address when p, else nothing: a predicated store, so that
// the compiler keeps the loads that feed it out of a branch
__device__ __forceinline__ void st_global_if(float* dst, float v, bool p) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n"
               ::"l"(dst), "f"(v), "r"((int)p));
}

// n floats of shared memory (a multiple of 4, 16-byte aligned) to v
__device__ __forceinline__ void ring_set(float* ring, int n, float v, int lane) {
  const float4 x = make_float4(v, v, v, v);
  for (int i = lane; i < n / 4; i += kWarp) reinterpret_cast<float4*>(ring)[i] = x;
}

// K consecutive floats of shared memory (at a multiple of K floats) into
// registers, as the widest vectors K allows
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 x = reinterpret_cast<const float4*>(p)[k / 4];
      v[k] = x.x, v[k + 1] = x.y, v[k + 2] = x.z, v[k + 3] = x.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 x = reinterpret_cast<const float2*>(p)[k / 2];
      v[k] = x.x, v[k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}
// A cursor's lane, in the chunk of diagonals [n_lo, n_lo + C), takes
// diagonal n_lo + lane % C, from row `first` on by 32 / C rows a copy.

// alpha's step n reads blank[t-1, u] and label[t, u-1] (t = n - u) at
// column u: blank cell (r, c) goes to column c, label cell (r, c) to column
// c + 1, both on diagonal r + c + 1; rows n_lo - U1 .. n_lo + C - 1. The
// ring starts at -1e30: frame -1, column -1 (label column 0 is never
// filled), rows past T, columns past U.
struct FillAlpha {
  uint32_t d;
  const float *pb, *pl;  // dereferenced only at real cells
  int r, c;
  __device__ __forceinline__ void start(const float* bl, const float* lb, int n_lo, int lc,
                                        int P, int U1, int lane) {
    const int n = n_lo + (lane & ((1 << lc) - 1));
    r = n_lo - U1 + (lane >> lc);
    c = n - 1 - r;
    d = 4 * ((n & ((4 << lc) - 1)) * P + c);
    pb = bl + (r * U1 + c);
    pl = lb + (r * (U1 - 1) + c);
  }
  __device__ __forceinline__ void copy(uint32_t rb, uint32_t rl, int R, int T, int U1) {
    const bool row = (unsigned)r < (unsigned)T;
    cp_async4_if(rb + d, pb, row && (unsigned)c < (unsigned)U1);
    cp_async4_if(rl + d + 4, pl, row && (unsigned)c < (unsigned)(U1 - 1));
    r += R;
    c -= R;
    d -= 4 * R;
    pb += R * (U1 - 1);
    pl += R * (U1 - 2);
  }
};

// beta's step n reads blank, label and alpha at (t, u) = (n - u, u): cell
// (r, c) goes to column c of diagonal r + c; rows n_lo - U .. n_lo + C - 1.
// The ring starts with blank at 0 and label at -1e30: the rows past T as
// free blanks with no labels, and label column U (never filled) at -1e30;
// the columns past U keep -1e30 (label), so they reach no real column.
struct FillBeta {
  uint32_t d;
  const float *pb, *pa, *pl;
  int r, c;
  __device__ __forceinline__ void start(const float* bl, const float* al, const float* lb,
                                        int n_lo, int lc, int P, int U1, int lane) {
    const int n = n_lo + (lane & ((1 << lc) - 1));
    r = n_lo - (U1 - 1) + (lane >> lc);
    c = n - r;
    d = 4 * ((n & ((4 << lc) - 1)) * P + c);
    pb = bl + (r * U1 + c);
    pa = al + (r * U1 + c);
    pl = lb + (r * (U1 - 1) + c);
  }
  __device__ __forceinline__ void copy(uint32_t rb, uint32_t ra, uint32_t rl, int R, int T,
                                       int U1) {
    const bool real = (unsigned)r < (unsigned)T && (unsigned)c < (unsigned)U1;
    cp_async4_if(rb + d, pb, real);
    cp_async4_if(ra + d, pa, real);
    cp_async4_if(rl + d, pl, real && c < U1 - 1);
    r += R;
    c -= R;
    d -= 4 * R;
    pb += R * (U1 - 1);
    pa += R * (U1 - 1);
    pl += R * (U1 - 2);
  }
};

template <int K, int Q>
__global__ void __launch_bounds__(kWarp)
rnnt_alpha_warp_kernel(const float* __restrict__ blank, const float* __restrict__ label,
                       const int* __restrict__ ulens, float* __restrict__ alpha,
                       float* __restrict__ ll, int T, int U1, int lc) {
  constexpr int P = kWarp * K;  // floats a ring slot
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x, b = blockIdx.x, U = U1 - 1;
  const int C = 1 << lc, R = kWarp >> lc, W = 4 * C * P;
  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W;  // blank, label
  const float* bl = blank + (size_t)b * T * U1;
  const float* lb = label + (size_t)b * T * U;
  float* al = alpha + (size_t)b * T * U1;
  const int N = T + U1 - 1;  // diagonals; 0 is alpha[0, 0] alone
  const int nc = (N + C - 1) >> lc;
  ring_set(ring, 2 * W, kNeg, lane);
  __syncwarp();
  FillAlpha f;
  for (int ci = 0; ci < 2; ++ci) {
    f.start(bl, lb, ci * C, lc, P, U1, lane);
    for (int i = 0; i < (C + U1 + R - 1) / R; ++i) f.copy(rb, rl, R, T, U1);
    cp_async_commit();
  }
  const int ul = ulens[b];
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = lane * K + k == 0 ? 0.f : kNeg;
  if (lane == 0) al[0] = 0.f;  // alpha[0, 0], diagonal 0
  f.start(bl, lb, 2 * C, lc, P, U1, lane);
#pragma unroll
  for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);  // the share of diagonal 0

  int n = 1;
  for (int ci = 0; ci < nc; ++ci) {
    // chunk ci has landed (ci + 1 may be in flight)
    cp_async_wait<1>();
    __syncwarp();
    if (ci > 0) f.start(bl, lb, (ci + 2) * C, lc, P, U1, lane);
    const int n_hi = min(ci * C + C, N);
    float eb[K], el[K];  // this step's blank and label terms
    load_k<K>(ring + (n & (4 * C - 1)) * P + lane * K, eb);
    load_k<K>(ring + W + (n & (4 * C - 1)) * P + lane * K, el);
    for (; n < n_hi; ++n) {
      // the next step's terms, read ahead of the chain (at a chunk's last
      // step from a slot that may still be filling: read again after the wait)
      float fb[K], fl[K];
      const float* s = ring + ((n + 1) & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, fb);
      load_k<K>(s + W, fl);
#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, rl, R, T, U1);
      const float left = __shfl_up_sync(kFull, a[K - 1], 1);  // lane 0: its own, + -1e30
      float na[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        na[k] = logadd2(a[k] + eb[k], (k == 0 ? left : a[k >= 1 ? k - 1 : 0]) + el[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = na[k];
        eb[k] = fb[k];
        el[k] = fl[k];
      }
      // the step's cells into the tape, U floats apart: stores that nothing
      // waits on
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int u = lane * K + k;
        st_global_if(al + ((n - u) * U1 + u), a[k], (unsigned)(n - u) < (unsigned)T && u < U1);
      }
    }
    cp_async_commit();
  }
  // ll = alpha[T-1, u_len] + blank[T-1, u_len], read back from the tape
  // (NaN, loud, when there is no such column)
  asm volatile("" ::: "memory");  // the predicated stores above stay before the read
  __syncwarp();
  if (lane == 0)
    ll[b] = ul >= 0 && ul <= U ? al[(size_t)(T - 1) * U1 + ul] + bl[(size_t)(T - 1) * U1 + ul]
                               : NAN;
}

template <int K, int Q>
__global__ void __launch_bounds__(kWarp)
rnnt_beta_grad_warp_kernel(const float* __restrict__ blank, const float* __restrict__ label,
                           const int* __restrict__ ulens, const float* __restrict__ alpha,
                           const float* __restrict__ ll, const float* __restrict__ g,
                           float* __restrict__ gblank, float* __restrict__ glabel, int T,
                           int U1, int lc) {
  constexpr int P = kWarp * K;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x, b = blockIdx.x, U = U1 - 1;
  const int C = 1 << lc, R = kWarp >> lc, W = 4 * C * P;
  const uint32_t rb = smem_addr(ring), rl = rb + 4 * W, ra = rb + 8 * W;  // blank, label, alpha
  const size_t base1 = (size_t)b * T * U1, base = (size_t)b * T * U;
  const float* bl = blank + base1;
  const float* lb = label + base;
  const float* al = alpha + base1;
  float* gb = gblank + base1;
  float* gl = glabel + base;
  const int top = T + U1 - 2;  // the last diagonal, cell (T-1, U); the sweep runs down to 0
  const int nc = (top + C) >> lc;
  const int rows = (C + U + R - 1) / R;  // a lane's rows of a chunk's fill
  // chunk ci: diagonals top - ci C down to top - ci C - C + 1
  auto n_lo = [&](int ci) { return top - ci * C - C + 1; };
  ring_set(ring, W, 0.f, lane);
  ring_set(ring + W, W, kNeg, lane);
  __syncwarp();
  FillBeta f;
  for (int ci = 0; ci < 2; ++ci) {
    f.start(bl, al, lb, n_lo(ci), lc, P, U1, lane);
    for (int i = 0; i < rows; ++i) f.copy(rb, ra, rl, R, T, U1);
    cp_async_commit();
  }
  const int ul = ulens[b];
  const float llb = ll[b], gs = g[b];
  float bt[K];  // beta[t+1, u] of each column: from the virtual row t = T
#pragma unroll
  for (int k = 0; k < K; ++k) bt[k] = lane * K + k == ul ? 0.f : kNeg;
  f.start(bl, al, lb, n_lo(2), lc, P, U1, lane);

  int n = top;
  for (int ci = 0; ci < nc; ++ci) {
    cp_async_wait<1>();
    __syncwarp();
    if (ci > 0) f.start(bl, al, lb, n_lo(ci + 2), lc, P, U1, lane);
    const int n_end = max(n_lo(ci), 0);
    float eb[K], el[K], ea[K];
    {
      const float* s = ring + (n & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, eb);
      load_k<K>(s + W, el);
      load_k<K>(s + 2 * W, ea);
    }
    for (; n >= n_end; --n) {
      float fb[K], fl[K], fa[K];  // the next step's, read ahead of the chain
      const float* s = ring + ((n - 1) & (4 * C - 1)) * P + lane * K;
      load_k<K>(s, fb);
      load_k<K>(s + W, fl);
      load_k<K>(s + 2 * W, fa);
#pragma unroll
      for (int q = 0; q < Q; ++q) f.copy(rb, ra, rl, R, T, U1);
      // lane 31: its own first column, + label column U's -1e30 or a column past U
      const float right = __shfl_down_sync(kFull, bt[0], 1);
      float ob[K], ol[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x = eb[k] + bt[k];  // via the blank: blank + beta[t+1, u]
        const float y = el[k] + (k + 1 < K ? bt[k + 1 < K ? k + 1 : 0] : right);  // via the label
        ob[k] = gs * exp_fast(fminf(ea[k] + x - llb, 0.f));  // beside the chain
        ol[k] = gs * exp_fast(fminf(ea[k] + y - llb, 0.f));
        bt[k] = logadd2(x, y);  // column k+1's old value was read above
        eb[k] = fb[k];
        el[k] = fl[k];
        ea[k] = fa[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {  // the step's cells, U floats apart
        const int u = lane * K + k;
        const bool real = (unsigned)(n - u) < (unsigned)T && u < U1;
        st_global_if(gb + ((n - u) * U1 + u), ob[k], real);
        st_global_if(gl + ((n - u) * U + u), ol[k], real && u < U);
      }
    }
    cp_async_commit();
  }
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

// the warp route's shared memory: `chunks` chunks of 2^lc = ch diagonals of
// 32k floats (alpha: four of blank and four of label; beta: four each of
// blank, label and alpha; ch <= 32),
// within the 48 KB a block has without opting in (the plan never asks
// more), and q rows a step enough for a chunk's ch + rows rows of a copy
// (alpha U1, beta U) at 32 / ch a row; -> lc, or -1
int ring_log2(int U1, int k, int ch, int q, int rows, int chunks, size_t* smem) {
  if (k < 1 || k > kMaxK || kWarp * k < U1 || ch < 1 || ch > kWarp || (ch & (ch - 1)))
    return -1;
  if (q < k || q > k + 1 || q * ch < (ch + rows + kWarp / ch - 1) / (kWarp / ch)) return -1;
  *smem = sizeof(float) * (size_t)chunks * ch * kWarp * k;
  return *smem > 48 * 1024 ? -1 : __builtin_ctz(ch);
}

// the warp route's kernel for k columns a lane and q = k or k + 1 rows a
// step copies: one warp a block, a block an utterance
#define RNNT_WARP_CASE(KERNEL, K_, ...)                                         \
  case K_:                                                                       \
    if (q > K_)                                                                  \
      KERNEL<K_, K_ + 1><<<B, kWarp, smem, st>>>(__VA_ARGS__);                   \
    else                                                                         \
      KERNEL<K_, K_><<<B, kWarp, smem, st>>>(__VA_ARGS__);                       \
    break;
#define RNNT_WARP_SWITCH(KERNEL, ...)                                           \
  switch (k) {                                                                   \
    RNNT_WARP_CASE(KERNEL, 1, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 2, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 3, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 4, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 5, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 6, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 7, __VA_ARGS__)                                       \
    RNNT_WARP_CASE(KERNEL, 8, __VA_ARGS__)                                       \
  }

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blank [B, T, U1], label [B, T, U1-1] fp32, ulens [B] int32 -> alpha
// [B, T, U1] fp32, ll [B] fp32; all contiguous, T >= 1, 1 <= U1 <= 1024.
// k = 0: the block route; k = 1..8: the warp route with k columns a lane
// (32k >= U1), ring chunks of ch diagonals (a power of two up to 32) and q
// rows of each copy a step.
int rnnt_alpha(const void* blank, const void* label, const void* ulens, void* alpha,
               void* ll, int B, int T, int U1, int k, int ch, int q, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U1 < 1 || U1 > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *bl = static_cast<const float*>(blank), *lb = static_cast<const float*>(label);
  const int* ul = static_cast<const int*>(ulens);
  float *af = static_cast<float*>(alpha), *llf = static_cast<float*>(ll);
  if (k == 0) {
    rnnt_alpha_kernel<<<B, threads_for(U1), 0, st>>>(bl, lb, ul, af, llf, T, U1);
    return static_cast<int>(cudaGetLastError());
  }
  size_t smem;
  const int lc = ring_log2(U1, k, ch, q, U1, 8, &smem);
  if (lc < 0) return static_cast<int>(cudaErrorInvalidValue);
  RNNT_WARP_SWITCH(rnnt_alpha_warp_kernel, bl, lb, ul, af, llf, T, U1, lc)
  return static_cast<int>(cudaGetLastError());
}

// + alpha [B, T, U1], ll [B], g [B] (upstream gradient of ll) -> gblank
// [B, T, U1], glabel [B, T, U1-1] fp32; k, ch and q as for rnnt_alpha (a
// ring chunk holds blank, label and alpha).
int rnnt_beta_grad(const void* blank, const void* label, const void* ulens,
                   const void* alpha, const void* ll, const void* g, void* gblank,
                   void* glabel, int B, int T, int U1, int k, int ch, int q, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || U1 < 1 || U1 > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *bl = static_cast<const float*>(blank), *lb = static_cast<const float*>(label);
  const int* ul = static_cast<const int*>(ulens);
  const float *af = static_cast<const float*>(alpha), *llf = static_cast<const float*>(ll);
  const float* gf = static_cast<const float*>(g);
  float *gbf = static_cast<float*>(gblank), *glf = static_cast<float*>(glabel);
  if (k == 0) {
    rnnt_beta_grad_kernel<<<B, threads_for(U1), 0, st>>>(bl, lb, ul, af, llf, gf, gbf, glf,
                                                         T, U1);
    return static_cast<int>(cudaGetLastError());
  }
  size_t smem;
  const int lc = ring_log2(U1, k, ch, q, U1 - 1, 12, &smem);
  if (lc < 0) return static_cast<int>(cudaErrorInvalidValue);
  RNNT_WARP_SWITCH(rnnt_beta_grad_warp_kernel, bl, lb, ul, af, llf, gf, gbf, glf, T, U1, lc)
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
