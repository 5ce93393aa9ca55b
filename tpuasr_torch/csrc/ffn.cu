// Fused conformer feed-forward: LN -> W1 + b1 -> swish -> keep-mask 1 ->
// W2 + b2 -> keep-mask 2 -> x + s * y (forward), and its backward, without
// the [R, H] hidden activation ever reaching device memory.
//
// Replaces the TPU kernels `_fwd_kernel` / `_fused_ffn_fwd`
// (tpuasr/ops/ffn_pallas.py:54-69, :169-187) and `_bwd_kernel` /
// `_fused_ffn_bwd` (:72-123, :190-221). Rows x [R, D] in the compute type T
// (fp32 or bf16); weights in torch's layout, w1 [H, D] and w2 [D, H], in T;
// the LN scale/bias and b1/b2 fp32; the dropout keep-masks uint8 [R, H] and
// [R, D] drawn by the caller (1 = keep; null pointers = no dropout). The
// rounding points are the JAX kernel's: LN(x)*g + b rounds to T before W1;
// h, the swish and the masks stay fp32; the activation rounds to T before
// W2; x + s*y is fp32 and rounds once. The backward rounds dy, the dropped
// activation and dh to T before their products, as `_bwd_kernel` does.
//
// What bounds them on an H100: operations. At the flagship's training shape
// (R = 12 x 191 = 2,292 rows, D 256, H 1024, bf16) the forward does
// 4 R D H = 2.40 GFLOP (2.4 us at the bf16 tensor-core peak) against ~6 MB
// of x, out, weights and masks (1.9 us); the backward five products,
// 6.0 GFLOP (6.1 us). These kernels do their products on CUDA cores in fp32
// (67 TFLOP/s), so their own floor is 36 us and 90 us; tensor-core tiles
// (mma.sync / wgmma on bf16 fragments) are a later PR's work.
//
// Forward design: the TPU kernel keeps a 256-row tile with its whole
// [256, 4D] hidden in VMEM (1 MB fp32); a Hopper block cannot hold even 64
// rows of it. One block of 256 threads takes 32 rows: it normalises them
// (fp32 statistics, a warp per row) into shared memory as xn, then walks
// the hidden dimension in chunks of 32 units. For each chunk it stages
// W1's 32 rows and W2's 32 columns in shared memory (fp32, padded pitches
// so the 128-bit loads of eight lanes hit distinct banks), computes
// h = xn . W1c^T + b1 (lane = hidden unit, a warp per 4 rows), applies the
// swish and mask 1 and rounds to T into shared memory, and adds a . W2c^T
// into the block's [32, D] output held in registers (thread = 8 rows x
// D/64 columns). The epilogue adds b2, mask 2 and the scaled residual.
//
// Backward design: the TPU kernel sums the weight and LN gradients over a
// row grid that runs in order. Hopper blocks run in no order, so each block
// (32 rows, as the forward) recomputes LN, h and the activation chunk by
// chunk, forms dad = dy . W2c and dh, and adds its rows' share of dW2 =
// dy^T . a, dW1 = dh^T . xn, db1, db2, dg and db into zeroed fp32 outputs
// with atomics in global memory (a warp adds 32 consecutive floats at a
// time). dxn = dh . W1c accumulates in registers across the chunks; the LN
// backward then runs a warp per row. The atomics' order changes from run to
// run, so the weight and LN gradients agree with a fixed-order sum to fp32
// rounding of the partial sums, not bit for bit; dx and the forward are
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 32;      // rows per block
constexpr int kHC = 32;        // hidden units per chunk (= lanes)
constexpr int kWP = kHC + 4;   // pitch of [.][kHC] tiles
constexpr float kEps = 1e-6f;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// a rounding point: to T and back
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// LN statistics of one row, a warp per row (two passes, as the JAX kernel:
// mean, then the mean of squared deviations)
template <typename T, int D>
__device__ __forceinline__ void row_stats(const T* xr, int lane, float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = lane; k < D; k += 32) s += to_f(xr[k]);
  mu = warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int k = lane; k < D; k += 32) {
    const float t = to_f(xr[k]) - mu;
    v = fmaf(t, t, v);
  }
  rstd = 1.f / sqrtf(warp_sum(v) / D + kEps);
}

// W1's rows and W2's columns of hidden chunk c into shared memory (fp32):
// w1s[j][k] (pitch D + 4), w2s[i][j] (pitch kWP)
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ w1, const T* __restrict__ w2,
                                            float* w1s, float* w2s, int c, int H) {
  constexpr int P = D + 4;
  const T* w1c = w1 + (size_t)c * kHC * D;
  for (int e = threadIdx.x; e < kHC * D; e += kThreads) {
    const int j = e / D, k = e - j * D;
    w1s[j * P + k] = to_f(w1c[e]);
  }
  for (int e = threadIdx.x; e < D * kHC; e += kThreads) {
    const int i = e / kHC, j = e - i * kHC;
    w2s[i * kWP + j] = to_f(w2[(size_t)i * H + c * kHC + j]);
  }
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return (size_t)(kRows + kHC) * (D + 4) + (size_t)(D + kRows) * kWP;
}

template <int D>
constexpr size_t bwd_smem_floats() {
  return (size_t)(2 * kRows + kHC) * (D + 4) + (size_t)(D + 2 * kRows) * kWP + 2 * kRows + kHC;
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ bb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, const uint8_t* __restrict__ m1,
               const uint8_t* __restrict__ m2, T* __restrict__ out, int R, int H, float keep,
               float scale) {
  constexpr int D = 64 * NQ;
  constexpr int P = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* xn = smem;                  // [kRows][P]
  float* w1s = xn + kRows * P;       // [kHC][P]
  float* w2s = w1s + kHC * P;        // [D][kWP]
  float* as = w2s + D * kWP;         // [kRows][kWP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;

  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int r = row0 + rr;
    float* xr = xn + rr * P;
    if (r < R) {
      const T* xg = x + (size_t)r * D;
      float mu, rstd;
      row_stats<T, D>(xg, lane, mu, rstd);
#pragma unroll
      for (int k = lane; k < D; k += 32) xr[k] = rnd<T>((to_f(xg[k]) - mu) * rstd * g[k] + bb[k]);
    } else {
#pragma unroll
      for (int k = lane; k < D; k += 32) xr[k] = 0.f;
    }
  }

  const int cg = threadIdx.x & 63, rg = threadIdx.x >> 6;  // output: 8 rows x NQ columns
  float y[8][NQ];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int q = 0; q < NQ; ++q) y[rr][q] = 0.f;

  const int n_chunks = H / kHC;
  for (int c = 0; c < n_chunks; ++c) {
    stage_chunk<T, D>(w1, w2, w1s, w2s, c, H);
    __syncthreads();
    {  // h = xn . W1c^T + b1 -> swish -> mask 1 -> round: lane = unit, warp = 4 rows
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wr = w1s + lane * P;
      const float* x0 = xn + warp * 4 * P;
#pragma unroll 4
      for (int k = 0; k < D; k += 4) {
        const float4 wv = ld4(wr + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = dot4(ld4(x0 + q * P + k), wv, acc[q]);
      }
      const int jj = c * kHC + lane;
      const float bj = b1[jj];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = warp * 4 + q, r = row0 + rr;
        const float hv = acc[q] + bj;
        float av = hv * (1.f / (1.f + expf(-hv)));
        if (m1 != nullptr) av = (r < R && m1[(size_t)r * H + jj]) ? av / keep : 0.f;
        as[rr * kWP + lane] = rnd<T>(av);
      }
    }
    __syncthreads();
    // y += a . W2c^T: thread = rows rg*8.., columns cg + 64 q
#pragma unroll
    for (int j = 0; j < kHC; j += 4) {
      float4 av[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) av[rr] = ld4(as + (rg * 8 + rr) * kWP + j);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 wv = ld4(w2s + (cg + 64 * q) * kWP + j);
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) y[rr][q] = dot4(av[rr], wv, y[rr][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = row0 + rg * 8 + rr;
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = cg + 64 * q;
      const size_t at = (size_t)r * D + i;
      float yv = y[rr][q] + b2[i];
      if (m2 != nullptr) yv = m2[at] ? yv / keep : 0.f;
      out[at] = from_f<T>(__fadd_rn(to_f(x[at]), __fmul_rn(scale, yv)));
    }
  }
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ bb, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
               const T* __restrict__ dout, T* __restrict__ dx, float* __restrict__ dg,
               float* __restrict__ db, float* __restrict__ dw1, float* __restrict__ db1,
               float* __restrict__ dw2, float* __restrict__ db2, int R, int H, float keep,
               float scale) {
  constexpr int D = 64 * NQ;
  constexpr int P = D + 4;
  constexpr int KL = D / 32;  // columns per lane in the row-wise phases
  extern __shared__ __align__(16) float smem[];
  float* xn = smem;                   // [kRows][P] LN(x)*g + b, rounded to T
  float* dys = xn + kRows * P;        // [kRows][P] dy rounded to T; later dxn
  float* w1s = dys + kRows * P;       // [kHC][P]
  float* w2s = w1s + kHC * P;         // [D][kWP]
  float* ads = w2s + D * kWP;         // [kRows][kWP] dropped activation, rounded
  float* dhs = ads + kRows * kWP;     // [kRows][kWP] dh, rounded
  float* mus = dhs + kRows * kWP;     // [kRows]
  float* rstds = mus + kRows;         // [kRows]
  float* db1s = rstds + kRows;        // [kHC] this block's db1 for the chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, R - row0);

  {  // LN recomputed; dy = do * s, mask 2, rounded; db2 = sum of unrounded dy
    float part[KL];
#pragma unroll
    for (int m = 0; m < KL; ++m) part[m] = 0.f;
    for (int rr = warp; rr < kRows; rr += kThreads / 32) {
      const int r = row0 + rr;
      float* xr = xn + rr * P;
      float* dr = dys + rr * P;
      if (r < R) {
        const T* xg = x + (size_t)r * D;
        float mu, rstd;
        row_stats<T, D>(xg, lane, mu, rstd);
        if (lane == 0) {
          mus[rr] = mu;
          rstds[rr] = rstd;
        }
#pragma unroll
        for (int m = 0; m < KL; ++m) {
          const int k = lane + 32 * m;
          const size_t at = (size_t)r * D + k;
          xr[k] = rnd<T>((to_f(xg[k]) - mu) * rstd * g[k] + bb[k]);
          float dv = to_f(dout[at]) * scale;
          if (m2 != nullptr) dv = m2[at] ? dv / keep : 0.f;
          dr[k] = rnd<T>(dv);
          part[m] += dv;
        }
      } else {
#pragma unroll
        for (int m = 0; m < KL; ++m) xr[lane + 32 * m] = dr[lane + 32 * m] = 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < KL; ++m) atomicAdd(db2 + lane + 32 * m, part[m]);
  }

  const int cg = threadIdx.x & 63, rg = threadIdx.x >> 6;  // dxn: 8 rows x NQ columns
  float dxn[8][NQ];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int q = 0; q < NQ; ++q) dxn[rr][q] = 0.f;

  const int n_chunks = H / kHC;
  for (int c = 0; c < n_chunks; ++c) {
    stage_chunk<T, D>(w1, w2, w1s, w2s, c, H);
    if (threadIdx.x < kHC) db1s[threadIdx.x] = 0.f;
    __syncthreads();
    {  // h = xn . W1c^T + b1 and dad = dy . W2c: lane = unit, warp = 4 rows
      float ah[4] = {0.f, 0.f, 0.f, 0.f}, ad[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wr = w1s + lane * P;
#pragma unroll 4
      for (int k = 0; k < D; k += 4) {
        const float4 wv = ld4(wr + k);
        const float4 wc = make_float4(w2s[k * kWP + lane], w2s[(k + 1) * kWP + lane],
                                      w2s[(k + 2) * kWP + lane], w2s[(k + 3) * kWP + lane]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = warp * 4 + q;
          ah[q] = dot4(ld4(xn + rr * P + k), wv, ah[q]);
          ad[q] = dot4(ld4(dys + rr * P + k), wc, ad[q]);
        }
      }
      const int jj = c * kHC + lane;
      const float bj = b1[jj];
      float dbsum = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = warp * 4 + q, r = row0 + rr;
        const float hv = ah[q] + bj;
        const float sg = 1.f / (1.f + expf(-hv));
        float av = hv * sg, da = ad[q];
        if (m1 != nullptr) {
          const bool kept = r < R && m1[(size_t)r * H + jj];
          av = kept ? av / keep : 0.f;
          da = kept ? da / keep : 0.f;
        }
        const float dh = da * (sg * (1.f + hv * (1.f - sg)));
        ads[rr * kWP + lane] = rnd<T>(av);
        dhs[rr * kWP + lane] = rnd<T>(dh);
        dbsum += dh;
      }
      atomicAdd(db1s + lane, dbsum);
    }
    __syncthreads();
    if (threadIdx.x < kHC) atomicAdd(db1 + c * kHC + threadIdx.x, db1s[threadIdx.x]);
    {  // dW2[i][c*kHC + j] += sum_r dy[r][i] a[r][j]: lane = j, warp = D/8 rows i
      constexpr int NI = D / 8;
      float acc[NI];
#pragma unroll
      for (int m = 0; m < NI; ++m) acc[m] = 0.f;
      for (int rr = 0; rr < n_rows; ++rr) {
        const float av = ads[rr * kWP + lane];
        const float* dr = dys + rr * P + warp * NI;
#pragma unroll
        for (int m = 0; m < NI; m += 4) {
          const float4 dv = ld4(dr + m);
          acc[m] = fmaf(dv.x, av, acc[m]);
          acc[m + 1] = fmaf(dv.y, av, acc[m + 1]);
          acc[m + 2] = fmaf(dv.z, av, acc[m + 2]);
          acc[m + 3] = fmaf(dv.w, av, acc[m + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < NI; ++m)
        atomicAdd(dw2 + (size_t)(warp * NI + m) * H + c * kHC + lane, acc[m]);
    }
    {  // dW1[c*kHC + j][k] += sum_r dh[r][j] xn[r][k]: lane = k + 32 m, warp = 4 units
      float acc[4][KL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < KL; ++m) acc[u][m] = 0.f;
      for (int rr = 0; rr < n_rows; ++rr) {
        const float4 hv = ld4(dhs + rr * kWP + warp * 4);
        const float* xr = xn + rr * P + lane;
#pragma unroll
        for (int m = 0; m < KL; ++m) {
          const float xv = xr[32 * m];
          acc[0][m] = fmaf(hv.x, xv, acc[0][m]);
          acc[1][m] = fmaf(hv.y, xv, acc[1][m]);
          acc[2][m] = fmaf(hv.z, xv, acc[2][m]);
          acc[3][m] = fmaf(hv.w, xv, acc[3][m]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < KL; ++m)
          atomicAdd(dw1 + (size_t)(c * kHC + warp * 4 + u) * D + lane + 32 * m, acc[u][m]);
    }
    // dxn += dh . W1c: thread = rows rg*8.., columns cg + 64 q
#pragma unroll
    for (int j = 0; j < kHC; j += 4) {
      float4 hv[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) hv[rr] = ld4(dhs + (rg * 8 + rr) * kWP + j);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int k = cg + 64 * q;
        const float4 wv = make_float4(w1s[j * P + k], w1s[(j + 1) * P + k],
                                      w1s[(j + 2) * P + k], w1s[(j + 3) * P + k]);
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) dxn[rr][q] = dot4(hv[rr], wv, dxn[rr][q]);
      }
    }
    __syncthreads();
  }

  // dxn into shared memory (over dy), then the LN backward a warp per row
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int q = 0; q < NQ; ++q) dys[(rg * 8 + rr) * P + cg + 64 * q] = dxn[rr][q];
  __syncthreads();
  float pg[KL], pb[KL];
#pragma unroll
  for (int m = 0; m < KL; ++m) pg[m] = pb[m] = 0.f;
  for (int rr = warp; rr < n_rows; rr += kThreads / 32) {
    const int r = row0 + rr;
    const float mu = mus[rr], rstd = rstds[rr];
    float xh[KL], dxh[KL], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < KL; ++m) {
      const int k = lane + 32 * m;
      xh[m] = (to_f(x[(size_t)r * D + k]) - mu) * rstd;
      const float dn = dys[rr * P + k];
      pg[m] = fmaf(dn, xh[m], pg[m]);
      pb[m] += dn;
      dxh[m] = dn * g[k];
      s1 += dxh[m];
      s2 = fmaf(dxh[m], xh[m], s2);
    }
    s1 = warp_sum(s1) / D;
    s2 = warp_sum(s2) / D;
#pragma unroll
    for (int m = 0; m < KL; ++m) {
      const size_t at = (size_t)r * D + lane + 32 * m;
      const float dln = rstd * (dxh[m] - s1 - xh[m] * s2);
      dx[at] = from_f<T>(to_f(dout[at]) + dln);
    }
  }
#pragma unroll
  for (int m = 0; m < KL; ++m) {
    atomicAdd(dg + lane + 32 * m, pg[m]);
    atomicAdd(db + lane + 32 * m, pb[m]);
  }
}

template <typename T, int NQ>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* m1,
                       const void* m2, void* out, int R, int H, float keep, float scale,
                       cudaStream_t st) {
  const size_t smem = fwd_smem_floats<64 * NQ>() * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ffn_fwd_kernel<T, NQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(R + kRows - 1) / kRows, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const uint8_t*>(m1),
      static_cast<const uint8_t*>(m2), static_cast<T*>(out), R, H, keep, scale);
  return cudaGetLastError();
}

template <typename T, int NQ>
cudaError_t launch_bwd(const void* x, const void* g, const void* b, const void* w1,
                       const void* b1, const void* w2, const void* m1, const void* m2,
                       const void* dout, void* dx, void* dg, void* db, void* dw1, void* db1,
                       void* dw2, void* db2, int R, int H, float keep, float scale,
                       cudaStream_t st) {
  const size_t smem = bwd_smem_floats<64 * NQ>() * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ffn_bwd_kernel<T, NQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(R + kRows - 1) / kRows, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2),
      static_cast<const T*>(dout), static_cast<T*>(dx), static_cast<float*>(dg),
      static_cast<float*>(db), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), R, H, keep, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [R, D] T; g, b, b2 [D] and b1 [H] fp32; w1 [H, D], w2 [D, H] T; m1 [R, H]
// and m2 [R, D] uint8 or both null; -> out [R, D] T. keep = 1 - rate (the
// kept values are divided by it), scale = ff_scale. D 64 (the card tests')
// or 256 (the flagship's), H a multiple of 32; T = bf16 if bf16 else fp32;
// all contiguous.
int ffn_fwd(const void* x, const void* g, const void* b, const void* w1, const void* b1,
            const void* w2, const void* b2, const void* m1, const void* m2, void* out, int R,
            int D, int H, float keep, float scale, int bf16, void* stream) {
  if (R == 0) return 0;
  if ((D != 64 && D != 256) || H % kHC || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_FWD(T, NQ) \
  err = launch_fwd<T, NQ>(x, g, b, w1, b1, w2, b2, m1, m2, out, R, H, keep, scale, st)
  if (bf16) {
    if (D == 64) TPUASR_FWD(__nv_bfloat16, 1);
    if (D == 256) TPUASR_FWD(__nv_bfloat16, 4);
  } else {
    if (D == 64) TPUASR_FWD(float, 1);
    if (D == 256) TPUASR_FWD(float, 4);
  }
#undef TPUASR_FWD
  return static_cast<int>(err);
}

// + dout [R, D] T -> dx [R, D] T and the fp32 sums over the rows dg, db [D],
// dw1 [H, D], db1 [H], dw2 [D, H], db2 [D], which must be zeroed: the kernel
// adds into them. b2 is not read (its gradient needs only dy).
int ffn_bwd(const void* x, const void* g, const void* b, const void* w1, const void* b1,
            const void* w2, const void* b2, const void* m1, const void* m2, const void* dout,
            void* dx, void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2, int R,
            int D, int H, float keep, float scale, int bf16, void* stream) {
  (void)b2;
  if (R == 0) return 0;
  if ((D != 64 && D != 256) || H % kHC || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_BWD(T, NQ)                                                                   \
  err = launch_bwd<T, NQ>(x, g, b, w1, b1, w2, m1, m2, dout, dx, dg, db, dw1, db1, dw2, db2, \
                          R, H, keep, scale, st)
  if (bf16) {
    if (D == 64) TPUASR_BWD(__nv_bfloat16, 1);
    if (D == 256) TPUASR_BWD(__nv_bfloat16, 4);
  } else {
    if (D == 64) TPUASR_BWD(float, 1);
    if (D == 256) TPUASR_BWD(float, 4);
  }
#undef TPUASR_BWD
  return static_cast<int>(err);
}

}  // extern "C"
