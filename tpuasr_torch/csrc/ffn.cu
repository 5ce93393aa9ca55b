// Fused conformer feed-forward: LN -> W1 + b1 -> swish -> keep-mask 1 ->
// W2 + b2 -> keep-mask 2 -> x + s * y (forward, #10), and its backward
// (#11), without the [R, H] hidden activation ever reaching device memory
// in the forward.
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
// activation and dh to T before their products, as `_bwd_kernel` does, and
// every product sums in fp32 (`preferred_element_type=jnp.float32`).
//
// What bounds them on an H100: operations. At the flagship's training shape
// (R = 12 x 191 = 2,292 rows, D 256, H 1024, bf16) the forward does
// 4 R D H = 2.40 GFLOP, 2.43 us at the bf16 tensor-core peak, against
// ~6 MB of x, out, weights and masks (1.9 us); the backward five products,
// 6.0 GFLOP, 6.08 us. fp32 (CUDA cores, 67 TFLOP/s): serving's 748 rows
// 11.7 us, a streaming chunk's 128 rows 2.0 us.
//
// Design. A block takes a tile of rows and one slice of H (grid = row tiles
// x slices); `_ffn_plan` (ops/ffn.py) picks the slices: as many as let every
// block be resident in one wave (one block an SM, two for the fp32
// forward), at most one a chunk, none empty. 36 x 3 blocks at the training
// shape (forward and backward), 24 x 11 at serving (fp32 forward), 4 x 32
// at a streaming chunk, 12 x 11 and 24 x 5 at the trainer's 756 and 1,524
// rows. More slices fill more of the card but each adds S R D fp32 of
// partial sums through L2 and a longer sum: at the training shape 3 slices
// timed best (chip_smoke phase 3 times 1 to 16). H is walked in chunks of
// 32 units (any H that is a multiple of 32, no tail case). No atomics:
// every sum across blocks goes through a partial buffer that one thread
// sums in a fixed order, so two calls give the same bits.
//
// bf16 (training, bf16 serving): tensor cores, mma.sync.m16n8k16 with bf16
// operands and fp32 sums, which is the reference's own rounding (single bf16
// operands, fp32 accumulation), up to the order of the sums. 64 rows a
// block and 8 warps: warp (rg, hf) owns rows 16 rg .. 16 rg + 15; in a
// chunk's first product it takes units 16 hf .. 16 hf + 15, in the second
// columns hf D/2 .. (hf + 1) D/2, so its accumulators stay at 64 registers
// (D 256) and two warps share each scheduler. The activation (and dh) pass
// between the two through a bf16 [64][32] tile in shared memory. Fragment
// loads run ahead of their mma, and long sums alternate two accumulator
// sets. The swish's sigmoid is __expf and __fdividef and the keep division a
// product by 1/keep, within 2 fp32 ulp before the activation rounds to
// bf16: the IEEE division's slow-path branches had serialized the chunk.
// #10 (`ffn_fwd_tc_kernel`): LN into bf16 xn in shared memory (each warp's
// rows loaded at once, 16 bytes a lane); per chunk h = xn . W1c^T, then b1,
// swish and mask 1 in fp32, rounded to bf16, then y += a . W2c^T. W1c
// [32][D] and W2c [D][32] come by cp.async into a double buffer (pitches
// D + 8 and 40: an odd multiple of 16 bytes, so ldmatrix hits 8 distinct
// bank groups); mask 1's [64][32] bytes into one buffer, refilled for the
// next chunk once the activation has read it. 115 KB of shared memory.
// With one slice the block finishes the output; with S slices it writes
// its partial y [S][R][D] fp32 and `ffn_fwd_sum_kernel` sums them in slice
// order, adds b2, mask 2 and the residual. Workspace: S R D 4 bytes, 7.04
// MB at the training shape.
// #11, three kernels:
//  (a) `ffn_bwd_rows_tc_kernel`, the forward's grid: LN into xn, dy =
//      do s mask2 / keep (fp32) and its bf16 dyc; per chunk h = xn . W1c^T
//      and dad = dyc . W2c (W2c read with ldmatrix.trans), the activation
//      and dh in fp32, both rounded to bf16 into the block's tiles and from
//      there, 16 bytes a thread, into the scratch [R, H]; the rows' db1 of
//      the fp32 dh (a shuffle tree, then row groups in order); dxn += dhc .
//      W1c (W1c read transposed), written as the slice's partial. The
//      slice-0 blocks write xn, dyc and the rows' db2. 153 KB of shared
//      memory: one block an SM.
//  (b) `ffn_bwd_ln_kernel`: a warp per row, 8 rows a block: dxn = the sum
//      of the partials in slice order, the LN backward, dx; the rows' dg and
//      db, warps in order.
//  (c) `ffn_bwd_w_kernel`: dW2 = dyc^T . adc and dW1 = dhc^T . xn, one
//      64 x 64 output tile a block of 8 warps (2 x 64 blocks at D 256, H
//      1024), the rows in 64-row steps through a cp.async double buffer,
//      both operands by ldmatrix.trans; each element summed by one block,
//      rows in order, and written once. One more block sums the row tiles'
//      db1, db2, dg and db in tile order.
// The staged adc and dhc keep (c) to two plain products instead of a third
// recompute of the forward; at the training shape they are 4.7 MB each and
// stay in the 50 MB L2. Workspace (`bwd_ws`): 2 R D + 2 R H elements of T,
// S R D fp32 partial dxn and the per-tile vectors: 19.5 MB at the training
// shape.
//
// fp32 (serving with `fused_ffn`, the card-against-CPU checks): phase 4's
// tokens must equal the CPU's and the checks hold #10 to 1e-5 and #11 to
// 1e-4, which TF32 would not keep, so the products stay fp32 FMA on CUDA
// cores with IEEE expf and division: 32 rows and 256 threads a block, h
// with lane = unit and a warp per 4 rows, y (and dxn) with a thread per 8
// rows x D/64 columns, W1c/W2c staged in fp32 shared memory by 16-byte
// loads. The grid, the partial buffers and the epilogues (b) and (c) are the
// bf16 route's; (c) runs an fp32 64 x 64 tile a block, 4 x 4 outputs a
// thread. Workspace: 8.4 MB (serving, 11 slices) and 4.2 MB (streaming, 32
// slices) forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kHC = 32;        // hidden units per chunk (both routes)
constexpr int kTcRows = 64;    // rows per block, bf16 route
constexpr int kTcWarps = 8;    // 4 row groups of 16 x 2 halves of the units / columns
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRows = 32;      // rows per block, fp32 route
constexpr int kThreads = 256;  // fp32 route: 8 warps
constexpr int kWP = kHC + 4;   // pitch of fp32 [.][kHC] tiles
constexpr int kLnRows = 8;     // rows per block of the LN backward: a warp per row
constexpr int kWT = 64;        // weight-gradient output tile: 64 x 64
constexpr int kWThreads = 256; // its block: 8 warps of 16 rows x 32 columns
constexpr float kEps = 1e-6f;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float h) { return 1.f / (1.f + expf(-h)); }

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

// this block's hidden chunks [c0, c1): slice blockIdx.y of gridDim.y slices
// of ceil(nc / slices) chunks each
__device__ __forceinline__ void slice_chunks(int H, int& c0, int& c1) {
  const int nc = H / kHC, per = cdiv(nc, gridDim.y);
  c0 = blockIdx.y * per;
  c1 = min(nc, c0 + per);
}

// ------------------------------------------------- fp32 route: CUDA cores

// W1's rows and W2's columns of hidden chunk c into shared memory:
// w1s[j][k] (pitch D + 4), w2s[i][j] (pitch kWP), 16 bytes a load
template <int D>
__device__ __forceinline__ void stage_chunk_f32(const float* __restrict__ w1,
                                                const float* __restrict__ w2, float* w1s,
                                                float* w2s, int c, int H) {
  constexpr int P = D + 4, Q = D / 4;
  const float* w1c = w1 + (size_t)c * kHC * D;
  for (int e = threadIdx.x; e < kHC * Q; e += kThreads) {
    const int j = e / Q, k = (e - j * Q) * 4;
    *reinterpret_cast<float4*>(w1s + j * P + k) = ld4(w1c + j * D + k);
  }
  for (int e = threadIdx.x; e < D * (kHC / 4); e += kThreads) {
    const int i = e / (kHC / 4), j = (e - i * (kHC / 4)) * 4;
    *reinterpret_cast<float4*>(w2s + i * kWP + j) = ld4(w2 + (size_t)i * H + c * kHC + j);
  }
}

template <int D>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * ((size_t)(kRows + kHC) * (D + 4) + (size_t)(D + kRows) * kWP);
}

// #10, fp32: 32 rows x one slice of H a block. y = a . W2^T over the slice's
// chunks; with `part` the block writes its partial y (before b2) to
// part[slice][R][D], else it finishes the output itself.
template <int NQ>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ bb, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const uint8_t* __restrict__ m1,
                   const uint8_t* __restrict__ m2, float* __restrict__ out,
                   float* __restrict__ part, int R, int H, float keep, float scale) {
  constexpr int D = 64 * NQ;
  constexpr int P = D + 4;
  extern __shared__ __align__(16) float fsmem[];
  float* xn = fsmem;                 // [kRows][P]
  float* w1s = xn + kRows * P;       // [kHC][P]
  float* w2s = w1s + kHC * P;        // [D][kWP]
  float* as = w2s + D * kWP;         // [kRows][kWP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  int c0, c1;
  slice_chunks(H, c0, c1);

  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int r = row0 + rr;
    float* xr = xn + rr * P;
    if (r < R) {
      const float* xg = x + (size_t)r * D;
      float mu, rstd;
      row_stats<float, D>(xg, lane, mu, rstd);
#pragma unroll
      for (int k = lane; k < D; k += 32) xr[k] = (xg[k] - mu) * rstd * g[k] + bb[k];
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

  for (int c = c0; c < c1; ++c) {
    stage_chunk_f32<D>(w1, w2, w1s, w2s, c, H);
    __syncthreads();
    {  // h = xn . W1c^T + b1 -> swish -> mask 1: lane = unit, warp = 4 rows
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
        float av = hv * sigmoid(hv);
        if (m1 != nullptr) av = (r < R && m1[(size_t)r * H + jj]) ? av / keep : 0.f;
        as[rr * kWP + lane] = av;
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
      if (part != nullptr) {
        part[(size_t)blockIdx.y * R * D + at] = y[rr][q];
        continue;
      }
      float yv = y[rr][q] + b2[i];
      if (m2 != nullptr) yv = m2[at] ? yv / keep : 0.f;
      out[at] = __fadd_rn(x[at], __fmul_rn(scale, yv));
    }
  }
}

template <int D>
constexpr size_t bwd_f32_smem() {
  return sizeof(float) *
         ((size_t)(3 * kRows) * (D + 4) + (size_t)(D + 2 * kRows) * kWP + 8 * kHC);
}

// The backward's scratch in one workspace (`bwd_ws`): xn and dyc [R, D] and
// the dropped activation adc and dh rounded, dhc [R, H], in the compute
// type; the partial dxn [S][R][D]; per row tile the partial db1 [H] and db2
// [D] (row side) and dg, db [D] (LN backward), all fp32.
struct BwdWs {
  size_t xs, dys, ad, dh, dxp, db1p, db2p, dgp, dbp, total;
};

BwdWs bwd_ws(long long R, long long D, long long H, long long S, long long es,
             long long tiles) {
  BwdWs w{};
  size_t at = 0;
  auto take = [&](long long n) {
    const size_t o = at;
    at += (size_t)(n + 255) / 256 * 256;
    return o;
  };
  const long long ln_tiles = (R + kLnRows - 1) / kLnRows;
  w.xs = take(R * D * es);
  w.dys = take(R * D * es);
  w.ad = take(R * H * es);
  w.dh = take(R * H * es);
  w.dxp = take(S * R * D * 4);
  w.db1p = take(tiles * H * 4);
  w.db2p = take(tiles * D * 4);
  w.dgp = take(ln_tiles * D * 4);
  w.dbp = take(ln_tiles * D * 4);
  w.total = at;
  return w;
}

// #11 (a), fp32 row side: 32 rows x one slice of H a block. Recomputes LN,
// h and the activation chunk by chunk, forms dad = dy . W2c and dh, writes
// the dropped activation and dh to the scratch, adds dh . W1c into dxn
// (registers) and writes dxn as this slice's partial. Each block writes its
// rows' db1 over its chunks; the slice-0 blocks also write xn, dy and the
// rows' db2. Every sum over rows runs in a fixed order.
template <int NQ>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ bb, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
                        const float* __restrict__ dout, float* __restrict__ xs_g,
                        float* __restrict__ dys_g, float* __restrict__ ad_g,
                        float* __restrict__ dh_g, float* __restrict__ dxp,
                        float* __restrict__ db1p, float* __restrict__ db2p, int R, int H,
                        float keep, float scale) {
  constexpr int D = 64 * NQ;
  constexpr int P = D + 4;
  constexpr int KL = D / 32;  // columns per lane in the row-wise phases
  extern __shared__ __align__(16) float fsmem[];
  float* xn = fsmem;                  // [kRows][P] LN(x)*g + b
  float* dys = xn + kRows * P;        // [kRows][P] dy
  float* w1s = dys + kRows * P;       // [kHC][P]; first the db2 partials [8][D]
  float* w2s = w1s + kHC * P;         // [D][kWP]
  float* ads = w2s + D * kWP;         // [kRows][kWP] dropped activation
  float* dhs = ads + kRows * kWP;     // [kRows][kWP] dh
  float* red = dhs + kRows * kWP;     // [8][kHC] db1 per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const bool first = blockIdx.y == 0;
  int c0, c1;
  slice_chunks(H, c0, c1);

  {  // LN recomputed; dy = do * s, mask 2; db2 = the sum of dy over the rows
    float part[KL];
#pragma unroll
    for (int m = 0; m < KL; ++m) part[m] = 0.f;
    for (int rr = warp; rr < kRows; rr += kThreads / 32) {
      const int r = row0 + rr;
      float* xr = xn + rr * P;
      float* dr = dys + rr * P;
      if (r < R) {
        const float* xg = x + (size_t)r * D;
        float mu, rstd;
        row_stats<float, D>(xg, lane, mu, rstd);
#pragma unroll
        for (int m = 0; m < KL; ++m) {
          const int k = lane + 32 * m;
          const size_t at = (size_t)r * D + k;
          xr[k] = (xg[k] - mu) * rstd * g[k] + bb[k];
          float dv = dout[at] * scale;
          if (m2 != nullptr) dv = m2[at] ? dv / keep : 0.f;
          dr[k] = dv;
          part[m] += dv;
          if (first) {
            xs_g[at] = xr[k];
            dys_g[at] = dv;
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < KL; ++m) xr[lane + 32 * m] = dr[lane + 32 * m] = 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < KL; ++m) w1s[warp * D + lane + 32 * m] = part[m];
    __syncthreads();
    if (first) {
      for (int k = threadIdx.x; k < D; k += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) s += w1s[w * D + k];
        db2p[(size_t)blockIdx.x * D + k] = s;
      }
    }
    __syncthreads();
  }

  const int cg = threadIdx.x & 63, rg = threadIdx.x >> 6;  // dxn: 8 rows x NQ columns
  float dxn[8][NQ];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int q = 0; q < NQ; ++q) dxn[rr][q] = 0.f;

  for (int c = c0; c < c1; ++c) {
    stage_chunk_f32<D>(w1, w2, w1s, w2s, c, H);
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
        const float sg = sigmoid(hv);
        float av = hv * sg, da = ad[q];
        if (m1 != nullptr) {
          const bool kept = r < R && m1[(size_t)r * H + jj];
          av = kept ? av / keep : 0.f;
          da = kept ? da / keep : 0.f;
        }
        const float dh = da * (sg * (1.f + hv * (1.f - sg)));
        ads[rr * kWP + lane] = av;
        dhs[rr * kWP + lane] = dh;
        dbsum += dh;
      }
      red[warp * kHC + lane] = dbsum;
    }
    __syncthreads();
    if (threadIdx.x < kHC) {  // db1 of the block's rows, warps in order
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += red[w * kHC + threadIdx.x];
      db1p[(size_t)blockIdx.x * H + c * kHC + threadIdx.x] = s;
    }
    for (int e = threadIdx.x; e < kRows * kHC; e += kThreads) {  // ad, dh to the scratch
      const int rr = e / kHC, j = e - rr * kHC, r = row0 + rr;
      if (r < R) {
        ad_g[(size_t)r * H + c * kHC + j] = ads[rr * kWP + j];
        dh_g[(size_t)r * H + c * kHC + j] = dhs[rr * kWP + j];
      }
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

#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = row0 + rg * 8 + rr;
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      dxp[((size_t)blockIdx.y * R + r) * D + cg + 64 * q] = dxn[rr][q];
  }
}

// ------------------------------------------------- epilogues (both routes)

// #10 with slices: out = x + s * mask2(sum of the slices' partial y + b2),
// the partials summed in slice order; four columns a thread
template <typename T>
__global__ void __launch_bounds__(256)
ffn_fwd_sum_kernel(const T* __restrict__ x, const float* __restrict__ b2,
                   const uint8_t* __restrict__ m2, const float* __restrict__ part,
                   T* __restrict__ out, int R, int D, int S, float keep, float scale) {
  const size_t n = (size_t)R * D, at = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (at >= n) return;
  float4 y = ld4(part + at);
#pragma unroll 8  // the loads run ahead; the adds stay in slice order
  for (int s = 1; s < S; ++s) {
    const float4 p = ld4(part + (size_t)s * n + at);
    y.x += p.x;
    y.y += p.y;
    y.z += p.z;
    y.w += p.w;
  }
  const float yv[4] = {y.x, y.y, y.z, y.w};
  const int i0 = (int)(at % D);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = yv[e] + b2[i0 + e];
    if (m2 != nullptr) v = m2[at + e] ? v / keep : 0.f;
    out[at + e] = from_f<T>(__fadd_rn(to_f(x[at + e]), __fmul_rn(scale, v)));
  }
}

// #11 (b): dxn = the sum of the slices' partials in slice order, then the LN
// backward a warp per row: dx = do + rstd (dxh - mean(dxh) - xh mean(dxh xh)),
// dxh = dxn g; the block's rows' dg = sum dxn xh and db = sum dxn, warps in
// order.
template <typename T, int D>
__global__ void __launch_bounds__(256)
ffn_bwd_ln_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const T* __restrict__ dout, const float* __restrict__ dxp, int S,
                  T* __restrict__ dx, float* __restrict__ dgp, float* __restrict__ dbp, int R) {
  constexpr int KL = D / 32, NW = 8;
  __shared__ float red[2][NW][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kLnRows;
  float pg[KL], pb[KL];
#pragma unroll
  for (int m = 0; m < KL; ++m) pg[m] = pb[m] = 0.f;
  for (int rr = warp; rr < kLnRows && row0 + rr < R; rr += NW) {
    const int r = row0 + rr;
    float mu, rstd;
    row_stats<T, D>(x + (size_t)r * D, lane, mu, rstd);
    float xh[KL], dxh[KL], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < KL; ++m) {
      const int k = lane + 32 * m;
      float dn = dxp[(size_t)r * D + k];
#pragma unroll 8
      for (int s = 1; s < S; ++s) dn += dxp[((size_t)s * R + r) * D + k];
      xh[m] = (to_f(x[(size_t)r * D + k]) - mu) * rstd;
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
    red[0][warp][lane + 32 * m] = pg[m];
    red[1][warp][lane + 32 * m] = pb[m];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      a += red[0][w][k];
      b += red[1][w][k];
    }
    dgp[(size_t)blockIdx.x * D + k] = a;
    dbp[(size_t)blockIdx.x * D + k] = b;
  }
}

// ------------------------------------------------- bf16 route: tensor cores

// Shared memory of the tensor-core kernels: xn (and dyc) [kTcRows][D + 8],
// W1c [kHC][D + 8] and W2c [D][kHC + 8] double-buffered, mask 1's chunk
// [kTcRows][kHC] bytes, the activation (and dh) tile [kTcRows][kHC] bf16;
// the backward adds the warps' db1 [4][kHC] fp32.
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * ((size_t)kTcRows * (D + 8) + 2 * (size_t)kHC * (D + 8) +
                         2 * (size_t)D * (kHC + 8) + (size_t)kTcRows * kHC) +
         kTcRows * kHC;
}

template <int D>
constexpr size_t bwd_tc_smem() {
  return fwd_tc_smem<D>() + sizeof(bf16) * ((size_t)kTcRows * (D + 8) + kTcRows * kHC) +
         sizeof(float) * 4 * kHC;
}

// W1's rows [kHC][D] (pitch D + 8) and W2's columns [D][kHC] (pitch kHC + 8)
// of hidden chunk c into shared memory by cp.async
template <int D>
__device__ __forceinline__ void stage_weights_tc(const bf16* __restrict__ w1,
                                                 const bf16* __restrict__ w2, bf16* w1s,
                                                 bf16* w2s, int c, int H) {
  constexpr int XP = D + 8, WP = kHC + 8, Q = D / 8;
  const bf16* w1c = w1 + (size_t)c * kHC * D;
  for (int e = threadIdx.x; e < kHC * Q; e += kTcThreads) {
    const int j = e / Q, k = (e - j * Q) * 8;
    cp_async16(w1s + j * XP + k, w1c + j * D + k, true);
  }
  for (int e = threadIdx.x; e < D * (kHC / 8); e += kTcThreads) {
    const int i = e / (kHC / 8), j = (e - i * (kHC / 8)) * 8;
    cp_async16(w2s + i * WP + j, w2 + (size_t)i * H + c * kHC + j, true);
  }
}

// the block's rows of mask 1 for chunk c, [kTcRows][kHC] bytes (rows past R
// zero-filled: dropped), by cp.async
__device__ __forceinline__ void stage_mask_tc(const uint8_t* __restrict__ m1, uint8_t* ms,
                                              int c, int H, int row0, int R) {
  for (int e = threadIdx.x; e < kTcRows * (kHC / 16); e += kTcThreads) {
    const int rr = e / (kHC / 16), j = (e - rr * (kHC / 16)) * 16, r = row0 + rr;
    cp_async16(ms + rr * kHC + j, m1 + (size_t)(r < R ? r : 0) * H + c * kHC + j, r < R);
  }
}

// swish's sigmoid without IEEE division's slow-path branches: __expf and
// __fdividef, within 2 ulp of fp32, before the activation rounds to bf16
__device__ __forceinline__ float sigmoid_tc(float h) { return __fdividef(1.f, 1.f + __expf(-h)); }

// V consecutive values of a row, one load a lane (V = D / 32: 8 at D 256,
// 2 at D 64); bf16 stores round to nearest, as __float2bfloat16
__device__ __forceinline__ void ld_row(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void ld_row(const bf16* p, float (&v)[2]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = f.x;
  v[1] = f.y;
}
__device__ __forceinline__ void ld_row(const float* p, float (&v)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void ld_row(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void ld_row(const uint8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = (u.x >> (8 * i)) & 0xff;
    v[4 + i] = (u.y >> (8 * i)) & 0xff;
  }
}
__device__ __forceinline__ void ld_row(const uint8_t* p, float (&v)[2]) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(p);
  v[0] = u & 0xff;
  v[1] = u >> 8;
}
__device__ __forceinline__ void st_row(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void st_row(bf16* p, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
}

// LN(x)*g + b in place over a row held V values a lane (fp32 statistics,
// two passes as the JAX kernel: mean, then the mean of squared deviations)
template <int V>
__device__ __forceinline__ void ln_row(float (&v)[V], const float (&gv)[V],
                                       const float (&bv)[V]) {
  constexpr int D = 32 * V;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) s += v[e];
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = v[e] - mu;
    q = fmaf(t, t, q);
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / D + kEps);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = (v[e] - mu) * rstd * gv[e] + bv[e];
}

// The products of the tensor-core kernels. A warp's mma waits for its
// fragments, and ldmatrix and mma keep their order (volatile asm), so each
// loop loads its fragments some steps ahead of the mma that reads them
// (a ring of registers), and long sums run as two interleaved chains.

// h[2][4] = rows 16 rg .. of s_x (pitch D + 8) . units 16 hf .. of W1c^T
// (w1s [kHC][D + 8]): the D/16 steps alternate between two accumulator
// sets, added at the end
template <int D>
__device__ __forceinline__ void h_product(const bf16* s_x, const bf16* w1s, int rg, int hf,
                                          int lane, float (&h)[2][4]) {
  constexpr int XP = D + 8, K = D / 16;
  float acc[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  uint32_t xa[2][4], wb[2][4];
  ldsm4(xa[0], a_frag(s_x, XP, rg * 16, 0, lane));
  ldsm4(wb[0], b_frag(w1s, XP, hf * 16, 0, lane));
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < K) {
      ldsm4(xa[cur ^ 1], a_frag(s_x, XP, rg * 16, (kk + 1) * 16, lane));
      ldsm4(wb[cur ^ 1], b_frag(w1s, XP, hf * 16, (kk + 1) * 16, lane));
    }
    mma16816(acc[cur][0], xa[cur], wb[cur][0], wb[cur][1]);
    mma16816(acc[cur][1], xa[cur], wb[cur][2], wb[cur][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[nt][e] = acc[0][nt][e] + acc[1][nt][e];
}

// dd[2][4] = rows 16 rg .. of s_dy (pitch D + 8) . units 16 hf .. of W2c
// (w2s [D][kHC + 8], read transposed), as h_product
template <int D>
__device__ __forceinline__ void dad_product(const bf16* s_dy, const bf16* w2s, int rg, int hf,
                                            int lane, float (&dd)[2][4]) {
  constexpr int XP = D + 8, WP = kHC + 8, K = D / 16;
  float acc[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
  uint32_t ya[2][4], wc[2][4];
  ldsm4(ya[0], a_frag(s_dy, XP, rg * 16, 0, lane));
  ldsm4_t(wc[0], bt_frag(w2s, WP, hf * 16, 0, lane));
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < K) {
      ldsm4(ya[cur ^ 1], a_frag(s_dy, XP, rg * 16, (kk + 1) * 16, lane));
      ldsm4_t(wc[cur ^ 1], bt_frag(w2s, WP, hf * 16, (kk + 1) * 16, lane));
    }
    mma16816(acc[cur][0], ya[cur], wc[cur][0], wc[cur][1]);
    mma16816(acc[cur][1], ya[cur], wc[cur][2], wc[cur][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dd[nt][e] = acc[0][nt][e] + acc[1][nt][e];
}

// out[NC/8][4] += rows 16 rg .. of the chunk's tile s_t [kTcRows][kHC] .
// columns n0 .. n0 + NC of the weight tile w (W2c stored [n][k], pitch wp,
// or with `trans` W1c stored [k][n]); the B fragments 4 steps ahead
template <int NC, bool trans>
__device__ __forceinline__ void chunk_product(const bf16* s_t, const bf16* w, int wp, int rg,
                                              int n0, int lane, float (&out)[NC / 8][4]) {
  constexpr int NP = NC / 16, T = (kHC / 16) * NP, DEPTH = 4;
  uint32_t af[kHC / 16][4], wb[DEPTH][4];
#pragma unroll
  for (int kk = 0; kk < kHC / 16; ++kk) ldsm4(af[kk], a_frag(s_t, kHC, rg * 16, kk * 16, lane));
  auto load = [&](uint32_t (&r)[4], int t) {
    const int np = t % NP, kk = t / NP;
    if constexpr (trans)
      ldsm4_t(r, bt_frag(w, wp, n0 + np * 16, kk * 16, lane));
    else
      ldsm4(r, b_frag(w, wp, n0 + np * 16, kk * 16, lane));
  };
#pragma unroll
  for (int t = 0; t < DEPTH && t < T; ++t) load(wb[t], t);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int np = t % NP, kk = t / NP, q = t % DEPTH;
    mma16816(out[2 * np], af[kk], wb[q][0], wb[q][1]);
    mma16816(out[2 * np + 1], af[kk], wb[q][2], wb[q][3]);
    if (t + DEPTH < T) load(wb[q], t + DEPTH);
  }
}

constexpr int kLnGroup = 4;  // rows of x, do and mask 2 a warp of #11 loads at once

// LN(x)*g + b of the block's rows, rounded to bf16, into s_x (pitch D + 8);
// rows past R are 0. Warp w normalises rows 8 w .. 8 w + 7, their loads in
// flight together.
template <int D>
__device__ __forceinline__ void stage_xn_tc(const bf16* __restrict__ x,
                                            const float* __restrict__ g,
                                            const float* __restrict__ bb, bf16* s_x, int row0,
                                            int R) {
  constexpr int V = D / 32, RW = kTcRows / kTcWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, k0 = lane * V;
  float gv[V], bv[V], v[RW][V];
  ld_row(g + k0, gv);
  ld_row(bb + k0, bv);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = row0 + warp * RW + i;
    if (r < R) ld_row(x + (size_t)r * D + k0, v[i]);
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int rr = warp * RW + i;
    if (row0 + rr < R) {
      ln_row(v[i], gv, bv);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = 0.f;
    }
    st_row(s_x + rr * (D + 8) + k0, v[i]);
  }
}

// #10, bf16: 64 rows x one slice of H a block, 8 warps. Warp (rg, hf) =
// (w % 4, w / 4) owns rows 16 rg .. 16 rg + 15. Per chunk of 32 units: h =
// xn . W1c^T for its rows and units 16 hf .. 16 hf + 15 (mma), + b1, swish,
// mask 1 in fp32, rounded to bf16 into the block's activation tile; then
// y += a . W2c^T for its rows and columns hf D/2 .. (hf + 1) D/2 (mma). W1c
// and W2c come by cp.async into a double buffer (the next chunk loads under
// this chunk's products), mask 1's chunk into one buffer refilled once the
// activation has read it. With `part` the block writes its partial y
// (before b2) to part[slice][R][D], else it finishes the output.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
ffn_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ bb, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const uint8_t* __restrict__ m1,
                  const uint8_t* __restrict__ m2, bf16* __restrict__ out,
                  float* __restrict__ part, int R, int H, float keep, float scale) {
  constexpr int XP = D + 8, WP = kHC + 8, NC = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);  // [kTcRows][XP]
  bf16* s_w1 = s_x + kTcRows * XP;            // [2][kHC][XP]
  bf16* s_w2 = s_w1 + 2 * kHC * XP;           // [2][D][WP]
  bf16* s_a = s_w2 + 2 * D * WP;              // [kTcRows][kHC]
  uint8_t* s_m = reinterpret_cast<uint8_t*>(s_a + kTcRows * kHC);  // [kTcRows][kHC]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, cq = lane & 3, rg = warp & 3, hf = warp >> 2;
  const int row0 = blockIdx.x * kTcRows;
  const float inv_keep = 1.f / keep;
  int c0, c1;
  slice_chunks(H, c0, c1);

  stage_weights_tc<D>(w1, w2, s_w1, s_w2, c0, H);
  if (m1 != nullptr) stage_mask_tc(m1, s_m, c0, H, row0, R);
  cp_async_commit();
  stage_xn_tc<D>(x, g, bb, s_x, row0, R);

  float y[NC / 8][4];
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;

  for (int c = c0, buf = 0; c < c1; ++c, buf ^= 1) {
    if (c + 1 < c1)
      stage_weights_tc<D>(w1, w2, s_w1 + (buf ^ 1) * kHC * XP, s_w2 + (buf ^ 1) * D * WP,
                          c + 1, H);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c's weights and mask have landed
    __syncthreads();
    const bf16* w1s = s_w1 + buf * kHC * XP;
    const bf16* w2s = s_w2 + buf * D * WP;
    const float2 bj[2] = {*reinterpret_cast<const float2*>(b1 + c * kHC + hf * 16 + 2 * cq),
                          *reinterpret_cast<const float2*>(b1 + c * kHC + hf * 16 + 8 + 2 * cq)};
    float h[2][4];
    h_product<D>(s_x, w1s, rg, hf, lane, h);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = hf * 16 + nt * 8 + 2 * cq;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rr = rg * 16 + gq + 8 * hr;
        const float h0 = h[nt][2 * hr] + bj[nt].x, h1 = h[nt][2 * hr + 1] + bj[nt].y;
        float a0 = h0 * sigmoid_tc(h0), a1 = h1 * sigmoid_tc(h1);
        if (m1 != nullptr) {
          a0 = s_m[rr * kHC + j] ? a0 * inv_keep : 0.f;
          a1 = s_m[rr * kHC + j + 1] ? a1 * inv_keep : 0.f;
        }
        *reinterpret_cast<uint32_t*>(s_a + rr * kHC + j) = pack_bf16(a0, a1);
      }
    }
    __syncthreads();  // the activation tile is whole; mask 1's buffer is free
    if (m1 != nullptr && c + 1 < c1) stage_mask_tc(m1, s_m, c + 1, H, row0, R);
    cp_async_commit();
    chunk_product<NC, false>(s_a, w2s, WP, rg, hf * NC, lane, y);
    __syncthreads();  // every warp is done with this chunk's buffers
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + rg * 16 + gq + 8 * hr;
    if (r >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int i = hf * NC + nt * 8 + 2 * cq;
      const size_t at = (size_t)r * D + i;
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + (size_t)blockIdx.y * R * D + at) =
            make_float2(y[nt][2 * hr], y[nt][2 * hr + 1]);
        continue;
      }
      float v0 = y[nt][2 * hr] + b2[i], v1 = y[nt][2 * hr + 1] + b2[i + 1];
      if (m2 != nullptr) {
        v0 = m2[at] ? v0 / keep : 0.f;
        v1 = m2[at + 1] ? v1 / keep : 0.f;
      }
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
      *reinterpret_cast<uint32_t*>(out + at) =
          pack_bf16(__fadd_rn(xv.x, __fmul_rn(scale, v0)), __fadd_rn(xv.y, __fmul_rn(scale, v1)));
    }
  }
}

// #11 (a), bf16 row side: 64 rows x one slice of H a block, 8 warps as #10.
// Prologue: LN into bf16 xn, dy = do s mask2 / keep in fp32 and its bf16 dyc
// (the slice-0 blocks write xn, dyc and the rows' db2 of the fp32 dy). Per
// chunk of 32 units, warp (rg, hf) forms h = xn . W1c^T and dad = dyc . W2c
// (mma, W2c read with ldmatrix.trans) for its rows and 16 units, then the
// swish, mask 1 and dh in fp32; the dropped activation and dh, rounded to
// bf16, go to the block's tiles (and from there, 16 bytes a thread, to the
// scratch), the rows' db1 of the fp32 dh to the warps' partials; then
// dxn += dhc . W1c for its rows and columns hf D/2 .. (hf + 1) D/2 (mma, W1c
// read transposed). Ends by writing dxn as this slice's partial.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
ffn_bwd_rows_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ bb, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
                       const bf16* __restrict__ dout, bf16* __restrict__ xs_g,
                       bf16* __restrict__ dys_g, bf16* __restrict__ ad_g,
                       bf16* __restrict__ dh_g, float* __restrict__ dxp,
                       float* __restrict__ db1p, float* __restrict__ db2p, int R, int H,
                       float keep, float scale) {
  constexpr int XP = D + 8, WP = kHC + 8, NC = D / 2, V = D / 32, RW = kTcRows / kTcWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);  // [kTcRows][XP]
  bf16* s_w1 = s_x + kTcRows * XP;            // [2][kHC][XP]; first the db2 partials
  bf16* s_w2 = s_w1 + 2 * kHC * XP;           // [2][D][WP]
  bf16* s_a = s_w2 + 2 * D * WP;              // [kTcRows][kHC] dropped activation
  uint8_t* s_m = reinterpret_cast<uint8_t*>(s_a + kTcRows * kHC);  // [kTcRows][kHC]
  bf16* s_dy = reinterpret_cast<bf16*>(s_m + kTcRows * kHC);        // [kTcRows][XP]
  bf16* s_h = s_dy + kTcRows * XP;                                  // [kTcRows][kHC] dh
  float* s_red = reinterpret_cast<float*>(s_h + kTcRows * kHC);     // [4][kHC]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, cq = lane & 3, rg = warp & 3, hf = warp >> 2;
  const int row0 = blockIdx.x * kTcRows;
  const bool first = blockIdx.y == 0;
  const float inv_keep = 1.f / keep;
  int c0, c1;
  slice_chunks(H, c0, c1);

  stage_weights_tc<D>(w1, w2, s_w1, s_w2, c0, H);
  if (m1 != nullptr) stage_mask_tc(m1, s_m, c0, H, row0, R);
  cp_async_commit();
  {  // LN, dy; db2 over the rows (second W1 buffer as [kTcWarps][D] fp32)
    float* red2 = reinterpret_cast<float*>(s_w1 + kHC * XP);
    const int k0 = lane * V;
    float gv[V], bv[V], part[V];
    ld_row(g + k0, gv);
    ld_row(bb + k0, bv);
#pragma unroll
    for (int e = 0; e < V; ++e) part[e] = 0.f;
#pragma unroll
    for (int i0 = 0; i0 < RW; i0 += kLnGroup) {
      float xv[kLnGroup][V], dv[kLnGroup][V], mv[kLnGroup][V];
#pragma unroll
      for (int i = 0; i < kLnGroup; ++i) {
        const int r = row0 + warp * RW + i0 + i;
        if (r < R) {
          ld_row(x + (size_t)r * D + k0, xv[i]);
          ld_row(dout + (size_t)r * D + k0, dv[i]);
          if (m2 != nullptr) ld_row(m2 + (size_t)r * D + k0, mv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kLnGroup; ++i) {
        const int rr = warp * RW + i0 + i, r = row0 + rr;
        if (r < R) {
          ln_row(xv[i], gv, bv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float d = dv[i][e] * scale;
            if (m2 != nullptr) d = mv[i][e] != 0.f ? d / keep : 0.f;
            dv[i][e] = d;
            part[e] += d;
          }
          if (first) {
            st_row(xs_g + (size_t)r * D + k0, xv[i]);
            st_row(dys_g + (size_t)r * D + k0, dv[i]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) xv[i][e] = dv[i][e] = 0.f;
        }
        st_row(s_x + rr * XP + k0, xv[i]);
        st_row(s_dy + rr * XP + k0, dv[i]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) red2[warp * D + k0 + e] = part[e];
    __syncthreads();
    if (first) {
      for (int k = threadIdx.x; k < D; k += kTcThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kTcWarps; ++w) sum += red2[w * D + k];
        db2p[(size_t)blockIdx.x * D + k] = sum;
      }
    }
    __syncthreads();
  }

  float dxn[NC / 8][4];
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxn[nt][e] = 0.f;

  for (int c = c0, buf = 0; c < c1; ++c, buf ^= 1) {
    if (c + 1 < c1)
      stage_weights_tc<D>(w1, w2, s_w1 + (buf ^ 1) * kHC * XP, s_w2 + (buf ^ 1) * D * WP,
                          c + 1, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* w1s = s_w1 + buf * kHC * XP;
    const bf16* w2s = s_w2 + buf * D * WP;
    const float2 bj[2] = {*reinterpret_cast<const float2*>(b1 + c * kHC + hf * 16 + 2 * cq),
                          *reinterpret_cast<const float2*>(b1 + c * kHC + hf * 16 + 8 + 2 * cq)};
    float h[2][4], dd[2][4];
    h_product<D>(s_x, w1s, rg, hf, lane, h);
    dad_product<D>(s_dy, w2s, rg, hf, lane, dd);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = hf * 16 + nt * 8 + 2 * cq;
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rr = rg * 16 + gq + 8 * hr;
        float av[2], dh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hv = h[nt][2 * hr + e] + (e ? bj[nt].y : bj[nt].x);
          const float sg = sigmoid_tc(hv);
          float ac = hv * sg, da = dd[nt][2 * hr + e];
          if (m1 != nullptr) {
            const bool kept = s_m[rr * kHC + j + e] != 0;
            ac = kept ? ac * inv_keep : 0.f;
            da = kept ? da * inv_keep : 0.f;
          }
          av[e] = ac;
          dh[e] = da * (sg * (1.f + hv * (1.f - sg)));
          col[e] += dh[e];
        }
        *reinterpret_cast<uint32_t*>(s_a + rr * kHC + j) = pack_bf16(av[0], av[1]);
        *reinterpret_cast<uint32_t*>(s_h + rr * kHC + j) = pack_bf16(dh[0], dh[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)  // over the warp's 8 row pairs, a fixed tree
          col[e] += __shfl_xor_sync(0xffffffffu, col[e], o);
        if (gq == 0) s_red[rg * kHC + j + e] = col[e];
      }
    }
    __syncthreads();  // the activation and dh tiles are whole; mask 1's buffer is free
    if (m1 != nullptr && c + 1 < c1) stage_mask_tc(m1, s_m, c + 1, H, row0, R);
    cp_async_commit();
    if (threadIdx.x < kHC) {  // db1 of the block's rows, row groups in order
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += s_red[w * kHC + threadIdx.x];
      db1p[(size_t)blockIdx.x * H + c * kHC + threadIdx.x] = sum;
    }
    for (int e = threadIdx.x; e < 2 * kTcRows * (kHC / 8); e += kTcThreads) {
      const int t = e / (kTcRows * (kHC / 8)), q = e - t * (kTcRows * (kHC / 8));
      const int rr = q / (kHC / 8), j = (q - rr * (kHC / 8)) * 8, r = row0 + rr;
      if (r < R)
        *reinterpret_cast<uint4*>((t ? dh_g : ad_g) + (size_t)r * H + c * kHC + j) =
            *reinterpret_cast<const uint4*>((t ? s_h : s_a) + rr * kHC + j);
    }
    chunk_product<NC, true>(s_h, w1s, XP, rg, hf * NC, lane, dxn);
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + rg * 16 + gq + 8 * hr;
    if (r >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      *reinterpret_cast<float2*>(dxp + ((size_t)blockIdx.y * R + r) * D + hf * NC + nt * 8 +
                                 2 * cq) = make_float2(dxn[nt][2 * hr], dxn[nt][2 * hr + 1]);
  }
}

// ------------------------------------------------- #11 (c): the weight side

// out[m][n] = sum over r of A[r][m] B[r][n] for the block's 64 x 64 output
// tile (A [R][M], B [R][N] bf16; out [M][N] fp32), on tensor cores: A^T and
// B tiles of 64 rows by cp.async into a double buffer, both read with
// ldmatrix.trans; a warp owns 16 output rows x 32 columns. Each output element is summed
// by this block alone, rows in order, and written once.
__device__ __forceinline__ void weight_tile_tc(const bf16* __restrict__ A,
                                               const bf16* __restrict__ B,
                                               float* __restrict__ out, int R, int M, int N,
                                               int m0, int n0) {
  constexpr int TP = kWT + 8;
  __shared__ __align__(16) bf16 sA[2][kWT * TP], sB[2][kWT * TP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, cq = lane & 3, wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  auto stage = [&](int r0, int buf) {
    for (int e = threadIdx.x; e < kWT * (kWT / 8); e += kWThreads) {
      const int rr = e / (kWT / 8), cc = (e - rr * (kWT / 8)) * 8, r = r0 + rr;
      const bool in_a = r < R && m0 + cc < M, in_b = r < R && n0 + cc < N;
      cp_async16(sA[buf] + rr * TP + cc, A + (in_a ? (size_t)r * M + m0 + cc : 0), in_a);
      cp_async16(sB[buf] + rr * TP + cc, B + (in_b ? (size_t)r * N + n0 + cc : 0), in_b);
    }
  };
  float acc[4][4];  // the warp's 16 x 32 outputs
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int nk = cdiv(R, kWT);
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0, buf = 0; kt < nk; ++kt, buf ^= 1) {
    if (kt + 1 < nk) stage((kt + 1) * kWT, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    {  // the fragments of the next step loaded ahead of this step's mma
      constexpr int K = kWT / 16;
      uint32_t af[2][4], wb[2][2][4];
      auto load = [&](int kk, int q) {
        ldsm4_t(af[q], at_frag(sA[buf], TP, wm, kk * 16, lane));
        ldsm4_t(wb[q][0], bt_frag(sB[buf], TP, wn, kk * 16, lane));
        ldsm4_t(wb[q][1], bt_frag(sB[buf], TP, wn + 16, kk * 16, lane));
      };
      load(0, 0);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int q = kk & 1;
        if (kk + 1 < K) load(kk + 1, q ^ 1);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma16816(acc[2 * np], af[q], wb[q][np][0], wb[q][np][1]);
          mma16816(acc[2 * np + 1], af[q], wb[q][np][2], wb[q][np][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + wm + gq + 8 * hr;
    if (m >= M) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn + nt * 8 + 2 * cq;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
    }
  }
}

// the same in fp32 on CUDA cores: 16-row steps, a thread 4 x 4 outputs
__device__ __forceinline__ void weight_tile_f32(const float* __restrict__ A,
                                                const float* __restrict__ B,
                                                float* __restrict__ out, int R, int M, int N,
                                                int m0, int n0) {
  constexpr int KS = 16;
  __shared__ __align__(16) float sA[KS][kWT], sB[KS][kWT];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < R; r0 += KS) {
    for (int e = threadIdx.x; e < KS * (kWT / 4); e += kWThreads) {
      const int rr = e / (kWT / 4), cc = (e - rr * (kWT / 4)) * 4, r = r0 + rr;
      *reinterpret_cast<float4*>(&sA[rr][cc]) =
          r < R && m0 + cc < M ? ld4(A + (size_t)r * M + m0 + cc) : zero;
      *reinterpret_cast<float4*>(&sB[rr][cc]) =
          r < R && n0 + cc < N ? ld4(B + (size_t)r * N + n0 + cc) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kr = 0; kr < KS; ++kr) {
      const float4 a = ld4(&sA[kr][ty * 4]), b = ld4(&sB[kr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int n = n0 + tx * 4;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M)
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// #11 (c): dW2 [D][H] = dyc^T . adc and dW1 [H][D] = dhc^T . xn, a 64 x 64
// tile a block; the last block sums the row tiles' partial db1, db2, dg and
// db in tile order.
template <typename T>
__global__ void __launch_bounds__(kWThreads)
ffn_bwd_w_kernel(const T* __restrict__ xs, const T* __restrict__ dys, const T* __restrict__ ad,
                 const T* __restrict__ dh, float* __restrict__ dw1, float* __restrict__ dw2,
                 const float* __restrict__ db1p, const float* __restrict__ db2p,
                 const float* __restrict__ dgp, const float* __restrict__ dbp,
                 float* __restrict__ db1, float* __restrict__ db2, float* __restrict__ dg,
                 float* __restrict__ db, int R, int D, int H, int tiles, int ln_tiles) {
  const int th = cdiv(H, kWT), n2 = (D / kWT) * th;
  int t = blockIdx.x;
  if (t == 2 * n2) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float s = 0.f;
      for (int i = 0; i < tiles; ++i) s += db1p[(size_t)i * H + j];
      db1[j] = s;
    }
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
      float s = 0.f, a = 0.f, b = 0.f;
      for (int i = 0; i < tiles; ++i) s += db2p[(size_t)i * D + k];
      for (int i = 0; i < ln_tiles; ++i) {
        a += dgp[(size_t)i * D + k];
        b += dbp[(size_t)i * D + k];
      }
      db2[k] = s;
      dg[k] = a;
      db[k] = b;
    }
    return;
  }
  const bool second = t >= n2;  // dW1
  t -= second ? n2 : 0;
  const T* A = second ? dh : dys;
  const T* B = second ? xs : ad;
  float* out = second ? dw1 : dw2;
  const int M = second ? H : D, N = second ? D : H, tn = cdiv(N, kWT);
  const int m0 = (t / tn) * kWT, n0 = (t % tn) * kWT;
  if constexpr (sizeof(T) == 2)
    weight_tile_tc(A, B, out, R, M, N, m0, n0);
  else
    weight_tile_f32(A, B, out, R, M, N, m0, n0);
}

// ------------------------------------------------- launches

// S slices of nc chunks: each of ceil(nc / S) chunks, none empty
bool valid_slices(int H, int S) {
  const int nc = H / kHC;
  return S >= 1 && S <= nc && cdiv(nc, cdiv(nc, S)) == S;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // as much shared memory as the SM has, so two forward blocks fit an SM
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* m1,
                       const void* m2, void* out, float* part, int R, int H, int S, float keep,
                       float scale, cudaStream_t st) {
  constexpr bool tc = sizeof(T) == 2;
  const int rows = tc ? kTcRows : kRows;
  const dim3 grid(cdiv(R, rows), S);
  float* own = S > 1 ? part : nullptr;
  cudaError_t err;
  if constexpr (tc) {
    err = prepare(ffn_fwd_tc_kernel<D>, fwd_tc_smem<D>());
    if (err != cudaSuccess) return err;
    ffn_fwd_tc_kernel<D><<<grid, kTcThreads, fwd_tc_smem<D>(), st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2),
        static_cast<bf16*>(out), own, R, H, keep, scale);
  } else {
    err = prepare(ffn_fwd_f32_kernel<D / 64>, fwd_f32_smem<D>());
    if (err != cudaSuccess) return err;
    ffn_fwd_f32_kernel<D / 64><<<grid, kThreads, fwd_f32_smem<D>(), st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const uint8_t*>(m1),
        static_cast<const uint8_t*>(m2), static_cast<float*>(out), own, R, H, keep, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t quads = (size_t)R * D / 4;
  ffn_fwd_sum_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(b2), static_cast<const uint8_t*>(m2),
      part, static_cast<T*>(out), R, D, S, keep, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* x, const void* g, const void* b, const void* w1,
                       const void* b1, const void* w2, const void* m1, const void* m2,
                       const void* dout, void* dx, void* dg, void* db, void* dw1, void* db1,
                       void* dw2, void* db2, unsigned char* ws, const BwdWs& w, int R, int H,
                       int S, float keep, float scale, cudaStream_t st) {
  constexpr bool tc = sizeof(T) == 2;
  const int tiles = cdiv(R, tc ? kTcRows : kRows), ln_tiles = cdiv(R, kLnRows);
  T* xs = reinterpret_cast<T*>(ws + w.xs);
  T* dys = reinterpret_cast<T*>(ws + w.dys);
  T* ad = reinterpret_cast<T*>(ws + w.ad);
  T* dh = reinterpret_cast<T*>(ws + w.dh);
  float* dxp = reinterpret_cast<float*>(ws + w.dxp);
  float* db1p = reinterpret_cast<float*>(ws + w.db1p);
  float* db2p = reinterpret_cast<float*>(ws + w.db2p);
  float* dgp = reinterpret_cast<float*>(ws + w.dgp);
  float* dbp = reinterpret_cast<float*>(ws + w.dbp);
  const dim3 grid(tiles, S);
  cudaError_t err;
  if constexpr (tc) {
    err = prepare(ffn_bwd_rows_tc_kernel<D>, bwd_tc_smem<D>());
    if (err != cudaSuccess) return err;
    ffn_bwd_rows_tc_kernel<D><<<grid, kTcThreads, bwd_tc_smem<D>(), st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const uint8_t*>(m1),
        static_cast<const uint8_t*>(m2), static_cast<const bf16*>(dout), xs, dys, ad, dh, dxp,
        db1p, db2p, R, H, keep, scale);
  } else {
    err = prepare(ffn_bwd_rows_f32_kernel<D / 64>, bwd_f32_smem<D>());
    if (err != cudaSuccess) return err;
    ffn_bwd_rows_f32_kernel<D / 64><<<grid, kThreads, bwd_f32_smem<D>(), st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2),
        static_cast<const float*>(dout), xs, dys, ad, dh, dxp, db1p, db2p, R, H, keep, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_bwd_ln_kernel<T, D><<<ln_tiles, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const T*>(dout), dxp,
      S, static_cast<T*>(dx), dgp, dbp, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n2 = (D / kWT) * cdiv(H, kWT);
  ffn_bwd_w_kernel<T><<<2 * n2 + 1, kWThreads, 0, st>>>(
      xs, dys, ad, dh, static_cast<float*>(dw1), static_cast<float*>(dw2), db1p, db2p, dgp, dbp,
      static_cast<float*>(db1), static_cast<float*>(db2), static_cast<float*>(dg),
      static_cast<float*>(db), R, D, H, tiles, ln_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [R, D] T; g, b, b2 [D] and b1 [H] fp32; w1 [H, D], w2 [D, H] T; m1 [R, H]
// and m2 [R, D] uint8 or both null; -> out [R, D] T. keep = 1 - rate (the
// kept values are divided by it), scale = ff_scale. D 64 or 256, H a
// multiple of 32; T = bf16 if bf16 else fp32; all contiguous, 16-byte
// aligned. `slices` S splits H (valid_slices); with S > 1, ws holds the
// partial outputs, S R D fp32 (ws_bytes at least that).
int ffn_fwd(const void* x, const void* g, const void* b, const void* w1, const void* b1,
            const void* w2, const void* b2, const void* m1, const void* m2, void* out, int R,
            int D, int H, float keep, float scale, int bf16_, void* ws, long long ws_bytes,
            int slices, void* stream) {
  if (R == 0) return 0;
  if ((D != 64 && D != 256) || H % kHC || H <= 0 || !valid_slices(H, slices) ||
      (slices > 1 && ws_bytes < (long long)slices * R * D * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_FWD(T, DD) \
  err = launch_fwd<T, DD>(x, g, b, w1, b1, w2, b2, m1, m2, out, part, R, H, slices, keep, scale, st)
  if (bf16_) {
    if (D == 64) TPUASR_FWD(bf16, 64);
    if (D == 256) TPUASR_FWD(bf16, 256);
  } else {
    if (D == 64) TPUASR_FWD(float, 64);
    if (D == 256) TPUASR_FWD(float, 256);
  }
#undef TPUASR_FWD
  return static_cast<int>(err);
}

// + dout [R, D] T -> dx [R, D] T and the fp32 sums over the rows dg, db [D],
// dw1 [H, D], db1 [H], dw2 [D, H], db2 [D], each written once (no need to
// zero them). ws holds the scratch of `bwd_ws` (ws_bytes at least its
// total). b2 is not read (its gradient needs only dy).
int ffn_bwd(const void* x, const void* g, const void* b, const void* w1, const void* b1,
            const void* w2, const void* b2, const void* m1, const void* m2, const void* dout,
            void* dx, void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2, int R,
            int D, int H, float keep, float scale, int bf16_, void* ws, long long ws_bytes,
            int slices, void* stream) {
  (void)b2;
  if (R == 0) return 0;
  if ((D != 64 && D != 256) || H % kHC || H <= 0 || !valid_slices(H, slices))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdWs w = bwd_ws(R, D, H, slices, bf16_ ? 2 : 4, cdiv(R, bf16_ ? kTcRows : kRows));
  if (ws_bytes < (long long)w.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_BWD(T, DD)                                                                  \
  err = launch_bwd<T, DD>(x, g, b, w1, b1, w2, m1, m2, dout, dx, dg, db, dw1, db1, dw2, db2, \
                          base, w, R, H, slices, keep, scale, st)
  if (bf16_) {
    if (D == 64) TPUASR_BWD(bf16, 64);
    if (D == 256) TPUASR_BWD(bf16, 256);
  } else {
    if (D == 64) TPUASR_BWD(float, 64);
    if (D == 256) TPUASR_BWD(float, 256);
  }
#undef TPUASR_BWD
  return static_cast<int>(err);
}

}  // extern "C"
