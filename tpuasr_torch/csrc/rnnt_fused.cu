// Fused RNN-T joint: tanh(enc_p[t] + pred_p[u]) @ W + b, log-softmax and the
// blank / label log-probs (forward, #4), and the joint's gradients (backward,
// #5), without the [B, T, U1, V] logits ever reaching device memory.
//
// Replaces the TPU kernels `_fused_fwd_kernel` / `_fused_lp`
// (tpuasr/ops/rnnt_fused_pallas.py:38-68, :153-177) and `_fused_bwd_kernel` /
// `_fused_grads` (:71-123, :180-217). All fp32, as the JAX wrapper casts its
// operands (:139-143). Rows are the (t, u) pairs of one utterance, row
// n = t * U1 + u.
//
// What bounds them on an H100: operations. At the flagship's training shape
// (B 12, T' 191, U1 33, D 256, V 412: 75,636 rows) the forward is one
// [rows, D] x [D, V] product, 15.95 GFLOP, 0.24 ms at the fp32 CUDA-core peak
// (67 TFLOP/s), against ~4 MB of operands and outputs (~1 us). The backward
// needs three such products (logits again, dX.W^T, a^T.dX), 47.9 GFLOP: 0.714
// ms on CUDA cores; on tensor cores as 3xTF32 (three TF32 passes a product,
// below) 3 x 47.9 GFLOP at the dense TF32 peak (494.7 TFLOP/s), 0.290 ms.
// The exp of every logit (31 M) comes on top.
//
// Forward design (CUDA cores): one block of 256 threads per (utterance, tile
// of 64 rows). The block writes tanh(enc + pred) for its rows into shared
// memory once, then walks the vocabulary in tiles of 64 columns: W arrives in
// chunks of 32 x 64 through shared memory, each thread accumulates a 4 x 4
// block of logits in registers, and an online logsumexp (running max and sum
// per row, reduced across the 16 threads of a row with warp shuffles) folds
// each tile in. The blank column and the row's label column are picked as
// they pass; the label id is read directly (the TPU kernel builds a one-hot
// matrix, :147-149), an id outside [0, V) gives logit 0 as that one-hot
// does, and padded vocab columns never enter the sum. The outputs are
// blank_lp, label_lp and the row's logsumexp, [B, T, U1] each: the backward
// reads the logsumexp instead of running a first pass over V again.
//
// Backward design. dX = gb*1[blank] + gl*1[label] - exp(x - lse)*(gb + gl)
// for the logits x of a row; d_enc[t] = sum over u and d_pred[u] = sum over
// t of djoined = (dX . W^T) * (1 - a^2); dW = a^T . dX, db = sum of dX. The
// TPU kernel sums d_pred, dW and db across a grid that runs in order. Hopper
// blocks run in no order, and fp32 atomics would add in an order that
// changes between runs, so every sum across blocks goes through a partial
// buffer, summed by one thread in a fixed order: two calls give the same
// bits. Four kernels behind one entry, tiled by `_joint_bwd_plan`
// (ops/rnnt_fused.py); blocks of 512 threads (16 warps, 128 registers):
//  (0) `rnnt_bwd_wsplit_kernel` splits W once into TF32 (hi, lo) pairs in
//      the row side's [D][32] tiles (0.85 MB at the bench shape).
//  (a) `rnnt_bwd_rows_kernel`, the row side: a block owns utterance b's
//      frames t0..t0+tt-1 x label positions u0..u0+uc-1 (tt x uc <= 64
//      rows, tt + uc <= 32 at D 256; the plan takes the split of U1 with the
//      fewest waves, then the least workspace: uc 7 x tt 9, 5 x 22 x 12 =
//      1,320 blocks, 10 waves at the bench shape). It copies the tile's tt
//      enc rows and uc pred rows by cp.async (16, where each row's pair
//      would be 2 x 64) and writes a = tanh(enc + pred) for its rows into
//      shared memory once, then walks the vocabulary in tiles of 32 columns
//      (32 waste 1% of V 412, 64 would waste 8%), each W tile by cp.async
//      into a double buffer: the logits a . W_tile, warp (rows 16, all 32
//      columns, a quarter of D), so each a element is loaded by one warp;
//      the quarters' partial logits summed in order, dX from them in fp32
//      and stored split over the partials; then dA += dX . W_tile^T from the
//      same W tile (warp: 32 rows x 32 columns). Then djoined = dA * (1 -
//      a^2) in place of a, and a thread a column d sums it over u in order
//      into enc_part[b, u-chunk, t, d] and over t into pred_part[b, t-chunk,
//      u, d]. 224 KB of shared memory at D 256.
//  (b) `rnnt_bwd_vocab_kernel`, the vocabulary side: a block owns 64
//      vocabulary columns (W's split [D][64] in shared memory for its life)
//      and every S-th row-side tile, S = the SMs over the vocabulary tiles
//      (18 x 7 = 126 blocks at the bench shape, one wave). A step copies the
//      tile's enc and pred rows and forms a as the row side does, the
//      logits (warp: 16 rows x 32 columns x half of D) and dX as on the row
//      side, the columns' sums of dX for db, and dW += a^T . dX (warp: 32
//      rows of dW x 32 columns); at the end it writes dw_part[s] and
//      db_part[s]. So tanh and the logits are computed on both sides (four
//      products, not three): the price of no atomics and no [rows, V] or
//      [rows, D] buffer. 224 KB of shared memory at D 256.
//  (c) `rnnt_bwd_sum_kernel` sums enc_part over u-chunks, pred_part over
//      t-chunks and dw_part / db_part over s, each in the order 0, 1, ...,
//      and writes d_enc, d_pred, dW and db once: no output is zeroed first.
// A tile whose rows all have gb = gl = 0 (padding frames and labels) adds
// exactly nothing: the row side writes its zero partials and stops, the
// vocabulary side skips it; the strided tile order spreads the skipped
// tiles over the vocabulary blocks.
// Precision: 3xTF32 on mma.sync.m16n8k8 (mma.cuh): each fp32 operand is
// hi + lo, hi cut to TF32 and lo the rest (split_tf32), either as its
// fragment is loaded from an fp32 tile (a) or once into (hi, lo) pairs (W,
// dX); each product is lo.hi + hi.lo + hi.hi in fp32, about 21 bits: plain
// TF32 (10 bits) would not keep the card tests' 1e-4 of each output's max,
// since exp(x - lse) magnifies a logit's error. The three terms go pass by
// pass over a warp's tiles, so consecutive mma are independent. exp and
// tanh are ex2.approx with the product x log2(e) carried in two parts
// (~3 ulp) and 1 - 2/(e^(2|x|) + 1) (within ~2e-7): the libm versions cost
// several times the instructions, and these kernels are bound by issued
// instructions and short dependent phases, not by the tensor cores.
// Shared tiles have a pitch that is a multiple of 32 floats (16 pairs) and
// XOR-swizzle the column by the row (`swz`, `swz2`), so both ways a tile is
// read (rows g x columns c, and rows c x columns g) hit distinct banks. D is
// padded to a multiple of 32 with zeros; any D <= 256 and any T, U1, V are
// taken (rows and columns past the end read nothing and add nothing). The
// workspace is 29.1 MB at the bench shape (enc_part 11.7, pred_part 8.9,
// dw_part 7.6, W split 0.85) and 11.9 / 15.6 MB at the trainer's T' 63 /
// 127 (U1 17); the plan keeps the row side's partials under 32 MB so they
// stay in the 50 MB L2. Nothing of [rows, V] or [rows, D] is written to
// device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
// forward
constexpr int kR = 64;   // rows per block
constexpr int kVT = 64;  // vocabulary columns per tile
constexpr int kKC = 32;  // depth of a W chunk
// backward
constexpr int kBRows = 64;   // rows of a row-side block, and of a vocabulary-side step
constexpr int kRVT = 32;     // vocabulary columns of a row-side tile
constexpr int kVVT = 64;     // vocabulary columns of a vocabulary-side block
constexpr int kMaxD = 256;   // the accumulators' width
constexpr int kBThreads = 512;  // a backward block: 16 warps, 4 row groups x 4
constexpr int kStage = 8192;    // floats for a tile's enc and pred rows: (tt + uc) Dp <= kStage
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ int label_of(const int* labels, int b, int u, int U1, int blank) {
  // column U (the last) has no label; it reads the blank, as the TPU
  // kernel's padded label row does
  return u < U1 - 1 ? labels[(size_t)b * (U1 - 1) + u] : blank;
}

__global__ void __launch_bounds__(kThreads)
rnnt_fwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                const float* __restrict__ w, const float* __restrict__ bias,
                const int* __restrict__ labels, float* __restrict__ blank_lp,
                float* __restrict__ label_lp, float* __restrict__ lse, int T, int U1,
                int D, int V, int blank) {
  extern __shared__ float smem[];
  float* A = smem;                            // [kR][D + 1] tanh(enc + pred)
  float* Ws = A + (size_t)kR * (D + 1);       // [kKC][kVT] W chunk
  __shared__ float row_blank[kR], row_label[kR];
  __shared__ int row_lab[kR];

  const int b = blockIdx.y;
  const int N = T * U1;
  const int r0 = blockIdx.x * kR;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < kR * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int n = r0 + r;
    float a = 0.f;
    if (n < N) {
      const int t = n / U1, u = n - t * U1;
      a = tanhf(enc[((size_t)b * T + t) * D + d] + pred[((size_t)b * U1 + u) * D + d]);
    }
    A[r * (D + 1) + d] = a;
  }
  for (int r = tid; r < kR; r += kThreads) {
    const int n = r0 + r;
    row_lab[r] = n < N ? label_of(labels, b, n % U1, U1, blank) : -1;
    row_label[r] = 0.f;  // a label id outside [0, V) keeps logit 0 (one-hot parity)
    row_blank[r] = 0.f;
  }
  __syncthreads();

  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += kVT) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += kKC) {
      for (int i = tid; i < kKC * kVT; i += kThreads) {
        const int kk = i / kVT, c = i - kk * kVT;
        const int k = k0 + kk, col = v0 + c;
        Ws[i] = (k < D && col < V) ? w[(size_t)k * V + col] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKC, D - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4], x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = Ws[kk * kVT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col < V) {
          const float x = acc[i][j] + bias[col];
          acc[i][j] = x;
          mx = fmaxf(mx, x);
          if (col == blank) row_blank[r] = x;
          if (col == row_lab[r]) row_label[r] = x;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx + 16 * j < V) sum += expf(acc[i][j] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s[i] = s[i] * expf(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
  __syncthreads();  // row_blank / row_label written by other threads
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int n = r0 + r;
      if (n < N) {
        const float l = m[i] + logf(s[i]);
        const size_t o = (size_t)b * N + n;
        blank_lp[o] = row_blank[r] - l;
        label_lp[o] = row_label[r] - l;
        lse[o] = l;
      }
    }
  }
}

// ----------------------------------------------------------------- backward

__host__ __device__ inline int pad32(int d) { return (d + 31) / 32 * 32; }

// Shared tiles and their swizzles. fp32 tiles (pitch a multiple of 32
// floats) move row r's columns by swz(r): rows r..r+7 by 8 distinct
// multiples of 4 in bits 2-4, so a warp reads 32 distinct banks both as
// rows g x columns c (g = lane / 4, c = lane % 4: swz(g) distinct in bits
// 2-4) and as rows c x columns g (swz(c) = 8c distinct in bits 3-4). Split
// tiles hold each value as its (hi, lo) TF32 pair, a uint2 (pitch a
// multiple of 16 pairs), moved by swz2(r) = 4 (r % 4): a 64-bit load is
// served a half-warp at a time, and lanes 0-15 (g 0-3) or 16-31 (g 4-7) hit
// 16 distinct bank pairs both ways. Both keep groups of 4 columns together
// (16-byte stores).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int swz2(int r) { return (r & 3) << 2; }
__device__ __forceinline__ int at(int r, int c, int pitch) { return r * pitch + (c ^ swz(r)); }
__device__ __forceinline__ int at2(int r, int c, int pitch) { return r * pitch + (c ^ swz2(r)); }

__device__ __forceinline__ uint2 split_pair(float x) {
  uint2 p;
  split_tf32(x, p.x, p.y);
  return p;
}
// two neighbouring columns' pairs, one 16-byte store (even column)
__device__ __forceinline__ void store_pairs(uint2* p, float x0, float x1) {
  const uint2 a = split_pair(x0), b = split_pair(x1);
  *reinterpret_cast<uint4*>(p) = make_uint4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void to_frag(const uint2 (&p)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = p[i].x;
    lo[i] = p[i].y;
  }
}

// a block's rows: dX's operands, and the row's frame and label position in the tile
struct JointRows {
  float lse[kBRows], gb[kBRows], gl[kBRows];
  int lab[kBRows], ok[kBRows], tl[kBRows], ul[kBRows];
};

// -> whether the row has a gradient (gb or gl not 0): a tile of rows that
// all have none adds exactly nothing (dX = -softmax * 0 + 0) and is skipped
__device__ __forceinline__ bool load_row(JointRows& R, int r, int tl, int ul, bool ok, size_t o,
                                         const float* lse, const float* gb, const float* gl,
                                         const int* labels, int b, int u, int U1, int blank) {
  R.ok[r] = ok;
  R.tl[r] = tl;
  R.ul[r] = ul;
  R.lse[r] = ok ? lse[o] : 0.f;
  R.gb[r] = ok ? gb[o] : 0.f;
  R.gl[r] = ok ? gl[o] : 0.f;
  R.lab[r] = ok ? label_of(labels, b, u, U1, blank) : -1;
  return R.gb[r] != 0.f || R.gl[r] != 0.f;
}

// e^x for x <= ~0 within ~3 ulp: ex2.approx (2 ulp) of x log2(e) taken as
// t + e (t rounded, e its remainder), 2^e ~ 1 + e ln 2; a fraction of expf's
// instructions. Results below 2^-126 (x < -87.3) flush to 0.
__device__ __forceinline__ float exp_f32(float x) {
  const float t = x * 1.44269502f;
  const float e = fmaf(x, 1.44269502f, -t) + x * 1.92596299e-8f;
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(t));
  return p * fmaf(e, 0.693147181f, 1.f);
}

// tanh(x) = sign(x) (1 - 2 / (e^(2|x|) + 1)): within ~2e-7 of tanhf
// everywhere (absolute; a is at most 1 and enters sums of products), with a
// fraction of its instructions
__device__ __forceinline__ float tanh_f32(float x) {
  const float e = exp_f32(-2.f * fabsf(x));  // in (0, 1]: no overflow
  return copysignf(__fdividef(1.f - e, 1.f + e), x);
}

// A tile's rows (t0.. t0+nt-1, u0.. u0+nu-1 of utterance b) for a = tanh(enc +
// pred): its nt enc rows and nu pred rows by cp.async into St [nt + nu][Dp]
// (zeros past D; 16 bytes a copy when D % 4 == 0 and enc, pred are 16-byte
// aligned), one round trip for 16 rows where reading each row's pair would
// be 64 x 2
__device__ __forceinline__ void stage_rows(float* St, const float* enc, const float* pred,
                                           int b, int t0, int u0, int nt, int nu, int T,
                                           int U1, int D, int Dp, int vec, int tid) {
  const float* src_e = enc + ((size_t)b * T + t0) * D;
  const float* src_p = pred + ((size_t)b * U1 + u0) * D;
  if (vec) {
    const int dq = Dp / 4;
    for (int i = tid; i < (nt + nu) * dq; i += kBThreads) {
      const int r = i / dq, d = (i - r * dq) * 4;
      const float* src = r < nt ? src_e + (size_t)r * D : src_p + (size_t)(r - nt) * D;
      cp_async16(St + r * Dp + d, d < D ? src + d : enc, d < D);
    }
  } else {
    for (int i = tid; i < (nt + nu) * Dp; i += kBThreads) {
      const int r = i / Dp, d = i - r * Dp;
      const float* src = r < nt ? src_e + (size_t)r * D : src_p + (size_t)(r - nt) * D;
      cp_async4(St + r * Dp + d, d < D ? src + d : enc, d < D);
    }
  }
  cp_async_commit();
}
// then a into the fp32 tile As [64][Dp] (0 on rows that are not there): a
// thread a column, every (512 / Dp)-th row, no division in the loop
__device__ __forceinline__ void tanh_rows(float* As, const float* St, const JointRows& R, int nt,
                                          int Dp, int tid) {
  const int step = kBThreads / Dp, d = tid % Dp;
  if (tid < step * Dp)
    for (int r = tid / Dp; r < kBRows; r += step)
      As[at(r, d, Dp)] =
          R.ok[r] ? tanh_f32(St[R.tl[r] * Dp + d] + St[(nt + R.ul[r]) * Dp + d]) : 0.f;
}

// dX of the logit x at row r, vocabulary column v (dX = 0 past V and on
// rows that are not there); the plain version's order of additions
__device__ __forceinline__ float dlogit(const JointRows& R, int r, int v, float x, float bv,
                                        int V, int blank) {
  if (v >= V || !R.ok[r]) return 0.f;
  float dx = -exp_f32(x + bv - R.lse[r]) * (R.gb[r] + R.gl[r]);
  if (v == blank) dx += R.gb[r];
  if (v == R.lab[r]) dx += R.gl[r];
  return dx;
}

size_t rows_smem(int D) {  // a; two W tiles split; 4 partial logits (then dX split)
  return (size_t)kBRows * pad32(D) * sizeof(float) + 2 * (size_t)pad32(D) * kRVT * sizeof(uint2) +
         4 * (size_t)kBRows * kRVT * sizeof(float);
}
size_t vocab_smem(int D) {  // a; W's columns split; 2 partial logits (then dX split)
  return (size_t)kBRows * pad32(D) * sizeof(float) + (size_t)pad32(D) * kVVT * sizeof(uint2) +
         2 * (size_t)kBRows * kVVT * sizeof(float);
}

// W split once into (hi, lo) pairs, tile by tile: wsp [n_vt][Dp][32] (zeros
// past D and V), so the row side copies its tiles with cp.async as they are
__global__ void __launch_bounds__(kThreads)
rnnt_bwd_wsplit_kernel(const float* __restrict__ w, uint2* __restrict__ wsp, int D, int V) {
  const int Dp = pad32(D);
  const size_t n = (size_t)cdiv(V, kRVT) * Dp * kRVT;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int q = (int)(i % kRVT), k = (int)(i / kRVT % Dp), vt = (int)(i / ((size_t)kRVT * Dp));
    const int v = vt * kRVT + q;
    wsp[i] = split_pair(k < D && v < V ? w[(size_t)k * V + v] : 0.f);
  }
}

__global__ void __launch_bounds__(kBThreads, 1)
rnnt_bwd_rows_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                     const uint2* __restrict__ wsp, const float* __restrict__ bias,
                     const int* __restrict__ labels, const float* __restrict__ lse,
                     const float* __restrict__ gb, const float* __restrict__ gl,
                     float* __restrict__ enc_part, float* __restrict__ pred_part, int T, int U1,
                     int D, int V, int blank, int tt, int uc, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = pad32(D);
  // a [64][Dp], then djoined; 2 W tiles [Dp][32] split; the K quarters'
  // logits 4 x [64][32] (first the tile's enc and pred rows), then dX split
  float* As = smem;
  uint2* Ws = reinterpret_cast<uint2*>(As + (size_t)kBRows * Dp);
  float* Ps = reinterpret_cast<float*>(Ws + 2 * (size_t)Dp * kRVT);
  uint2* Xs = reinterpret_cast<uint2*>(Ps);
  __shared__ JointRows R;

  const int uk = blockIdx.x, tk = blockIdx.y, b = blockIdx.z;
  const int u0 = uk * uc, t0 = tk * tt;
  const int nu = min(uc, U1 - u0), nt = min(tt, T - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int n_vt = cdiv(V, kRVT);

  // W tile vt into buffer vt & 1: 16 bytes (two pairs) a copy
  auto stage = [&](int vt) {
    const uint2* src = wsp + (size_t)vt * Dp * kRVT;
    uint2* dst = Ws + (size_t)(vt & 1) * Dp * kRVT;
    for (int i = tid; i < Dp * (kRVT / 2); i += kBThreads) {
      const int k = i / (kRVT / 2), q = (i % (kRVT / 2)) * 2;
      cp_async16(dst + at2(k, q, kRVT), src + k * kRVT + q, true);
    }
    cp_async_commit();
  };
  stage(0);
  stage_rows(Ps, enc, pred, b, t0, u0, nt, nu, T, U1, D, Dp, vec, tid);  // before the partials

  bool live = false;
  for (int r = tid; r < kBRows; r += kBThreads) {
    const int tl = r / uc, ul = r - tl * uc;
    const int t = t0 + tl, u = u0 + ul;
    live |= load_row(R, r, tl, ul, tl < nt && ul < nu, ((size_t)b * T + t) * U1 + u, lse, gb,
                     gl, labels, b, u, U1, blank);
  }
  const int n_uc = gridDim.x, n_tc = gridDim.y;
  cp_async_wait<0>();
  if (!__syncthreads_or(live)) {  // no row has a gradient: the tile's partials are 0
    for (int i = tid; i < (nt + nu) * D; i += kBThreads) {
      const int r = i / D, d = i - r * D;
      if (r < nt)
        enc_part[(((size_t)b * n_uc + uk) * T + t0 + r) * D + d] = 0.f;
      else
        pred_part[(((size_t)b * n_tc + tk) * U1 + u0 + r - nt) * D + d] = 0.f;
    }
    return;
  }
  tanh_rows(As, Ps, R, nt, Dp, tid);

  // logits: warp (rg, cg) takes rows 16 rg.. x all 32 columns over the K
  // quarter cg Dp/4.. (each a element loaded by one warp a tile); dA: warp
  // (rp, warp / 2) rows 32 rp.. x columns dn = 32 (warp / 2).. (2 x 4
  // tiles, 32 accumulators; warps past Dp idle)
  const int rg = warp & 3, cg = warp >> 2;
  const int mr = 16 * rg, kw = Dp / 4, k_lo = cg * kw;
  const int rp = warp & 1, dn = 32 * (warp >> 1);
  const int sg = swz(g), sg2 = swz2(g);
  const float* a_lane = As + (mr + g) * Dp + c;  // + ((k0 + 4h) ^ sg), + 8 Dp for row g + 8
  int ob[4];  // W's columns (8 j + g) ^ swz2(c) of rows k0 + c (+4)
#pragma unroll
  for (int j = 0; j < 4; ++j) ob[j] = (8 * j + g) ^ swz2(c);
  int od[8];  // dX's and W's columns (k0 + 4h + c) ^ swz2(g) for k0 = 0, 8, 16, 24
#pragma unroll
  for (int i = 0; i < 8; ++i) od[i] = (8 * (i >> 1) + 4 * (i & 1) + c) ^ sg2;
  const int xr = tid >> 3, xq = (tid & 7) * 4;  // the dX phase: row xr, columns xq..xq+3
  float dA[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dA[i][j][e] = 0.f;

  for (int vt = 0; vt < n_vt; ++vt) {
    cp_async_wait<0>();
    __syncthreads();  // W tile vt landed; a and the rows filled; the last tile's dX read
    if (vt + 1 < n_vt) stage(vt + 1);  // its buffer's last readers were tile vt - 1's
    const uint2* Wt = Ws + (size_t)(vt & 1) * Dp * kRVT;
    const int v0 = vt * kRVT;

    // this K quarter's logits of rows mr.., 4 n-tiles, term by term
    float x[4][4] = {};
    for (int k0 = k_lo; k0 < k_lo + kw; k0 += 8) {
      uint32_t ah[4], al[4];
      split_tf32(a_lane[(k0 ^ sg)], ah[0], al[0]);
      split_tf32(a_lane[8 * Dp + (k0 ^ sg)], ah[1], al[1]);
      split_tf32(a_lane[((k0 + 4) ^ sg)], ah[2], al[2]);
      split_tf32(a_lane[8 * Dp + ((k0 + 4) ^ sg)], ah[3], al[3]);
      const uint2* wk = Wt + (k0 + c) * kRVT;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 b0 = wk[ob[j]], b1 = wk[4 * kRVT + ob[j]];
        bh[j][0] = b0.x, bh[j][1] = b1.x, bl[j][0] = b0.y, bl[j][1] = b1.y;
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1688_3xtf32(x[j], t, ah, al, bh[j], bl[j]);
    }
    float* P = Ps + cg * kBRows * kRVT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(P + at(mr + g + 8 * h, 8 * j + 2 * c, kRVT)) =
            make_float2(x[j][2 * h], x[j][2 * h + 1]);
    __syncthreads();

    // dX of row xr, columns xq..xq+3: the quarters summed in order; written
    // over the partials once every thread has read its own
    float dx[4];
    {
      const int o = at(xr, xq, kRVT);
      float4 s = *reinterpret_cast<const float4*>(Ps + o);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + k * kBRows * kRVT + o);
        s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
      }
      dx[0] = dlogit(R, xr, v0 + xq, s.x, v0 + xq < V ? bias[v0 + xq] : 0.f, V,
                     blank);
      dx[1] = dlogit(R, xr, v0 + xq + 1, s.y, v0 + xq + 1 < V ? bias[v0 + xq + 1] : 0.f, V,
                     blank);
      dx[2] = dlogit(R, xr, v0 + xq + 2, s.z, v0 + xq + 2 < V ? bias[v0 + xq + 2] : 0.f, V,
                     blank);
      dx[3] = dlogit(R, xr, v0 + xq + 3, s.w, v0 + xq + 3 < V ? bias[v0 + xq + 3] : 0.f, V,
                     blank);
    }
    __syncthreads();
    store_pairs(Xs + at2(xr, xq, kRVT), dx[0], dx[1]);
    store_pairs(Xs + at2(xr, xq, kRVT) + 2, dx[2], dx[3]);
    __syncthreads();

    // dA += dX . W^T: A = dX rows 32 rp.., B(k = v, n = d) = W[d][v]; the
    // three terms of 3xTF32 pass by pass over the 8 tiles
    if (dn < Dp) {
      const uint2* xa = Xs + (32 * rp + g) * kRVT;
      const uint2* wb = Wt + (dn + g) * kRVT;
#pragma unroll
      for (int s = 0; s < kRVT / 8; ++s) {
        const int o0 = od[2 * s], o1 = od[2 * s + 1];
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint2* x = xa + 16 * i * kRVT;
          const uint2 ap[4] = {x[o0], x[8 * kRVT + o0], x[o1], x[8 * kRVT + o1]};
          to_frag(ap, ah[i], al[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 b0 = wb[8 * j * kRVT + o0], b1 = wb[8 * j * kRVT + o1];
          bh[j][0] = b0.x, bh[j][1] = b1.x, bl[j][0] = b0.y, bl[j][1] = b1.y;
        }
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma1688_3xtf32(dA[i][j], t, ah[i], al[i], bh[j], bl[j]);
      }
    }
  }

  // djoined = dA * (1 - a^2), in place of a (each element is one thread's;
  // a was last read by the last tile's logits, before its second sync)
  if (dn < Dp) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = As[at(32 * rp + 16 * i + g + 8 * (e >> 1), dn + 8 * j + 2 * c + (e & 1), Dp)];
          s = dA[i][j][e] * (1.f - s * s);
        }
  }
  __syncthreads();

  // a thread a column, in order: the first half over u into enc_part, the
  // second over t into pred_part
  const int half = kBThreads / 2, d = tid % half;
  if (d < D) {
    if (tid < half) {
      for (int tl = 0; tl < nt; ++tl) {
        float s = 0.f;
        for (int ul = 0; ul < nu; ++ul) s += As[at(tl * uc + ul, d, Dp)];
        enc_part[(((size_t)b * n_uc + uk) * T + t0 + tl) * D + d] = s;
      }
    } else {
      for (int ul = 0; ul < nu; ++ul) {
        float s = 0.f;
        for (int tl = 0; tl < nt; ++tl) s += As[at(tl * uc + ul, d, Dp)];
        pred_part[(((size_t)b * n_tc + tk) * U1 + u0 + ul) * D + d] = s;
      }
    }
  }
}

__global__ void __launch_bounds__(kBThreads, 1)
rnnt_bwd_vocab_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                      const uint2* __restrict__ wsp, const float* __restrict__ bias,
                      const int* __restrict__ labels, const float* __restrict__ lse,
                      const float* __restrict__ gb, const float* __restrict__ gl,
                      float* __restrict__ dw_part, float* __restrict__ db_part, int T, int U1,
                      int D, int V, int blank, int tt, int uc, int n_tiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = pad32(D);
  // a [64][Dp]; W's columns [Dp][64] split; the K halves' logits 2 x
  // [64][64] (first the tile's enc and pred rows), then dX split
  float* As = smem;
  uint2* Wv = reinterpret_cast<uint2*>(As + (size_t)kBRows * Dp);
  float* Ps = reinterpret_cast<float*>(Wv + (size_t)Dp * kVVT);
  uint2* Xs = reinterpret_cast<uint2*>(Ps);
  __shared__ JointRows R;

  const int v0 = blockIdx.x * kVVT, s = blockIdx.y;
  const int n_uc = cdiv(U1, uc), n_tc = cdiv(T, tt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;

  {  // W's split tiles 2 bx and 2 bx + 1 side by side (zeros past the last tile)
    const int n_vt = cdiv(V, kRVT);
    for (int i = tid; i < Dp * (kVVT / 2); i += kBThreads) {
      const int k = i / (kVVT / 2), q = (i % (kVVT / 2)) * 2;
      const int vt = 2 * blockIdx.x + q / kRVT;
      const bool in = vt < n_vt;
      cp_async16(Wv + at2(k, q, kVVT), in ? wsp + ((size_t)vt * Dp + k) * kRVT + q % kRVT : wsp,
                 in);
    }
    cp_async_commit();
  }

  // logits: warp (rq, cq, kh) takes rows 16 rq.. x columns 32 cq.. over the
  // K half kh Dp/2..; dW: warp (dq, vh) rows 32 dq.. (d) x columns 32 vh..
  // (2 x 4 tiles; warps past Dp idle)
  const int rq = warp & 3, cq = (warp >> 2) & 1, kh = warp >> 3;
  const int kw = Dp / 2, k_lo = kh * kw;
  const int vh = warp & 1, dm = 32 * (warp >> 1);
  const int sg = swz(g);
  const float* a_lane = As + (16 * rq + g) * Dp + c;  // + 8 Dp (g + 8) + ((k0 + 4h) ^ sg)
  int ob[4];  // W's columns (32 cq + 8 j + g) ^ swz2(c) of rows k0 + c (+4)
#pragma unroll
  for (int j = 0; j < 4; ++j) ob[j] = (32 * cq + 8 * j + g) ^ swz2(c);
  int oT[8];  // a^T's fragments: As rows c + 4h, columns (dm + 16 m + 8 e + g) ^ swz(c + 4h)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int h = i & 1, e = (i >> 1) & 1, m = i >> 2;
    oT[i] = (c + 4 * h) * Dp + ((dm + 16 * m + 8 * e + g) ^ swz(c + 4 * h));
  }
  float dw[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[i][j][e] = 0.f;
  const int xr = tid >> 3, xq = (tid & 7) * 8;  // the dX phase: row xr, columns xq..xq+7
  float acc_b[8] = {}, bv[8];                   // their sums over the range's rows; their bias
#pragma unroll
  for (int i = 0; i < 8; ++i) bv[i] = v0 + xq + i < V ? bias[v0 + xq + i] : 0.f;

  // every S-th tile from s: each range samples all utterances alike, so the
  // tiles it skips (no gradient: padding) are spread evenly over the blocks
  for (int tile = s; tile < n_tiles; tile += gridDim.y) {
    // the row side's tile: utterance b, frames t0.. (nt), label positions u0.. (nu)
    const int uk = tile % n_uc, tk = (tile / n_uc) % n_tc, b = tile / (n_uc * n_tc);
    const int t0 = tk * tt, u0 = uk * uc;
    const int nt = min(tt, T - t0), nu = min(uc, U1 - u0);
    __syncthreads();  // the previous tile's a and dX are consumed
    stage_rows(Ps, enc, pred, b, t0, u0, nt, nu, T, U1, D, Dp, vec, tid);
    bool live = false;
    for (int r = tid; r < kBRows; r += kBThreads) {
      const int tl = r / uc, ul = r - tl * uc;
      const int t = t0 + tl, u = u0 + ul;
      live |= load_row(R, r, tl, ul, tl < nt && ul < nu, ((size_t)b * T + t) * U1 + u, lse, gb,
                       gl, labels, b, u, U1, blank);
    }
    cp_async_wait<0>();  // the rows (and on the first step W's tiles)
    if (!__syncthreads_or(live)) continue;  // no row has a gradient: nothing to add
    tanh_rows(As, Ps, R, nt, Dp, tid);
    __syncthreads();

    {  // this K half's logits: rows 16 rq.. x 4 n-tiles, term by term
      float x[4][4] = {};
      for (int k0 = k_lo; k0 < k_lo + kw; k0 += 8) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        split_tf32(a_lane[(k0 ^ sg)], ah[0], al[0]);
        split_tf32(a_lane[8 * Dp + (k0 ^ sg)], ah[1], al[1]);
        split_tf32(a_lane[((k0 + 4) ^ sg)], ah[2], al[2]);
        split_tf32(a_lane[8 * Dp + ((k0 + 4) ^ sg)], ah[3], al[3]);
        const uint2* wk = Wv + (k0 + c) * kVVT;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 b0 = wk[ob[j]], b1 = wk[4 * kVVT + ob[j]];
          bh[j][0] = b0.x, bh[j][1] = b1.x, bl[j][0] = b0.y, bl[j][1] = b1.y;
        }
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma1688_3xtf32(x[j], t, ah, al, bh[j], bl[j]);
      }
      float* P = Ps + kh * kBRows * kVVT;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(P + at(16 * rq + g + 8 * h, 32 * cq + 8 * j + 2 * c, kVVT)) =
              make_float2(x[j][2 * h], x[j][2 * h + 1]);
    }
    __syncthreads();

    float dx[8];  // dX of row xr, columns xq..: the halves summed in order
#pragma unroll
    for (int q4 = 0; q4 < 2; ++q4) {
      const int q = xq + 4 * q4, o = at(xr, q, kVVT);
      const float4 p0 = *reinterpret_cast<const float4*>(Ps + o);
      const float4 p1 = *reinterpret_cast<const float4*>(Ps + kBRows * kVVT + o);
      const float p[4] = {p0.x + p1.x, p0.y + p1.y, p0.z + p1.z, p0.w + p1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dx[4 * q4 + i] = dlogit(R, xr, v0 + q + i, p[i], bv[4 * q4 + i], V, blank);
        acc_b[4 * q4 + i] += dx[4 * q4 + i];
      }
    }
    __syncthreads();  // every partial read: dX goes over them
#pragma unroll
    for (int i = 0; i < 8; i += 2) store_pairs(Xs + at2(xr, xq + i, kVVT), dx[i], dx[i + 1]);
    __syncthreads();

    if (dm < Dp) {  // dW += a^T . dX: A = a^T rows dm.., B = dX; term by term
#pragma unroll 2
      for (int k0 = 0; k0 < kBRows; k0 += 8) {
        const float* ak = As + k0 * Dp;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split_tf32(ak[oT[4 * m + 0]], ah[m][0], al[m][0]);  // (g, c)
          split_tf32(ak[oT[4 * m + 2]], ah[m][1], al[m][1]);  // (g + 8, c)
          split_tf32(ak[oT[4 * m + 1]], ah[m][2], al[m][2]);  // (g, c + 4)
          split_tf32(ak[oT[4 * m + 3]], ah[m][3], al[m][3]);  // (g + 8, c + 4)
        }
        const uint2* xk = Xs + (k0 + c) * kVVT;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (32 * vh + 8 * j + g) ^ swz2(c);
          const uint2 b0 = xk[o], b1 = xk[4 * kVVT + o];
          bh[j][0] = b0.x, bh[j][1] = b1.x, bl[j][0] = b0.y, bl[j][1] = b1.y;
        }
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma1688_3xtf32(dw[m][j], t, ah[m], al[m], bh[j], bl[j]);
      }
    }
  }

  if (dm < Dp) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = dm + 16 * m + g + 8 * (e >> 1);
          const int v = v0 + 32 * vh + 8 * j + 2 * c + (e & 1);
          if (d < D && v < V) dw_part[((size_t)s * D + d) * V + v] = dw[m][j][e];
        }
  }
  // db: each thread's column sums over its row slot, then the 64 slots in order
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) Ps[xr * kVVT + xq + i] = acc_b[i];
  __syncthreads();
  if (tid < kVVT && v0 + tid < V) {
    float sum = 0.f;
    for (int r = 0; r < kBRows; ++r) sum += Ps[r * kVVT + tid];
    db_part[(size_t)s * V + v0 + tid] = sum;
  }
}

// d_enc = sum over u-chunks, d_pred over t-chunks, dW and db over the row
// ranges s, each in the order 0, 1, ...
__global__ void __launch_bounds__(kThreads)
rnnt_bwd_sum_kernel(const float* __restrict__ enc_part, const float* __restrict__ pred_part,
                    const float* __restrict__ dw_part, const float* __restrict__ db_part,
                    float* __restrict__ d_enc, float* __restrict__ d_pred,
                    float* __restrict__ dw, float* __restrict__ db, int B, int T, int U1, int D,
                    int V, int n_uc, int n_tc, int S) {
  const size_t ne = (size_t)B * T * D, np = (size_t)B * U1 * D, nw = (size_t)D * V;
  const size_t total = ne + np + nw + V;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < ne) {
      const size_t per = (size_t)T * D, b = i / per, rest = i - b * per;
      for (int k = 0; k < n_uc; ++k) s += enc_part[(b * n_uc + k) * per + rest];
      d_enc[i] = s;
    } else if (i < ne + np) {
      const size_t j = i - ne, per = (size_t)U1 * D, b = j / per, rest = j - b * per;
      for (int k = 0; k < n_tc; ++k) s += pred_part[(b * n_tc + k) * per + rest];
      d_pred[j] = s;
    } else if (i < ne + np + nw) {
      const size_t j = i - ne - np;
      for (int k = 0; k < S; ++k) s += dw_part[k * nw + j];
      dw[j] = s;
    } else {
      const size_t j = i - ne - np - nw;
      for (int k = 0; k < S; ++k) s += db_part[(size_t)k * V + j];
      db[j] = s;
    }
  }
}

// the workspace's parts (bytes, each 256-byte aligned), as `_joint_bwd_plan`
// sizes them: enc_part [B, n_uc, T, D], pred_part [B, n_tc, U1, D], dw_part
// [S, D, V], db_part [S, V] fp32; wsp [V/32][pad32(D)][32] (hi, lo) pairs
struct BwdWs {
  size_t enc, pred, dw, db, wsp, total;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

BwdWs bwd_ws(int B, int T, int U1, int D, int V, int n_uc, int n_tc, int S) {
  BwdWs w;
  w.enc = 0;
  w.pred = w.enc + align256(4 * (size_t)B * n_uc * T * D);
  w.dw = w.pred + align256(4 * (size_t)B * n_tc * U1 * D);
  w.db = w.dw + align256(4 * (size_t)S * D * V);
  w.wsp = w.db + align256(4 * (size_t)S * V);
  w.total = w.wsp + align256(sizeof(uint2) * (size_t)cdiv(V, kRVT) * pad32(D) * kRVT);
  return w;
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// enc [B, T, D], pred [B, U1, D], w [D, V], bias [V] fp32; labels [B, U1-1]
// int32 -> blank_lp, label_lp, lse [B, T, U1] fp32; all contiguous.
int rnnt_fused_fwd(const void* enc, const void* pred, const void* w, const void* bias,
                   const void* labels, void* blank_lp, void* label_lp, void* lse, int B,
                   int T, int U1, int D, int V, int blank, void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)kR * (D + 1) + (size_t)kKC * kVT);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rnnt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T * U1 + kR - 1) / kR, B);
  rnnt_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(pred),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(blank_lp),
      static_cast<float*>(label_lp), static_cast<float*>(lse), T, U1, D, V, blank);
  return static_cast<int>(cudaGetLastError());
}

// + lse, gb, gl [B, T, U1] fp32 (gl's column U1-1 is 0) -> d_enc [B, T, D],
// d_pred [B, U1, D], dw [D, V], db [V], each written once (nothing need be
// zeroed). ws: ws_bytes of scratch, sized by `_joint_bwd_plan` for its tt,
// uc (tt * uc <= 64) and S. D <= 256. Three kernels: row side, vocabulary
// side, sum.
int rnnt_fused_bwd(const void* enc, const void* pred, const void* w, const void* bias,
                   const void* labels, const void* lse, const void* gb, const void* gl,
                   void* d_enc, void* d_pred, void* dw, void* db, void* ws,
                   long long ws_bytes, int B, int T, int U1, int D, int V, int blank, int tt,
                   int uc, int S, void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return 0;
  if (D < 1 || D > kMaxD || V < 1 || tt < 1 || uc < 1 || tt * uc > kBRows ||
      (tt + uc) * pad32(D) > kStage || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_uc = cdiv(U1, uc), n_tc = cdiv(T, tt);
  const BwdWs L = bwd_ws(B, T, U1, D, V, n_uc, n_tc, S);
  if (ws_bytes != (long long)L.total) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(ws);
  float* enc_part = reinterpret_cast<float*>(base + L.enc);
  float* pred_part = reinterpret_cast<float*>(base + L.pred);
  float* dw_part = reinterpret_cast<float*>(base + L.dw);
  float* db_part = reinterpret_cast<float*>(base + L.db);
  uint2* wsp = reinterpret_cast<uint2*>(base + L.wsp);
  const int n_tiles = B * n_uc * n_tc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *e = static_cast<const float*>(enc), *p = static_cast<const float*>(pred),
              *wt = static_cast<const float*>(w), *bi = static_cast<const float*>(bias),
              *ls = static_cast<const float*>(lse), *g_b = static_cast<const float*>(gb),
              *g_l = static_cast<const float*>(gl);
  const int* lab = static_cast<const int*>(labels);
  const int vec_rows = D % 4 == 0 && reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pred) % 16 == 0;

  const size_t n_wsp = (size_t)cdiv(V, kRVT) * pad32(D) * kRVT;
  rnnt_bwd_wsplit_kernel<<<(unsigned)cdiv((int)n_wsp, kThreads), kThreads, 0, st>>>(wt, wsp, D,
                                                                                    V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(rnnt_bwd_rows_kernel, rows_smem(D))) != cudaSuccess)
    return static_cast<int>(err);
  rnnt_bwd_rows_kernel<<<dim3(n_uc, n_tc, B), kBThreads, rows_smem(D), st>>>(
      e, p, wsp, bi, lab, ls, g_b, g_l, enc_part, pred_part, T, U1, D, V, blank, tt, uc,
      vec_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if ((err = allow_smem(rnnt_bwd_vocab_kernel, vocab_smem(D))) != cudaSuccess)
    return static_cast<int>(err);
  rnnt_bwd_vocab_kernel<<<dim3(cdiv(V, kVVT), S), kBThreads, vocab_smem(D), st>>>(
      e, p, wsp, bi, lab, ls, g_b, g_l, dw_part, db_part, T, U1, D, V, blank, tt, uc, n_tiles,
      vec_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t total = (size_t)B * T * D + (size_t)B * U1 * D + (size_t)D * V + V;
  rnnt_bwd_sum_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      enc_part, pred_part, dw_part, db_part, static_cast<float*>(d_enc),
      static_cast<float*>(d_pred), static_cast<float*>(dw), static_cast<float*>(db), B, T, U1,
      D, V, n_uc, n_tc, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
