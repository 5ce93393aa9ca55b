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
// (67 TFLOP/s), against ~4 MB of operands and outputs (~1 us); as 3xTF32
// (three TF32 passes a product, below) at the dense TF32 peak (494.7
// TFLOP/s) 0.097 ms. The backward needs three such products (logits again,
// dX.W^T, a^T.dX), 47.9 GFLOP: 0.714 ms on CUDA cores, 0.290 ms as 3xTF32.
// The exp of every logit (31 M) comes on top.
//
// Forward design. A block owns utterance b's frames t0..t0+tt-1 x label
// positions u0..u0+uc-1 (tt x uc <= 32 rows, tt + uc <= 32; tiled by
// `_joint_fwd_plan`, ops/rnnt_fused.py: uc 2 x tt 16, 2,448 blocks at the
// bench shape), 8 warps, two blocks an SM (96 KB of shared memory, 128
// registers). K is D zero-padded to 256 whatever D, so one kernel serves
// every D <= 256 with its k-steps fixed at compile time. Two kernels behind
// one entry:
//  (0) `rnnt_fwd_wtile_kernel` lays W out once in fp32 tiles of 32
//      vocabulary columns, [256][32] each, zero padded, each row already in
//      the shared tile's swizzle (0.43 MB at the bench shape).
//  (1) `rnnt_fwd_kernel` copies the tile's tt enc rows and uc pred rows by
//      cp.async (`stage_rows`, as the backward), and each warp forms its
//      part of a = tanh(enc + pred) (16 rows x a quarter of K) straight into
//      registers, once: a is the same for every vocabulary tile, so it is
//      neither re-read nor kept in shared memory. Then it walks the
//      vocabulary in W tiles of 32 columns, each copied as it lies by
//      cp.async into a double buffer: warp (row group, K quarter) takes the
//      logits of its 16 rows x 32 columns over its quarter of K (3xTF32
//      mma.sync, a and W split into TF32 pairs as each fragment is formed)
//      into one of two sets of partials in shared memory; the fold of the
//      tile before (the quarters summed in order, + bias, each thread's
//      running max and sum over its 4 columns) sits in the same straight-
//      line block, without branches, so the scheduler interleaves it with
//      these products; one barrier a tile. At the end the 8 lanes of a row
//      combine their max and sum by shuffles. The blank column and the row's
//      label column are picked as they pass; the label id is read directly
//      (the TPU kernel builds a one-hot matrix, :147-149), an id outside [0,
//      V) gives logit 0 as that one-hot does, padded vocabulary columns never
//      enter the sum, and the last column u = U reads the blank. No atomics:
//      each block owns its rows, so two calls give the same bits. The
//      outputs are blank_lp, label_lp and the row's logsumexp, [B, T, U1]
//      each: the backward reads the logsumexp instead of running a first
//      pass over V again.
// What the time went to, on an H100 (PERF.md): the products alone are ~0.1
// ms of it; the fold, W's copies and the short phases between barriers
// (latency the 16 warps of an SM do not hide) the rest. Forming a once in
// registers and putting the fold beside the next tile's products moved it
// most; W as TF32 pairs (twice the bytes to copy) and 32-row warps were
// slower.
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
// fragment is formed (a; the forward's W) or once into (hi, lo) pairs (the
// backward's W, dX); each product is lo.hi + hi.lo + hi.hi in fp32, about
// 21 bits: plain TF32 (10 bits) would not keep the card tests' 5e-4 of the
// forward's log-probs or 1e-4 of each gradient's max, since exp(x - lse)
// magnifies a logit's error. The three terms go pass by pass over a warp's
// tiles, so consecutive mma are independent. exp and tanh are ex2.approx
// with the product x log2(e) carried in two parts (~3 ulp) and 1 - 2/(e^(2|x|)
// + 1) (within ~2e-7); the forward's sums of exp take ex2.approx alone (the
// logsumexp needs ~1e-6 of each term): the libm versions cost several times
// the instructions, and these kernels are bound by issued instructions and
// short dependent phases, not by the tensor cores.
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

constexpr int kThreads = 256;  // the W tile and sum kernels
constexpr int kFRows = 32;     // rows of a forward block
constexpr int kFThreads = 256;  // a forward block: 8 warps, 2 row groups x 4 K quarters
constexpr int kBRows = 64;  // rows of a row-side block, and of a vocabulary-side step
constexpr int kRVT = 32;    // vocabulary columns of a W tile (forward and row side)
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

// ------------------------------------------------- shared by both directions

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
template <int NT = kBThreads>
__device__ __forceinline__ void stage_rows(float* St, const float* enc, const float* pred,
                                           int b, int t0, int u0, int nt, int nu, int T,
                                           int U1, int D, int Dp, int vec, int tid) {
  const float* src_e = enc + ((size_t)b * T + t0) * D;
  const float* src_p = pred + ((size_t)b * U1 + u0) * D;
  if (vec) {
    const int dq = Dp / 4;
    for (int i = tid; i < (nt + nu) * dq; i += NT) {
      const int r = i / dq, d = (i - r * dq) * 4;
      const float* src = r < nt ? src_e + (size_t)r * D : src_p + (size_t)(r - nt) * D;
      cp_async16(St + r * Dp + d, d < D ? src + d : enc, d < D);
    }
  } else {
    for (int i = tid; i < (nt + nu) * Dp; i += NT) {
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

// ------------------------------------------------------------------ forward

// W zero-padded into fp32 tiles, wf [n_vt][kMaxD][32], each row's columns
// already swizzled as the forward's shared tile holds them (at(k, q, 32)),
// so a block copies a tile as it lies; the forward splits W as it loads its
// fragments
__global__ void __launch_bounds__(kThreads)
rnnt_fwd_wtile_kernel(const float* __restrict__ w, float* __restrict__ wf, int D, int V) {
  constexpr int Dp = kMaxD;
  const size_t n = (size_t)cdiv(V, kRVT) * Dp * kRVT;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int q = (int)(i % kRVT), k = (int)(i / kRVT % Dp), vt = (int)(i / ((size_t)kRVT * Dp));
    const int v = vt * kRVT + q;
    wf[i - q + (q ^ swz(k))] = k < D && v < V ? w[(size_t)k * V + v] : 0.f;
  }
}

// e^(t ln 2) for t <= 0 in one instruction (2 ulp, and 2^-126 and below flush
// to 0): the forward's sums of exp need ~1e-6 of each term, not exp_f32's ~3 ulp
__device__ __forceinline__ float ex2_fast(float t) {
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(t));
  return p;
}

// A block owns utterance b's frames t0.. (tt) x label positions u0.. (uc),
// <= 32 rows: 2 row groups x 4 K quarters = 8 warps, each 16 rows x 32
// columns over a quarter of K; two blocks an SM. K is D zero-padded to kMaxD
// (the rows are staged with zeros past D, W's tiles hold zeros there), so
// the k-steps of a quarter are known at compile time. A warp's a = tanh(enc
// + pred) (its rows, its quarter) is formed once and stays in registers
// while the vocabulary passes, split into TF32 pairs at each use. Shared
// memory (`_joint_fwd_plan`'s smem): two W tiles [kMaxD][32], then two sets
// of the K quarters' 4 partial logits [32][32] (the first holds the tile's
// enc and pred rows before that).
__global__ void __launch_bounds__(kFThreads, 2)
rnnt_fwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                const float* __restrict__ wf, const float* __restrict__ bias,
                const int* __restrict__ labels, float* __restrict__ blank_lp,
                float* __restrict__ label_lp, float* __restrict__ lse, int T, int U1, int D,
                int V, int blank, int tt, int uc, int vec) {
  constexpr int ROWS = kFRows, NT = kFThreads, RG = ROWS / 16;
  constexpr int Dp = kMaxD, KS = Dp / 4 / 8;  // K padded; k-steps of a K quarter
  constexpr int CPT = 4, LPR = kRVT / CPT;     // the fold: columns a thread, lanes a row
  constexpr int PS = 4 * ROWS * kRVT;          // floats of a set of partials
  extern __shared__ __align__(16) float smem[];
  float* Wb = smem;
  float* Ps = Wb + 2 * (size_t)Dp * kRVT;
  __shared__ JointRows R;
  __shared__ float row_x[2][ROWS];  // the row's blank and label logits

  const int uk = blockIdx.x, tk = blockIdx.y, b = blockIdx.z;
  const int u0 = uk * uc, t0 = tk * tt;
  const int nu = min(uc, U1 - u0), nt = min(tt, T - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int n_vt = cdiv(V, kRVT);

  // W tile vt into buffer vt & 1 as it lies, 16 bytes a copy
  auto stage = [&](int vt) {
    const float* src = wf + (size_t)vt * Dp * kRVT;
    float* dst = Wb + (size_t)(vt & 1) * Dp * kRVT;
    for (int i = 4 * tid; i < Dp * kRVT; i += 4 * NT) cp_async16(dst + i, src + i, true);
    cp_async_commit();
  };
  stage(0);
  stage_rows<NT>(Ps, enc, pred, b, t0, u0, nt, nu, T, U1, D, Dp, vec, tid);
  for (int r = tid; r < ROWS; r += NT) {
    const int tl = r / uc, ul = r - tl * uc;
    const bool ok = tl < nt && ul < nu;
    R.ok[r] = ok;
    R.tl[r] = tl;
    R.ul[r] = ul;
    R.lab[r] = ok ? label_of(labels, b, u0 + ul, U1, blank) : -1;
    row_x[0][r] = 0.f;
    row_x[1][r] = 0.f;  // a label id outside [0, V) keeps logit 0 (the one-hot's parity)
  }
  cp_async_wait<0>();
  __syncthreads();  // W tile 0, the rows
  if (n_vt > 1) stage(1);

  // warp (rg, cg) takes rows 16 rg.. x all 32 columns over the K quarter cg
  // Dp/4..; its A fragments: a of rows mr + g (+8), columns k_lo + 8 s + c
  // (+4), 0 on rows that are not there
  const int rg = warp % RG, cg = warp / RG;
  const int mr = 16 * rg, k_lo = cg * (Dp / 4);
  float af[KS][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // fragment register i: row + 8 (i & 1), column + 4 (i >> 1)
    const int r = mr + g + 8 * (i & 1);
    const float* e = Ps + R.tl[r] * Dp + k_lo + c + 4 * (i >> 1);
    const float* p = Ps + (nt + R.ul[r]) * Dp + k_lo + c + 4 * (i >> 1);
    const bool ok = R.ok[r];
#pragma unroll
    for (int s = 0; s < KS; ++s) af[s][i] = ok ? tanh_f32(e[8 * s] + p[8 * s]) : 0.f;
  }
  __syncthreads();  // the staged rows read (the partials go over them)

  int ob[2][4];  // W's columns 8 j + g of rows k0 + c and k0 + c + 4, swizzled
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ob[0][j] = (8 * j + g) ^ swz(c);
    ob[1][j] = (8 * j + g) ^ swz(c + 4);
  }
  // the fold: row xr, columns xq..xq+3 of each tile; the thread keeps its
  // own running max and sum over its columns, and the 8 lanes of a row
  // combine theirs once, at the end
  const int xr = tid / LPR, xq = (tid % LPR) * CPT;
  const int lab = R.lab[xr];
  float m_run = -INFINITY, s_run = 0.f;
  float bv[CPT];  // the bias of the fold's columns in the tile folded next

  // tile vt's logits from partial set vt & 1, summed over the quarters in
  // order, + bias; columns past V never enter (branch free: the fold shares
  // its block of instructions with the next tile's products); blank and
  // label picked as they pass
  auto fold = [&](int vt) {
    const float* P = Ps + (vt & 1) * PS;
    const int v0 = vt * kRVT, o = at(xr, xq, kRVT);
    float4 q = *reinterpret_cast<const float4*>(P + o);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(P + k * ROWS * kRVT + o);
      q.x += p.x, q.y += p.y, q.z += p.z, q.w += p.w;
    }
    float xv[CPT] = {q.x, q.y, q.z, q.w};
    float mx = m_run;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int v = v0 + xq + i;
      xv[i] = v < V ? xv[i] + bv[i] : -INFINITY;
      mx = fmaxf(mx, xv[i]);
      if (v == blank) row_x[0][xr] = xv[i];
      if (v == lab && v < V) row_x[1][xr] = xv[i];
    }
    // mx = -inf: no column below V yet (the sum stays 0)
    const float ml = mx * 1.44269502f;
    float sum = m_run == -INFINITY ? 0.f : s_run * ex2_fast(fmaf(m_run, 1.44269502f, -ml));
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      sum += xv[i] == -INFINITY ? 0.f : ex2_fast(fmaf(xv[i], 1.44269502f, -ml));
    s_run = sum;
    m_run = mx;
  };
  auto load_bias = [&](int vt) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int v = vt * kRVT + xq + i;
      bv[i] = v < V ? __ldg(bias + v) : 0.f;
    }
  };

  // tile vt: its products into partial set vt & 1 beside the fold of tile
  // vt - 1 (one block of instructions for the scheduler to interleave), then
  // one barrier
  load_bias(0);
  for (int vt = 0; vt < n_vt; ++vt) {
    const float* Wt = Wb + (size_t)(vt & 1) * Dp * kRVT;
    float x[4][4] = {};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(af[s][i], ah[i], al[i]);
      const float* wk = Wt + (k_lo + 8 * s + c) * kRVT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(wk[ob[0][j]], bh[j][0], bl[j][0]);
        split_tf32(wk[4 * kRVT + ob[1][j]], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1688_3xtf32(x[j], t, ah, al, bh[j], bl[j]);
    }
    if (vt > 0) {
      fold(vt - 1);
      load_bias(vt);
    }
    float* Pq = Ps + (vt & 1) * PS + cg * ROWS * kRVT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Pq + at(mr + g + 8 * h, 8 * j + 2 * c, kRVT)) =
            make_float2(x[j][2 * h], x[j][2 * h + 1]);
    cp_async_wait<0>();
    __syncthreads();  // tile vt's partials written, tile vt - 1's read; W tile vt + 1 landed,
                      // W tile vt read by all
    if (vt + 2 < n_vt) stage(vt + 2);  // into tile vt's buffer
  }
  fold(n_vt - 1);

  // the row's max and sum from its 8 lanes' (a lane with no column below V
  // adds nothing); the same bits in each lane
  float mrow = m_run;
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, off));
  float srow = m_run == -INFINITY ? 0.f : s_run * exp_f32(m_run - mrow);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) srow += __shfl_xor_sync(0xffffffffu, srow, off);
  __syncthreads();  // row_x written by the lane that held the column
  if (tid % LPR == 0 && R.ok[xr]) {
    const int t = t0 + R.tl[xr], u = u0 + R.ul[xr];
    const size_t o = ((size_t)b * T + t) * U1 + u;
    const float l = mrow + logf(srow);
    blank_lp[o] = row_x[0][xr] - l;
    label_lp[o] = row_x[1][xr] - l;
    lse[o] = l;
  }
}

// ----------------------------------------------------------------- backward

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
// int32 -> blank_lp, label_lp, lse [B, T, U1] fp32; all contiguous. The
// plan (`_joint_fwd_plan`, the owner of the layout): tiles of tt frames x uc
// label positions (tt * uc <= 32, (tt + uc) 256 <= 8192), smem, the block's
// shared bytes, and ws: ws_bytes of scratch for W's tiles; checked here
// against the shape, the card's limit and alignment. D <= 256. Two kernels:
// W's tiles, then the rows.
int rnnt_fused_fwd(const void* enc, const void* pred, const void* w, const void* bias,
                   const void* labels, void* blank_lp, void* label_lp, void* lse, void* ws,
                   long long ws_bytes, int B, int T, int U1, int D, int V, int blank, int tt,
                   int uc, int smem, void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return 0;
  const size_t n_w = (size_t)cdiv(V, kRVT) * kMaxD * kRVT;
  if (D < 1 || D > kMaxD || V < 1 || tt < 1 || uc < 1 || tt * uc > kFRows ||
      (tt + uc) * kMaxD > kStage || smem < 1 || (size_t)smem > kMaxSmem ||
      ws_bytes < (long long)(n_w * sizeof(float)) || reinterpret_cast<uintptr_t>(ws) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(ws);
  rnnt_fwd_wtile_kernel<<<(unsigned)cdiv((int)n_w, kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(w), wf, D, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if ((err = allow_smem(rnnt_fwd_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
  const int vec_rows = D % 4 == 0 && reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pred) % 16 == 0;
  rnnt_fwd_kernel<<<dim3(cdiv(U1, uc), cdiv(T, tt), B), kFThreads, smem, st>>>(
      static_cast<const float*>(enc), static_cast<const float*>(pred), wf,
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<float*>(blank_lp), static_cast<float*>(label_lp), static_cast<float*>(lse), T,
      U1, D, V, blank, tt, uc, vec_rows);
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
