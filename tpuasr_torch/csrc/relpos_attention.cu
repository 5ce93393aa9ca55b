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
// Two routes, one per input type, both flash-attention-2 style on tensor
// cores: a block takes 64 query rows of one (batch, head), 16 per warp
// (`launch_fwd_tc` says why 64). It walks the keys in tiles of 64: the
// tile's [k | p] rows (the JAX kernel's own concatenation, so the scores are
// one product of depth 2 dk) and v rows are staged by cp.async into a double
// buffer, so the next tile's loads run under this tile's products. The
// online max and sum stay in registers.
//
// bf16 (training and bf16 serving): `relpos_fwd_tc_kernel` forms [q+u | q+v]
// in bf16, as the reference does, as mma.sync A fragments in registers
// (mma.sync.m16n8k16, bf16 operands from ldmatrix, fp32 accumulators); out
// is divided by the sum at the end and rounded to bf16.
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
// fp32 (the default compute type: the card-vs-CPU checks, whose tokens must
// equal the CPU's, fp32 serving and training; the forward is held to 1e-5
// and the gradients to 1e-4 of their max): `relpos_fwd_tf32_kernel`, the
// same tile walk with every product in 3xTF32 (mma.sync.m16n8k8: each fp32
// operand split into a TF32 hi and the TF32 of the rest, lo, and lo.hi +
// hi.lo + hi.hi summed in fp32, about 21 bits; one TF32 pass keeps 10 and
// misses 1e-5, tests/test_torch_attention_tf32.py). Each k-step's three
// passes go into a zeroed partial that joins the accumulator by an fp32 add
// (`mma3`): the tensor core truncates its sums, and chained through one
// accumulator over a product's depth that left the forward 3x further from
// the plain version than the CUDA-core kernel it replaced (on an H100,
// 7e-6 against 2.3e-6 at [6, 191, 256]), enough to flip a ReLU in the AED
// step card against CPU; with the partials 2.4e-6. A block is 8 warps: two on each 16 query rows,
// each taking one half (32 keys) of every 64-key tile, their softmax states
// merged once at the end (`pair_exchange`); one warp alone on a scheduler
// waits out its own mma and shared loads, and these grids hold about one
// block an SM. [q+u | q+v] is formed in fp32 into shared memory and each
// fragment split as it is read (the A fragments of depth 2 dk in hi and lo
// would take 128 registers). p.v takes p from the score accumulators in
// registers: an accumulator holds keys 2c and 2c + 1 of its row where the A
// fragment wants keys c and c + 4, so each 8-key step of p.v runs over its
// keys in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot c takes key 2c, slot c + 4
// key 2c + 1), and the B fragment reads v's rows in that order. Tiles are
// fp32 rows at a pitch of width + 4 floats, so every fragment read hits 32
// banks. The first tile is asked for before its mask bits; each later
// tile's bits are built during the one before (a ballot per row and 32
// keys, each byte read once), and a barrier that ORs them skips the loads of
// a tile no row of the block attends: no shared memory grows with S, so the
// route has no length limit. With `lse` it writes each row's log-sum-exp as
// the bf16 route does (the fp32 output is out itself).
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
// work splits flash-attention-2 style into two kernels on one stream, each
// starting from the forward's output o (fp32) and log-sum-exp L, one sweep
// per side; recomputing s and dP on both sides makes 22 dk flops per pair
// against the function's 14:
// - the query side, a block per (batch, head, 64 query rows). Its prologue
//   forms D = rowsum(do * o) in fp32 (= rowsum(da * a) to fp32 precision,
//   since o = a.v) and writes it, and [q+u | q+v] for the key side ([B, H,
//   T, 2 dk] scratch in the input type). One sweep over the keys recomputes
//   s and dP = do.v^T, p = exp(s scale - L), ds = p (dP - D) scale rounded
//   to the input type, and dq += ds.(k + p), k + p summed in the input type
//   (`_bwd_kernel` :118-119).
// - the key side, a block per (batch, head, 64 keys), holding [k | p] and v:
//   one sweep over the query tiles recomputes s^T and dP^T and accumulates
//   dv += p^T.do, [dk | dp] += ds^T.[q+u | q+v] (one product of width 2 dk,
//   as :123-126) and each key's column sum of ds, rounded to the input type
//   for du and dvb (:128-132).
// A fully masked row has L = -inf; its p is selected to 0 by the mask, never
// computed from exp(s - L), so it gives exactly zero gradient.
// bf16 route (`relpos_bwd_q_tc_kernel`, `relpos_bwd_kv_tc_kernel`): bf16
// mma.sync as the forward; dv's p enters as hi + lo bf16 operands, as the
// forward's out32, so dv is the reference's fp32 a times do. dk and dv are
// written; dp, du and dvb, shared by the batch (du, dvb by every key tile
// too), are added with fp32 atomics into zeroed buffers, so their last bits
// change from run to run.
// fp32 route (`relpos_bwd_q_tf32_kernel`, `relpos_bwd_kv_tf32_kernel`,
// `relpos_bwd_sum_kernel`): every product 3xTF32 with zeroed partials, as
// the forward's, the accumulators turned into A fragments by the same key
// (here: query) order, 8 warps a block, two on each 16 rows (query rows; on
// the key side keys) splitting every tile's 64 keys (query rows) and summing
// their halves at the end in a fixed order; the key side takes its half's 32
// queries 16 at a time (32 at once put its dk = 64 instance at 255 registers
// with 296 bytes of spill stores; 16, at 255 with 76). The key side writes
// dk and dv, its batch's dp rows ([B, S, H*dk] partials) and its 64 keys'
// share of du and dvb ([B, S tiles, 2 H*dk] partials); a third kernel sums
// the partials over the batch (and the key tiles) in a fixed order, as #5
// and #11 do. No atomics: two fp32 backwards on the same inputs give the
// same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------- bf16 route: tensor cores

constexpr int kTile = 64;  // keys per tile (forward, query side); queries per tile (key side)
constexpr int kTcWarps = 4;  // a block: 16 query rows (or keys) per warp, 64 in all
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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


// ------------------------------------------------ fp32 route: 3xTF32 tensor cores

// A block of the fp32 route: 8 warps, two per group of 16 rows (the
// forward's and the query side's query rows, the key side's keys), each of
// the two taking one half of every 64-wide tile (32 keys; on the key side 32
// query rows). The two halves' sums meet once, at the end, through shared
// memory, in a fixed order. Two warps a row group keep two warps on each of
// the SM's four schedulers: one warp alone waits out its mma and shared
// loads, and these grids hold about one block an SM.
constexpr int kTfWarps = 8;
constexpr int kTfThreads = kTfWarps * 32;

// fp32 tiles in shared memory keep a row of width W (a multiple of 16) at a
// pitch of W + 4 floats: the fragment reads below, lane (g, c) at (row g,
// column c) or (row 2c, column g), then hit 32 different banks
template <int W> __host__ __device__ constexpr int pitch32() { return W + 4; }

// the A fragment of rows r0..r0+15, depth k0..k0+7 of a row-major fp32 tile,
// split into TF32 hi and lo as it is read (g = lane / 4, c = lane % 4)
__device__ __forceinline__ void load_a32(const float* t, int pitch, int r0, int k0, int g, int c,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* x = t + (r0 + g) * pitch + k0 + c;
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[8 * pitch], hi[1], lo[1]);
  split_tf32(x[4], hi[2], lo[2]);
  split_tf32(x[8 * pitch + 4], hi[3], lo[3]);
}

// the B fragment of the n-tile n0..n0+7 at depth k0..k0+7 of a tile stored
// [n][k] (B = tile^T)
__device__ __forceinline__ void load_b32(const float* t, int pitch, int n0, int k0, int g, int c,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* x = t + (n0 + g) * pitch + k0 + c;
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[4], hi[1], lo[1]);
}

// the B fragment of the n-tile n0..n0+7 of a tile stored [k][n] (B = tile)
// over the 8 rows from k0 in the order of `acc_a`: slot c is row k0 + 2c,
// slot c + 4 row k0 + 2c + 1. With `off`, each element is the sum of the
// tile's entries at columns n and n + off, rounded to fp32 (k + p).
__device__ __forceinline__ void load_bt32(const float* t, int pitch, int n0, int k0, int g, int c,
                                          uint32_t (&hi)[2], uint32_t (&lo)[2], int off = 0) {
  const float* x = t + (k0 + 2 * c) * pitch + n0 + g;
  split_tf32(off ? x[0] + x[off] : x[0], hi[0], lo[0]);
  split_tf32(off ? x[pitch] + x[pitch + off] : x[pitch], hi[1], lo[1]);
}

// an accumulator of a 16x8 product ({(g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)})
// as the A fragment of the next product over those 8 columns, in the order
// slot c = column 2c, slot c + 4 = column 2c + 1
__device__ __forceinline__ void acc_a(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[2], hi[1], lo[1]);
  split_tf32(x[1], hi[2], lo[2]);
  split_tf32(x[3], hi[3], lo[3]);
}

// The mask bits of a warp's 16 rows i0..i0+15 (query rows; on the key side,
// keys) against the 32 columns j0..j0+31 (keys; query rows), the element
// (i, j) at mask[base + i * si + j * sj], set where i < ni, j < nj and the
// byte is not 0: lane (g, c) gets rows g (m0) and g + 8 (m1), bit j - j0. A
// lane reads a column, each byte once, a ballot per row. -> whether any of
// the 16 rows has a bit (uniform over the warp)
__device__ __forceinline__ bool warp_bits(const uint8_t* __restrict__ mask, long long base,
                                          long long si, long long sj, int i0, int ni, int j0,
                                          int nj, uint32_t& m0, uint32_t& m1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, j = j0 + lane;
  bool ok[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = i0 + r;
    ok[r] = i < ni && j < nj && mask[base + i * si + j * sj] != 0;
  }
  uint32_t any = 0;
  m0 = m1 = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint32_t bits = __ballot_sync(kFull, ok[r]);
    any |= bits;
    if (r == g) m0 = bits;
    if (r == g + 8) m1 = bits;
  }
  return any != 0;
}

// [q + u | q + v] of BQ query rows from q0, formed in fp32, into s_q (pitch
// 2 dk + 4); rows past T are 0. With qc, the rows inside T are also written
// to qc ([T, 2 dk] of this (batch, head)). The trip count is known, so every
// load is in flight at once.
template <int DK, int BQ>
__device__ __forceinline__ void stage_qc32(const float* __restrict__ q,
                                           const float* __restrict__ ubias,
                                           const float* __restrict__ vbias, int b, int h, int q0,
                                           int t_len, int d_model, float* s_q,
                                           float* __restrict__ qc) {
  constexpr int QP = pitch32<2 * DK>(), CH = DK / 4;  // 16-byte chunks of a head's row
  static_assert(BQ * CH % kTfThreads == 0, "whole rounds of the block's threads");
#pragma unroll
  for (int it = 0; it < BQ * CH / kTfThreads; ++it) {
    const int i = it * kTfThreads + threadIdx.x;
    const int r = i / CH, c4 = (i - r * CH) * 4, t = q0 + r;
    float4 qu = make_float4(0.f, 0.f, 0.f, 0.f), qv = qu;
    if (t < t_len) {
      const float4 x =
          *reinterpret_cast<const float4*>(q + ((size_t)b * t_len + t) * d_model + h * DK + c4);
      const float4 u = *reinterpret_cast<const float4*>(ubias + h * DK + c4);
      const float4 w = *reinterpret_cast<const float4*>(vbias + h * DK + c4);
      qu = make_float4(x.x + u.x, x.y + u.y, x.z + u.z, x.w + u.w);
      qv = make_float4(x.x + w.x, x.y + w.y, x.z + w.z, x.w + w.w);
      if (qc != nullptr) {
        *reinterpret_cast<float4*>(qc + (size_t)t * 2 * DK + c4) = qu;
        *reinterpret_cast<float4*>(qc + (size_t)t * 2 * DK + DK + c4) = qv;
      }
    }
    *reinterpret_cast<float4*>(s_q + r * QP + c4) = qu;
    *reinterpret_cast<float4*>(s_q + r * QP + DK + c4) = qv;
  }
}

// [k | p] (pitch 2 dk + 4) and v (pitch dk + 4) fp32 rows of the 64 keys at
// s0 into shared memory, in flight; rows past S zero-filled
template <int DK>
__device__ __forceinline__ void load_keys32(const float* __restrict__ k,
                                            const float* __restrict__ p,
                                            const float* __restrict__ v, int b, int h, int s0,
                                            int s_len, int d_model, float* s_kp, float* s_v) {
  constexpr int QP = pitch32<2 * DK>(), VP = pitch32<DK>(), CH = DK / 4;
#pragma unroll
  for (int it = 0; it < kTile * CH / kTfThreads; ++it) {
    const int i = it * kTfThreads + threadIdx.x;
    const int r = i / CH, c4 = (i - r * CH) * 4, s = s0 + r;
    const bool in = s < s_len;
    const int sc = in ? s : 0;
    const size_t off = ((size_t)b * s_len + sc) * d_model + h * DK + c4;
    cp_async16(s_kp + r * QP + c4, k + off, in);
    cp_async16(s_kp + r * QP + DK + c4, p + (size_t)sc * d_model + h * DK + c4, in);
    cp_async16(s_v + r * VP + c4, v + off, in);
  }
}

// the largest count of n-tiles, at most 4, whose B fragments a product step
// holds at once (the three passes run over them, so consecutive mma are
// independent)
template <int N> __host__ __device__ constexpr int group() { return N < 4 ? N : 4; }

// acc[0..G) += a . b[0..G) over one k-step in 3xTF32. The three passes go
// into a zeroed partial, which joins acc by rounded fp32 adds: the tensor
// core truncates its fp32 sums, so a long chain of mma into one accumulator
// drifts toward zero (about 2**-24 of the sum a link), past fp32's rounding.
template <int G>
__device__ __forceinline__ void mma3(float (*acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[G][2],
                                     const uint32_t (&bl)[G][2]) {
  float part[G][4];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < G; ++i) mma1688_3xtf32(part[i], t, ah, al, bh[i], bl[i]);
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
}

// The second warp of each row group hands its per-thread values x[0..N) to
// the first through shared memory (xs: 4 groups x N x 32 floats), after a
// barrier that ends every warp's use of the region; -> where the first warp
// finds its partner's value i: at [i * 32].
template <int N>
__device__ __forceinline__ const float* pair_exchange(float* xs, const float (&x)[N]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* slot = xs + (warp & 3) * N * 32 + lane;
  __syncthreads();
  if (warp >= 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) slot[i * 32] = x[i];
  }
  __syncthreads();
  return slot;
}

template <int DK>
__global__ void __launch_bounds__(kTfThreads)
relpos_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ p, const float* __restrict__ v,
                       const float* __restrict__ ubias, const float* __restrict__ vbias,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
                       float* __restrict__ lse, int t_len, int s_len, int n_head, long long msb,
                       long long mst, long long mss, float scale) {
  constexpr int BQ = 64, D2 = 2 * DK, QP = pitch32<D2>(), VP = pitch32<DK>();
  constexpr int ND = DK / 8, GD = group<ND>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);  // [BQ][QP]  [q+u | q+v]
  float* s_kp = s_q + BQ * QP;                  // [2][kTile][QP]  [k | p]
  float* s_v = s_kp + 2 * kTile * QP;           // [2][kTile][VP]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int d_model = n_head * DK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = (warp & 3) * 16, k0 = (warp >> 2) * 32;  // this warp's rows, keys of a tile
  const float sl2 = scale * kLog2e;  // scores in log2 units
  const long long mb = b * msb;
  const int n_tiles = cdiv(s_len, kTile);

  // tile 0 is asked for at once, before its mask is known
  if (n_tiles > 0) load_keys32<DK>(k, p, v, b, h, 0, s_len, d_model, s_kp, s_v);
  cp_async_commit();
  stage_qc32<DK, BQ>(q, ubias, vbias, b, h, q0, t_len, d_model, s_q, nullptr);
  uint32_t m0 = 0, m1 = 0;  // this thread's rows' bits over the warp's keys of the tile
  bool wlive = n_tiles > 0 && warp_bits(mask, mb, mst, mss, q0 + r0, t_len, k0, s_len, m0, m1);
  bool live = __syncthreads_or(wlive);  // (and q is staged)

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    uint32_t n0 = 0, n1 = 0;
    bool wnext = false;
    if (j + 1 < n_tiles)
      wnext = warp_bits(mask, mb, mst, mss, q0 + r0, t_len, (j + 1) * kTile + k0, s_len, n0, n1);
    // every warp is also done with the other buffer, tile j - 1's
    const bool next = __syncthreads_or(wnext);
    if (next)
      load_keys32<DK>(k, p, v, b, h, (j + 1) * kTile, s_len, d_model,
                      s_kp + (buf ^ 1) * kTile * QP, s_v + (buf ^ 1) * kTile * VP);
    cp_async_commit();
    // every iteration, live or not: tile j - 1's group into the other buffer
    // must land before a later tile's copies target the same addresses
    cp_async_wait<1>();  // tile j has landed
    if (live) __syncthreads();
    if (live && wlive) {
      const float* kp = s_kp + buf * kTile * QP + k0 * QP;  // this warp's 32 keys
      const float* vt = s_v + buf * kTile * VP + k0 * VP;
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D2 / 8; ++kk) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        load_a32(s_q, QP, r0, kk * 8, g, c, ah, al);
#pragma unroll
        for (int i = 0; i < 4; ++i) load_b32(kp, QP, i * 8, kk * 8, g, c, bh[i], bl[i]);
        mma3<4>(s, ah, al, bh, bl);
      }
      // masked scaled scores (log2 units) and each row's new max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t mm = e < 2 ? m0 : m1;
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
      for (int nt = 0; nt < 4; ++nt)
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
      for (int nt = 0; nt < ND; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
      // o += p . v, 8 keys a step in the order of `acc_a`
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        acc_a(s[kk], ah, al);
#pragma unroll
        for (int n4 = 0; n4 < ND; n4 += GD) {
          uint32_t bh[GD][2], bl[GD][2];
#pragma unroll
          for (int i = 0; i < GD; ++i) load_bt32(vt, VP, (n4 + i) * 8, kk * 8, g, c, bh[i], bl[i]);
          mma3<GD>(o + n4, ah, al, bh, bl);
        }
      }
    }
    m0 = n0;
    m1 = n1;
    wlive = wnext;
    live = next;
  }

  // the two halves of each row: (m, l, o) merged onto the first warp
  float x[4 * ND + 4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * nt + e] = o[nt][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[4 * ND + r] = m_run[r];
    x[4 * ND + 2 + r] = l_run[r];
  }
  cp_async_wait<0>();
  const float* y = pair_exchange(s_kp, x);
  if (warp >= 4) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m2 = y[(4 * ND + r) * 32], m = fmaxf(m_run[r], m2);
    const float ca = m == -INFINITY ? 0.f : exp2f(m_run[r] - m);
    const float cb = m == -INFINITY ? 0.f : exp2f(m2 - m);
    l_run[r] = l_run[r] * ca + y[(4 * ND + 2 + r) * 32] * cb;
    m_run[r] = m;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        o[nt][e] = o[nt][e] * ca + y[(4 * nt + e) * 32] * cb;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    const int t = q0 + r0 + g + 8 * r;
    if (t >= t_len) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;  // all-masked row: 0
    float* row = out + ((size_t)b * t_len + t) * d_model + h * DK + 2 * c;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8) =
          make_float2(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    if (lse != nullptr && c == 0)
      lse[((size_t)b * n_head + h) * t_len + t] =
          l_run[r] > 0.f ? (m_run[r] + log2f(l_run[r])) * kLn2 : -INFINITY;
  }
}

template <int DK>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* p, const void* v,
                            const void* ub, const void* vb, const void* mask, void* out, void* lse,
                            int batch, int t_len, int s_len, int n_head, long long msb,
                            long long mst, long long mss, float scale, cudaStream_t stream) {
  constexpr int BQ = 64, QP = pitch32<2 * DK>(), VP = pitch32<DK>();
  const size_t smem = sizeof(float) * (BQ * QP + 2 * kTile * (QP + VP));
  cudaError_t err = allow_smem(relpos_fwd_tf32_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  relpos_fwd_tf32_kernel<DK><<<dim3(cdiv(t_len, BQ), n_head, batch), kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(p),
      static_cast<const float*>(v), static_cast<const float*>(ub), static_cast<const float*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse),
      t_len, s_len, n_head, msb, mst, mss, scale);
  return cudaGetLastError();
}

template <int DK>
__global__ void __launch_bounds__(kTfThreads)
relpos_bwd_q_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ p, const float* __restrict__ v,
                         const float* __restrict__ ubias, const float* __restrict__ vbias,
                         const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                         const float* __restrict__ out, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ dsum, float* __restrict__ qc,
                         int t_len, int s_len, int n_head, long long msb, long long mst,
                         long long mss, float scale) {
  constexpr int BQ = 64, D2 = 2 * DK, QP = pitch32<D2>(), VP = pitch32<DK>();
  constexpr int ND = DK / 8, GD = group<ND>(), CH = DK / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);  // [BQ][QP]  [q+u | q+v]
  float* s_do = s_q + BQ * QP;                  // [BQ][VP]
  float* s_kp = s_do + BQ * VP;                 // [2][kTile][QP]  [k | p]
  float* s_v = s_kp + 2 * kTile * QP;           // [2][kTile][VP]
  float* s_l = s_v + 2 * kTile * VP;            // [BQ] L in log2 units
  float* s_d = s_l + BQ;                        // [BQ] D

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = (warp & 3) * 16, k0 = (warp >> 2) * 32;  // this warp's rows, keys of a tile
  const float sl2 = scale * kLog2e;
  const long long mb = b * msb;
  const size_t row0 = ((size_t)b * n_head + h) * t_len;  // this (batch, head) in [B, H, T]
  const int n_tiles = cdiv(s_len, kTile);

  load_keys32<DK>(k, p, v, b, h, 0, s_len, d_model, s_kp, s_v);  // tile 0, before its mask
  cp_async_commit();
  stage_qc32<DK, BQ>(q, ubias, vbias, b, h, q0, t_len, d_model, s_q, qc + row0 * D2);
#pragma unroll
  for (int it = 0; it < BQ * CH / kTfThreads; ++it) {
    const int i = it * kTfThreads + tid;
    const int r = i / CH, c4 = (i - r * CH) * 4, t = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < t_len)
      x = *reinterpret_cast<const float4*>(dout + ((size_t)b * t_len + t) * d_model + h * DK + c4);
    *reinterpret_cast<float4*>(s_do + r * VP + c4) = x;
  }
  // D = rowsum(do * o) in fp32, o the forward's output, and L: four lanes
  // a row, dk / 4 features each, read from device memory beside the staging
  {
    const int r = tid >> 2, t = q0 + r, d0 = (tid & 3) * (DK / 4);
    float acc = 0.f;
    if (t < t_len) {
      const size_t o0 = ((size_t)b * t_len + t) * d_model + h * DK + d0;
#pragma unroll
      for (int i = 0; i < DK / 4; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(out + o0 + i);
        const float4 z = *reinterpret_cast<const float4*>(dout + o0 + i);
        acc = fmaf(a.x, z.x, acc);
        acc = fmaf(a.y, z.y, acc);
        acc = fmaf(a.z, z.z, acc);
        acc = fmaf(a.w, z.w, acc);
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    if ((tid & 3) == 0) {
      s_d[r] = acc;
      s_l[r] = t < t_len ? lse[row0 + t] * kLog2e : 0.f;
      if (t < t_len) dsum[row0 + t] = acc;
    }
  }

  uint32_t m0, m1;
  bool wlive = warp_bits(mask, mb, mst, mss, q0 + r0, t_len, k0, s_len, m0, m1);
  bool live = __syncthreads_or(wlive);  // (and q, do, L and D are in shared memory)
  const float lr[2] = {s_l[r0 + g], s_l[r0 + g + 8]};
  const float dr[2] = {s_d[r0 + g], s_d[r0 + g + 8]};
  float acc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    uint32_t n0 = 0, n1 = 0;
    bool wnext = false;
    if (j + 1 < n_tiles)
      wnext = warp_bits(mask, mb, mst, mss, q0 + r0, t_len, (j + 1) * kTile + k0, s_len, n0, n1);
    const bool next = __syncthreads_or(wnext);  // (and tile j - 1's buffer is free)
    if (next)
      load_keys32<DK>(k, p, v, b, h, (j + 1) * kTile, s_len, d_model,
                      s_kp + (buf ^ 1) * kTile * QP, s_v + (buf ^ 1) * kTile * VP);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed, live or not (see the forward)
    if (live) __syncthreads();
    if (live && wlive) {
      const float* kp = s_kp + buf * kTile * QP + k0 * QP;  // this warp's 32 keys
      const float* vt = s_v + buf * kTile * VP + k0 * VP;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      // s (depth 2 dk) and dP (depth dk) in one loop, a dP step after every
      // second s step: twice the independent mma chains
#pragma unroll
      for (int kk = 0; kk < D2 / 8; ++kk) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        load_a32(s_q, QP, r0, kk * 8, g, c, ah, al);
#pragma unroll
        for (int i = 0; i < 4; ++i) load_b32(kp, QP, i * 8, kk * 8, g, c, bh[i], bl[i]);
        mma3<4>(s, ah, al, bh, bl);
        if (kk & 1) {
          const int kd = kk >> 1;
          load_a32(s_do, VP, r0, kd * 8, g, c, ah, al);
#pragma unroll
          for (int i = 0; i < 4; ++i) load_b32(vt, VP, i * 8, kd * 8, g, c, bh[i], bl[i]);
          mma3<4>(dp, ah, al, bh, bl);
        }
      }
      // ds = p (dP - D) scale with p = 2^(s sl2 - L): 0 where masked
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = ((r ? m1 : m0) >> (nt * 8 + 2 * c + (e & 1))) & 1;
          const float pr = ok ? exp2f(s[nt][e] * sl2 - lr[r]) : 0.f;
          s[nt][e] = pr * (dp[nt][e] - dr[r]) * scale;
        }
      // dq += ds . (k + p), 8 keys a step in the order of `acc_a`
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        acc_a(s[kk], ah, al);
#pragma unroll
        for (int n4 = 0; n4 < ND; n4 += GD) {
          uint32_t bh[GD][2], bl[GD][2];
#pragma unroll
          for (int i = 0; i < GD; ++i)
            load_bt32(kp, QP, (n4 + i) * 8, kk * 8, g, c, bh[i], bl[i], DK);
          mma3<GD>(acc + n4, ah, al, bh, bl);
        }
      }
    }
    m0 = n0;
    m1 = n1;
    wlive = wnext;
    live = next;
  }

  // the two key halves' dq summed on the first warp of each row group
  float x[4 * ND];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * nt + e] = acc[nt][e];
  cp_async_wait<0>();
  const float* y = pair_exchange(s_kp, x);
  if (warp >= 4) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + r0 + g + 8 * r;
    if (t >= t_len) continue;
    float* row = dq + ((size_t)b * t_len + t) * d_model + h * DK + 2 * c;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8) =
          make_float2(acc[nt][2 * r] + y[(4 * nt + 2 * r) * 32],
                      acc[nt][2 * r + 1] + y[(4 * nt + 2 * r + 1) * 32]);
  }
}

template <int DK>
__global__ void __launch_bounds__(kTfThreads)
relpos_bwd_kv_tf32_kernel(const float* __restrict__ k, const float* __restrict__ p,
                          const float* __restrict__ v, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dsum, const float* __restrict__ qc,
                          float* __restrict__ dk_out, float* __restrict__ dv_out,
                          float* __restrict__ dp_part, float* __restrict__ bias_part, int t_len,
                          int s_len, int n_head, long long msb, long long mst, long long mss,
                          float scale) {
  constexpr int BK = 64, D2 = 2 * DK, QP = pitch32<D2>(), VP = pitch32<DK>();
  constexpr int ND = DK / 8, GD = group<ND>(), GD2 = group<D2 / 8>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_kp = reinterpret_cast<float*>(smem);  // [BK][QP]  [k | p] of the block's keys
  float* s_v = s_kp + BK * QP;                   // [BK][VP]
  float* s_q = s_v + BK * VP;                    // [2][kTile][QP]  [q+u | q+v] of a query tile
  float* s_do = s_q + 2 * kTile * QP;            // [2][kTile][VP]
  float* s_l = s_do + 2 * kTile * VP;            // [2][kTile]
  float* s_d = s_l + 2 * kTile;                  // [2][kTile]
  float* s_col = s_d + 2 * kTile;                // [BK]

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * BK;
  const int d_model = n_head * DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = (warp & 3) * 16, t0w = (warp >> 2) * 32;  // this warp's keys, queries of a tile
  const float sl2 = scale * kLog2e;
  const long long mb = b * msb;
  const size_t row0 = ((size_t)b * n_head + h) * t_len;
  const int n_tiles = cdiv(t_len, kTile);

  // the query tile at t0 into buffer `buf`, in flight; rows past T zero
  auto load_queries = [&](int t0, int buf) {
    float* sq = s_q + buf * kTile * QP;
    float* sg = s_do + buf * kTile * VP;
    constexpr int CH = DK / 4;  // 16-byte chunks of a head's row
    static_assert(kTile * 3 * CH % kTfThreads == 0, "whole rounds of the block's threads");
#pragma unroll
    for (int it = 0; it < kTile * 3 * CH / kTfThreads; ++it) {
      const int i = it * kTfThreads + tid;
      const int r = i / (3 * CH), c4 = (i - r * 3 * CH) * 4, t = t0 + r;
      const bool in = t < t_len;
      const int tc = in ? t : 0;
      if (c4 < D2)
        cp_async16(sq + r * QP + c4, qc + (row0 + tc) * D2 + c4, in);
      else
        cp_async16(sg + r * VP + c4 - D2,
                   dout + ((size_t)b * t_len + tc) * d_model + h * DK + c4 - D2, in);
    }
    if (tid < kTile) {
      const int t = t0 + tid;
      const bool in = t < t_len;
      cp_async4(s_l + buf * kTile + tid, lse + row0 + (in ? t : 0), in);
      cp_async4(s_d + buf * kTile + tid, dsum + row0 + (in ? t : 0), in);
    }
  };

  load_keys32<DK>(k, p, v, b, h, key0, s_len, d_model, s_kp, s_v);
  load_queries(0, 0);  // query tile 0, before its mask is known
  cp_async_commit();
  // this thread's keys g and g + 8 of the warp, over the warp's queries of a tile
  uint32_t m0, m1;
  bool wlive = warp_bits(mask, mb, mss, mst, key0 + r0, s_len, t0w, t_len, m0, m1);
  bool live = __syncthreads_or(wlive);

  float dv[ND][4], dkp[D2 / 8][4], col[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < D2 / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkp[nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    uint32_t n0 = 0, n1 = 0;
    bool wnext = false;
    if (j + 1 < n_tiles)
      wnext = warp_bits(mask, mb, mss, mst, key0 + r0, s_len, (j + 1) * kTile + t0w, t_len, n0,
                        n1);
    const bool next = __syncthreads_or(wnext);  // (and tile j - 1's buffer is free)
    if (next) load_queries((j + 1) * kTile, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the keys) have landed, live or not (see the forward)
    if (live) __syncthreads();
    if (live && wlive) {
#pragma unroll 1
      for (int q16 = t0w; q16 < t0w + 32; q16 += 16) {  // this warp's queries, 16 at a time
        const float* sq = s_q + buf * kTile * QP + q16 * QP;
        const float* sg = s_do + buf * kTile * VP + q16 * VP;
        const float* sl = s_l + buf * kTile + q16;
        const float* sd = s_d + buf * kTile + q16;
        const uint32_t w0 = m0 >> (q16 - t0w), w1 = m1 >> (q16 - t0w);
        float st[2][4], gt[2][4];  // s^T and dP^T: keys x queries
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = gt[nt][e] = 0.f;
        // s^T (depth 2 dk) and dP^T (depth dk) in one loop, a dP^T step
        // after every second s^T step: twice the independent mma chains
#pragma unroll
        for (int kk = 0; kk < D2 / 8; ++kk) {
          uint32_t ah[4], al[4], bh[2][2], bl[2][2];
          load_a32(s_kp, QP, r0, kk * 8, g, c, ah, al);
#pragma unroll
          for (int i = 0; i < 2; ++i) load_b32(sq, QP, i * 8, kk * 8, g, c, bh[i], bl[i]);
          mma3<2>(st, ah, al, bh, bl);
          if (kk & 1) {
            const int kd = kk >> 1;
            load_a32(s_v, VP, r0, kd * 8, g, c, ah, al);
#pragma unroll
            for (int i = 0; i < 2; ++i) load_b32(sg, VP, i * 8, kd * 8, g, c, bh[i], bl[i]);
            mma3<2>(gt, ah, al, bh, bl);
          }
        }
        // p^T and ds^T; the column (query) statistics L and D
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int qi = nt * 8 + 2 * c;
          const float2 lq = *reinterpret_cast<const float2*>(sl + qi);
          const float2 dq2 = *reinterpret_cast<const float2*>(sd + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l2 = (e & 1 ? lq.y : lq.x) * kLog2e, dd = e & 1 ? dq2.y : dq2.x;
            const bool ok = ((e < 2 ? w0 : w1) >> (qi + (e & 1))) & 1;
            const float pr = ok ? exp2f(st[nt][e] * sl2 - l2) : 0.f;
            const float ds = pr * (gt[nt][e] - dd) * scale;
            col[e >> 1] += ds;
            st[nt][e] = pr;
            gt[nt][e] = ds;
          }
        }
        // dv += p^T . do and [dk | dp] += ds^T . [q+u | q+v], 8 queries a
        // step in the order of `acc_a`
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t ph[4], pl[4], dh[4], dl[4];
          acc_a(st[kq], ph, pl);
          acc_a(gt[kq], dh, dl);
#pragma unroll
          for (int n4 = 0; n4 < ND; n4 += GD) {
            uint32_t bh[GD][2], bl[GD][2];
#pragma unroll
            for (int i = 0; i < GD; ++i)
              load_bt32(sg, VP, (n4 + i) * 8, kq * 8, g, c, bh[i], bl[i]);
            mma3<GD>(dv + n4, ph, pl, bh, bl);
          }
#pragma unroll
          for (int n4 = 0; n4 < D2 / 8; n4 += GD2) {
            uint32_t bh[GD2][2], bl[GD2][2];
#pragma unroll
            for (int i = 0; i < GD2; ++i)
              load_bt32(sq, QP, (n4 + i) * 8, kq * 8, g, c, bh[i], bl[i]);
            mma3<GD2>(dkp + n4, dh, dl, bh, bl);
          }
        }
      }
    }
    m0 = n0;
    m1 = n1;
    wlive = wnext;
    live = next;
  }

  // the two query halves summed on the first warp of each key group: dk,
  // dv, this batch's dp rows, and each key's ds column sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    col[r] += __shfl_xor_sync(kFull, col[r], 1);
    col[r] += __shfl_xor_sync(kFull, col[r], 2);
  }
  float x[12 * ND + 2];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * nt + e] = dv[nt][e];
#pragma unroll
  for (int nt = 0; nt < D2 / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * ND + 4 * nt + e] = dkp[nt][e];
  x[12 * ND] = col[0];
  x[12 * ND + 1] = col[1];
  cp_async_wait<0>();  // the keys, if no query tile was ever waited for
  const float* y = pair_exchange(s_q, x);
  if (warp < 4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = r0 + g + 8 * r, s = key0 + kr;
      if (c == 0) s_col[kr] = col[r] + y[(12 * ND + r) * 32];  // keys past S: 0
      if (s >= s_len) continue;
      const size_t off = ((size_t)b * s_len + s) * d_model + h * DK + 2 * c;
#pragma unroll
      for (int nt = 0; nt < ND; ++nt) {
        const int e = 2 * r, iv = (4 * nt + e) * 32, ik = iv + 4 * ND * 32, ip = ik + 4 * ND * 32;
        *reinterpret_cast<float2*>(dv_out + off + nt * 8) =
            make_float2(dv[nt][e] + y[iv], dv[nt][e + 1] + y[iv + 32]);
        *reinterpret_cast<float2*>(dk_out + off + nt * 8) =
            make_float2(dkp[nt][e] + y[ik], dkp[nt][e + 1] + y[ik + 32]);
        *reinterpret_cast<float2*>(dp_part + off + nt * 8) =
            make_float2(dkp[ND + nt][e] + y[ip], dkp[ND + nt][e + 1] + y[ip + 32]);
      }
    }
  }
  __syncthreads();
  // this block's share of du | dvb: col . k | col . p over its keys, in order
  float* part = bias_part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * d_model;
  for (int i = tid; i < D2; i += kTfThreads) {
    const int which = i / DK, d = i - which * DK;
    float acc = 0.f;
    for (int kr = 0; kr < BK; ++kr) acc = fmaf(s_col[kr], s_kp[kr * QP + which * DK + d], acc);
    part[which * d_model + h * DK + d] = acc;
  }
}

// dp [S, H*dk] = the sum over the batch of dp_part [B, S, H*dk], and du |
// dvb [H*dk each] = the sum over the batch and the key tiles of bias_part
// [B * key tiles, 2 H*dk], each in ascending order
__global__ void relpos_bwd_sum_kernel(const float* __restrict__ dp_part,
                                      const float* __restrict__ bias_part, float* __restrict__ dp,
                                      float* __restrict__ du, float* __restrict__ dvb, int batch,
                                      int parts, int sd, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float x = 0.f;
  if (i < sd) {
    for (int n = 0; n < batch; ++n) x += dp_part[(size_t)n * sd + i];
    dp[i] = x;
  } else if (i < sd + 2 * d) {
    const int j = i - sd;
    for (int n = 0; n < parts; ++n) x += bias_part[(size_t)n * 2 * d + j];
    (j < d ? du : dvb)[j < d ? j : j - d] = x;
  }
}

template <int DK>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* p, const void* v,
                            const void* ub, const void* vb, const void* mask, const void* dout,
                            const void* out, const void* lse, void* dq, void* dk, void* dv,
                            void* dp, void* du, void* dvb, void* dsum, void* qc, void* part,
                            int batch, int t_len, int s_len, int n_head, long long msb,
                            long long mst, long long mss, float scale, cudaStream_t stream) {
  constexpr int B64 = 64, QP = pitch32<2 * DK>(), VP = pitch32<DK>();
  const int d_model = n_head * DK, key_tiles = cdiv(s_len, B64);
  size_t smem = sizeof(float) * (B64 * (QP + VP) + 2 * kTile * (QP + VP) + 2 * B64);
  cudaError_t err = allow_smem(relpos_bwd_q_tf32_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  relpos_bwd_q_tf32_kernel<DK><<<dim3(cdiv(t_len, B64), n_head, batch), kTfThreads, smem,
                                 stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(p),
      static_cast<const float*>(v), static_cast<const float*>(ub), static_cast<const float*>(vb),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(dout),
      static_cast<const float*>(out), static_cast<const float*>(lse), static_cast<float*>(dq),
      static_cast<float*>(dsum), static_cast<float*>(qc), t_len, s_len, n_head, msb, mst, mss,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* dp_part = static_cast<float*>(part);  // [B, S, H*dk], then [B, key tiles, 2 H*dk]
  float* bias_part = dp_part + (size_t)batch * s_len * d_model;
  smem = sizeof(float) * (B64 * (QP + VP) + 2 * kTile * (QP + VP) + 4 * kTile + B64);
  err = allow_smem(relpos_bwd_kv_tf32_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  relpos_bwd_kv_tf32_kernel<DK><<<dim3(key_tiles, n_head, batch), kTfThreads, smem, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(p), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<const float*>(qc), static_cast<float*>(dk), static_cast<float*>(dv), dp_part,
      bias_part, t_len, s_len, n_head, msb, mst, mss, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int sd = s_len * d_model;
  relpos_bwd_sum_kernel<<<cdiv(sd + 2 * d_model, 256), 256, 0, stream>>>(
      dp_part, bias_part, static_cast<float*>(dp), static_cast<float*>(du),
      static_cast<float*>(dvb), batch, batch * key_tiles, sd, d_model);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, T, H*dk], k/v [B, S, H*dk], p [1, S, H*dk], biases [H*dk], all of
// one type (is_bf16: bf16, else fp32), contiguous and 16-byte aligned; mask
// bool read at b*msb + t*mst + s*mss (element strides, 0 to broadcast). dk
// is 16, 32 or 64. lse null, or fp32 [B, H, T] for each row's log-sum-exp,
// what the backward reads beside the fp32 output; bf16 then also needs out32,
// fp32 [B, T, H*dk] for the output before its rounding to bf16 (null
// without lse; fp32 never reads it: out is that output).
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
#define TPUASR_FWD_TF32(DK)                                                                  \
  err = launch_fwd_tf32<DK>(q, k, p, v, ub, vb, mask, out, lse, batch, t_len, s_len, n_head, \
                            msb, mst, mss, scale, st)
  if (is_bf16) {
    if (dk == 16) TPUASR_FWD_TC(16);
    if (dk == 32) TPUASR_FWD_TC(32);
    if (dk == 64) TPUASR_FWD_TC(64);
  } else {
    if (dk == 16) TPUASR_FWD_TF32(16);
    if (dk == 32) TPUASR_FWD_TF32(32);
    if (dk == 64) TPUASR_FWD_TF32(64);
  }
#undef TPUASR_FWD_TC
#undef TPUASR_FWD_TF32
  return static_cast<int>(err);
}

// The backward of relpos_attention_fwd: + do [B, T, H*dk] (q's type), out
// (fp32 [B, T, H*dk]: bf16's out32, fp32's out) and lse [B, H, T] as
// relpos_attention_fwd wrote them -> dq [B, T, H*dk], dk, dv [B, S, H*dk]
// in q's type; dp [1, S, H*dk], du, dvb [H*dk] fp32. Scratch: stats fp32
// [B, H, T] (each row's rowsum(do * out)) and qc [B, H, T, 2 dk] in q's
// type ([q+u | q+v]). bf16 adds into dp, du and dvb (zeroed by the caller)
// and reads no part; fp32 writes them from part, fp32 scratch of
// B*S*H*dk + B*ceil(S / 64)*2*H*dk floats (the key side's partial sums).
// T, S >= 1.
int relpos_attention_bwd(const void* q, const void* k, const void* p, const void* v,
                         const void* ub, const void* vb, const void* mask,
                         const void* dout, const void* out, const void* lse, void* dq, void* dk,
                         void* dv, void* dp, void* du, void* dvb, void* stats, void* qc,
                         void* part, int batch, int t_len, int s_len, int n_head, int dk_,
                         long long msb, long long mst, long long mss, float scale, int is_bf16,
                         void* stream) {
  if (batch == 0 || t_len == 0 || s_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TPUASR_BWD_TC(DK)                                                                    \
  err = launch_bwd_tc<DK>(q, k, p, v, ub, vb, mask, dout, out, lse, dq, dk, dv, dp, du, dvb, \
                          stats, qc, batch, t_len, s_len, n_head, msb, mst, mss, scale, st)
#define TPUASR_BWD_TF32(DK)                                                                    \
  err = launch_bwd_tf32<DK>(q, k, p, v, ub, vb, mask, dout, out, lse, dq, dk, dv, dp, du, dvb, \
                            stats, qc, part, batch, t_len, s_len, n_head, msb, mst, mss, scale, \
                            st)
  if (is_bf16) {
    if (dk_ == 16) TPUASR_BWD_TC(16);
    if (dk_ == 32) TPUASR_BWD_TC(32);
    if (dk_ == 64) TPUASR_BWD_TC(64);
  } else {
    if (dk_ == 16) TPUASR_BWD_TF32(16);
    if (dk_ == 32) TPUASR_BWD_TF32(32);
    if (dk_ == 64) TPUASR_BWD_TF32(64);
  }
#undef TPUASR_BWD_TC
#undef TPUASR_BWD_TF32
  return static_cast<int>(err);
}

}  // extern "C"
