// Log-mel fbank over framed audio, one pass per tile of frames: three routes.
//
// Replaces the TPU kernel `_fbank_kernel` / `fbank_frames_pallas`
// (tpuasr/ops/fbank_pallas.py:25-88): window multiply, real DFT as two
// products against the cos/sin basis, power, mel product and
// 10*log10(max(., amin)). The [R, n_freq] spectrum never reaches device
// memory on any route.
//
// "highest" at a power-of-two n_fft (fp32, `fbank_fft_kernel`, serving's
// route): the function computes the real DFT of each windowed frame, which
// an FFT does in ~2.5 n log2 n flops (26 kflop a frame at n_fft 1024)
// against the dense products' 4 n n_freq (2.1 MFLOP), and the triangular mel
// filters touch ~2 bins each of 513, not 41,040 products. So the function
// is bound by bytes on this card (4 KB of frame in, 320 B out a frame: 5.5
// us for the serving requests' 4,112 frames at 3.35 TB/s), and what a
// kernel adds is its instructions and the waits between its phases. TF32
// would not keep serving's exact fp32 tokens, and the FFT's work is too
// small for tensor cores to matter, so it runs in fp32 on the CUDA cores.
// Design:
//  (0) `fbank_band_kernel`, once per call: each mel filter's first and last
//      nonzero bin, found from the mel matrix it is given (a warp a filter),
//      into a scratch the wrapper allocates.
//  (a) `fbank_fft_kernel<LOGM>`: a block of F frames, M = n_fft / 2 = 2**LOGM
//      complex points a frame and 16 a thread (a warp a frame at n_fft
//      1024). A thread loads its part of the frame 16 bytes a lane, windows
//      it in fp32 and packs it as z[n] = x[2n] + i x[2n+1]; the twiddles
//      W^k = cos[1, k] + i sin[1, k], k <= M, are read from row 1 of the
//      basis into shared memory once a block (no fast-math sin/cos: the
//      function's inputs decide the result). The M-point FFT runs as radix-2
//      DIF stages grouped into passes of 3, 4, 4, ... index bits: a pass's
//      stages run on a thread's 16 points in registers, and between passes
//      the points go through shared memory, padded by `fpad` so that every
//      pass's lane strides land on distinct banks. The layout is fixed at
//      compile time (per register) plus one runtime part per thread and
//      pass, so no pass computes an index per point and none divides. A
//      frame of one warp syncs with __syncwarp alone. Then the real split
//      X[k] = (Z[k] + Z*[M-k]) / 2 - i W^k (Z[k] - Z*[M-k]) / 2, k = 0..M,
//      and the power into a [M + 1][F | 1] tile. The mel product takes a
//      lane a frame and walks each filter's band of bins in ascending order
//      (the bins outside it add exact zeros: the same fp32 sum as the dense
//      walk), so a warp reads one weight at a time for all its lanes; then
//      10*log10(max(., amin)) through shared memory and out coalesced. No
//      atomics: two calls give the same bits. The plan (ops/fbank.py:
//      `_fbank_fft_plan`) picks the route by shape and F, and owns the
//      shared memory, which the entry checks.
//
// "highest" at any other n_fft (fp32, `fbank_kernel`): exact fp32 products with no TF32, so on
// the CUDA cores (67 TFLOP/s peak), and bound by operations there: a frame
// costs 2 * 2 * n_fft * n_freq (DFT) + 2 * n_freq * n_mels (mel) flops, about
// 2.2 MFLOP at n_fft 1024, against 4 KB of frame read and 320 B of output.
// One block per tile of kTR frames stages its windowed frames in shared
// memory transposed ([n][frame], so one float4 load broadcasts four frames
// to every thread); each thread owns one frequency bin and accumulates re/im
// for all kTR frames while streaming its cos/sin column (neighbouring
// threads read neighbouring bins: coalesced, and the basis stays in L2
// across blocks). The tile's power spectrum lives in shared memory
// ([kTR][n_freq]), where the mel product and the log read it.
//
// "default" (bf16 operands, fp32 sums, `fbank_tc_kernel`): what the TPU's
// single bf16 pass computes, and what `mma.sync.m16n8k16.bf16` computes
// exactly: frames * window rounded once to bf16, cos/sin and mel rounded to
// bf16, fp32 sums, and the power re^2 + im^2 rounded once to bf16 before the
// mel product. The kernel and the plain version differ only in the order of
// fp32 sums. As dense products the DFT is 4 * n_fft * n_freq flops a frame
// (19.9 GFLOP at bench.py's 9,216 frames, 0.020 ms at the dense bf16 peak).
// What bounds the route on the H100 is the SM's shared-memory pipe and the
// issue of `mma.sync`, not the tensor cores' published rate or L2: in a
// build with cycle stamps in the loop, a stage's time followed the SM's
// count of ldmatrix and cp.async, or the products on its busiest
// sub-partition, whichever was more, and its waits and barriers cost next
// to nothing. So the design loads few fragments a product, puts one warp
// on each of the SM's four sub-partitions, and fills the card in one round.
// Design:
//  (0) `fbank_pack_kernel`, once per call: cos/sin into one bf16 basis
//      [chunk][k][64], a chunk's 32 bins as 64 columns in groups of 16 (the
//      cos of 8 bins, then their sin), so a lane's re and im accumulators
//      hold the same bins; mel into bf16 [32 n_chunks][mel_ld]. K is padded
//      to a multiple of the 128-deep K tile, bins to 32, mel columns to
//      slabs of 80: zeros, so padding adds nothing. Where the last chunk's
//      second 16 bins are all padding (513 bins at n_fft 1024: 528 computed,
//      not 544), the main kernel skips them.
//  (a) `fbank_tc_kernel<RM, WM, WN>`: a block owns 16 RM WM frames and
//      WM x WN warps; warp w takes RM row groups of 16 frames and 4 / WN of
//      a chunk's 4 groups of 8 bins (the plan's shapes: 32 or 80 frames, 4
//      warps each over all the frames and 8 bins, so each B fragment serves
//      2 or 5 products). The block loads its frames 16 bytes a lane,
//      multiplies them by the window in fp32 and keeps them as bf16 in
//      shared memory, the A operand of every product (pitch k_pad + 8:
//      ldmatrix rows on distinct banks). It walks the bins in chunks of 32:
//      128 x 64 basis tiles stream through two cp.async buffers (one in
//      flight while one is used; on the card two of 128 beat four of 64:
//      half the stages), each k-step's fragments loaded while the previous
//      one's products issue, and no integer division on the per-stage path
//      (in the first design, divisions and index math outnumbered a stage's
//      products many times over and set its time).
//      After a chunk's last K tile, p = re^2 + im^2 goes to shared memory
//      as bf16, and the mel product runs by row group (A = the power rows,
//      B = the chunk's mel rows, loaded beside its first K tile and
//      double-buffered by chunk) into 16 x 80 fp32 sums a row group,
//      which stay on one warp: no cross-warp sum, no atomics, two calls
//      give the same bits. After the last chunk, 10*log10(max(., amin))
//      goes out for the valid rows and columns. Rows past R are zero on
//      load and never stored. More than 80 mel filters take several column
//      slabs of 80 (gridDim.y), each repeating the DFT.
//  The plan (ops/fbank.py: `_fbank_plan`) owns the packed layout (padded
//  sizes, scratch, shared memory), picks the block's shape by the time on
//  the busiest SM and passes all of it to the entry, which checks it.

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- fp32

constexpr int kTR = 16;           // frames per block
constexpr int kMaxThreads = 576;  // one bin per thread up to n_fft 1150

__global__ void __launch_bounds__(kMaxThreads)
fbank_kernel(const float* __restrict__ frames, const float* __restrict__ window,
             const float* __restrict__ cosb, const float* __restrict__ sinb,
             const float* __restrict__ mel, float* __restrict__ out, int rows, int n_fft,
             int n_freq, int n_mels, float amin) {
  extern __shared__ float4 smem4[];
  float* fw = reinterpret_cast<float*>(smem4);  // [n_fft][kTR]
  float* spec = fw + (size_t)n_fft * kTR;       // [kTR][n_freq]
  const int r0 = blockIdx.x * kTR;

  for (int i = threadIdx.x; i < kTR * n_fft; i += blockDim.x) {
    const int r = i / n_fft, n = i - r * n_fft;
    float x = 0.f;
    if (r0 + r < rows) x = frames[(size_t)(r0 + r) * n_fft + n] * window[n];
    fw[n * kTR + r] = x;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freq; f += blockDim.x) {
    float re[kTR], im[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) re[r] = im[r] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      const float c = cosb[(size_t)n * n_freq + f];
      const float s = sinb[(size_t)n * n_freq + f];
      const float4* row = reinterpret_cast<const float4*>(fw + n * kTR);
#pragma unroll
      for (int q = 0; q < kTR / 4; ++q) {
        const float4 x = row[q];
        re[4 * q + 0] = fmaf(x.x, c, re[4 * q + 0]);
        re[4 * q + 1] = fmaf(x.y, c, re[4 * q + 1]);
        re[4 * q + 2] = fmaf(x.z, c, re[4 * q + 2]);
        re[4 * q + 3] = fmaf(x.w, c, re[4 * q + 3]);
        im[4 * q + 0] = fmaf(x.x, s, im[4 * q + 0]);
        im[4 * q + 1] = fmaf(x.y, s, im[4 * q + 1]);
        im[4 * q + 2] = fmaf(x.z, s, im[4 * q + 2]);
        im[4 * q + 3] = fmaf(x.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r) spec[r * n_freq + f] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTR * n_mels; i += blockDim.x) {
    const int r = i / n_mels, m = i - r * n_mels;
    if (r0 + r >= rows) continue;
    const float* sp = spec + r * n_freq;
    float acc = 0.f;
    for (int f = 0; f < n_freq; ++f) acc = fmaf(sp[f], mel[(size_t)f * n_mels + m], acc);
    out[(size_t)(r0 + r) * n_mels + m] = 10.f * log10f(fmaxf(acc, amin));
  }
}

cudaError_t launch_fp32(const float* frames, const float* window, const float* cosb,
                        const float* sinb, const float* mel, float* out, int rows, int n_fft,
                        int n_freq, int n_mels, float amin, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)n_fft * kTR + (size_t)kTR * n_freq);
  cudaError_t err = allow_smem(fbank_kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_freq + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int blocks = (rows + kTR - 1) / kTR;
  fbank_kernel<<<blocks, threads, smem, stream>>>(frames, window, cosb, sinb, mel, out, rows,
                                                  n_fft, n_freq, n_mels, amin);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 FFT

constexpr int kFftPoints = 16;  // complex points a thread holds in registers

// a padded shared-memory index: a float2 word more every 16 and every 256, so
// the lanes' strides of each pass land on distinct bank pairs; over indices
// with disjoint bits it adds up (fpad(a | b) = fpad(a) + fpad(b)), so a
// thread's runtime part and each register's compile-time part pad apart
__host__ __device__ constexpr int fpad(int i) { return i + (i >> 4) + (i >> 8); }

// the radix-2 DIF stages in groups, top index bit first: group 0 covers the
// top 3 bits of the m-bit index (m >= 5), then groups of 4 bits and the
// rest, never a group of 1 (4 + 4 + ... + 1 bits go as 3 + 4 + ... + 2); a
// group's stages run in registers, and the passes between groups go
// through shared memory
__host__ __device__ constexpr int fft_groups(int m) { return 1 + cdiv(m - 3, 4); }
__host__ __device__ constexpr int group_bits(int m, int g) {
  const int r = m - 3, n = cdiv(r, 4);
  const bool one_left = r > 1 && r % 4 == 1;
  if (g == 0) return 3;
  if (g == n) return one_left ? 2 : r - 4 * (n - 1);
  return g == 1 && one_left ? 3 : 4;
}
// closed form: with a loop summing the groups' bits, ptxas left registers
// of the unrolled passes in local memory
__host__ __device__ constexpr int group_lo(int m, int g) {
  const int r = m - 3, n = cdiv(r, 4);
  const bool one_left = r > 1 && r % 4 == 1;
  return g == 0 ? m - 3 : g == n ? 0 : m - 3 - 4 * g + (one_left ? 1 : 0);
}
// the index bits register j of a thread holds in group g: j's low L bits are
// the group's field; in group 0 j's bit 3 is index bit 0 (so a float4 of the
// frame is registers j and j + 8), in the others j's spare bits are the top
// bits of the index
__host__ __device__ constexpr int reg_bits(int m, int g, int j) {
  return g == 0 ? ((j >> 3) & 1) | ((j & 7) << (m - 3))
                : ((j & ((1 << group_bits(m, g)) - 1)) << group_lo(m, g)) |
                      ((j >> group_bits(m, g)) << (m - 4 + group_bits(m, g)));
}
// thread t's index bits in group g: the bits the group's field and spare
// register bits leave, lowest first
__device__ __forceinline__ int thread_bits(int m, int g, int t) {
  if (g == 0) return t << 1;
  const int lo = group_lo(m, g);
  return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + group_bits(m, g)));
}
__host__ __device__ constexpr int brev_bits(int i, int m) {
  int r = 0;
  for (int b = 0; b < m; ++b) r |= ((i >> b) & 1) << (m - 1 - b);
  return r;
}

// a shared-memory layout of the FFT route, shared by the entry's check and the
// kernel: twiddles [fpad(M) + 1] float2, a zone of F frames' complex points
// [F][fpad(M)] float2 (after the split, the block's log-mel [F][n_mels | 1]
// fp32), the power [M + 1][F | 1] fp32
__host__ __device__ constexpr int fft_tw_bytes(int m) {
  return cdiv(8 * (fpad(1 << m) + 1), 16) * 16;
}
__host__ __device__ constexpr int fft_zone_bytes(int m, int f, int n_mels) {
  const int points = 8 * f * fpad(1 << m), logmel = 4 * f * (n_mels | 1);
  return cdiv(points > logmel ? points : logmel, 16) * 16;
}
__host__ __device__ constexpr int fft_smem(int m, int f, int n_mels) {
  return fft_tw_bytes(m) + fft_zone_bytes(m, f, n_mels) + 4 * ((1 << m) + 1) * (f | 1);
}

// each filter's first and last nonzero bin, a warp a filter: [lo, hi] of
// mel[:, m] != 0 (lo = n_freq, hi = -1 for a filter of zeros)
__global__ void fbank_band_kernel(const float* __restrict__ mel, int2* __restrict__ band,
                                  int n_freq, int n_mels) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= n_mels) return;  // the whole warp
  int lo = n_freq, hi = -1;
  for (int f = lane; f < n_freq; f += 32)
    if (mel[(size_t)f * n_mels + m] != 0.f) {
      lo = min(lo, f);
      hi = max(hi, f);
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) band[m] = make_int2(lo, hi);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a frame's threads share its points through shared memory: a frame of one
// warp or less needs only __syncwarp
template <int T>
__device__ __forceinline__ void frame_sync() {
  if constexpr (T > 32) __syncthreads(); else __syncwarp();
}

// pass G and the passes after it: the points of the last pass in (G > 0),
// the group's DIF stages on index bits lo + L - 1 .. lo in registers, pair
// (i, i + h), h = 2**B: y_i = a + b, y_{i+h} = (a - b) W^(2 (i mod h) 2**s),
// s = LOGM - 1 - B, then the points out (after the last pass in natural
// order: the point at index i is Z[bit reverse of i])
template <int LOGM, int G>
__device__ __forceinline__ void fft_passes(float2 (&v)[kFftPoints], float2* zp,
                                           const float2* s_tw, int t) {
  constexpr int NG = fft_groups(LOGM), lo = group_lo(LOGM, G), L = group_bits(LOGM, G);
  constexpr int T = 1 << (LOGM - 4);
  const int base = thread_bits(LOGM, G, t), pbase = fpad(base);
  if constexpr (G > 0) {
#pragma unroll
    for (int j = 0; j < kFftPoints; ++j) v[j] = zp[pbase + fpad(reg_bits(LOGM, G, j))];
  }
#pragma unroll
  for (int q = L - 1; q >= 0; --q) {
    const int B = lo + q, s = LOGM - 1 - B;
    const int ptb = fpad((base & ((1 << B) - 1)) << (s + 1));
#pragma unroll
    for (int j0 = 0; j0 < kFftPoints; ++j0) {
      if (j0 & (1 << q)) continue;
      const int j1 = j0 | (1 << q);
      const float2 a = v[j0], b = v[j1];
      v[j0] = make_float2(a.x + b.x, a.y + b.y);
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      const int ptj = fpad((reg_bits(LOGM, G, j0) & ((1 << B) - 1)) << (s + 1));
      v[j1] = B == 0 ? d : cmul(d, s_tw[ptb + ptj]);
    }
  }
  if constexpr (G > 0) frame_sync<T>();  // every point of the last pass read
  if constexpr (G + 1 < NG) {
#pragma unroll
    for (int j = 0; j < kFftPoints; ++j) zp[pbase + fpad(reg_bits(LOGM, G, j))] = v[j];
    frame_sync<T>();
    fft_passes<LOGM, G + 1>(v, zp, s_tw, t);
  } else {
    const int pb = fpad(__brev(base) >> (32 - LOGM));
#pragma unroll
    for (int j = 0; j < kFftPoints; ++j)
      zp[pb + fpad(brev_bits(reg_bits(LOGM, G, j), LOGM))] = v[j];
    frame_sync<T>();
  }
}

// M = 2**LOGM complex points a frame (n_fft = 2M), T = M / 16 threads a
// frame, F = 2**log2f frames a block (F T >= 32, a whole number of warps)
template <int LOGM>
__global__ void __launch_bounds__(1024)
fbank_fft_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                 const float* __restrict__ cosb, const float* __restrict__ sinb,
                 const float* __restrict__ mel, const int2* __restrict__ band,
                 float* __restrict__ out, int rows, int n_mels, int log2f, float amin) {
  constexpr int M = 1 << LOGM, N = 2 * M, NF = M + 1, LT = LOGM - 4, T = 1 << LT;
  constexpr int ZP = fpad(M);
  const int F = 1 << log2f, SP = F | 1, OP = n_mels | 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_tw = reinterpret_cast<float2*>(smem);
  float2* s_z = reinterpret_cast<float2*>(smem + fft_tw_bytes(LOGM));
  float* s_out = reinterpret_cast<float*>(s_z);  // after the split
  float* s_p = reinterpret_cast<float*>(smem + fft_tw_bytes(LOGM) +
                                        fft_zone_bytes(LOGM, F, n_mels));

  const int tid = threadIdx.x, t = tid & (T - 1), rl = tid >> LT;
  const int r0 = blockIdx.x * F;
  const bool live = r0 + rl < rows;
  // the frame, 16 bytes a lane, times the window in fp32, as z[i] =
  // x[2i] + i x[2i+1]: register u and u + 8 from one float4 (group 0's layout)
  float2 v[kFftPoints];
  {
    const float* fr = frames + (size_t)(r0 + rl) * N;
    auto at = [t](int u) { return 2 * ((t << 1) | (u << (LOGM - 3))); };  // floats
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = live ? __ldcs(reinterpret_cast<const float4*>(fr + at(u)))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(window + at(u)));
      v[u] = make_float2(x[u].x * w.x, x[u].y * w.y);
      v[u + 8] = make_float2(x[u].z * w.z, x[u].w * w.w);
    }
  }
  // the twiddles W^k = cos[1, k] + i sin[1, k], k <= M: row 1 of the basis
  for (int k = tid; k <= M; k += blockDim.x)
    s_tw[fpad(k)] = make_float2(cosb[NF + k], sinb[NF + k]);
  __syncthreads();

  float2* zp = s_z + rl * ZP;
  fft_passes<LOGM, 0>(v, zp, s_tw, t);

  // the real split: X[k] = E - i W^k D, E = (Z[k] + Z*[M-k]) / 2,
  // D = (Z[k] - Z*[M-k]) / 2, k = t + c T and (thread 0) k = M; the power
  // into column rl of the block's power
  float* pw = s_p + rl;
  auto split = [&](int k, int pk) {
    const float2 a = zp[pk], b = zp[fpad((M - k) & (M - 1))], w = s_tw[pk];
    const float ex = 0.5f * (a.x + b.x), ey = 0.5f * (a.y - b.y);
    const float dx = 0.5f * (a.x - b.x), dy = 0.5f * (a.y + b.y);
    const float2 wd = cmul(make_float2(dx, dy), w);
    const float xr = ex + wd.y, xi = ey - wd.x;
    pw[k * SP] = xr * xr + xi * xi;
  };
  const int pt = fpad(t);
#pragma unroll
  for (int c = 0; c < kFftPoints; ++c) split(t + c * T, pt + fpad(c * T));
  if (t == 0) {  // k = M: Z[M] = Z[0]; its twiddle sits at fpad(M), not zp's
    const float2 a = zp[0], w = s_tw[fpad(M)];
    const float2 wd = cmul(make_float2(0.f, a.y), w);
    const float xr = a.x + wd.y, xi = -wd.x;
    pw[M * SP] = xr * xr + xi * xi;
  }
  __syncthreads();  // every frame's power is in; the points are free

  // the mel product: a warp takes 32 / F filters for the block's F frames
  // (lane: frame lane % F, filter lane / F), each filter's band of bins
  // walked in ascending order from the power in shared memory
  const int warp = tid >> 5, lane = tid & 31, per = 32 >> log2f;
  const int n_tasks = cdiv(n_mels, per);
  for (int task = warp; task < n_tasks; task += blockDim.x >> 5) {
    const int r = lane & (F - 1), m = task * per + (lane >> log2f);
    if (m < n_mels) {
      const int2 bd = band[m];
      const float* pr = s_p + r;
      float acc = 0.f;
#pragma unroll 4
      for (int f = bd.x; f <= bd.y; ++f)
        acc = fmaf(pr[f * SP], __ldg(mel + (size_t)f * n_mels + m), acc);
      s_out[r * OP + m] = 10.f * log10f(fmaxf(acc, amin));
    }
  }
  __syncthreads();
  for (int r = warp; r < F; r += blockDim.x >> 5)
    if (r0 + r < rows)
      for (int m = lane; m < n_mels; m += 32)
        out[(size_t)(r0 + r) * n_mels + m] = s_out[r * OP + m];
}

template <int LOGM>
cudaError_t launch_fft(const float* frames, const float* window, const float* cosb,
                       const float* sinb, const float* mel, const int2* band, float* out, int rows,
                       int n_mels, int log2f, float amin, int smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(fbank_fft_kernel<LOGM>, smem);
  if (err != cudaSuccess) return err;
  const int f = 1 << log2f;
  fbank_fft_kernel<LOGM><<<cdiv(rows, f), f << (LOGM - 4), smem, stream>>>(
      frames, window, cosb, sinb, mel, band, out, rows, n_mels, log2f, amin);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kKT = 128;          // K tile: frame samples a stage
constexpr int kNB = 32;           // bins a chunk
constexpr int kBC = 2 * kNB;      // basis columns a chunk: cos and sin
constexpr int kBP = kBC + 8;      // basis tile pitch in shared memory
constexpr int kStages = 2;        // basis tiles in the cp.async ring
constexpr int kPP = kNB + 8;      // pitch of a chunk's power in shared memory
constexpr int kMW = 80;           // mel columns a slab (gridDim.y)
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

// cos/sin [n_fft][n_freq] -> basis [n_chunks][k_pad][kBC] (column c of a
// chunk: group c / 16, bin c % 8 of the group's 8, cos if c % 16 < 8 else
// sin); mel [n_freq][n_mels] -> melp [n_chunks * kNB][mel_ld]; bf16, zeros
// past n_fft, n_freq and n_mels
__global__ void fbank_pack_kernel(const float* __restrict__ cosb, const float* __restrict__ sinb,
                                  const float* __restrict__ mel, bf16* __restrict__ basis,
                                  bf16* __restrict__ melp, int n_fft, int n_freq, int n_mels,
                                  int k_pad, int n_chunks, int mel_ld) {
  const size_t nb = (size_t)n_chunks * k_pad * kBC, nm = (size_t)n_chunks * kNB * mel_ld;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nb + nm;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < nb) {
      const int c = (int)(i % kBC), k = (int)(i / kBC % k_pad);
      const int ch = (int)(i / ((size_t)kBC * k_pad));
      const int f = ch * kNB + (c >> 4) * 8 + (c & 7);
      const float* src = (c & 8) ? sinb : cosb;
      basis[i] = __float2bfloat16(k < n_fft && f < n_freq ? src[(size_t)k * n_freq + f] : 0.f);
    } else {
      const size_t j = i - nb;
      const int m = (int)(j % mel_ld), f = (int)(j / mel_ld);
      melp[j] = __float2bfloat16(f < n_freq && m < n_mels ? mel[(size_t)f * n_mels + m] : 0.f);
    }
  }
}

// warp w: rows 16 RM (w % WM).. (RM row groups of 16), the chunk's bin
// groups G (w / WM).. (G = 4 / WN groups of 8 bins, each an n-tile of cos
// and one of sin). A warp's A fragments serve its G groups and its B
// fragments its RM row groups. The chunk's power goes through shared memory
// ([BR][kPP] bf16), and the mel product runs by row group (row group r on
// warp r % (WM WN)), so a warp's mel sums take 40 registers (16 x 80 fp32)
// for each of its MG row groups whatever its DFT tile.
template <int RM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
fbank_tc_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                const bf16* __restrict__ basis, const bf16* __restrict__ melp,
                float* __restrict__ out, int rows, int n_fft, int k_pad, int n_chunks,
                int half_last, int n_mels, int mel_ld, float amin, int vec) {
  constexpr int BR = 16 * RM * WM, NW = WM * WN, NT = NW * 32, G = 4 / WN;
  constexpr int MT = kMW / 8, MP = kMW + 8, MG = cdiv(BR / 16, NW);
  static_assert(G * WN == 4, "WN divides the chunk's 4 bin groups");
  const int FP = k_pad + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_f = reinterpret_cast<bf16*>(smem);  // [BR][FP] windowed frames
  bf16* s_b = s_f + (size_t)BR * FP;          // [kStages][kKT][kBP] basis tiles
  bf16* s_m = s_b + kStages * kKT * kBP;      // [2][kNB][MP] a chunk's mel rows
  bf16* s_p = s_m + 2 * kNB * MP;             // [BR][kPP] a chunk's power

  const int r0 = blockIdx.x * BR, m0 = blockIdx.y * kMW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rw = (warp % WM) * 16 * RM, q0 = (warp / WM) * G;  // first row, first group
  const int nk = k_pad / kKT, n_stages = n_chunks * nk;

  // stage s: K tile s % nk of chunk s / nk, contiguous in the packed basis
  // (s * kKT * kBC on), and with a chunk's first tile (kt = 0) its mel rows;
  // a thread's 16-byte pieces are tid + j * NT (no division on this path)
  auto load_stage = [&](int s, int ch, int kt) {
    const bf16* src = basis + (size_t)s * (kKT * kBC);
    bf16* dst = s_b + (s % kStages) * (kKT * kBP);
#pragma unroll
    for (int j = 0; j < cdiv(kKT * kBC / 8, NT); ++j) {
      const int i = tid + j * NT;
      if (kKT * kBC / 8 % NT == 0 || i < kKT * kBC / 8)
        cp_async16(dst + (i / (kBC / 8)) * kBP + (i % (kBC / 8)) * 8, src + i * 8, true);
    }
    if (kt == 0) {
      const bf16* msrc = melp + (size_t)ch * kNB * mel_ld + m0;
      bf16* mdst = s_m + (ch & 1) * (kNB * MP);
#pragma unroll
      for (int j = 0; j < cdiv(kNB * kMW / 8, NT); ++j) {
        const int i = tid + j * NT;
        if (i < kNB * kMW / 8)
          cp_async16(mdst + (i / (kMW / 8)) * MP + (i % (kMW / 8)) * 8,
                     msrc + (size_t)(i / (kMW / 8)) * mel_ld + (i % (kMW / 8)) * 8, true);
      }
    }
  };

  // the next stage to load, as (s, chunk, K tile) counters
  int ls = 0, lch = 0, lkt = 0;
  auto load_next = [&]() {
    if (ls < n_stages) load_stage(ls, lch, lkt);
    cp_async_commit();
    ++ls;
    if (++lkt == nk) lkt = 0, ++lch;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  // the frames, windowed in fp32 and rounded once to bf16, a warp a row;
  // zeros past R and past n_fft
  if (vec) {  // 16 loads of 16 bytes a lane in flight: two rows of 1,024
    for (int r = warp; r < BR; r += 2 * NW)
      for (int k0 = 0; k0 < k_pad; k0 += 1024) {
        float4 f[2][8];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int rr = r + (u >> 3) * NW, k = k0 + (u & 7) * 128 + lane * 4;
          f[u >> 3][u & 7] = rr < BR && r0 + rr < rows && k < n_fft
                                 ? *reinterpret_cast<const float4*>(
                                       frames + (size_t)(r0 + rr) * n_fft + k)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int rr = r + (u >> 3) * NW, k = k0 + (u & 7) * 128 + lane * 4;
          if (rr >= BR || k >= k_pad) continue;
          const float4 w = k < n_fft ? *reinterpret_cast<const float4*>(window + k)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 x = f[u >> 3][u & 7];
          *reinterpret_cast<uint2*>(s_f + rr * FP + k) = make_uint2(
              pack_bf16(x.x * w.x, x.y * w.y), pack_bf16(x.z * w.z, x.w * w.w));
        }
      }
  } else {
    for (int r = warp; r < BR; r += NW) {
      const bool in = r0 + r < rows;
      for (int k = lane; k < k_pad; k += 32)
        s_f[r * FP + k] = __float2bfloat16(
            in && k < n_fft ? frames[(size_t)(r0 + r) * n_fft + k] * window[k] : 0.f);
    }
  }

  // acc[rm][j][0] re, acc[rm][j][1] im of row group rm, bin group q0 + j
  // (rows g and g + 8, bins 2c and 2c + 1 of the group's 8); macc[mg] the
  // mel sums of row group warp + mg NW
  float acc[RM][G][2][4], macc[MG][MT][4];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm)
#pragma unroll
    for (int e = 0; e < G * 8; ++e) acc[rm][e >> 3][(e >> 2) & 1][e & 3] = 0.f;
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int e = 0; e < MT * 4; ++e) macc[mg][e >> 2][e & 3] = 0.f;

  for (int s = 0, ch = 0, kt = 0; s < n_stages; ++s, kt = kt + 1 == nk ? 0 : kt + 1,
           ch += kt == 0) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread, and stage s - 1's slot is free
    load_next();                   // stage s + kStages - 1

    // in the last chunk groups 2 and 3 may be all padding: skipped
    const int live = half_last && ch == n_chunks - 1 ? 2 : 4;
    const bf16* bt = s_b + (s % kStages) * kKT * kBP;
    // the fragments of k-step kk + 1 are loaded before kk's products issue
    uint32_t fa[2][RM][4], fb[2][G][4];
    auto frags = [&](int kk, int i) {
#pragma unroll
      for (int rm = 0; rm < RM; ++rm)
        ldsm4(fa[i][rm], a_frag(s_f, FP, rw + 16 * rm, kt * kKT + kk * 16, lane));
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (q0 + j < live) ldsm4_t(fb[i][j], bt_frag(bt, kBP, (q0 + j) * 16, kk * 16, lane));
    };
    if (q0 < live) {
      frags(0, 0);
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        if (kk + 1 < kKT / 16) frags(kk + 1, (kk + 1) & 1);
        const int i = kk & 1;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (q0 + j >= live) continue;
#pragma unroll
          for (int rm = 0; rm < RM; ++rm) {
            mma16816(acc[rm][j][0], fa[i][rm], fb[i][j][0], fb[i][j][1]);
            mma16816(acc[rm][j][1], fa[i][rm], fb[i][j][2], fb[i][j][3]);
          }
        }
      }
    }
    if (kt != nk - 1) continue;

    // the chunk's power, rounded once to bf16, into shared memory (bins 8q
    // + 2c and 8q + 2c + 1 of rows g and g + 8 as one word), then the mel
    // product by row group: A = the power rows, B = the chunk's mel rows
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float re = acc[rm][j][0][2 * h + e], im = acc[rm][j][1][2 * h + e];
            p[e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
          }
          *reinterpret_cast<uint32_t*>(s_p + (rw + 16 * rm + g + 8 * h) * kPP + (q0 + j) * 8 +
                                       2 * c) = pack_bf16(p[0], p[1]);
        }
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int e = 0; e < G * 8; ++e) acc[rm][e >> 3][(e >> 2) & 1][e & 3] = 0.f;
    __syncthreads();  // the power of every bin group is in
    const bf16* mt = s_m + (ch & 1) * kNB * MP;
#pragma unroll
    for (int kk = 0; kk < kNB / 16; ++kk) {
      uint32_t pa[MG][4];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg)
        if (warp + mg * NW < BR / 16)
          ldsm4(pa[mg], a_frag(s_p, kPP, 16 * (warp + mg * NW), kk * 16, lane));
#pragma unroll
      for (int np = 0; np < MT / 2; ++np) {
        uint32_t bb[4];
        ldsm4_t(bb, bt_frag(mt, MP, np * 16, kk * 16, lane));
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          if (warp + mg * NW >= BR / 16) continue;
          mma16816(macc[mg][2 * np], pa[mg], bb[0], bb[1]);
          mma16816(macc[mg][2 * np + 1], pa[mg], bb[2], bb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
    if (warp + mg * NW >= BR / 16) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * (warp + mg * NW) + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + nt * 8 + 2 * c + e;
          if (m < n_mels)
            out[(size_t)r * n_mels + m] = 10.f * log10f(fmaxf(macc[mg][nt][2 * h + e], amin));
        }
    }
  }
}

template <int RM, int WM, int WN>
cudaError_t launch_tc(const float* frames, const float* window, const bf16* basis,
                      const bf16* melp, float* out, int rows, int n_fft, int k_pad, int n_chunks,
                      int half_last, int n_mels, int mel_ld, float amin, int smem, int vec,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(fbank_tc_kernel<RM, WM, WN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(rows, 16 * RM * WM), mel_ld / kMW);
  fbank_tc_kernel<RM, WM, WN><<<grid, WM * WN * 32, smem, stream>>>(
      frames, window, basis, melp, out, rows, n_fft, k_pad, n_chunks, half_last, n_mels, mel_ld,
      amin, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames [rows, n_fft], window [n_fft], cos/sin [n_fft, n_freq],
// mel [n_freq, n_mels] -> out [rows, n_mels]; all fp32, contiguous. route:
// 0 "highest" by the dense kernel (every argument after route but the
// stream unused); 2 "highest" by the FFT (n_fft = 2**(log2m + 1) from 64 to
// 16,384, n_freq = n_fft / 2 + 1, cos/sin the DFT basis, whose row 1 holds
// the twiddles), laid out by `_fbank_fft_plan` (ops/fbank.py): band is its
// scratch ([n_mels] int2, written here by the band kernel), frames_per_block
// frames of threads_per_frame threads a block, smem bytes of shared memory,
// frames and window 16-byte aligned; 1 "default", laid out by `_fbank_plan`,
// which owns the packed layout: basis and melp are its scratch parts
// ([n_chunks][k_pad][64] and [32 n_chunks][mel_ld] bf16, written here by the
// pack), K padded to k_pad, bins to n_chunks chunks (half_last: the last
// one's second 16 bins skipped), mel columns to mel_ld (slabs of 80), a block
// smem bytes of shared memory and warps_m x warps_n warps, each over 16 x
// row_groups frames and 4 / warps_n of a chunk's 4 bin groups. The entry
// checks each route's layout against the shape and the shared memory against
// the card's limit.
int fbank_logmel(const void* frames, const void* window, const void* cosb, const void* sinb,
                 const void* mel, void* out, void* basis, void* melp, void* band, int rows,
                 int n_fft, int n_freq, int n_mels, float amin, int route, int k_pad,
                 int n_chunks, int half_last, int mel_ld, int smem, int row_groups, int warps_m,
                 int warps_n, int frames_per_block, int threads_per_frame, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(frames), *win = static_cast<const float*>(window),
              *cb = static_cast<const float*>(cosb), *sb = static_cast<const float*>(sinb),
              *ml = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  if (route == 0)
    return static_cast<int>(launch_fp32(fr, win, cb, sb, ml, o, rows, n_fft, n_freq, n_mels,
                                        amin, st));

  if (route == 2) {
    int log2m = 0;
    while ((2 << log2m) < n_fft) ++log2m;
    int log2f = 0;
    while ((1 << log2f) < frames_per_block) ++log2f;
    const int f = frames_per_block, t = threads_per_frame;
    if ((2 << log2m) != n_fft || log2m < 5 || log2m > 13 || n_freq != n_fft / 2 + 1 ||
        (1 << log2f) != f || f > 32 || t != 1 << (log2m - 4) || f * t < 32 || f * t > 1024 ||
        smem != fft_smem(log2m, f, n_mels) || smem > kMaxSmem ||
        reinterpret_cast<uintptr_t>(frames) % 16 || reinterpret_cast<uintptr_t>(window) % 16 ||
        reinterpret_cast<uintptr_t>(band) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    int2* bd = static_cast<int2*>(band);
    fbank_band_kernel<<<cdiv(n_mels, 8), 256, 0, st>>>(ml, bd, n_freq, n_mels);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (log2m) {
#define FBANK_FFT(L)                                                                       \
  case L:                                                                                  \
    return static_cast<int>(                                                               \
        launch_fft<L>(fr, win, cb, sb, ml, bd, o, rows, n_mels, log2f, amin, smem, st));
      FBANK_FFT(5) FBANK_FFT(6) FBANK_FFT(7) FBANK_FFT(8)
      FBANK_FFT(9) FBANK_FFT(10) FBANK_FFT(11) FBANK_FFT(12) FBANK_FFT(13)
#undef FBANK_FFT
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }

  if (route != 1 || k_pad % kKT || k_pad < n_fft || n_chunks * kNB < n_freq || mel_ld % kMW ||
      mel_ld < n_mels || (half_last && n_freq > n_chunks * kNB - kNB / 2) ||
      smem > kMaxSmem || reinterpret_cast<uintptr_t>(basis) % 16 ||
      reinterpret_cast<uintptr_t>(melp) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  bf16 *bp = static_cast<bf16*>(basis), *mp = static_cast<bf16*>(melp);
  const size_t n_pack = (size_t)n_chunks * ((size_t)k_pad * kBC + (size_t)kNB * mel_ld);
  const int pack_blocks = (int)((n_pack + 255) / 256 < 4096 ? (n_pack + 255) / 256 : 4096);
  fbank_pack_kernel<<<pack_blocks, 256, 0, st>>>(cb, sb, ml, bp, mp, n_fft, n_freq, n_mels,
                                                 k_pad, n_chunks, mel_ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int vec = n_fft % 4 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(window) % 16 == 0;
#define FBANK_TILES(R, M, N)                                                               \
  if (row_groups == R && warps_m == M && warps_n == N)                                     \
    return static_cast<int>(launch_tc<R, M, N>(fr, win, bp, mp, o, rows, n_fft, k_pad,      \
                                               n_chunks, half_last, n_mels, mel_ld, amin, \
                                               smem, vec, st));
  FBANK_TILES(2, 1, 4)
  FBANK_TILES(5, 1, 4)
#undef FBANK_TILES
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
