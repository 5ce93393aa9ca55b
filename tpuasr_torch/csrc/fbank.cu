// Log-mel fbank over framed audio, one pass per tile of frames: two routes.
//
// Replaces the TPU kernel `_fbank_kernel` / `fbank_frames_pallas`
// (tpuasr/ops/fbank_pallas.py:25-88): window multiply, real DFT as two
// products against the cos/sin basis, power, mel product and
// 10*log10(max(., amin)). The [R, n_freq] spectrum never reaches device
// memory on either route.
//
// "highest" (fp32, `fbank_kernel`): exact fp32 products with no TF32, so on
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
// mel [n_freq, n_mels] -> out [rows, n_mels]; all fp32, contiguous.
// bf16_operands = 0: "highest" (every argument after it but the stream
// unused). Else "default", laid out by `_fbank_plan` (ops/fbank.py), which
// owns the packed layout: basis and melp are its scratch parts ([n_chunks]
// [k_pad][64] and [32 n_chunks][mel_ld] bf16, written here by the pack), K
// padded to k_pad, bins to n_chunks chunks (half_last: the last one's second
// 16 bins skipped), mel columns to mel_ld (slabs of 80), a block smem bytes
// of shared memory and warps_m x warps_n warps, each over 16 x row_groups
// frames and 4 / warps_n of a chunk's 4 bin groups. The entry checks the
// layout against the shape and the shared memory against the card's limit.
int fbank_logmel(const void* frames, const void* window, const void* cosb, const void* sinb,
                 const void* mel, void* out, void* basis, void* melp, int rows, int n_fft,
                 int n_freq, int n_mels, float amin, int bf16_operands, int k_pad, int n_chunks,
                 int half_last, int mel_ld, int smem, int row_groups, int warps_m, int warps_n,
                 void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(frames), *win = static_cast<const float*>(window),
              *cb = static_cast<const float*>(cosb), *sb = static_cast<const float*>(sinb),
              *ml = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  if (!bf16_operands)
    return static_cast<int>(launch_fp32(fr, win, cb, sb, ml, o, rows, n_fft, n_freq, n_mels,
                                        amin, st));

  if (k_pad % kKT || k_pad < n_fft || n_chunks * kNB < n_freq || mel_ld % kMW ||
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
