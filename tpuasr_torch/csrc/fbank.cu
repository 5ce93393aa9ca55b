// Log-mel fbank over framed audio, one pass per tile of frames.
//
// Replaces the TPU kernel `_fbank_kernel` / `fbank_frames_pallas`
// (tpuasr/ops/fbank_pallas.py:25-88): window multiply, real DFT as two
// products against the cos/sin basis, power, mel product and
// 10*log10(max(., amin)).
//
// What bounds it on an H100: operations. Each frame costs
// 2 * 2 * n_fft * n_freq (DFT) + 2 * n_freq * n_mels (mel) flops, about
// 2.2 MFLOP at n_fft 1024, against 4 KB of frame read and 320 B of output, so
// the work sits far above the card's bytes-to-flops line. "highest" runs
// in fp32 on the CUDA cores (67 TFLOP/s peak), not on the tensor cores,
// because the contract is exact fp32 with no TF32.
//
// Design: one block per tile of kTR frames. The block stages its windowed
// frames in shared memory transposed ([n][frame], so one float4 load
// broadcasts four frames to every thread), then each thread owns one
// frequency bin and accumulates re/im for all kTR frames while streaming
// its cos/sin column (neighbouring threads read neighbouring bins:
// coalesced, and the basis stays in L2 across blocks). The power spectrum of
// the tile lives only in shared memory ([kTR][n_freq]); the mel product and
// the log read it from there, so the [R, n_freq] spectrum never reaches
// device memory. With bf16_operands (precision "default") each product's
// operands are rounded to bf16 first and accumulated in fp32, as the TPU's
// single bf16 pass does. An FFT formulation (O(n log n) per frame) is a
// later redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTR = 16;           // frames per block
constexpr int kMaxThreads = 576;  // one bin per thread up to n_fft 1150

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
fbank_kernel(const float* __restrict__ frames, const float* __restrict__ window,
             const float* __restrict__ cosb, const float* __restrict__ sinb,
             const float* __restrict__ mel, float* __restrict__ out, int rows,
             int n_fft, int n_freq, int n_mels, float amin) {
  extern __shared__ float4 smem4[];
  float* fw = reinterpret_cast<float*>(smem4);  // [n_fft][kTR]
  float* spec = fw + (size_t)n_fft * kTR;       // [kTR][n_freq]
  const int r0 = blockIdx.x * kTR;

  for (int i = threadIdx.x; i < kTR * n_fft; i += blockDim.x) {
    const int r = i / n_fft, n = i - r * n_fft;
    float x = 0.f;
    if (r0 + r < rows) x = frames[(size_t)(r0 + r) * n_fft + n] * window[n];
    fw[n * kTR + r] = kBf16 ? round_bf16(x) : x;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freq; f += blockDim.x) {
    float re[kTR], im[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) re[r] = im[r] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      float c = cosb[(size_t)n * n_freq + f];
      float s = sinb[(size_t)n * n_freq + f];
      if (kBf16) {
        c = round_bf16(c);
        s = round_bf16(s);
      }
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
    for (int r = 0; r < kTR; ++r) {
      const float p = re[r] * re[r] + im[r] * im[r];
      spec[r * n_freq + f] = kBf16 ? round_bf16(p) : p;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTR * n_mels; i += blockDim.x) {
    const int r = i / n_mels, m = i - r * n_mels;
    if (r0 + r >= rows) continue;
    const float* sp = spec + r * n_freq;
    float acc = 0.f;
    for (int f = 0; f < n_freq; ++f) {
      const float w = mel[(size_t)f * n_mels + m];
      acc = fmaf(sp[f], kBf16 ? round_bf16(w) : w, acc);
    }
    out[(size_t)(r0 + r) * n_mels + m] = 10.f * log10f(fmaxf(acc, amin));
  }
}

template <bool kBf16>
cudaError_t launch(const float* frames, const float* window, const float* cosb,
                   const float* sinb, const float* mel, float* out, int rows,
                   int n_fft, int n_freq, int n_mels, float amin,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)n_fft * kTR + (size_t)kTR * n_freq);
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_freq + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int blocks = (rows + kTR - 1) / kTR;
  fbank_kernel<kBf16><<<blocks, threads, smem, stream>>>(
      frames, window, cosb, sinb, mel, out, rows, n_fft, n_freq, n_mels, amin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpuasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames [rows, n_fft], window [n_fft], cos/sin [n_fft, n_freq],
// mel [n_freq, n_mels] -> out [rows, n_mels]; all fp32, contiguous.
int fbank_logmel(const void* frames, const void* window, const void* cosb,
                 const void* sinb, const void* mel, void* out, int rows,
                 int n_fft, int n_freq, int n_mels, float amin,
                 int bf16_operands, void* stream) {
  if (rows == 0) return 0;
  auto f = bf16_operands ? launch<true> : launch<false>;
  return static_cast<int>(f(
      static_cast<const float*>(frames), static_cast<const float*>(window),
      static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<const float*>(mel), static_cast<float*>(out), rows, n_fft,
      n_freq, n_mels, amin, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
