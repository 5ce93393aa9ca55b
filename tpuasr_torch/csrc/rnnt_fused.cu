// Fused RNN-T joint: tanh(enc_p[t] + pred_p[u]) @ W + b, log-softmax and the
// blank / label log-probs (forward), and the joint's gradients (backward),
// without the [B, T, U+1, V] logits ever reaching device memory.
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
// does three such products (logits again, dX.W^T, a^T.dX), 47.9 GFLOP,
// 0.71 ms. The exp of every logit (31 M) comes on top. No tensor cores yet:
// the contract is fp32; TF32 or bf16 wgmma tiles are a later PR's work.
//
// Forward design: one block of 256 threads per (utterance, tile of 64 rows).
// The block writes tanh(enc + pred) for its rows into shared memory once,
// then walks the vocabulary in tiles of 64 columns: W arrives in chunks of
// 32 x 64 through shared memory, each thread accumulates a 4 x 4 block of
// logits in registers, and an online logsumexp (running max and sum per row,
// reduced across the 16 threads of a row with warp shuffles) folds each
// tile in. The blank column and the row's label column are picked as they
// pass; the label id is read directly (the TPU kernel builds a one-hot
// matrix, :147-149), an id outside [0, V) gives logit 0 as that one-hot
// does, and padded vocab columns never enter the sum. The outputs are
// blank_lp, label_lp and the row's logsumexp, [B, T, U1] each: the backward
// reads the logsumexp instead of running a first pass over V again.
//
// Backward design: the TPU kernel sums d_pred, dW and db across a grid that
// runs in order. Hopper blocks run in no order, so each block owns one tile
// of 64 vocabulary columns and one chunk of frames of one utterance (all u),
// keeps W's 64 columns in shared memory for its whole life, and walks its
// rows 32 at a time: logits for its 64 columns, softmax from the saved
// logsumexp, dX = gb*1[blank] + gl*1[label] - softmax*(gb + gl), its share
// of da = dX.W^T and of djoined = da*(1 - a^2) (summed over u and over t in
// shared memory with shared atomics), and its share of dW = a^T.dX in
// registers (one row of dW per thread) and of db. At the end it adds d_enc,
// d_pred, dW and db into the zeroed outputs with fp32 atomics in global
// memory. The order of those additions changes from run to run, so results
// agree with a fixed-order sum to fp32 rounding of the partial sums (a
// relative 1e-6 or so), not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// forward
constexpr int kR = 64;   // rows per block
constexpr int kVT = 64;  // vocabulary columns per tile
constexpr int kKC = 32;  // depth of a W chunk
// backward
constexpr int kRS = 32;          // rows per sub-tile
constexpr int kMaxD = 256;       // one dW row per thread
constexpr int kRowsPerBlock = 512;
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

struct BwdLayout {
  int tt;          // frames per block
  size_t wt, a, dx, denc, dpred, total;  // float offsets and the byte total
};

__host__ __device__ inline size_t round4(size_t x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline BwdLayout bwd_layout(int tt, int U1, int D) {
  BwdLayout L;
  L.tt = tt;
  L.wt = 0;                                       // [D][kVT + 1] W columns
  L.a = round4(L.wt + (size_t)D * (kVT + 1));     // [kRS][D + 1] tanh(enc + pred)
  L.dx = round4(L.a + (size_t)kRS * (D + 1));     // [kRS][kVT] dX, float4 rows
  L.denc = round4(L.dx + (size_t)kRS * kVT);      // [tt][D]
  L.dpred = L.denc + (size_t)tt * D;              // [U1][D]
  L.total = (L.dpred + (size_t)U1 * D) * sizeof(float);
  return L;
}

__global__ void __launch_bounds__(kThreads)
rnnt_bwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred,
                const float* __restrict__ w, const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ gb, const float* __restrict__ gl,
                float* __restrict__ d_enc, float* __restrict__ d_pred,
                float* __restrict__ dw, float* __restrict__ db, int T, int U1, int D,
                int V, int blank, int tt) {
  extern __shared__ float smem[];
  const BwdLayout L = bwd_layout(tt, U1, D);
  float* Wt = smem + L.wt;
  float* A = smem + L.a;
  float* dX = smem + L.dx;
  float* denc = smem + L.denc;
  float* dpred = smem + L.dpred;
  __shared__ float row_lse[kRS], row_gb[kRS], row_gl[kRS];
  __shared__ int row_lab[kRS], row_ok[kRS];

  const int v0 = blockIdx.x * kVT;
  const int t0 = blockIdx.y * tt;
  const int b = blockIdx.z;
  const int nt = min(tt, T - t0);
  const int rows = nt * U1;
  const int N = T * U1;
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;

  for (int i = tid; i < D * kVT; i += kThreads) {
    const int d = i / kVT, c = i - d * kVT;
    Wt[d * (kVT + 1) + c] = v0 + c < V ? w[(size_t)d * V + v0 + c] : 0.f;
  }
  for (int i = tid; i < (tt + U1) * D; i += kThreads) denc[i] = 0.f;  // denc, dpred adjoin

  float acc_w[kVT];
#pragma unroll
  for (int c = 0; c < kVT; ++c) acc_w[c] = 0.f;
  float acc_b = 0.f;

  for (int rs0 = 0; rs0 < rows; rs0 += kRS) {
    __syncthreads();  // the previous sub-tile's A and dX are consumed
    for (int i = tid; i < kRS * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int nl = rs0 + r;
      float a = 0.f;
      if (nl < rows) {
        const int t = t0 + nl / U1, u = nl % U1;
        a = tanhf(enc[((size_t)b * T + t) * D + d] + pred[((size_t)b * U1 + u) * D + d]);
      }
      A[r * (D + 1) + d] = a;
    }
    for (int r = tid; r < kRS; r += kThreads) {
      const int nl = rs0 + r;
      const bool ok = nl < rows;
      const size_t o = (size_t)b * N + (size_t)t0 * U1 + nl;
      row_ok[r] = ok;
      row_lse[r] = ok ? lse[o] : 0.f;
      row_gb[r] = ok ? gb[o] : 0.f;
      row_gl[r] = ok ? gl[o] : 0.f;
      row_lab[r] = ok ? label_of(labels, b, nl % U1, U1, blank) : -1;
    }
    __syncthreads();

    // logits of 4 rows x 2 columns per thread, then dX into shared memory
    float acc[4][2] = {};
    for (int k = 0; k < D; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty + 8 * i) * (D + 1) + k];
      const float x0 = Wt[k * (kVT + 1) + tx], x1 = Wt[k * (kVT + 1) + tx + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i], x0, acc[i][0]);
        acc[i][1] = fmaf(a[i], x1, acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 32 * j, col = v0 + c;
        float dx = 0.f;
        if (row_ok[r] && col < V) {
          const float sm = expf(acc[i][j] + bias[col] - row_lse[r]);
          dx = -sm * (row_gb[r] + row_gl[r]);
          if (col == blank) dx += row_gb[r];
          if (col == row_lab[r]) dx += row_gl[r];
        }
        dX[r * kVT + c] = dx;
      }
    }
    __syncthreads();

    // da = dX . W^T (this tile's columns) -> djoined = da * (1 - a^2),
    // summed over u into denc[t] and over t into dpred[u]
    float da[4][kMaxD / 32] = {};
    for (int c = 0; c < kVT; ++c) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = dX[(ty + 8 * i) * kVT + c];
#pragma unroll
      for (int mm = 0; mm < kMaxD / 32; ++mm) {
        const int d = tx + 32 * mm;
        const float wv = d < D ? Wt[d * (kVT + 1) + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i][mm] = fmaf(x[i], wv, da[i][mm]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      if (!row_ok[r]) continue;
      const int nl = rs0 + r;
      const int tl = nl / U1, u = nl % U1;
#pragma unroll
      for (int mm = 0; mm < kMaxD / 32; ++mm) {
        const int d = tx + 32 * mm;
        if (d < D) {
          const float a = A[r * (D + 1) + d];
          const float dj = da[i][mm] * (1.f - a * a);
          atomicAdd(&denc[tl * D + d], dj);
          atomicAdd(&dpred[u * D + d], dj);
        }
      }
    }

    // dW[d, v0:v0+64] += a[:, d]^T . dX, one row d per thread; db
    if (tid < D) {
      const float4* dx4 = reinterpret_cast<const float4*>(dX);
      for (int r = 0; r < kRS; ++r) {
        const float a = A[r * (D + 1) + tid];
#pragma unroll
        for (int q = 0; q < kVT / 4; ++q) {
          const float4 x = dx4[r * (kVT / 4) + q];
          acc_w[4 * q + 0] = fmaf(a, x.x, acc_w[4 * q + 0]);
          acc_w[4 * q + 1] = fmaf(a, x.y, acc_w[4 * q + 1]);
          acc_w[4 * q + 2] = fmaf(a, x.z, acc_w[4 * q + 2]);
          acc_w[4 * q + 3] = fmaf(a, x.w, acc_w[4 * q + 3]);
        }
      }
    }
    if (tid < kVT)
      for (int r = 0; r < kRS; ++r) acc_b += dX[r * kVT + tid];
  }
  __syncthreads();

  if (tid < D) {
#pragma unroll
    for (int c = 0; c < kVT; ++c)
      if (v0 + c < V) atomicAdd(&dw[(size_t)tid * V + v0 + c], acc_w[c]);
  }
  if (tid < kVT && v0 + tid < V) atomicAdd(&db[v0 + tid], acc_b);
  for (int i = tid; i < nt * D; i += kThreads)
    atomicAdd(&d_enc[((size_t)b * T + t0) * D + i], denc[i]);
  for (int i = tid; i < U1 * D; i += kThreads)
    atomicAdd(&d_pred[(size_t)b * U1 * D + i], dpred[i]);
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
// d_pred [B, U1, D], dw [D, V], db [V], which must be zeroed: the kernel adds
// into them. D <= 256.
int rnnt_fused_bwd(const void* enc, const void* pred, const void* w, const void* bias,
                   const void* labels, const void* lse, const void* gb, const void* gl,
                   void* d_enc, void* d_pred, void* dw, void* db, int B, int T, int U1,
                   int D, int V, int blank, void* stream) {
  if (B == 0 || T == 0 || U1 == 0) return 0;
  if (D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int tt = kRowsPerBlock / U1;
  if (tt < 1) tt = 1;
  if (tt > T) tt = T;
  while (tt > 1 && bwd_layout(tt, U1, D).total > kMaxSmem) --tt;
  const size_t smem = bwd_layout(tt, U1, D).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rnnt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + kVT - 1) / kVT, (T + tt - 1) / tt, B);
  rnnt_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(pred),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(gb), static_cast<const float*>(gl),
      static_cast<float*>(d_enc), static_cast<float*>(d_pred), static_cast<float*>(dw),
      static_cast<float*>(db), T, U1, D, V, blank, tt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
