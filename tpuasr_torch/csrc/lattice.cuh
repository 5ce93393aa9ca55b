// What the warp routes of the CTC and RNN-T lattices share (ctc_lattice.cu,
// rnnt_lattice.cu): -1e30 as -inf, the warp's shape and the single-MUFU
// exponential and logarithm of their log-adds. Each source is its own
// library, so the helpers sit in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxK = 8;  // values (states, columns) a lane holds on a warp route

constexpr float kLog2e = 1.44269504088896341f, kLn2 = 0.693147180559945309f;

// e^x and log2(x) in one MUFU instruction each (ex2 / lg2, results below
// 2^-126 flushed to 0: they add nothing to a sum that holds a 1)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}
__device__ __forceinline__ float lg2_fast(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
