// Shared device helpers for the port's attention kernels (Hopper, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked logits use a large finite negative value, as the reference does,
// so that fully masked rows never produce inf - inf.
constexpr float kNegInf = -1e30f;

// Element types the launchers accept (the Python wrappers pass the code).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N contiguous elements (N * sizeof(T) bytes, a power of two >= 4,
// aligned to its size) as float32 with the widest vector load that fits.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes >= 4 && (kBytes & (kBytes - 1)) == 0, "vector width");
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f32(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  } else {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  }
}

// Sum over groups of `width` neighbouring lanes (width a power of two <= 32).
template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// Merge the key splits of one output row (flash-decoding's second pass):
// block b of a 1-D grid owns row b of `out` (D wide); `ml` holds each
// split's (max, sum) and `part` its max-relative D-wide accumulator, split
// after split for each row.  D threads.
template <typename T, int D>
__global__ void __launch_bounds__(D)
combine_splits(const float* __restrict__ ml, const float* __restrict__ part,
               T* __restrict__ out, int splits) {
  const size_t row = blockIdx.x;
  const float* mlr = ml + row * splits * 2;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, mlr[2 * s]);
  float total = 0.f, L = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(mlr[2 * s] - M);
    L += mlr[2 * s + 1] * w;
    total += part[(row * splits + s) * D + threadIdx.x] * w;
  }
  out[row * D + threadIdx.x] = from_f32<T>(total / fmaxf(L, 1e-30f));
}

// Launch combine_splits over `rows` rows of d = 64, 128 or 256 columns.  A
// row whose every split is empty (max kNegInf, sum 0) weighs each at
// exp(0) = 1 against a sum of 0 and comes out as zeros.  Returns
// cudaGetLastError().
template <typename T>
cudaError_t launch_combine(const float* ml, const float* part, T* out, int rows, int splits,
                           int d, cudaStream_t st) {
  if (rows <= 0 || splits < 1) return cudaErrorInvalidValue;
  switch (d) {
    case 64: combine_splits<T, 64><<<rows, 64, 0, st>>>(ml, part, out, splits); break;
    case 128: combine_splits<T, 128><<<rows, 128, 0, st>>>(ml, part, out, splits); break;
    case 256: combine_splits<T, 256><<<rows, 256, 0, st>>>(ml, part, out, splits); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace rt
