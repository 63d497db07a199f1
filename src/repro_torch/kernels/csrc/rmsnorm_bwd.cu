// Backward of the (1 + scale) RMSNorm in the three forms the training path
// calls it in: the norm, the qk pair and the residual add with the next
// norm (rmsnorm.cu's kNorm, its two-segment launch, and kAdd).
//
// The TPU kernel repro/kernels/rmsnorm.py (rmsnorm -> _rmsnorm_kernel) has
// no backward: the JAX package differentiates its jnp norm.  The port's
// forward is the kernel of rmsnorm.cu, so its gradient is a kernel too.
// With w = 1 + scale and r = rsqrt(mean(x^2) + eps), recomputed from the
// saved input x (kAdd: the saved sum s = x + y):
//   dx     = r * (dy * w - x * r^2 * mean(dy * w * x))   (+ dres for kAdd:
//            the gradient of the sum output, so dx = dy_in = dres + dnorm)
//   dscale = sum over rows of dy * x * r, in float32.
// dx is computed in float32 and rounded once to x's type.  dscale is
// deterministic, without atomics: each block writes its rows' partial sum
// per column (norm_bwd_kernel) and a second kernel adds the blocks'
// partials in order (dscale_kernel).  The pair's two segments (q and k,
// each with its own gain) share one launch of each kernel.
//
// Bound on the card: bytes (x, dy and dres read once, dx written once;
// about ten operations an element).  A warp normalises a row of up to 1024
// elements, a block of 256 threads a wider one; every thread keeps its
// columns' values and partial dscale in registers across its rows.
#include "common.cuh"

namespace {

constexpr int NT = 256;

struct Seg {
  const void* x;     // rows of D (kAdd: the sum s)
  const void* dy;    // gradient of the normalised output
  const void* dres;  // kAdd: gradient of the sum output, else null
  const float* gain;
  void* dx;
  int rows;
};

// Sum of a value over a group of G threads (a warp, or the block when G is
// the block's size) into every thread of the group.
template <int G>
__device__ __forceinline__ float2 group_sum2(float2 v, float2* red) {
  v.x = rt::group_sum<32>(v.x);
  v.y = rt::group_sum<32>(v.y);
  if constexpr (G == 32) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    __syncthreads();  // red is free
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    float2 t = make_float2(0.f, 0.f);
    for (int w = 0; w < G / 32; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
    return t;
  }
}

// Groups of G threads, one row a group at a time; a thread owns columns
// lane + G k (k < KP).  Partials: (gridDim.x, 2, D) floats.
template <typename T, int G, int KP>
__global__ void __launch_bounds__(NT)
norm_bwd_kernel(Seg s0, Seg s1, int D, float eps, float* __restrict__ partial) {
  extern __shared__ float acc_s[];  // (groups, D) partial sums
  __shared__ float2 red[NT / 32];
  constexpr int groups = NT / G;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const float invD = 1.f / D;
  for (int seg = 0; seg < 2; ++seg) {
    // the segment's fields, chosen one by one (a reference to a parameter
    // struct would put both structs in local memory)
    const int rows = seg ? s1.rows : s0.rows;
    const T* xs = static_cast<const T*>(seg ? s1.x : s0.x);
    const T* dys = static_cast<const T*>(seg ? s1.dy : s0.dy);
    const T* dres = static_cast<const T*>(seg ? s1.dres : s0.dres);
    const float* gain = seg ? s1.gain : s0.gain;
    T* dxs = static_cast<T*>(seg ? s1.dx : s0.dx);
    float acc[KP], w[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int c = lane + G * k;
      acc[k] = 0.f;
      w[k] = c < D && rows > 0 ? 1.f + gain[c] : 0.f;
    }
    // every group runs the same number of iterations (the block sums)
    const int stride = gridDim.x * groups;
    for (int base = blockIdx.x * groups; base < rows; base += stride) {
      const int row = base + grp;
      const bool live = row < rows;
      const T* x = xs + (size_t)row * D;
      const T* dy = dys + (size_t)row * D;
      float xv[KP], gv[KP];
      float2 sums = make_float2(0.f, 0.f);  // (sum x^2, sum dy w x)
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int c = lane + G * k;
        const bool ok = live && c < D;
        xv[k] = ok ? rt::to_f32(x[c]) : 0.f;
        gv[k] = ok ? rt::to_f32(dy[c]) : 0.f;
        sums.x = fmaf(xv[k], xv[k], sums.x);
        sums.y = fmaf(gv[k] * w[k], xv[k], sums.y);
      }
      sums = group_sum2<G>(sums, red);
      const float r = rsqrtf(sums.x * invD + eps);
      const float coef = r * r * sums.y * invD;
      if (!live) continue;
      T* dx = dxs + (size_t)row * D;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int c = lane + G * k;
        if (c >= D) continue;
        float g = r * (gv[k] * w[k] - xv[k] * coef);
        if (dres != nullptr) g += rt::to_f32(dres[(size_t)row * D + c]);
        dx[c] = rt::from_f32<T>(g);
        acc[k] = fmaf(gv[k], xv[k] * r, acc[k]);
      }
    }
    // the groups' partials, added in group order
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int c = lane + G * k;
      if (c < D) acc_s[grp * D + c] = acc[k];
    }
    __syncthreads();
    float* out = partial + ((size_t)blockIdx.x * 2 + seg) * D;
    for (int c = threadIdx.x; c < D; c += NT) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += acc_s[g * D + c];
      out[c] = t;
    }
    __syncthreads();
  }
}

// dscale of each segment: the blocks' partials of a column, in block order.
__global__ void __launch_bounds__(NT)
dscale_kernel(const float* __restrict__ partial, int blocks, int D, float* __restrict__ dg0,
              float* __restrict__ dg1) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= 2 * D) return;
  const int seg = idx / D, c = idx % D;
  float* dst = seg ? dg1 : dg0;
  if (dst == nullptr) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += partial[((size_t)b * 2 + seg) * D + c];
  dst[c] = t;
}

template <typename T, int G, int KP>
cudaError_t launch_k(const Seg& s0, const Seg& s1, int D, float eps, float* partial, int blocks,
                     cudaStream_t st) {
  const size_t smem = (size_t)(NT / G) * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_bwd_kernel<T, G, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  norm_bwd_kernel<T, G, KP><<<blocks, NT, smem, st>>>(s0, s1, D, eps, partial);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Seg& s0, const Seg& s1, int D, float eps, float* partial, int blocks,
                     cudaStream_t st) {
  cudaError_t e;
  if (D <= 32 * 4) e = launch_k<T, 32, 4>(s0, s1, D, eps, partial, blocks, st);
  else if (D <= 32 * 8) e = launch_k<T, 32, 8>(s0, s1, D, eps, partial, blocks, st);
  else if (D <= 32 * 32) e = launch_k<T, 32, 32>(s0, s1, D, eps, partial, blocks, st);
  else if (D <= NT * 16) e = launch_k<T, NT, 16>(s0, s1, D, eps, partial, blocks, st);
  else e = launch_k<T, NT, 32>(s0, s1, D, eps, partial, blocks, st);
  return e;
}

}  // namespace

// Segment 0: x0 (rows0, D) (kAdd: the saved sum), dy0, dres0 (null unless
// the add form), gain0, dx0 out; segment 1 (rows1 > 0: the pair's k): x1,
// dy1, gain1, dx1.  All rows contiguous, one dtype, D <= 8192.  The first
// kernel runs `blocks` blocks of 256 threads (groups of 32 threads a row
// for D <= 1024, else the whole block), each striding over both segments'
// rows; partial: blocks * 2 * D floats of scratch.  dgain0/dgain1: (D,)
// f32 out (dgain1 null without segment 1).  Two launches.  Returns
// cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(int dtype, int D, float eps, const void* x0, const void* dy0,
                                  const void* dres0, const void* gain0, void* dx0, int rows0,
                                  const void* x1, const void* dy1, const void* gain1, void* dx1,
                                  int rows1, float* partial, int blocks, float* dgain0,
                                  float* dgain1, void* stream) {
  if (D <= 0 || D > NT * 32 || rows0 < 0 || rows1 < 0 || blocks <= 0 || partial == nullptr ||
      dgain0 == nullptr || (rows1 > 0 && dgain1 == nullptr))
    return cudaErrorInvalidValue;
  const Seg s0{x0, dy0, dres0, static_cast<const float*>(gain0), dx0, rows0};
  const Seg s1{x1, dy1, nullptr, static_cast<const float*>(gain1), dx1, rows1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rt::kFloat32) e = launch_t<float>(s0, s1, D, eps, partial, blocks, st);
  else if (dtype == rt::kBFloat16) e = launch_t<__nv_bfloat16>(s0, s1, D, eps, partial, blocks, st);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  dscale_kernel<<<(2 * D + NT - 1) / NT, NT, 0, st>>>(partial, blocks, D, dgain0,
                                                       rows1 > 0 ? dgain1 : nullptr);
  return cudaGetLastError();
}
