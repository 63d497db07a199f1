// RG-LRU linear recurrence (Griffin) from a zero state.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py (rglru ->
// _rglru_kernel); oracle ref.rglru_chunked.  Per channel d:
//   a_t = exp(log_a_t),  b_t = sqrt(max(1 - exp(2 log_a_t), 0)) gate_t x_t,
//   h_t = a_t h_{t-1} + b_t,  h_0 = 0,  y_t = h_t rounded to x's type,
// with a and b computed in f32 from the (bf16) inputs inside the kernel.
//
// Bound on the card: bytes (three inputs read once, one output written,
// about ten operations per element).  The channels are independent and
// there is no matrix product, so the work is a scan along time.  The TPU
// kernel's doubling scan and its chunk / block_d padding fed the TPU's
// vector unit; here:
//   * a block owns 32 neighbouring channels (one per lane: a warp's loads of
//     one time step are one contiguous run) and cuts time into 8 segments,
//     one per warp, so a 1024-token prompt is 8 chains of 128 steps, not
//     one of 1024, and 4096 channels give 128 blocks of 8 warps;
//   * pass 1: each warp scans its segment from h = 0 and keeps only the
//     segment's end state and decay product; the block combines those in
//     shared memory into each segment's incoming state; pass 2: each warp
//     rescans its segment from that state and writes h (the inputs come
//     from L2 the second time);
//   * each warp loads 8 time steps of its inputs before using them, to keep
//     loads in flight along the dependent chain.
#include "common.cuh"

namespace {

constexpr int kSegs = 8;    // warps per block = time segments
constexpr int kUnroll = 8;  // time steps loaded ahead

template <typename T>
__device__ __forceinline__ void terms(const T* __restrict__ x, const T* __restrict__ la,
                                      const T* __restrict__ g, size_t off, float& a,
                                      float& bx) {
  const float l = rt::to_f32(la[off]);
  a = expf(l);
  const float beta = sqrtf(fmaxf(1.f - expf(2.f * l), 0.f));
  bx = beta * rt::to_f32(g[off]) * rt::to_f32(x[off]);
}

template <typename T>
__global__ void __launch_bounds__(kSegs * 32)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ log_a,
             const T* __restrict__ gate, T* __restrict__ y, int S, int D) {
  const int lane = threadIdx.x % 32, seg = threadIdx.x / 32;
  const int d = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const int per = (S + kSegs - 1) / kSegs;
  const int t_lo = min(S, seg * per), t_hi = min(S, t_lo + per);
  const bool live = d < D;
  const size_t base = (size_t)b * S * D + d;

  // pass 1: this segment's decay product and end state from h = 0
  float prod = 1.f, h = 0.f;
  if (live) {
    for (int t0 = t_lo; t0 < t_hi; t0 += kUnroll) {
      float a[kUnroll], bx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u < t_hi) terms(x, log_a, gate, base + (size_t)(t0 + u) * D, a[u], bx[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u < t_hi) {
          h = a[u] * h + bx[u];
          prod *= a[u];
        }
    }
  }
  __shared__ float s_prod[kSegs][32], s_end[kSegs][32];
  s_prod[seg][lane] = prod;
  s_end[seg][lane] = h;
  __syncthreads();
  h = 0.f;  // incoming state of this segment
  for (int s = 0; s < seg; ++s) h = s_prod[s][lane] * h + s_end[s][lane];
  if (!live) return;

  // pass 2: rescan from the incoming state and write every h_t
  for (int t0 = t_lo; t0 < t_hi; t0 += kUnroll) {
    float a[kUnroll], bx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < t_hi) terms(x, log_a, gate, base + (size_t)(t0 + u) * D, a[u], bx[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < t_hi) {
        h = a[u] * h + bx[u];
        y[base + (size_t)(t0 + u) * D] = rt::from_f32<T>(h);
      }
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* la, const void* g, void* y, int B,
                     int S, int D, cudaStream_t st) {
  rglru_kernel<T><<<dim3((D + 31) / 32, B), kSegs * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(la), static_cast<const T*>(g),
      static_cast<T*>(y), S, D);
  return cudaGetLastError();
}

}  // namespace

// x, log_a, gate, y: (B,S,D) contiguous, one dtype.  Returns
// cudaGetLastError().
extern "C" int rglru_scan_launch(const void* x, const void* log_a, const void* gate,
                                 void* y, int B, int S, int D, int dtype,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch_t<float>(x, log_a, gate, y, B, S, D, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(x, log_a, gate, y, B, S, D, st);
  return cudaErrorInvalidValue;
}
