// Mamba2 SSD (state-space duality) chunked scan from a zero state.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py (ssd -> _ssd_kernel);
// oracle ref.ssd_chunked.  For each (batch row b, head h), chunk by chunk of
// Q positions, with xb = x * dt, ld = dt * -exp(a_log[h]) and cum the
// inclusive prefix sum of ld inside the chunk:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xb_j      (intra-chunk)
//       + exp(cum_i) C_i . h                                   (carried state)
//       + d_skip[h] x_i
//   h   = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) B_j xb_j^T   (N x P, f32)
// The TPU kernel ran the chunks as the sequential axis of its grid with h in
// VMEM scratch.  Blocks of a Hopper grid run in parallel and in no order,
// so here the chunk loop runs inside the block and h stays in shared memory
// from the first chunk to the last.
//
// Bound on the card: at the serving chunk (32 tokens, 48 heads of 64, state
// 128) a launch reads and writes well under a megabyte, so its bytes take
// well under a microsecond and launch latency and the block's serial chunk
// steps dominate; at a 1024-token prompt the products (C.B^T and the state
// update, O(S Q N) per head) bound it, and they run in f32 on the CUDA cores
// here.  Design:
//   * one block per (16 columns of P, head, batch row): the P columns of h,
//     y and xb are independent, so a 64-wide head runs as 4 blocks and 48
//     heads give 192 blocks; each recomputes the shared Q x Q score C.B^T;
//   * the state dimension N is walked in tiles of 32: a tile of C and B is
//     staged in shared memory, adds its part to the score, to the
//     carried-state output (read from h before the tile's rows of h are
//     updated) and updates those rows of h;
//   * the chunk width Q is a run-time argument from 1 to 128 and sizes the
//     dynamic shared memory (about 23 KB at Q = 32, 117 KB at Q = 128 with
//     N = 128);
//   * the decay exp(cum_i - cum_j) is folded into the score once per chunk,
//     and the inner products accumulate with fmaf in f32 whatever the input
//     type; y is rounded once to the input type after d_skip x is added.
// Not done yet: tensor-core products (mma.sync / wgmma) for C.B^T, the
// state update and the carried-state term.
#include "common.cuh"

namespace {

constexpr int PB = 16;          // columns of P per block
constexpr int NT = 32;          // rows of the state per tile
constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kOwn = kMaxChunk * PB / kThreads;  // outputs per thread, at most

__host__ __device__ inline int pad_state(int n) { return (n + NT - 1) / NT * NT; }

__host__ inline size_t smem_bytes(int q, int n) {
  const size_t floats = (size_t)q * (q + 1)        // score
                        + 2 * (size_t)q * (NT + 1)  // C and B tiles
                        + (size_t)q * PB            // xb
                        + (size_t)pad_state(n) * PB // h
                        + 2 * (size_t)q;            // cum, exp(total - cum)
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           T* __restrict__ y, int S, int H, int P, int N, int Q) {
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int npad = pad_state(N);
  const int ld_g = Q + 1, ld_t = NT + 1;

  extern __shared__ float smem[];
  float* G = smem;                  // [Q][Q + 1] decay-weighted C.B^T
  float* Cs = G + Q * ld_g;         // [Q][NT + 1]
  float* Bs = Cs + Q * ld_t;        // [Q][NT + 1]
  float* xb = Bs + Q * ld_t;        // [Q][PB]
  float* hs = xb + Q * PB;          // [npad][PB] carried state (f32)
  float* cum = hs + npad * PB;      // [Q]
  float* dout = cum + Q;            // [Q] exp(cum_Q - cum_j)

  const float A = -expf(a_log[h]);
  const float dsk = d_skip == nullptr ? 0.f : d_skip[h];
  for (int i = tid; i < npad * PB; i += kThreads) hs[i] = 0.f;
  const int own = (Q * PB + kThreads - 1) / kThreads;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // xb = x dt and the log-decays of this chunk
    for (int idx = tid; idx < Q * PB; idx += kThreads) {
      const int i = idx / PB, p = idx % PB;
      const size_t row = ((size_t)b * S + c0 + i) * H + h;
      xb[idx] = rt::to_f32(x[row * P + p0 + p]) * rt::to_f32(dt[row]);
    }
    for (int i = tid; i < Q; i += kThreads)
      cum[i] = rt::to_f32(dt[((size_t)b * S + c0 + i) * H + h]) * A;
    for (int idx = tid; idx < Q * ld_g; idx += kThreads) G[idx] = 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum, one warp, 32 entries at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? cum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    const float keep = expf(total);
    for (int j = tid; j < Q; j += kThreads) dout[j] = expf(total - cum[j]);

    float yint[kOwn];
#pragma unroll
    for (int k = 0; k < kOwn; ++k) yint[k] = 0.f;

    for (int n0 = 0; n0 < npad; n0 += NT) {
      for (int idx = tid; idx < Q * NT; idx += kThreads) {
        const int i = idx / NT, nn = idx % NT, n = n0 + nn;
        const size_t off = ((size_t)b * S + c0 + i) * N + n;
        Cs[i * ld_t + nn] = n < N ? rt::to_f32(cm[off]) : 0.f;
        Bs[i * ld_t + nn] = n < N ? rt::to_f32(bm[off]) : 0.f;
      }
      __syncthreads();
      // score C.B^T (lower triangle) and the carried-state term C.h
      for (int idx = tid; idx < Q * Q; idx += kThreads) {
        const int i = idx / Q, j = idx % Q;
        if (j > i) continue;
        float s = 0.f;
#pragma unroll 8
        for (int nn = 0; nn < NT; ++nn) s = fmaf(Cs[i * ld_t + nn], Bs[j * ld_t + nn], s);
        G[i * ld_g + j] += s;
      }
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int idx = tid + k * kThreads;
        if (k < own && idx < Q * PB) {
          const int i = idx / PB, p = idx % PB;
          float s = yint[k];
#pragma unroll 8
          for (int nn = 0; nn < NT; ++nn) s = fmaf(Cs[i * ld_t + nn], hs[(n0 + nn) * PB + p], s);
          yint[k] = s;
        }
      }
      __syncthreads();
      // this tile's rows of h: decay the old state, add the chunk's inputs
      for (int idx = tid; idx < NT * PB; idx += kThreads) {
        const int nn = idx / PB, p = idx % PB;
        float s = 0.f;
        for (int j = 0; j < Q; ++j) s = fmaf(Bs[j * ld_t + nn] * dout[j], xb[j * PB + p], s);
        float* hp = hs + (n0 + nn) * PB + p;
        *hp = fmaf(keep, *hp, s);
      }
      __syncthreads();
    }

    // fold the decay into the score, then y
    for (int idx = tid; idx < Q * Q; idx += kThreads) {
      const int i = idx / Q, j = idx % Q;
      if (j <= i) G[i * ld_g + j] *= expf(cum[i] - cum[j]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int idx = tid + k * kThreads;
      if (k < own && idx < Q * PB) {
        const int i = idx / PB, p = idx % PB;
        float s = 0.f;
        for (int j = 0; j <= i; ++j) s = fmaf(G[i * ld_g + j], xb[j * PB + p], s);
        const size_t at = (((size_t)b * S + c0 + i) * H + h) * P + p0 + p;
        const float out = s + expf(cum[i]) * yint[k] + dsk * rt::to_f32(x[at]);
        y[at] = rt::from_f32<T>(out);
      }
    }
    __syncthreads();  // xb, cum and the score are rewritten by the next chunk
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* dt, const float* a_log,
                     const void* bm, const void* cm, const float* d_skip,
                     void* y, int B, int S, int H, int P, int N, int Q,
                     cudaStream_t st) {
  const size_t bytes = smem_bytes(Q, N);
  // set once per instance, to the most any valid launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxChunk, 512));
  if (attr != cudaSuccess) return attr;
  ssd_kernel<T><<<dim3(P / PB, H, B), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a_log,
      static_cast<const T*>(bm), static_cast<const T*>(cm), d_skip,
      static_cast<T*>(y), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), b/c (B,S,N), y (B,S,H,P): contiguous, one dtype.
// a_log (H,) and d_skip (H,) or null: float32.  P a multiple of 16, N at
// most 512, 1 <= chunk <= 128 dividing S.  Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a_log,
                               const void* b_mat, const void* c_mat,
                               const void* d_skip, void* y, int B, int S, int H,
                               int P, int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P % PB ||
      N <= 0 || N > 512 || chunk < 1 || chunk > kMaxChunk || S % chunk)
    return cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(x, dt, al, b_mat, c_mat, ds, y, B, S, H, P, N, chunk, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(x, dt, al, b_mat, c_mat, ds, y, B, S, H, P, N, chunk, st);
  return cudaErrorInvalidValue;
}
