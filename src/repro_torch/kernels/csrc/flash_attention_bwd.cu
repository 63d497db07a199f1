// Backward of the fused attention with position masks: dQ, dK and dV.
//
// The TPU kernel repro/kernels/flash_attention.py (flash_attention ->
// _flash_kernel) has no backward of its own: the JAX package differentiates
// its jnp path.  The port's forward is the Hopper kernel of
// flash_attention.cu, so its gradient needs this kernel, the half of the
// kernel that jax.grad gives the reference for free.  Same masks as the
// forward: key j is visible to query i when k_pos[b,j] >= 0, and
// k_pos <= q_pos when causal, and k_pos > q_pos - window.  No softcap, D 64
// and 128 (the wrapper refuses the rest).
//
// FlashAttention-2's recompute from the forward's log-sum-exp, in float32
// for bf16 and f32 inputs alike:
//   delta_i = rowsum(dO_i * O_i)                       (flash_bwd_delta)
//   P = exp(S * scale - lse),  dP = dO V^T,  dS = P * (dP - delta)
//   dV = P^T dO,  dK = dS^T Q * scale                  (flash_bwd_dkdv)
//   dQ = dS K * scale                                  (flash_bwd_dq)
// Deterministic, no float atomics: a dK/dV block owns one key tile of one
// KV head and walks every query tile of every query head of its GQA group,
// so the group's sum is taken in order inside the block; a dQ block owns
// one query tile of one head and walks the key tiles.  A tile pair that no
// (query, key) of it can see, by the positions, is skipped.
//
// Bound on the card: operations (about 8 S T D multiply-adds per head over
// the visible pairs, two recomputed score products in each kernel).  This
// first kernel runs them on the CUDA cores in f32 (64 x 64 tiles in shared
// memory, a 4 x 4 register tile of scores a thread); the tensor cores
// (mma.sync/wgmma) are ROADMAP work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BKV = 64;     // keys per tile
constexpr int NT = 256;     // threads per block
constexpr int LDP = BKV + 1;

template <int D>
struct Layout {  // shared memory, in floats (ints after)
  static constexpr int LD = D + 1;
  static constexpr int q = 0;
  static constexpr int dout = q + BQ * LD;
  static constexpr int k = dout + BQ * LD;
  static constexpr int v = k + BKV * LD;
  static constexpr int p = v + BKV * LD;
  static constexpr int ds = p + BQ * LDP;
  static constexpr int lse = ds + BQ * LDP;
  static constexpr int delta = lse + BQ;
  static constexpr int qpos = delta + BQ;  // int
  static constexpr int kpos = qpos + BQ;   // int
  static constexpr size_t bytes = (size_t)(kpos + BKV) * 4;
  static_assert(bytes <= 232448, "flash backward block within 227 KB");
};

__device__ __forceinline__ bool visible(int p, int qp, int causal, int window) {
  return p >= 0 && (!causal || p <= qp) && (window <= 0 || p > qp - window);
}

// rows x D elements of T at src (row r at src + r * stride) into the f32
// shared tile dst (row length LD); rows >= nrows are zero.  16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t stride,
                                          int nrows, int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x * V; idx < rows * D; idx += NT * V) {
    const int r = idx / D, d = idx % D;
    float x[V];
    if (r < nrows) {
      rt::load_f32<T, V>(src + r * stride + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * LD + d + e] = x[e];
  }
}

// f32 shared tile (row length D + 1) to rows of T at dst, times mult.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const float* src, size_t stride,
                                           int nrows, float mult) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < nrows * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * stride + d] = rt::from_f32<T>(src[r * LD + d] * mult);
  }
}

// min and max of the live entries of n positions in shared memory (live:
// >= 0 for keys, any for queries); empty -> (INT_MAX, INT_MIN).
__device__ __forceinline__ void pos_range(const int* p, int n, bool keys, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = 0; i < n; ++i) {
    const int x = p[i];
    if (keys && x < 0) continue;
    lo = min(lo, x);
    hi = max(hi, x);
  }
}

// Whether some query in [qlo, qhi] can see some key in [klo, khi].
__device__ __forceinline__ bool tiles_meet(int qlo, int qhi, int klo, int khi, int causal,
                                           int window) {
  if (klo > khi || qlo > qhi) return false;
  return (!causal || klo <= qhi) && (window <= 0 || khi > qlo - window);
}

// The warp-synchronous score tile: rows tr + 16 i and keys tc + 16 j of the
// shared Q/dO and K/V tiles; S = Q K^T and dP = dO V^T, 4 x 4 per thread.
template <int D>
__device__ __forceinline__ void scores(const float* sm, int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qd[4], od[4], kd[4], vd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qd[i] = sm[L::q + (tr + 16 * i) * LD + d];
      od[i] = sm[L::dout + (tr + 16 * i) * LD + d];
      kd[i] = sm[L::k + (tc + 16 * i) * LD + d];
      vd[i] = sm[L::v + (tc + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
        dp[i][j] = fmaf(od[i], vd[j], dp[i][j]);
      }
  }
}

// P and dS of the tile into shared memory (P only where want_p).
template <int D>
__device__ __forceinline__ void probs(float* sm, int q0, int k0, int S, int T, int causal,
                                      int window, float scale, bool want_p) {
  using L = Layout<D>;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int* qps = reinterpret_cast<const int*>(sm + L::qpos);
  const int* kps = reinterpret_cast<const int*>(sm + L::kpos);
  float s[4][4], dp[4][4];
  scores<D>(sm, tr, tc, s, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const float lse = sm[L::lse + r], dl = sm[L::delta + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const bool vis = q0 + r < S && k0 + c < T && visible(kps[c], qps[r], causal, window);
      const float p = vis ? expf(fmaf(s[i][j], scale, -lse)) : 0.f;
      if (want_p) sm[L::p + r * LDP + c] = p;
      sm[L::ds + r * LDP + c] = p * (dp[i][j] - dl);
    }
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
                int B, int S, int hq, int D) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * S * hq) return;  // whole warps leave together
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(rt::to_f32(o[d]), rt::to_f32(g[d]), acc);
  acc = rt::group_sum<32>(acc);
  if (lane == 0) {
    const int h = row % hq;
    const long long bi = row / hq;  // b * S + i
    const int i = bi % S, b = bi / S;
    delta[((size_t)b * hq + h) * S + i] = acc;
  }
}

// Loads of one (query tile, head) into shared memory: Q, dO, lse, delta,
// the query positions.
template <typename T, int D>
__device__ __forceinline__ void load_queries(float* sm, const T* q, const T* dout,
                                             const float* lse, const float* delta, const int* qp,
                                             int b, int h, int q0, int S, int hq) {
  using L = Layout<D>;
  const int nq = min(BQ, S - q0);
  const size_t base = (((size_t)b * S + q0) * hq + h) * D;
  load_tile<T, D>(sm + L::q, q + base, (size_t)hq * D, nq, BQ);
  load_tile<T, D>(sm + L::dout, dout + base, (size_t)hq * D, nq, BQ);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool ok = r < nq;
    const size_t at = ((size_t)b * hq + h) * S + q0 + r;
    sm[L::lse + r] = ok ? lse[at] : 0.f;
    sm[L::delta + r] = ok ? delta[at] : 0.f;
    reinterpret_cast<int*>(sm + L::qpos)[r] = ok ? qp[(size_t)b * S + q0 + r] : 0;
  }
}

// dK, dV of one key tile of KV head kh, batch row b: block (key tile, kh, b).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, const int* __restrict__ q_pos,
               const int* __restrict__ k_pos, T* __restrict__ dk, T* __restrict__ dv, int S,
               int T_, int hq, int hkv, int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD, E = D / 16;
  extern __shared__ float sm[];
  int* qps = reinterpret_cast<int*>(sm + L::qpos);
  int* kps = reinterpret_cast<int*>(sm + L::kpos);
  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv, nk = min(BKV, T_ - k0);
  const size_t kbase = (((size_t)b * T_ + k0) * hkv + kh) * D;
  load_tile<T, D>(sm + L::k, k + kbase, (size_t)hkv * D, nk, BKV);
  load_tile<T, D>(sm + L::v, v + kbase, (size_t)hkv * D, nk, BKV);
  for (int c = threadIdx.x; c < BKV; c += NT) kps[c] = c < nk ? k_pos[(size_t)b * T_ + k0 + c] : -1;
  __syncthreads();
  int klo, khi;
  pos_range(kps, BKV, true, klo, khi);

  // this thread's share of dK and dV: keys kc + 16 j, columns dc + 16 e
  const int kc = threadIdx.x % 16, dc = threadIdx.x / 16;
  float ak[4][E], av[4][E];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's shared data is consumed
    const int nq = min(BQ, S - q0);
    for (int r = threadIdx.x; r < BQ; r += NT) qps[r] = r < nq ? q_pos[(size_t)b * S + q0 + r] : 0;
    __syncthreads();
    int qlo, qhi;
    pos_range(qps, nq, false, qlo, qhi);
    if (!tiles_meet(qlo, qhi, klo, khi, causal, window)) continue;  // uniform
    for (int hh = 0; hh < rep; ++hh) {
      const int h = kh * rep + hh;
      __syncthreads();
      load_queries<T, D>(sm, q, dout, lse, delta, q_pos, b, h, q0, S, hq);
      __syncthreads();
      probs<D>(sm, q0, k0, S, T_, causal, window, scale, true);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pj[4], sj[4], od[E], qd[E];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pj[j] = sm[L::p + r * LDP + kc + 16 * j];
          sj[j] = sm[L::ds + r * LDP + kc + 16 * j];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          od[e] = sm[L::dout + r * LD + dc + 16 * e];
          qd[e] = sm[L::q + r * LD + dc + 16 * e];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            av[j][e] = fmaf(pj[j], od[e], av[j][e]);
            ak[j][e] = fmaf(sj[j], qd[e], ak[j][e]);
          }
      }
    }
  }
  __syncthreads();
  // stage through the K/V tiles so that the stores are coalesced
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sm[L::k + (kc + 16 * j) * LD + dc + 16 * e] = ak[j][e];
      sm[L::v + (kc + 16 * j) * LD + dc + 16 * e] = av[j][e];
    }
  __syncthreads();
  store_tile<T, D>(dk + kbase, sm + L::k, (size_t)hkv * D, nk, scale);
  store_tile<T, D>(dv + kbase, sm + L::v, (size_t)hkv * D, nk, 1.f);
}

// dQ of one query tile of head h, batch row b: block (query tile, h, b).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, T* __restrict__ dq, int S, int T_, int hq, int hkv,
             int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD, E = D / 16;
  extern __shared__ float sm[];
  int* qps = reinterpret_cast<int*>(sm + L::qpos);
  int* kps = reinterpret_cast<int*>(sm + L::kpos);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (hq / hkv), nq = min(BQ, S - q0);
  load_queries<T, D>(sm, q, dout, lse, delta, q_pos, b, h, q0, S, hq);
  __syncthreads();
  int qlo, qhi;
  pos_range(qps, nq, false, qlo, qhi);

  // this thread's share of dQ: rows rq + 16 i, columns dc + 16 e
  const int rq = threadIdx.x % 16, dc = threadIdx.x / 16;
  float aq[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) aq[i][e] = 0.f;

  for (int k0 = 0; k0 < T_; k0 += BKV) {
    __syncthreads();  // the previous tile's shared data is consumed
    const int nk = min(BKV, T_ - k0);
    for (int c = threadIdx.x; c < BKV; c += NT)
      kps[c] = c < nk ? k_pos[(size_t)b * T_ + k0 + c] : -1;
    __syncthreads();
    int klo, khi;
    pos_range(kps, BKV, true, klo, khi);
    if (!tiles_meet(qlo, qhi, klo, khi, causal, window)) continue;  // uniform
    const size_t kbase = (((size_t)b * T_ + k0) * hkv + kh) * D;
    load_tile<T, D>(sm + L::k, k + kbase, (size_t)hkv * D, nk, BKV);
    load_tile<T, D>(sm + L::v, v + kbase, (size_t)hkv * D, nk, BKV);
    __syncthreads();
    probs<D>(sm, q0, k0, S, T_, causal, window, scale, false);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float sd[4], kd[E];
#pragma unroll
      for (int i = 0; i < 4; ++i) sd[i] = sm[L::ds + (rq + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < E; ++e) kd[e] = sm[L::k + c * LD + dc + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) aq[i][e] = fmaf(sd[i], kd[e], aq[i][e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) sm[L::q + (rq + 16 * i) * LD + dc + 16 * e] = aq[i][e];
  __syncthreads();
  const size_t base = (((size_t)b * S + q0) * hq + h) * D;
  store_tile<T, D>(dq + base, sm + L::q, (size_t)hq * D, nq, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* out, const T* dout,
                     const float* lse, const int* qp, const int* kp, float* delta, T* dq, T* dk,
                     T* dv, int B, int S, int T_, int hq, int hkv, int causal, int window,
                     float scale, cudaStream_t st) {
  constexpr size_t bytes = Layout<D>::bytes;
  static const cudaError_t a1 = allow_smem(flash_bwd_dkdv<T, D>, bytes);
  static const cudaError_t a2 = allow_smem(flash_bwd_dq<T, D>, bytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const long long rows = (long long)B * S * hq;
  flash_bwd_delta<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      out, dout, delta, B, S, hq, D);
  flash_bwd_dkdv<T, D><<<dim3((T_ + BKV - 1) / BKV, hkv, B), NT, bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dk, dv, S, T_, hq, hkv, causal, window, scale);
  flash_bwd_dq<T, D><<<dim3((S + BQ - 1) / BQ, hq, B), NT, bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dq, S, T_, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const float* lse, const int* qp, const int* kp,
                     float* delta, void* dq, void* dk, void* dv, int B, int S, int T_, int hq,
                     int hkv, int d, int causal, int window, float scale, cudaStream_t st) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
  switch (d) {
    case 64:
      return launch_d<T, 64>(c(q), c(k), c(v), c(out), c(dout), lse, qp, kp, delta, m(dq), m(dk),
                             m(dv), B, S, T_, hq, hkv, causal, window, scale, st);
    case 128:
      return launch_d<T, 128>(c(q), c(k), c(v), c(out), c(dout), lse, qp, kp, delta, m(dq),
                              m(dk), m(dv), B, S, T_, hq, hkv, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout, dq (B,S,Hq,D); k, v, dk, dv (B,T,Hkv,D): contiguous, one
// dtype, 16-byte aligned.  lse (B,Hq,S) f32 from the forward; q_pos (B,S),
// k_pos (B,T) int32; delta: B * Hq * S floats of scratch.  D 64 or 128.
// Three launches on `stream`: delta, dK/dV, dQ.  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          const void* q_pos, const void* k_pos, void* delta,
                                          void* dq, void* dk, void* dv, int B, int S, int T,
                                          int hq, int hkv, int d, int dtype, int causal,
                                          int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, out, dout, l, qp, kp, dl, dq, dk, dv, B, S, T, hq, hkv, d,
                           causal, window, scale, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(q, k, v, out, dout, l, qp, kp, dl, dq, dk, dv, B, S, T, hq,
                                   hkv, d, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
