// Fused attention forward with position masks (prefill and chunked prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (flash_attention
// -> _flash_kernel).  Masking is by explicit positions instead of
// q_offset/iota: key j is visible to query i when k_pos[b,j] >= 0, and
// k_pos <= q_pos when causal, and k_pos > q_pos - window.  Whole-prompt
// prefill passes q_pos = k_pos = arange(S) (oracle ref.mha_reference);
// chunked prefill passes the ring's pos plane followed by the chunk's own
// positions (oracle ref.mha_cache_masked), which reproduces the (B, C, n+C)
// mask of repro/models/blocks.py without building it.
//
// Bound on the card: at the main path's shapes (a 32-token chunk over a
// 2048-slot ring, a 512-token prompt) the bytes of q, K, V and out take
// longer at 3.35 TB/s than the bf16 operations at the tensor-core rate.
// This kernel computes in float32 on the CUDA cores, which keeps the f32
// reference's numerics for both bf16 and f32 inputs but makes the
// operations, not the bytes, its limit.  Design:
//   * one block per (16-query tile, query head, batch row, key split); a
//     loop inside the block walks 32-key tiles of K and V staged in shared
//     memory (f32, rows padded against bank conflicts), loaded with 16-byte
//     vector loads;
//   * a chunk has few query tiles, so the keys are also split over blocks
//     (as flash-decoding does): the launcher picks the split count to fill
//     about two waves, and a second kernel merges the splits' (max, sum,
//     acc) from an f32 workspace; a whole prompt has enough query tiles and
//     runs one split, written directly;
//   * GQA reads KV head h / rep; the ragged edges of S and T are masked in
//     the kernel instead of padded;
//   * a key tile whose positions are all invisible to every query of the
//     block (empty ring slots, keys past the causal edge, keys before the
//     window) is skipped before its K/V are loaded;
//   * eight neighbouring threads share a query row: each holds 4 of the 32
//     scores and D/8 output columns, with an f32 online softmax (running
//     max and sum reduced by shuffles among the eight).
// Not done yet: bf16 tensor-core products (mma.sync / wgmma) with TMA-fed,
// double-buffered tiles, which would put it on its byte bound.
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;    // query rows per block
constexpr int BK = 32;    // keys per shared-memory tile
constexpr int NT = 128;   // threads per block: 8 per query row
constexpr int TPR = NT / BQ;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ q_pos, const int* __restrict__ k_pos,
             T* __restrict__ out, float* __restrict__ ml, float* __restrict__ part,
             int S, int Tk, int hq, int hkv, int causal, int window, float scale,
             float softcap, int splits) {
  constexpr int CPT = D / TPR;   // output columns per thread
  constexpr int SPT = BK / TPR;  // scores per thread per key tile
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int kh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int i = tid / TPR;  // query row of this thread within the tile
  const int c = tid % TPR;  // its column group

  // this split's key range, in whole tiles
  const int tiles = (Tk + BK - 1) / BK;
  const int per = (tiles + splits - 1) / splits;
  const int t_begin = split * per * BK;
  const int t_end = min(Tk, (split + 1) * per * BK);

  for (int idx = tid * VEC; idx < BQ * D; idx += NT * VEC) {
    const int r = idx / D, d = idx % D, row = qt * BQ + r;
    float x[VEC];
    if (row < S) {
      rt::load_f32<T, VEC>(q + (((size_t)b * S + row) * hq + h) * D + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r][d + e] = x[e];
  }
  if (tid < BQ) {
    const int row = qt * BQ + tid;
    qp_s[tid] = row < S ? q_pos[(size_t)b * S + row] : INT_MIN;
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int r = 0; r < BQ; ++r) {
    if (qt * BQ + r < S) {
      qmin = min(qmin, qp_s[r]);
      qmax = max(qmax, qp_s[r]);
    }
  }
  const bool row_ok = qt * BQ + i < S;
  const int qp = qp_s[i];

  float m = rt::kNegInf, l = 0.f, acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    int live = 0;
    if (tid < BK) {
      const int j = t0 + tid;
      const int p = j < t_end ? k_pos[(size_t)b * Tk + j] : -1;
      kp_s[tid] = p;
      live = p >= 0 && (!causal || p <= qmax) && (window <= 0 || p > qmin - window);
    }
    if (!__syncthreads_or(live)) continue;  // nothing in this tile is visible

    for (int idx = tid * VEC; idx < BK * D; idx += NT * VEC) {
      const int jj = idx / D, d = idx % D, j = t0 + jj;
      float kx[VEC], vx[VEC];
      if (j < t_end) {
        const size_t off = (((size_t)b * Tk + j) * hkv + kh) * D + d;
        rt::load_f32<T, VEC>(k + off, kx);
        rt::load_f32<T, VEC>(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[jj][d + e] = kx[e];
        Vs[jj][d + e] = vx[e];
      }
    }
    __syncthreads();

    float s[SPT];
    bool ok[SPT];
#pragma unroll
    for (int u = 0; u < SPT; ++u) s[u] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[i][d];
#pragma unroll
      for (int u = 0; u < SPT; ++u) s[u] = fmaf(qd, Ks[c + TPR * u][d], s[u]);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int p = kp_s[c + TPR * u];
      ok[u] = row_ok && p >= 0 && (!causal || p <= qp) && (window <= 0 || p > qp - window);
      s[u] = ok[u] ? rt::soft_cap(s[u] * scale, softcap) : rt::kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    mx = rt::group_max<TPR>(mx);
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const float p = ok[u] ? expf(s[u] - mx) : 0.f;
      Ps[i][c + TPR * u] = p;
      psum += p;
    }
    l = l * corr + rt::group_sum<TPR>(psum);
    m = mx;
    __syncwarp();  // a row's scores are written and read by one warp
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] *= corr;
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      const float p = Ps[i][jj];
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[e] = fmaf(p, Vs[jj][c + TPR * e], acc[e]);
    }
    __syncthreads();  // K/V/P tiles are rewritten by the next iteration
  }

  if (!row_ok) return;
  const size_t head = ((size_t)b * S + qt * BQ + i) * hq + h;  // (b, row, h)
  if (splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < CPT; ++e) out[head * D + c + TPR * e] = rt::from_f32<T>(acc[e] * inv);
  } else {
    const size_t slot = head * splits + split;
#pragma unroll
    for (int e = 0; e < CPT; ++e) part[slot * D + c + TPR * e] = acc[e];
    if (c == 0) {
      ml[slot * 2] = m;
      ml[slot * 2 + 1] = l;
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* qp,
                     const int* kp, void* out, float* work, int B, int S, int Tk,
                     int hq, int hkv, int splits, int causal, int window,
                     float scale, float softcap, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  float* ml = work;
  float* part = work == nullptr ? nullptr : work + (size_t)B * S * hq * splits * 2;
  flash_kernel<T, D><<<dim3((S + BQ - 1) / BQ, hq, B * splits), NT, 0, st>>>(
      qq, kk, vv, qp, kp, oo, ml, part, S, Tk, hq, hkv, causal, window, scale,
      softcap, splits);
  if (splits > 1)
    rt::combine_splits<T, D><<<B * S * hq, D, 0, st>>>(ml, part, oo, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* qp,
                     const int* kp, void* out, float* work, int B, int S, int Tk,
                     int hq, int hkv, int d, int splits, int causal, int window,
                     float scale, float softcap, cudaStream_t st) {
  switch (d) {
    case 64: return launch_d<T, 64>(q, k, v, qp, kp, out, work, B, S, Tk, hq, hkv, splits, causal, window, scale, softcap, st);
    case 128: return launch_d<T, 128>(q, k, v, qp, kp, out, work, B, S, Tk, hq, hkv, splits, causal, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,Hq,D), k/v (B,T,Hkv,D), out (B,S,Hq,D): contiguous, one dtype.
// q_pos (B,S) and k_pos (B,T) int32.  `work` holds B * S * Hq * splits *
// (D + 2) floats when splits > 1 (unused otherwise).  Returns
// cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      void* work, int B, int S, int Tk, int hq,
                                      int hkv, int d, int dtype, int splits,
                                      int causal, int window, float scale,
                                      float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 ||
      splits < 1 || (long long)B * splits > 65535 || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* ww = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, qp, kp, out, ww, B, S, Tk, hq, hkv, d, splits, causal, window, scale, softcap, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(q, k, v, qp, kp, out, ww, B, S, Tk, hq, hkv, d, splits, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
