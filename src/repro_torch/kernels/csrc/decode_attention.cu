// Flash-decode over per-lane KV caches: one query token per lane.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py (decode_attention
// -> _decode_kernel), and with the optional `pos` plane also serves the ring
// decode site of repro/models/blocks.py (oracle ref.decode_mha_masked).
//
// Bound on the card: bytes.  Each (lane, KV head) reads its K and V rows
// once (2 * len * D elements) for rep = Hq / Hkv queries, about one FMA per
// byte, far below the ~295 operations per byte where the tensor cores would
// be the limit.  Design against that:
//   * D is 64, 128 or 256 and rep 1 to 16; a block takes at most 8 query
//     heads of a group (4 at D = 256), so that a lane's accumulators stay in
//     registers, and a larger group runs as several blocks reading the same
//     K/V rows (from L2 after the first);
//   * blocks per (KV head, head group, lane, split): the lane's slots are cut into
//     `splits` contiguous ranges (flash-decoding), so 8 lanes x 8 KV heads
//     still put several blocks on every one of the 132 SMs; the launcher
//     picks `splits` to fill about two waves;
//   * inside a block, 8 warps split the range; the rep query heads of the
//     GQA group share every K/V row loaded;
//   * a warp owns whole rows: lane i holds D/32 contiguous elements, so a
//     row is one coalesced 16-byte-per-thread load (D = 128, f32) or
//     8 bytes (bf16), and the q·k dot is a 5-step shuffle reduction;
//   * each warp loads 4 rows of K and of V before using any of them, to keep
//     loads in flight; masked slots (pos < 0, outside the window) are not
//     loaded at all, and slots at or past cache_len are never visited;
//   * every warp keeps its own f32 online softmax (m, l, acc); the warps
//     merge through shared memory, and with splits > 1 a second kernel
//     merges the splits' (max, sum, acc) from an f32 workspace.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;  // rows of K and V each warp loads before using them

// One split of one (lane, KV head).  With splits == 1 it writes the output;
// otherwise it writes, per query head, (max, sum) into `ml` and the
// max-relative accumulator into `part`, for rt::combine_splits.
// REP query heads per block: a GQA group of `rep` heads runs as rep / REP
// blocks, each with its own REP heads, so the per-lane accumulators
// (REP x D/32 f32) stay in registers at D = 256 and rep = 16.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cache_len,
              const int* __restrict__ pos, T* __restrict__ out,
              float* __restrict__ ml, float* __restrict__ part, int n, int hkv,
              int rep, int window, float scale, float softcap) {
  constexpr int EPL = D / 32;  // elements of a row each lane holds
  const int groups = rep / REP;
  const int h = blockIdx.x / groups;  // KV head
  const int q0 = h * rep + (blockIdx.x % groups) * REP;  // first query head
  const int b = blockIdx.y;    // lane of the decode batch
  const int split = blockIdx.z, splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * rep;
  const int len = cache_len[b];

  // Slots at or past cache_len hold nothing this query may see (a ring slot j
  // only ever holds positions congruent to j mod n, so pos >= j there too).
  const int hi_all = min(len, n);
  const int lo_all = (pos == nullptr && window > 0) ? max(0, len - window) : 0;
  const int per = (max(hi_all - lo_all, 0) + splits - 1) / splits;
  const int lo = lo_all + split * per;
  const int hi = min(hi_all, lo + per);

  float qf[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    rt::load_f32<T, EPL>(q + ((size_t)b * hq + q0 + r) * D + lane * EPL, qf[r]);

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const size_t row = (size_t)hkv * D;  // elements between consecutive slots
  const T* kb = k + (size_t)b * n * row + (size_t)h * D + lane * EPL;
  const T* vb = v + (size_t)b * n * row + (size_t)h * D + lane * EPL;
  const int* pb = pos == nullptr ? nullptr : pos + (size_t)b * n;

  for (int j0 = lo + warp * kGroup; j0 < hi; j0 += kWarps * kGroup) {
    bool ok[kGroup];
    float kf[kGroup][EPL], vf[kGroup][EPL];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = j0 + g;
      ok[g] = j < hi;
      if (ok[g] && pb != nullptr) {
        const int p = pb[j];
        ok[g] = p >= 0 && p < len && (window <= 0 || p > len - 1 - window);
      }
      if (ok[g]) {
        rt::load_f32<T, EPL>(kb + (size_t)j * row, kf[g]);
        rt::load_f32<T, EPL>(vb + (size_t)j * row, vf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[g][e] = vf[g][e] = 0.f;
      }
    }
    float s[kGroup][REP];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[r][e], kf[g][e], d);
        s[g][r] = d;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float x = rt::soft_cap(rt::group_sum<32>(s[g][r]) * scale, softcap);
        s[g][r] = ok[g] ? x : rt::kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) mx = fmaxf(mx, s[g][r]);
      const float corr = expf(m[r] - mx);
      float p[kGroup], psum = 0.f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        p[g] = ok[g] ? expf(s[g][r] - mx) : 0.f;
        psum += p[g];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * corr;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) a = fmaf(p[g], vf[g][e], a);
        acc[r][e] = a;
      }
      m[r] = mx;
    }
  }

  // Merge the warps' partial softmax states, one query head at a time.
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    const float mine = expf(m[r] - M);
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[r][e] * mine;
    __syncthreads();
    const size_t head = (size_t)b * hq + q0 + r;
    if (threadIdx.x < D) {
      float total = 0.f, L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        total += sm_acc[w][threadIdx.x];
        L += sm_l[w][r] * expf(sm_m[w][r] - M);
      }
      if (splits == 1) {
        out[head * D + threadIdx.x] = rt::from_f32<T>(total / fmaxf(L, 1e-30f));
      } else {
        part[(head * splits + split) * D + threadIdx.x] = total;
        if (threadIdx.x == 0) {
          ml[(head * splits + split) * 2] = M;
          ml[(head * splits + split) * 2 + 1] = L;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int D, int REP>
cudaError_t launch_rep(const T* q, const T* k, const T* v, const int* cl,
                       const int* pos, T* out, float* work, int B, int n,
                       int hkv, int rep, int splits, int window, float scale,
                       float softcap, cudaStream_t st) {
  const int hq = hkv * rep;
  float* ml = work;
  float* part = work == nullptr ? nullptr : work + (size_t)B * hq * splits * 2;
  decode_kernel<T, D, REP><<<dim3(hkv * (rep / REP), B, splits), kWarps * 32, 0, st>>>(
      q, k, v, cl, pos, out, ml, part, n, hkv, rep, window, scale, softcap);
  if (splits > 1)
    rt::combine_splits<T, D><<<B * hq, D, 0, st>>>(ml, part, out, splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* cl,
                     const int* pos, void* out, float* work, int B, int n,
                     int hq, int hkv, int splits, int window, float scale,
                     float softcap, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  // query heads per block: 8, or 4 at D = 256 (see decode_kernel)
  constexpr int kMaxRep = D >= 256 ? 4 : 8;
  switch (hq / hkv) {
    case 1: return launch_rep<T, D, 1>(qq, kk, vv, cl, pos, oo, work, B, n, hkv, 1, splits, window, scale, softcap, st);
    case 2: return launch_rep<T, D, 2>(qq, kk, vv, cl, pos, oo, work, B, n, hkv, 2, splits, window, scale, softcap, st);
    case 4: return launch_rep<T, D, 4>(qq, kk, vv, cl, pos, oo, work, B, n, hkv, 4, splits, window, scale, softcap, st);
    case 8: return launch_rep<T, D, kMaxRep>(qq, kk, vv, cl, pos, oo, work, B, n, hkv, 8, splits, window, scale, softcap, st);
    case 16: return launch_rep<T, D, kMaxRep>(qq, kk, vv, cl, pos, oo, work, B, n, hkv, 16, splits, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* cl,
                     const int* pos, void* out, float* work, int B, int n, int hq,
                     int hkv, int d, int splits, int window, float scale,
                     float softcap, cudaStream_t st) {
  switch (d) {
    case 64: return launch_d<T, 64>(q, k, v, cl, pos, out, work, B, n, hq, hkv, splits, window, scale, softcap, st);
    case 128: return launch_d<T, 128>(q, k, v, cl, pos, out, work, B, n, hq, hkv, splits, window, scale, softcap, st);
    case 256: return launch_d<T, 256>(q, k, v, cl, pos, out, work, B, n, hq, hkv, splits, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,1,Hq,D), k/v (B,n,Hkv,D), out (B,1,Hq,D): contiguous, one dtype.
// cache_len (B,) int32; pos (B,n) int32 or null.  `work` holds
// B * Hq * splits * (D + 2) floats when splits > 1 (unused otherwise).
// Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cache_len, const void* pos,
                                       void* out, void* work, int B, int n, int hq,
                                       int hkv, int d, int dtype, int splits,
                                       int window, float scale, float softcap,
                                       void* stream) {
  if (B <= 0 || B > 65535 || n <= 0 || hkv <= 0 || hq % hkv != 0 || splits < 1 ||
      splits > 65535 || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const int* cl = static_cast<const int*>(cache_len);
  const int* pp = static_cast<const int*>(pos);
  float* ww = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, cl, pp, out, ww, B, n, hq, hkv, d, splits, window, scale, softcap, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(q, k, v, cl, pp, out, ww, B, n, hq, hkv, d, splits, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
