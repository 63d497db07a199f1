// Flash-decode over a block-table page pool: one query token per lane.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py
// (paged_decode_attention -> _paged_decode_kernel); oracle
// ref.paged_decode_mha_reference.  Lane b's position r lives in pool row
// tables[b, r / page], slot r % page; the slot is visible when that table
// entry is >= 0, the pos plane there holds exactly r (a recycled page, or
// one written only up to mid-page, fails this), r < cache_len[b], and r is
// inside the window.
//
// Bound on the card: bytes.  Each (lane, KV head) reads the K and V rows of
// its live pages once for rep = Hq / Hkv queries, about one FMA per byte.
// Design against that:
//   * blocks per (KV head, lane, split): the lane's table slots (pages) up
//     to ceil(cache_len / page) are cut into `splits` ranges
//     (flash-decoding), so 8 lanes x 8 KV heads still fill the 132 SMs;
//     the partial softmax states merge in rt::combine_splits;
//   * inside a block, 8 warps split the range row by row; the query heads
//     of the block (a GQA group of up to 8, 4 at D = 256; a larger group
//     runs as several blocks, as in decode_attention.cu) share every K/V
//     row loaded;
//   * a table entry of -1 is skipped before any pos or K/V load, and a row
//     whose pos does not match is skipped before its K/V load;
//   * pool offsets ((row * page + t) * Hkv + h) * D are 64-bit: the pool
//     grows with num_pages.
//
// A lane with no visible slot gets what the oracle gives it: the softmax of
// equal masked logits, i.e. the mean of V over all maxp * page gathered
// slots, absent entries gathered from pool row 0.  Split 0 of such a lane
// computes it (reading only the lane's own pages and row 0 once); the
// engine never reads the output of such lanes (free and mid-prefill lanes).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;  // rows of K and V each warp loads before using them

// REP query heads per block: a GQA group of `rep` heads runs as rep / REP
// blocks, each with its own REP heads, so the per-lane accumulators
// (REP x D/32 f32) stay in registers at D = 256 and rep = 16.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ tables,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    float* __restrict__ ml, float* __restrict__ part, int page,
                    int maxp, int hkv, int rep, int window, float scale,
                    float softcap) {
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
  const int* tb = tables + (size_t)b * maxp;

  // Positions this query may see: [lo_all, hi_all); split over whole pages.
  const int hi_all = max(0, min(len, maxp * page));
  const int lo_all = min(window > 0 ? max(0, len - window) : 0, hi_all);
  const int pg_lo = lo_all / page, pg_hi = (hi_all + page - 1) / page;
  const int per = (pg_hi - pg_lo + splits - 1) / splits;
  const int lo = max(lo_all, (pg_lo + split * per) * page);
  const int hi = min(hi_all, (pg_lo + split * per + per) * page);

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

  const T* kh = k + (size_t)h * D + lane * EPL;
  const T* vh = v + (size_t)h * D + lane * EPL;

  for (int j0 = lo + warp * kGroup; j0 < hi; j0 += kWarps * kGroup) {
    bool ok[kGroup];
    float kf[kGroup][EPL], vf[kGroup][EPL];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int r = j0 + g;
      ok[g] = r < hi;
      size_t off = 0;
      if (ok[g]) {
        const int slot = r / page;
        const int row = __ldg(tb + slot);
        ok[g] = row >= 0;
        if (ok[g]) {
          const size_t prow = (size_t)row * page + (r - slot * page);
          ok[g] = __ldg(pos + prow) == r;
          off = prow * hkv * D;
        }
      }
      if (ok[g]) {
        rt::load_f32<T, EPL>(kh + off, kf[g]);
        rt::load_f32<T, EPL>(vh + off, vf[g]);
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

  // Split 0 of a lane with no visible slot at all computes the oracle's
  // uniform mean of V over every gathered slot (see the header).
  bool empty = false;
  float uniform = 0.f;
  if (split == 0) {
    float seen = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) seen += sm_l[w][0];
    if (seen <= 0.f) {
      int found = 0;
      for (int r = lo_all + threadIdx.x; r < hi_all && !found; r += blockDim.x) {
        const int slot = r / page;
        const int row = __ldg(tb + slot);
        found = row >= 0 && __ldg(pos + (size_t)row * page + (r - slot * page)) == r;
      }
      empty = !__syncthreads_or(found);
    }
    if (empty && threadIdx.x < D) {
      const size_t col = (size_t)h * D + threadIdx.x;
      float sum = 0.f;
      int absent = 0;
      for (int j = 0; j < maxp; ++j) {
        const int row = __ldg(tb + j);
        if (row < 0) {
          ++absent;
          continue;
        }
        for (int t = 0; t < page; ++t)
          sum += rt::to_f32(v[((size_t)row * page + t) * hkv * D + col]);
      }
      if (absent > 0) {
        float row0 = 0.f;
        for (int t = 0; t < page; ++t) row0 += rt::to_f32(v[(size_t)t * hkv * D + col]);
        sum += (float)absent * row0;
      }
      // the oracle rounds its probabilities to the storage type before P.V
      uniform = sum * rt::to_f32(rt::from_f32<T>(1.f / ((float)maxp * (float)page)));
    }
  }

  // Merge the warps' partial softmax states, one query head at a time.
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
      if (empty) {
        total = uniform;
        L = 1.f;
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
cudaError_t launch_rep(const T* q, const T* k, const T* v, const int* pos,
                       const int* tables, const int* cl, T* out, float* work,
                       int B, int maxp, int page, int hkv, int rep, int splits,
                       int window, float scale, float softcap, cudaStream_t st) {
  const int hq = hkv * rep;
  float* ml = work;
  float* part = work == nullptr ? nullptr : work + (size_t)B * hq * splits * 2;
  paged_decode_kernel<T, D, REP><<<dim3(hkv * (rep / REP), B, splits), kWarps * 32, 0, st>>>(
      q, k, v, pos, tables, cl, out, ml, part, page, maxp, hkv, rep, window, scale,
      softcap);
  if (splits > 1)
    rt::combine_splits<T, D><<<B * hq, D, 0, st>>>(ml, part, out, splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* pos,
                     const int* tables, const int* cl, void* out, float* work,
                     int B, int maxp, int page, int hq, int hkv, int splits,
                     int window, float scale, float softcap, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  // query heads per block: 8, or 4 at D = 256 (see paged_decode_kernel)
  constexpr int kMaxRep = D >= 256 ? 4 : 8;
  switch (hq / hkv) {
    case 1: return launch_rep<T, D, 1>(qq, kk, vv, pos, tables, cl, oo, work, B, maxp, page, hkv, 1, splits, window, scale, softcap, st);
    case 2: return launch_rep<T, D, 2>(qq, kk, vv, pos, tables, cl, oo, work, B, maxp, page, hkv, 2, splits, window, scale, softcap, st);
    case 4: return launch_rep<T, D, 4>(qq, kk, vv, pos, tables, cl, oo, work, B, maxp, page, hkv, 4, splits, window, scale, softcap, st);
    case 8: return launch_rep<T, D, kMaxRep>(qq, kk, vv, pos, tables, cl, oo, work, B, maxp, page, hkv, 8, splits, window, scale, softcap, st);
    case 16: return launch_rep<T, D, kMaxRep>(qq, kk, vv, pos, tables, cl, oo, work, B, maxp, page, hkv, 16, splits, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* pos,
                     const int* tables, const int* cl, void* out, float* work,
                     int B, int maxp, int page, int hq, int hkv, int d, int splits,
                     int window, float scale, float softcap, cudaStream_t st) {
  switch (d) {
    case 64: return launch_d<T, 64>(q, k, v, pos, tables, cl, out, work, B, maxp, page, hq, hkv, splits, window, scale, softcap, st);
    case 128: return launch_d<T, 128>(q, k, v, pos, tables, cl, out, work, B, maxp, page, hq, hkv, splits, window, scale, softcap, st);
    case 256: return launch_d<T, 256>(q, k, v, pos, tables, cl, out, work, B, maxp, page, hq, hkv, splits, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,1,Hq,D), pools k/v (P,page,Hkv,D), out (B,1,Hq,D): contiguous, one
// dtype.  pos (P,page), tables (B,maxp), cache_len (B,): int32.  `work`
// holds B * Hq * splits * (D + 2) floats when splits > 1 (unused
// otherwise).  Returns cudaGetLastError().
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* cache_len, void* out, void* work, int B,
    int maxp, int page, int hq, int hkv, int d, int dtype, int splits,
    int window, float scale, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || maxp <= 0 || page <= 0 || hkv <= 0 || hq % hkv != 0 ||
      splits < 1 || splits > 65535 || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos);
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cache_len);
  float* ww = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, pp, tb, cl, out, ww, B, maxp, page, hq, hkv, d, splits, window, scale, softcap, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(q, k, v, pp, tb, cl, out, ww, B, maxp, page, hq, hkv, d, splits, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
