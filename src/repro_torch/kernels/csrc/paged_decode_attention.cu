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
// its live pages once for rep = Hq / Hkv queries, about one FMA per byte,
// far below the ~295 operations per byte where the tensor cores would be
// the limit.  bf16 design (paged_decode_tc_kernel), the ring-decode design
// of decode_attention.cu with rows addressed through the table:
//   * one block per (KV head, lane, split) holds all rep query heads of the
//     GQA group (any rep from 1 to 16), so every K/V row is read exactly
//     once per group at every ratio; the lane's pages up to
//     ceil(cache_len / page) (from the window's first page) are cut into
//     `splits` page-aligned ranges (flash-decoding), merged by
//     rt::combine_splits;
//   * the split's slice of the lane's table is copied into shared memory
//     once, at the block's start;
//   * the range passes through shared memory in tiles of 64 slots, two or
//     three stages deep, each thread copying 16 bytes per cp.async; slot r
//     of a tile comes from pool row ((tables[b, r / page] * page + r % page)
//     * Hkv + h) * D (64-bit: the pool grows with num_pages), so a tile may
//     span pages or end mid-page whatever the page size.  The slot's pos
//     entry arrives in the same stage (4-byte cp.async), and no K/V copy
//     waits on it.  A table entry of -1 issues no copy: the stage is
//     zero-filled and its pos entry set to -1;
//   * visibility is one compare a score, pos == r (slots past the range
//     carry -1): every tile needs it, since any page may be stale.  Scores
//     S = q·Kᵀ on the tensor cores with the query heads on M (rep rows of a
//     16-row tile) and 16 slots per warp on N (mma.sync.m16n8k16, f32 sums
//     of exact bf16 products); the online softmax runs in log2 units (one
//     FMA and one ex2.approx a score); O += P·V on the tensor cores with P
//     rounded to bf16 once, as the oracle rounds it;
//   * four warps take 16 slots each of every tile, each with its own
//     softmax state, and merge through shared memory at the end.
// f32 inputs (the identity checks, held at 2e-5) take the CUDA-core body
// paged_decode_f32_kernel, selected by dtype: 8 warps split the range row
// by row, a block takes up to 8 query heads (4 at D = 256; the largest
// divisor of the ratio within that), a -1 entry is skipped before any load
// and a row whose pos does not match before its K/V load.  This is a dispatch by dtype, not a fallback: both routes
// launch or fail.
//
// A lane with no visible slot gets what the oracle gives it: the softmax of
// equal masked logits, i.e. the mean of V over all maxp * page gathered
// slots, absent entries gathered from pool row 0.  Split 0 of such a lane
// computes it (reading only the lane's own pages and row 0 once); the
// engine never reads the output of such lanes (free and mid-prefill lanes).
#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 route
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the most table entries (pages) one split may hold in shared memory
constexpr int kMaxSlice = 8192;

template <int D>
struct TcLayout {
  static constexpr int BK = 16 * kWarps;            // slots per tile
  static constexpr int STAGES = D >= 256 ? 2 : 3;
  static constexpr int LD = D + 8;                  // padded row, bf16
  static constexpr int LDO = D + 8;                 // padded row of the merge buffer, f32
  static constexpr size_t q = 0;                    // 16 x LD bf16
  static constexpr size_t stage = 2 * BK * LD * sizeof(bf16) + BK * sizeof(int);
  static constexpr size_t kv = q + 16 * LD * sizeof(bf16);
  static constexpr size_t ml = kv + STAGES * stage; // (m, l) of each warp's 16 rows
  static constexpr size_t table = ml + 2 * kWarps * 16 * sizeof(float);
  // the split's table slice follows: `slice` ints
  static constexpr size_t bytes(int slice) { return table + (size_t)slice * sizeof(int); }
  // the warps' scaled accumulators reuse the stages once the loop is done,
  // and the empty lane's mean of V reuses the query tile
  static_assert(kWarps * 16 * LDO * sizeof(float) <= STAGES * stage, "merge buffer");
  static_assert(D * sizeof(float) <= 16 * LD * sizeof(bf16), "mean buffer");
  static_assert(kWarps * 16 * LDO * sizeof(float) + (kThreads / (D / 8)) * (D + 1) * 4 <=
                    STAGES * stage,
                "the mean's partial sums behind the merge buffer");
  // within the 227 KB a block may use (1 KB of the SM's 228 KB is reserved)
  static_assert(table + kMaxSlice * sizeof(int) + 1024 <= 233472,
                "paged decode block within an SM");
};

// (one block per SM at least: without the minimum, ptxas caps the D = 64
// instance at 96 registers and spills)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ pos,
                       const int* __restrict__ tables, const int* __restrict__ cache_len,
                       bf16* __restrict__ out, float* __restrict__ ml,
                       float* __restrict__ part, int page, int maxp, int hkv, int rep,
                       int window, float scale, float softcap) {
  using L = TcLayout<D>;
  constexpr int BK = L::BK, LD = L::LD, LDO = L::LDO, STAGES = L::STAGES;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  // an empty lane's mean of V: column groups of 8 and table-entry shares
  constexpr int kMeanCols = D / 8, kMeanRows = kThreads / kMeanCols;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  float* sm_m = reinterpret_cast<float*>(smem + L::ml);
  float* sm_l = sm_m + kWarps * 16;
  int* tab = reinterpret_cast<int*>(smem + L::table);

  const int kh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hq = hkv * rep;

  // the group's rep query rows, zero rows up to 16 (requested before the
  // lane's length and table are known)
  for (int idx = tid; idx < 16 * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < rep;
    rt::cp_async16(Qs + r * LD + c * 8, ok ? q + ((size_t)b * hq + kh * rep + r) * D + c * 8 : q,
                   ok);
  }
  rt::cp_async_commit();

  // Positions this query may see: [lo_all, hi_all); split over whole pages
  // [pa, pb) into the positions [lo, hi).
  const int len = cache_len[b];
  const int* tb = tables + (size_t)b * maxp;
  const int hi_all = max(0, min(len, maxp * page));
  const int lo_all = min(window > 0 ? max(0, len - window) : 0, hi_all);
  const int pg_lo = lo_all / page, pg_hi = (hi_all + page - 1) / page;
  const int per = (pg_hi - pg_lo + splits - 1) / splits;
  const int pa = pg_lo + split * per, pb = min(pg_hi, pa + per);
  const int lo = max(lo_all, pa * page), hi = min(hi_all, pb * page);
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  for (int i = tid; i < pb - pa; i += kThreads) tab[i] = __ldg(tb + pa + i);
  __syncthreads();  // the table slice is in place

  const size_t rowstride = (size_t)hkv * D;  // elements between consecutive pool slots
  const bf16* kb = k + (size_t)kh * D;
  const bf16* vb = v + (size_t)kh * D;
  auto request = [&](int t, int s) {  // tile t of the range into stage s
    const int jb = lo + t * BK;
    unsigned char* base = smem + L::kv + s * L::stage;
    bf16* Ks = reinterpret_cast<bf16*>(base);
    bf16* Vs = Ks + BK * LD;
    int* ps = reinterpret_cast<int*>(base + 2 * BK * LD * sizeof(bf16));
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int jj = idx / CPR, c = idx % CPR, r = jb + jj;
      const int pj = r / page;
      const int row = r < hi ? tab[pj - pa] : -1;
      const bool ok = row >= 0;
      const size_t off = ok ? ((size_t)row * page + (r - pj * page)) * rowstride + c * 8 : 0;
      rt::cp_async16(Ks + jj * LD + c * 8, kb + off, ok);
      rt::cp_async16(Vs + jj * LD + c * 8, vb + off, ok);
    }
    for (int jj = tid; jj < BK; jj += kThreads) {
      const int r = jb + jj, pj = r / page;
      const int row = r < hi ? tab[pj - pa] : -1;
      if (row >= 0)
        rt::cp_async4(ps + jj, pos + (size_t)row * page + (r - pj * page));
      else
        ps[jj] = -1;  // an absent page or past the range: never visible
    }
  };

  // logits x (the softcapped product, or q·k) enter the softmax in log2
  // units: x * mult = logit * log2(e)
  const float mult = (softcap > 0.f ? 1.f : scale) * rt::kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max of x (heads g, g + 8) and each thread's share of the sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) request(s, s);
    rt::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed; the stage read at t - 1 is free
    if (t + STAGES - 1 < ntiles) request(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    rt::cp_async_commit();

    const unsigned char* base = smem + L::kv + (t % STAGES) * L::stage;
    const bf16* Ks = reinterpret_cast<const bf16*>(base) + warp * 16 * LD;  // the warp's 16 slots
    const bf16* Vs = reinterpret_cast<const bf16*>(base) + (BK + warp * 16) * LD;
    const int* ps = reinterpret_cast<const int*>(base + 2 * BK * LD * sizeof(bf16)) + warp * 16;
    const int j0 = lo + t * BK + warp * 16;

    // S = q·Kᵀ: heads on M, the warp's 16 slots on N (two 8-slot tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      rt::ldmatrix_x4(a, Qs + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      rt::ldmatrix_x4(bk, Ks + ((lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      rt::mma_bf16(sc[0], a, bk[0], bk[1]);
      rt::mma_bf16(sc[1], a, bk[2], bk[3]);
    }

    // softcap, mask by slot (the same for every head), online softmax
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = nt * 8 + 2 * tq + e;
        const bool ok = ps[jj] == j0 + jj;
        if (softcap > 0.f) {
          sc[nt][e] = softcap * tanhf(sc[nt][e] * scale / softcap);
          sc[nt][e + 2] = softcap * tanhf(sc[nt][e + 2] * scale / softcap);
        }
        if (!ok) sc[nt][e] = sc[nt][e + 2] = -INFINITY;
      }
    }
    float mx0 = fmaxf(m0, fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
    float mx1 = fmaxf(m1, fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3])));
    mx0 = rt::group_max<4>(mx0);
    mx1 = rt::group_max<4>(mx1);
    // a head with nothing visible yet keeps max -inf: subtract 0 instead
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * mult;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * mult;
    const float c0 = rt::exp2_approx(m0 * mult - b0), c1 = rt::exp2_approx(m1 * mult - b1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = rt::exp2_approx(fmaf(sc[nt][0], mult, -b0));
      sc[nt][1] = rt::exp2_approx(fmaf(sc[nt][1], mult, -b0));
      sc[nt][2] = rt::exp2_approx(fmaf(sc[nt][2], mult, -b1));
      sc[nt][3] = rt::exp2_approx(fmaf(sc[nt][3], mult, -b1));
    }
    l0 = l0 * c0 + sc[0][0] + sc[0][1] + sc[1][0] + sc[1][1];
    l1 = l1 * c1 + sc[0][2] + sc[0][3] + sc[1][2] + sc[1][3];
    const uint32_t pa4[4] = {rt::pack_bf16(sc[0][0], sc[0][1]), rt::pack_bf16(sc[0][2], sc[0][3]),
                             rt::pack_bf16(sc[1][0], sc[1][1]), rt::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bv[4];
      rt::ldmatrix_x4_trans(bv, Vs + (((lane / 8) % 2) * 8 + lane % 8) * LD + dn * 16 +
                                    (lane / 16) * 8);
      acc[2 * dn][0] *= c0;
      acc[2 * dn][1] *= c0;
      acc[2 * dn][2] *= c1;
      acc[2 * dn][3] *= c1;
      acc[2 * dn + 1][0] *= c0;
      acc[2 * dn + 1][1] *= c0;
      acc[2 * dn + 1][2] *= c1;
      acc[2 * dn + 1][3] *= c1;
      rt::mma_bf16(acc[2 * dn], pa4, bv[0], bv[1]);
      rt::mma_bf16(acc[2 * dn + 1], pa4, bv[2], bv[3]);
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();  // the stages are free: they hold the merge buffer now

  // merge the warps' softmax states, head by head
  l0 = rt::group_sum<4>(l0);
  l1 = rt::group_sum<4>(l1);
  if (tq == 0) {
    sm_m[warp * 16 + g] = m0;
    sm_m[warp * 16 + g + 8] = m1;
    sm_l[warp * 16 + g] = l0;
    sm_l[warp * 16 + g + 8] = l1;
  }
  __syncthreads();
  float M0 = -INFINITY, M1 = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    M0 = fmaxf(M0, sm_m[w * 16 + g]);
    M1 = fmaxf(M1, sm_m[w * 16 + g + 8]);
  }
  // the warps' maxima of x, in log2 units relative to the block's
  const float f0 = M0 == -INFINITY ? 0.f : rt::exp2_approx((m0 - M0) * mult);
  const float f1 = M1 == -INFINITY ? 0.f : rt::exp2_approx((m1 - M1) * mult);
  float* buf = reinterpret_cast<float*>(smem + L::kv);  // [warp][16][LDO]
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float* r = buf + (warp * 16 + g) * LDO + nt * 8 + 2 * tq;
    *reinterpret_cast<float2*>(r) = make_float2(acc[nt][0] * f0, acc[nt][1] * f0);
    *reinterpret_cast<float2*>(r + 8 * LDO) = make_float2(acc[nt][2] * f1, acc[nt][3] * f1);
  }

  // Split 0 of a lane with no visible slot at all computes the oracle's
  // uniform mean of V over every gathered slot (see the header) into the
  // query tile's place.
  bool empty = false;
  float* mean = reinterpret_cast<float*>(smem + L::q);
  if (split == 0 && out != nullptr) {
    float seen = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) seen += sm_l[w * 16];
    if (seen <= 0.f) {
      int found = 0;
      for (int r = lo_all + tid; r < hi_all && !found; r += kThreads) {
        const int pj = r / page;
        const int row = __ldg(tb + pj);
        found = row >= 0 && __ldg(pos + (size_t)row * page + (r - pj * page)) == r;
      }
      empty = !__syncthreads_or(found);
    }
    if (empty) {
      // threads own 8 columns (one 16-byte row piece) of a share of the
      // table entries; the shares' sums are added in a fixed order, and
      // each absent entry counts as pool row 0
      const int cg = tid % kMeanCols, jg = tid / kMeanCols;
      float* partial = buf + kWarps * 16 * LDO;  // [kMeanRows][D], behind the merge buffer
      int* absent = reinterpret_cast<int*>(partial + kMeanRows * D);  // [kMeanRows]
      const bf16* vc = v + (size_t)kh * D + cg * 8;
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int gaps = 0;
      for (int j = jg; j < maxp; j += kMeanRows) {
        const int row = __ldg(tb + j);
        if (row < 0) {
          ++gaps;
          continue;
        }
        for (int t = 0; t < page; ++t) {
          float f[8];
          rt::load_f32<bf16, 8>(vc + ((size_t)row * page + t) * rowstride, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] += f[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) partial[jg * D + cg * 8 + e] = sum[e];
      if (cg == 0) absent[jg] = gaps;
      __syncthreads();
      // the oracle rounds its probabilities to the storage type before P.V
      const float inv = __bfloat162float(__float2bfloat16(1.f / ((float)maxp * (float)page)));
      int gathered0 = 0;
      for (int r = 0; r < kMeanRows; ++r) gathered0 += absent[r];
      for (int c = tid; c < D; c += kThreads) {
        float total = 0.f, row0 = 0.f;
        for (int r = 0; r < kMeanRows; ++r) total += partial[r * D + c];
        if (gathered0 > 0) {
          for (int t = 0; t < page; ++t) row0 += __bfloat162float(v[(size_t)t * rowstride + kh * D + c]);
          total += (float)gathered0 * row0;
        }
        mean[c] = total * inv;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * 16 + r]);
    float total = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += buf[(w * 16 + r) * LDO + c];
      if (M != -INFINITY) lsum += sm_l[w * 16 + r] * rt::exp2_approx((sm_m[w * 16 + r] - M) * mult);
    }
    if (empty) {
      total = mean[c];
      lsum = 1.f;
    }
    const size_t head = (size_t)b * hq + kh * rep + r;
    if (part == nullptr) {
      out[head * D + c] = __float2bfloat16(total / fmaxf(lsum, 1e-30f));
    } else {
      // (max, sum) in natural-log units of the logits, as combine_splits
      // reads them; a split with nothing visible keeps rt::kNegInf
      part[(head * splits + split) * D + c] = total;
      if (c == 0) {
        ml[(head * splits + split) * 2] = M == -INFINITY ? rt::kNegInf : M * mult * rt::kLn2;
        ml[(head * splits + split) * 2 + 1] = lsum;
      }
    }
  }
}

// ----------------------------------------------------------------- f32 route
constexpr int kWarpsF = 8;
constexpr int kGroup = 4;  // rows of K and V each warp loads before using them

// REP query heads per block: a GQA group of `rep` heads runs as rep / REP
// blocks, each with its own REP heads, so the per-lane accumulators
// (REP x D/32 f32) stay in registers at D = 256 and rep = 16.
template <int D, int REP>
__global__ void __launch_bounds__(kWarpsF * 32)
paged_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ tables,
                        const int* __restrict__ cache_len, float* __restrict__ out,
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
    rt::load_f32<float, EPL>(q + ((size_t)b * hq + q0 + r) * D + lane * EPL, qf[r]);

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const float* kh = k + (size_t)h * D + lane * EPL;
  const float* vh = v + (size_t)h * D + lane * EPL;

  for (int j0 = lo + warp * kGroup; j0 < hi; j0 += kWarpsF * kGroup) {
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
        rt::load_f32<float, EPL>(kh + off, kf[g]);
        rt::load_f32<float, EPL>(vh + off, vf[g]);
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

  __shared__ float sm_m[kWarpsF][REP];
  __shared__ float sm_l[kWarpsF][REP];
  __shared__ float sm_acc[kWarpsF][D];
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
  if (split == 0 && out != nullptr) {
    float seen = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsF; ++w) seen += sm_l[w][0];
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
      uniform = sum * (1.f / ((float)maxp * (float)page));
    }
  }

  // Merge the warps' partial softmax states, one query head at a time.
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float M = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarpsF; ++w) M = fmaxf(M, sm_m[w][r]);
    const float mine = expf(m[r] - M);
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[r][e] * mine;
    __syncthreads();
    const size_t head = (size_t)b * hq + q0 + r;
    if (threadIdx.x < D) {
      float total = 0.f, L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsF; ++w) {
        total += sm_acc[w][threadIdx.x];
        L += sm_l[w][r] * expf(sm_m[w][r] - M);
      }
      if (empty) {
        total = uniform;
        L = 1.f;
      }
      if (part == nullptr) {
        out[head * D + threadIdx.x] = total / fmaxf(L, 1e-30f);
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

// Query heads per f32 block: at most 8, or 4 at D = 256 (see
// paged_decode_f32_kernel).  A group of `rep` heads runs as rep / REP
// blocks, REP the largest divisor of rep within that limit, so the grid is
// exact at every ratio: 6 -> 6 and 7 -> 7 at D <= 128, 6 -> 3 and 7 -> 1
// at D = 256.
template <int D, int REP = (D >= 256 ? 4 : 8)>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int* pos,
                       const int* tables, const int* cl, float* out, float* ml, float* part,
                       int B, int maxp, int page, int hkv, int rep, int splits, int window,
                       float scale, float softcap, cudaStream_t st) {
  if (rep % REP != 0) {
    if constexpr (REP > 1)
      return launch_f32<D, REP - 1>(q, k, v, pos, tables, cl, out, ml, part, B, maxp, page,
                                    hkv, rep, splits, window, scale, softcap, st);
    return cudaErrorInvalidValue;
  }
  paged_decode_f32_kernel<D, REP><<<dim3(hkv * (rep / REP), B, splits), kWarpsF * 32, 0, st>>>(
      q, k, v, pos, tables, cl, out, ml, part, page, maxp, hkv, rep, window, scale, softcap);
  return cudaSuccess;
}

// The attention kernel alone: with `part` it writes each split's partial
// softmax state to (ml, part), without it (one split) the output.
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* pos,
                     const int* tables, const int* cl, void* out, float* ml, float* part,
                     int B, int maxp, int page, int hq, int hkv, int splits, int window,
                     float scale, float softcap, cudaStream_t st) {
  const int rep = hq / hkv;
  if constexpr (sizeof(T) == 2) {
    const int slice = (maxp + splits - 1) / splits;
    if (slice > kMaxSlice) return cudaErrorInvalidValue;
    // set once per instance, to the most any valid launch asks for
    static const cudaError_t attr =
        cudaFuncSetAttribute(paged_decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TcLayout<D>::bytes(kMaxSlice));
    if (attr != cudaSuccess) return attr;
    paged_decode_tc_kernel<D><<<dim3(hkv, B, splits), kThreads, TcLayout<D>::bytes(slice), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        pos, tables, cl, static_cast<bf16*>(out), ml, part, page, maxp, hkv, rep, window, scale,
        softcap);
    return cudaSuccess;
  } else {
    return launch_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), pos, tables, cl, static_cast<float*>(out),
                         ml, part, B, maxp, page, hkv, rep, splits, window, scale, softcap, st);
  }
}

// The kernel, then (with `merge` and more than one split) the combine.
template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* pos,
                     const int* tables, const int* cl, void* out, float* ml, float* part,
                     int B, int maxp, int page, int hq, int hkv, int d, int splits,
                     int window, float scale, float softcap, bool merge, cudaStream_t st) {
  cudaError_t e;
  switch (d) {
    case 64: e = launch_d<T, 64>(q, k, v, pos, tables, cl, out, ml, part, B, maxp, page, hq, hkv, splits, window, scale, softcap, st); break;
    case 128: e = launch_d<T, 128>(q, k, v, pos, tables, cl, out, ml, part, B, maxp, page, hq, hkv, splits, window, scale, softcap, st); break;
    case 256: e = launch_d<T, 256>(q, k, v, pos, tables, cl, out, ml, part, B, maxp, page, hq, hkv, splits, window, scale, softcap, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  if (merge && part != nullptr)
    return rt::launch_combine(ml, part, static_cast<T*>(out), B * hq, splits, d, st);
  return cudaGetLastError();
}

int launch_any(const void* q, const void* k, const void* v, const void* pos,
               const void* tables, const void* cache_len, void* out, float* ml, float* part,
               int B, int maxp, int page, int hq, int hkv, int d, int dtype, int splits,
               int window, float scale, float softcap, bool merge, void* stream) {
  const int rep = hkv > 0 ? hq / hkv : 0;
  if (B <= 0 || B > 65535 || maxp <= 0 || page <= 0 || hkv <= 0 || hq % hkv != 0 ||
      rep < 1 || rep > 16 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int* pp = static_cast<const int*>(pos);
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cache_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, pp, tb, cl, out, ml, part, B, maxp, page, hq, hkv, d, splits, window, scale, softcap, merge, st);
  if (dtype == rt::kBFloat16)
    return launch_t<bf16>(q, k, v, pp, tb, cl, out, ml, part, B, maxp, page, hq, hkv, d, splits, window, scale, softcap, merge, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,1,Hq,D), pools k/v (P,page,Hkv,D), out (B,1,Hq,D): contiguous, one
// dtype.  pos (P,page), tables (B,maxp), cache_len (B,): int32.  `work`
// holds B * Hq * splits * (D + 2) floats when splits > 1 (unused
// otherwise): the splits' partial states, which rt::combine_splits merges
// into `out`.  In bf16, ceil(maxp / splits) is at most 8192 (the table
// slice a block holds in shared memory).  Returns cudaGetLastError().
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* cache_len, void* out, void* work, int B,
    int maxp, int page, int hq, int hkv, int d, int dtype, int splits,
    int window, float scale, float softcap, void* stream) {
  if (splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  float* ml = splits > 1 ? static_cast<float*>(work) : nullptr;
  float* part = splits > 1 ? ml + (size_t)B * hq * splits * 2 : nullptr;
  return launch_any(q, k, v, pos, tables, cache_len, out, ml, part, B, maxp, page, hq, hkv, d,
                    dtype, splits, window, scale, softcap, true, stream);
}

// The partials launch: the same kernel with no merge, at any `splits` (1
// included), over the pool rows a sequence shard of a serving mesh holds
// (its table has -1 for pages elsewhere).  ml (B*Hq, splits, 2) receives
// each split's (max in natural-log units of the logits, sum), part
// (B*Hq, splits, D) its max-relative accumulator; a split with nothing
// visible writes (rt::kNegInf, 0, 0), not the empty lane's mean of V (that
// is the whole lane's answer, which only the combine of every shard knows).
// decode_attention.cu's attention_combine_launch joins the shards.
extern "C" int paged_decode_attention_partials_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* cache_len, void* ml, void* part, int B,
    int maxp, int page, int hq, int hkv, int d, int dtype, int splits,
    int window, float scale, float softcap, void* stream) {
  if (ml == nullptr || part == nullptr) return cudaErrorInvalidValue;
  return launch_any(q, k, v, pos, tables, cache_len, nullptr, static_cast<float*>(ml),
                    static_cast<float*>(part), B, maxp, page, hq, hkv, d, dtype, splits, window,
                    scale, softcap, false, stream);
}
