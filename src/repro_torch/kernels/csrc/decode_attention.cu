// Flash-decode over per-lane KV caches: one query token per lane.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py (decode_attention
// -> _decode_kernel), and with the optional `pos` plane also serves the ring
// decode site of repro/models/blocks.py (oracle ref.decode_mha_masked).
//
// Bound on the card: bytes.  Each (lane, KV head) reads its K and V rows
// once (2 * len * D elements) for rep = Hq / Hkv queries, about one FMA per
// byte, far below the ~295 operations per byte where the tensor cores would
// be the limit.  bf16 design (decode_tc_kernel), all about keeping bytes in
// flight and reading each once:
//   * one block per (KV head, lane, split) holds all rep query heads of the
//     GQA group (any rep from 1 to 16, in the first rep rows of a 16-row
//     tile), so K and V are read exactly once at every ratio; the lane's
//     slots [lo, min(len, n)) are cut into `splits` ranges
//     (flash-decoding) and the launcher picks `splits` so that the
//     blocks, counted per (lane, KV head), fill about two waves of the SMs;
//   * the range passes through shared memory in tiles of 64 slots, two or
//     three stages deep, each thread copying 16 bytes per cp.async; the
//     next tiles are in flight while one is computed.  The tile's `pos`
//     entries arrive with it (4-byte cp.async), and no K/V copy depends on
//     them: a masked slot inside the range is loaded whole and masked on
//     its score.  Slots at or past min(len, n) are never visited;
//   * scores on the tensor cores: S = q·Kᵀ with the query heads on M (rep
//     rows of a 16-row tile, the rest zero) and 16 keys per warp on N
//     (mma.sync.m16n8k16, f32 accumulation of exact bf16 products), so no
//     per-(slot, head) shuffle reduction; the online softmax runs in log2
//     units (one FMA and one ex2.approx a score); then O += P·V on the
//     tensor cores with P rounded to bf16, where the oracle rounds it too
//     (the oracle rounds the normalised P, the kernel the running one);
//   * four warps take 16 slots each of every tile, each with its own online
//     softmax (m, l and a 16 x D f32 accumulator, D / 2 registers a
//     thread); the warps merge through shared memory at the end, and with
//     splits > 1 rt::combine_splits merges the splits' (max, sum, acc) from
//     an f32 workspace.
// decode_attention_partials_launch runs the same kernel and stops before
// that merge, at any `splits` (1 too): it leaves every split's state to the
// caller, and attention_combine_launch merges states from any number of
// such launches (a serving mesh's sequence shards, each over its own slots).
// f32 inputs (the identity checks, held at 2e-5) take the CUDA-core body
// decode_f32_kernel, selected by dtype: a warp owns whole rows (lane i holds
// D/32 elements), a block takes up to 8 query heads of a group (4 at
// D = 256; the largest divisor of the ratio within that), and masked slots
// are not loaded.  This is a dispatch by dtype, not a fallback: both routes
// launch or fail.
#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Slot range [lo, hi) of one split of lane b.  Slots at or past cache_len
// hold nothing the query may see (a ring slot j only ever holds positions
// congruent to j mod n, so pos >= j there too); without `pos` a window
// also cuts the range from below.
struct Range {
  int lo, hi;
};
__device__ __forceinline__ Range split_range(int len, int n, bool has_pos, int window,
                                             int split, int splits) {
  const int hi_all = min(len, n);
  const int lo_all = (!has_pos && window > 0) ? max(0, len - window) : 0;
  const int per = (max(hi_all - lo_all, 0) + splits - 1) / splits;
  const int lo = lo_all + split * per;
  return {lo, min(hi_all, lo + per)};
}

// ---------------------------------------------------------------- bf16 route
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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
  static constexpr size_t bytes = ml + 2 * kWarps * 16 * sizeof(float);
  // the warps' scaled accumulators reuse the stages once the loop is done
  static_assert(kWarps * 16 * LDO * sizeof(float) <= STAGES * stage, "merge buffer");
  // within the 227 KB a block may use (1 KB of the SM's 228 KB is reserved)
  static_assert(bytes + 1024 <= 233472, "decode block within an SM");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ cache_len,
                 const int* __restrict__ pos, bf16* __restrict__ out, float* __restrict__ ml,
                 float* __restrict__ part, int n, int hkv, int rep, int window, float scale,
                 float softcap) {
  using L = TcLayout<D>;
  constexpr int BK = L::BK, LD = L::LD, LDO = L::LDO, STAGES = L::STAGES;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  float* sm_m = reinterpret_cast<float*>(smem + L::ml);
  float* sm_l = sm_m + kWarps * 16;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int hq = hkv * rep;

  // the group's rep query rows, zero rows up to 16 (requested before the
  // lane's length is known)
  for (int idx = tid; idx < 16 * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < rep;
    rt::cp_async16(Qs + r * LD + c * 8, ok ? q + ((size_t)b * hq + kh * rep + r) * D + c * 8 : q,
                   ok);
  }
  rt::cp_async_commit();
  const int len = cache_len[b];
  const Range rg = split_range(len, n, pos != nullptr, window, split, splits);
  const int ntiles = (max(rg.hi - rg.lo, 0) + BK - 1) / BK;

  const size_t rowstride = (size_t)hkv * D;  // elements between consecutive slots
  const bf16* kb = k + (size_t)b * n * rowstride + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * n * rowstride + (size_t)kh * D;
  const int* pb = pos == nullptr ? nullptr : pos + (size_t)b * n;
  auto request = [&](int t, int s) {  // tile t of the range into stage s
    const int jb = rg.lo + t * BK;
    unsigned char* base = smem + L::kv + s * L::stage;
    bf16* Ks = reinterpret_cast<bf16*>(base);
    bf16* Vs = Ks + BK * LD;
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int jj = idx / CPR, c = idx % CPR, j = jb + jj;
      const bool ok = j < rg.hi;
      const size_t off = ok ? (size_t)j * rowstride + c * 8 : 0;
      rt::cp_async16(Ks + jj * LD + c * 8, kb + off, ok);
      rt::cp_async16(Vs + jj * LD + c * 8, vb + off, ok);
    }
    if (pb != nullptr) {
      int* ps = reinterpret_cast<int*>(base + 2 * BK * LD * sizeof(bf16));
      for (int jj = tid; jj < BK; jj += kThreads)
        if (jb + jj < rg.hi) rt::cp_async4(ps + jj, pb + jb + jj);
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
    const int j0 = rg.lo + t * BK + warp * 16;

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
        bool ok = j0 + jj < rg.hi;
        if (ok && pb != nullptr) {
          const int p = ps[jj];
          ok = p >= 0 && p < len && (window <= 0 || p > len - 1 - window);
        }
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
    const uint32_t pa[4] = {rt::pack_bf16(sc[0][0], sc[0][1]), rt::pack_bf16(sc[0][2], sc[0][3]),
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
      rt::mma_bf16(acc[2 * dn], pa, bv[0], bv[1]);
      rt::mma_bf16(acc[2 * dn + 1], pa, bv[2], bv[3]);
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
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ cache_len,
                  const int* __restrict__ pos, float* __restrict__ out,
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
  const Range rg = split_range(len, n, pos != nullptr, window, split, splits);
  const int lo = rg.lo, hi = rg.hi;

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

  const size_t row = (size_t)hkv * D;  // elements between consecutive slots
  const float* kb = k + (size_t)b * n * row + (size_t)h * D + lane * EPL;
  const float* vb = v + (size_t)b * n * row + (size_t)h * D + lane * EPL;
  const int* pb = pos == nullptr ? nullptr : pos + (size_t)b * n;

  for (int j0 = lo + warp * kGroup; j0 < hi; j0 += kWarpsF * kGroup) {
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
        rt::load_f32<float, EPL>(kb + (size_t)j * row, kf[g]);
        rt::load_f32<float, EPL>(vb + (size_t)j * row, vf[g]);
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
// decode_f32_kernel).  A group of `rep` heads runs as rep / REP blocks,
// REP the largest divisor of rep within that limit, so the grid is exact
// at every ratio: 6 -> 6 and 7 -> 7 at D <= 128, 6 -> 3 and 7 -> 1 at
// D = 256.
template <int D, int REP = (D >= 256 ? 4 : 8)>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const int* cl,
                       const int* pos, float* out, float* ml, float* part, int B, int n,
                       int hkv, int rep, int splits, int window, float scale, float softcap,
                       cudaStream_t st) {
  if (rep % REP != 0) {
    if constexpr (REP > 1)
      return launch_f32<D, REP - 1>(q, k, v, cl, pos, out, ml, part, B, n, hkv, rep, splits,
                                    window, scale, softcap, st);
    return cudaErrorInvalidValue;
  }
  decode_f32_kernel<D, REP><<<dim3(hkv * (rep / REP), B, splits), kWarpsF * 32, 0, st>>>(
      q, k, v, cl, pos, out, ml, part, n, hkv, rep, window, scale, softcap);
  return cudaSuccess;
}

// The attention kernel alone: with `part` it writes each split's partial
// softmax state to (ml, part), without it (one split) the output.
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* cl,
                     const int* pos, void* out, float* ml, float* part, int B, int n, int hq,
                     int hkv, int splits, int window, float scale, float softcap,
                     cudaStream_t st) {
  const int rep = hq / hkv;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t bytes = TcLayout<D>::bytes;
    // set once per instance: the size is a constant
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (attr != cudaSuccess) return attr;
    decode_tc_kernel<D><<<dim3(hkv, B, splits), kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        cl, pos, static_cast<bf16*>(out), ml, part, n, hkv, rep, window, scale, softcap);
    return cudaSuccess;
  } else {
    return launch_f32<D>(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), cl, pos, static_cast<float*>(out), ml,
                         part, B, n, hkv, rep, splits, window, scale, softcap, st);
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* cl,
                     const int* pos, void* out, float* ml, float* part, int B, int n, int hq,
                     int hkv, int d, int splits, int window, float scale, float softcap,
                     cudaStream_t st) {
  switch (d) {
    case 64: return launch_d<T, 64>(q, k, v, cl, pos, out, ml, part, B, n, hq, hkv, splits, window, scale, softcap, st);
    case 128: return launch_d<T, 128>(q, k, v, cl, pos, out, ml, part, B, n, hq, hkv, splits, window, scale, softcap, st);
    case 256: return launch_d<T, 256>(q, k, v, cl, pos, out, ml, part, B, n, hq, hkv, splits, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int n, int hq, int hkv, int d, int splits) {
  const int rep = hkv > 0 ? hq / hkv : 0;
  return B <= 0 || B > 65535 || n <= 0 || hkv <= 0 || hq % hkv != 0 || rep < 1 || rep > 16 ||
         splits < 1 || splits > 65535 || (d != 64 && d != 128 && d != 256);
}

cudaError_t launch_any(const void* q, const void* k, const void* v, const void* cache_len,
                       const void* pos, void* out, float* ml, float* part, int B, int n, int hq,
                       int hkv, int d, int dtype, int splits, int window, float scale,
                       float softcap, cudaStream_t st) {
  const int* cl = static_cast<const int*>(cache_len);
  const int* pp = static_cast<const int*>(pos);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == rt::kFloat32)
    e = launch_t<float>(q, k, v, cl, pp, out, ml, part, B, n, hq, hkv, d, splits, window, scale, softcap, st);
  else if (dtype == rt::kBFloat16)
    e = launch_t<bf16>(q, k, v, cl, pp, out, ml, part, B, n, hq, hkv, d, splits, window, scale, softcap, st);
  return e;
}

cudaError_t combine_any(const float* ml, const float* part, void* out, int rows, int splits,
                        int d, int dtype, cudaStream_t st) {
  if (dtype == rt::kFloat32)
    return rt::launch_combine(ml, part, static_cast<float*>(out), rows, splits, d, st);
  if (dtype == rt::kBFloat16)
    return rt::launch_combine(ml, part, static_cast<bf16*>(out), rows, splits, d, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,1,Hq,D), k/v (B,n,Hkv,D), out (B,1,Hq,D): contiguous, one dtype.
// cache_len (B,) int32; pos (B,n) int32 or null.  `work` holds
// B * Hq * splits * (D + 2) floats when splits > 1 (unused otherwise): the
// splits' partial states, which rt::combine_splits merges into `out`.
// Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cache_len, const void* pos,
                                       void* out, void* work, int B, int n, int hq,
                                       int hkv, int d, int dtype, int splits,
                                       int window, float scale, float softcap,
                                       void* stream) {
  if (bad_shape(B, n, hq, hkv, d, splits) || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  float* ml = splits > 1 ? static_cast<float*>(work) : nullptr;
  float* part = splits > 1 ? ml + (size_t)B * hq * splits * 2 : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_any(q, k, v, cache_len, pos, out, ml, part, B, n, hq, hkv, d,
                                   dtype, splits, window, scale, softcap, st);
  if (e != cudaSuccess) return e;
  if (splits > 1) return combine_any(ml, part, out, B * hq, splits, d, dtype, st);
  return cudaGetLastError();
}

// The partials launch: the same kernel with no merge, at any `splits`
// (1 included).  ml (B*Hq, splits, 2) receives each split's (max in
// natural-log units of the logits, sum), part (B*Hq, splits, D) its
// max-relative accumulator; a split with nothing visible writes
// (rt::kNegInf, 0, 0).  A serving mesh runs it on each sequence shard and
// joins the shards with attention_combine_launch.
extern "C" int decode_attention_partials_launch(const void* q, const void* k, const void* v,
                                                const void* cache_len, const void* pos,
                                                void* ml, void* part, int B, int n, int hq,
                                                int hkv, int d, int dtype, int splits,
                                                int window, float scale, float softcap,
                                                void* stream) {
  if (bad_shape(B, n, hq, hkv, d, splits) || ml == nullptr || part == nullptr)
    return cudaErrorInvalidValue;
  const cudaError_t e = launch_any(q, k, v, cache_len, pos, nullptr, static_cast<float*>(ml),
                                   static_cast<float*>(part), B, n, hq, hkv, d, dtype, splits,
                                   window, scale, softcap, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The combine launch: rt::combine_splits over `rows` output rows of D, each
// with `splits` partial states in (ml, part) as the partials launches write
// them (any number of them concatenated along the split axis).  A row
// whose every state is empty comes out as zeros.
extern "C" int attention_combine_launch(const void* ml, const void* part, void* out, int rows,
                                        int splits, int d, int dtype, void* stream) {
  if (ml == nullptr || part == nullptr) return cudaErrorInvalidValue;
  return combine_any(static_cast<const float*>(ml), static_cast<const float*>(part), out, rows,
                     splits, d, dtype, static_cast<cudaStream_t>(stream));
}
