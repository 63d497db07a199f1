// Fused attention forward with position masks (prefill and chunked prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (flash_attention
// -> _flash_kernel).  Masking is by explicit positions instead of
// q_offset/iota: key j is visible to query i when k_pos[b,j] >= 0, and
// k_pos <= q_pos when causal, and k_pos > q_pos - window.  Whole-prompt
// prefill passes q_pos = k_pos = arange(S) (oracle ref.mha_reference).
// Chunked prefill passes the ring through a second set of pointers: keys
// [0, n) are the ring's slots (k_cache, v_cache, cache_pos) and keys
// [n, n + C) the chunk's own (k, v, k_pos), which reproduces the (B, C,
// n + C) mask of repro/models/blocks.py (oracle ref.mha_cache_masked)
// without building it or concatenating ring and chunk.
//
// Bound on the card: at the main path's shapes (a 32-token chunk over a
// 2048-slot ring, a 512-token prompt) the bytes of q, K, V and out take
// longer at 3.35 TB/s than the bf16 operations at the tensor-core rate.
// bf16 design (flash_tc_kernel):
//   * rows packed by KV head: a block owns (row tile, KV head, batch row,
//     key split), where packed row r is query r / rep of query head
//     kh * rep + r % rep.  A tile of 64 packed rows holds the heads of
//     64 / rep queries, so every K/V tile is read once per row tile, not
//     once per query head.  Where rep does not divide 64 (3, 5, 6, 7, ...)
//     a tile ends part way through a query's heads and the next tile holds
//     the rest: every row is indexed by r / rep and r % rep alone, and the
//     live-tile masks read each row's own query position.  Four warps, 16
//     packed rows each;
//   * Q·Kᵀ and P·V run on the tensor cores (mma.sync.m16n8k16, bf16
//     operands from shared memory through ldmatrix, f32 accumulators; at
//     D <= 128 the Q fragments stay in registers across tiles); softcap,
//     masking and the online softmax run on the f32 fragments, in log2
//     units (one FMA and one ex2.approx a score).  The oracle keeps P in
//     f32: P is split into hi = bf16(P) and lo = bf16(P - hi) and both are
//     multiplied with the bf16 V tile, which carries P to about 16 mantissa
//     bits (relative error near 2^-17) for a third more tensor-core work;
//   * K/V tiles of 64 keys (32 at D = 256) pass through a ring of
//     shared-memory stages filled by cp.async, 16 bytes per thread; the
//     next live tile is requested before the current one is computed.  A
//     tile's key positions arrive with it (4-byte cp.async);
//   * a key tile whose positions are invisible to every query of the block
//     (empty ring slots, keys past the causal edge, keys before the window)
//     is never requested: a prologue reads the split's positions once,
//     with the queries' positions, into a bitmask of live tiles, and the
//     pipeline walks the set bits.  A second mask marks the tiles some of
//     whose (key, query) pairs are invisible; only those are masked score
//     by score (the ring's holes, the causal diagonal, the window edge);
//   * key splits as in flash-decoding: blocks are counted per (KV head,
//     row tile), the launcher picks the split count to fill about two
//     waves, and rt::combine_splits merges the splits' (max, sum, acc) from
//     an f32 workspace; a whole prompt with enough row tiles runs one split;
//   * shared memory (dynamic): Q tile, two K/V stages (three at D = 64),
//     positions and the two masks, about 89 KB at D = 128 and 103 KB at
//     D = 256, so two blocks share an SM (a static_assert holds it).
// f32 inputs (the identity checks, held at 2e-5) take a CUDA-core body,
// flash_f32_kernel, selected by dtype, with the same two key sources and
// splits: one block per (16-query tile, query head, batch row, split),
// 32-key f32 tiles in shared memory, eight threads per query row.  This is
// a dispatch by dtype, not a fallback: both routes launch or fail.
#include <climits>

#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The two key sources of batch row b: key j < n is ring slot j, key j >= n
// is the chunk's key j - n.  Without a ring n == 0 and the ring pointers
// are null.
template <typename T>
struct Keys {
  const T* k;
  const T* v;
  const int* pos;   // chunk (B, C, Hkv, D), (B, C)
  const T* kc;
  const T* vc;
  const int* cpos;  // ring (B, n, Hkv, D), (B, n)
  int C, n, hkv;

  __device__ __forceinline__ size_t row(int b, int j, int kh) const {
    return j < n ? ((size_t)b * n + j) * hkv + kh : ((size_t)b * C + (j - n)) * hkv + kh;
  }
  __device__ __forceinline__ const T* kbase(int j) const { return j < n ? kc : k; }
  __device__ __forceinline__ const T* vbase(int j) const { return j < n ? vc : v; }
  __device__ __forceinline__ const int* pos_ptr(int b, int j) const {
    return j < n ? cpos + (size_t)b * n + j : pos + (size_t)b * C + (j - n);
  }
};

__device__ __forceinline__ bool visible(int p, int qp, int causal, int window) {
  return p >= 0 && (!causal || p <= qp) && (window <= 0 || p > qp - window);
}

// ---------------------------------------------------------------- bf16 route
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;     // packed rows per block
constexpr int kMaxTiles = 4096;     // key tiles per split (bitmask size)

template <int D>
struct TcLayout {
  static constexpr int BK = D >= 256 ? 32 : 64;     // keys per tile
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int LD = D + 8;                  // padded row, bf16
  static constexpr size_t q = 0;
  static constexpr size_t stage = 2 * BK * LD * sizeof(bf16);  // K then V
  static constexpr size_t kv = q + BM * LD * sizeof(bf16);
  static constexpr size_t kpos = kv + STAGES * stage;
  static constexpr size_t qpos = kpos + STAGES * BK * sizeof(int);
  static constexpr size_t bits = qpos + BM * sizeof(int);  // live, then partial
  static constexpr size_t bytes = bits + 2 * (kMaxTiles / 8);
  // two blocks share an SM (228 KB, 1 KB of it reserved per block)
  static_assert(2 * (bytes + 1024) <= 233472, "two bf16 flash blocks per SM");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, Keys<bf16> keys, const int* __restrict__ q_pos,
                bf16* __restrict__ out, float* __restrict__ ml, float* __restrict__ part,
                float* __restrict__ lse, int S, int hq, int causal, int window, float scale,
                float softcap, int splits) {
  using L = TcLayout<D>;
  constexpr int BK = L::BK, LD = L::LD, STAGES = L::STAGES;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int JSTEP = kThreads / CPR;      // rows one pass of the block copies
  constexpr bool kQInRegs = D <= 128;        // Q fragments held across tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  int* kps = reinterpret_cast<int*>(smem + L::kpos);
  int* qps = reinterpret_cast<int*>(smem + L::qpos);
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(smem + L::bits);
  uint32_t* part_bits = live_bits + kMaxTiles / 32;

  const int hkv = keys.hkv, rep = hq / hkv, n = keys.n;
  const int kh = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int rows = S * rep, r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int Tk = n + keys.C;
  const int tiles = (Tk + BK - 1) / BK;
  const int per = (tiles + splits - 1) / splits;
  const int tile0 = split * per;
  const int ntiles = max(0, min(tiles, tile0 + per) - tile0);

  // the block's packed rows of q, and each row's query position
  for (int idx = tid; idx < BM * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR, R = r0 + r;
    const bool ok = R < rows;
    const bf16* src = ok ? q + (((size_t)b * S + R / rep) * hq + kh * rep + R % rep) * D + c * 8 : q;
    rt::cp_async16(Qs + r * LD + c * 8, src, ok);
  }
  rt::cp_async_commit();
  // the split's key positions, kPass keys per thread per pass, the first
  // pass loaded together with the queries' positions
  constexpr int kPass = 4;
  const int kbeg = tile0 * BK, kstop = kbeg + ntiles * BK;  // whole tiles
  int pk[kPass];
  auto load_pos = [&](int base) {
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int j = base + u * kThreads + tid;
      pk[u] = j < kstop && j < Tk ? *keys.pos_ptr(b, j) : -1;
    }
  };
  load_pos(kbeg);
  if (tid < BM) qps[tid] = r0 + tid < rows ? q_pos[(size_t)b * S + (r0 + tid) / rep] : 0;
  for (int w = tid; w < 2 * (kMaxTiles / 32); w += kThreads) live_bits[w] = 0;
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < min(BM, rows - r0); ++r) {
    qmin = min(qmin, qps[r]);
    qmax = max(qmax, qps[r]);
  }

  // From the positions alone, before any K/V is requested: a tile is live
  // when one of its keys is visible to some query of the block, and partial
  // unless every key is visible to every query (only those pay for masks).
  for (int base = kbeg; base < kstop; base += kPass * kThreads) {
    if (base != kbeg) load_pos(base);
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int j0 = base + u * kThreads + warp * 32;  // this warp's 32 keys
      if (j0 >= kstop) break;
      const int p = pk[u];
      const bool live = p >= 0 && (!causal || p <= qmax) && (window <= 0 || p > qmin - window);
      const bool all = p >= 0 && (!causal || p <= qmin) && (window <= 0 || p > qmax - window);
      const bool any_live = __any_sync(0xffffffffu, live), every = __all_sync(0xffffffffu, all);
      if (lane == 0) {
        const int t = (j0 - kbeg) / BK;
        if (any_live) atomicOr(&live_bits[t / 32], 1u << (t % 32));
        if (!every) atomicOr(&part_bits[t / 32], 1u << (t % 32));
      }
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();
  int nlive = 0;
  for (int w = 0; w * 32 < ntiles; ++w) nlive += __popc(live_bits[w]);
  auto next_live = [&](int from) {
    for (int w = from / 32; w * 32 < ntiles; ++w) {
      const uint32_t m = live_bits[w] & (w == from / 32 ? ~0u << (from % 32) : ~0u);
      if (m) return w * 32 + __ffs(m) - 1;
    }
    return ntiles;
  };

  // each thread copies one 16-byte column chunk of every JSTEP-th key row
  const int c8 = (tid % CPR) * 8, jr0 = tid / CPR;
  const size_t rs = (size_t)hkv * D;  // elements between consecutive keys
  const bf16* kr = n > 0 ? keys.kc + ((size_t)b * n * hkv + kh) * D + c8 : nullptr;
  const bf16* vr = n > 0 ? keys.vc + ((size_t)b * n * hkv + kh) * D + c8 : nullptr;
  const bf16* kq = keys.k + ((size_t)b * keys.C * hkv + kh) * D + c8;
  const bf16* vq = keys.v + ((size_t)b * keys.C * hkv + kh) * D + c8;
  auto request = [&](int t, int s) {  // split-local tile t into stage s
    const int jb = (tile0 + t) * BK;
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::kv + s * L::stage);
    bf16* Vs = Ks + BK * LD;
#pragma unroll
    for (int jj = jr0; jj < BK; jj += JSTEP) {
      const int j = jb + jj;
      const bool ok = j < Tk;
      const bool ring = j < n;
      const size_t off = (size_t)(ring ? j : j - n) * rs;
      rt::cp_async16(Ks + jj * LD + c8, ok ? (ring ? kr : kq) + off : keys.k, ok);
      rt::cp_async16(Vs + jj * LD + c8, ok ? (ring ? vr : vq) + off : keys.v, ok);
    }
    for (int jj = tid; jj < BK; jj += kThreads) {
      const int j = jb + jj;
      if (j < Tk)
        rt::cp_async4(kps + s * BK + jj, keys.pos_ptr(b, j));
      else
        kps[s * BK + jj] = -1;
    }
  };

  const int wrow = warp * 16;  // this warp's first packed row in the tile
  const int qp0 = qps[wrow + g], qp1 = qps[wrow + g + 8];
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      rt::ldmatrix_x4(qf[kk], Qs + (wrow + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
  }
  // logits x (the softcapped product, or q·k) enter the softmax in log2
  // units: x * mult = logit * log2(e)
  const float mult = (softcap > 0.f ? 1.f : scale) * rt::kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max of x (rows g, g + 8) and each thread's share of the sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int req = next_live(0), comp = req;  // next tile to request, to compute
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (req < ntiles) {
      request(req, s);
      req = next_live(req + 1);
    }
    rt::cp_async_commit();
  }
  for (int it = 0; it < nlive; ++it) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; the stage read at it - 1 is free
    if (req < ntiles) {
      request(req, (it + STAGES - 1) % STAGES);
      req = next_live(req + 1);
    }
    rt::cp_async_commit();

    const int s = it % STAGES;
    const bf16* Ks = reinterpret_cast<const bf16*>(smem + L::kv + s * L::stage);
    const bf16* Vs = Ks + BK * LD;
    const int* kp = kps + s * BK;
    const bool partial = (part_bits[comp / 32] >> (comp % 32)) & 1u;
    comp = next_live(comp + 1);

    // S = Q·Kᵀ for the warp's 16 rows and the tile's BK keys
    float sc[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        rt::ldmatrix_x4(a, Qs + (wrow + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t bk[4];
        rt::ldmatrix_x4(bk, Ks + (nn * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                                ((lane / 8) % 2) * 8);
        rt::mma_bf16(sc[2 * nn], a, bk[0], bk[1]);
        rt::mma_bf16(sc[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // softcap, then masks (only on a partial tile), then the online softmax;
    // a row's 4 threads share its max through shuffles
    if (softcap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = softcap * tanhf(sc[nt][e] * scale / softcap);
    }
    if (partial) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = kp[nt * 8 + 2 * tq + e];
          if (!visible(p, qp0, causal, window)) sc[nt][e] = -INFINITY;
          if (!visible(p, qp1, causal, window)) sc[nt][e + 2] = -INFINITY;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    mx0 = rt::group_max<4>(mx0);
    mx1 = rt::group_max<4>(mx1);
    // a row with nothing visible yet keeps max -inf: subtract 0 instead
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * mult;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * mult;
    const float c0 = rt::exp2_approx(m0 * mult - b0), c1 = rt::exp2_approx(m1 * mult - b1);
    m0 = mx0;
    m1 = mx1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sc[nt][0] = rt::exp2_approx(fmaf(sc[nt][0], mult, -b0));
      sc[nt][1] = rt::exp2_approx(fmaf(sc[nt][1], mult, -b0));
      sc[nt][2] = rt::exp2_approx(fmaf(sc[nt][2], mult, -b1));
      sc[nt][3] = rt::exp2_approx(fmaf(sc[nt][3], mult, -b1));
      s0 += sc[nt][0] + sc[nt][1];
      s1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }

    // O += P·V with P = hi + lo, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      rt::split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      rt::split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      rt::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      rt::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        rt::ldmatrix_x4_trans(bv, Vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                      dn * 16 + (lane / 16) * 8);
        rt::mma_bf16(acc[2 * dn], ph, bv[0], bv[1]);
        rt::mma_bf16(acc[2 * dn], pl, bv[0], bv[1]);
        rt::mma_bf16(acc[2 * dn + 1], ph, bv[2], bv[3]);
        rt::mma_bf16(acc[2 * dn + 1], pl, bv[2], bv[3]);
      }
    }
  }
  rt::cp_async_wait<0>();

  l0 = rt::group_sum<4>(l0);
  l1 = rt::group_sum<4>(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = r0 + wrow + g + 8 * half;
    if (R >= rows) continue;
    const size_t head = ((size_t)b * S + R / rep) * hq + kh * rep + R % rep;  // (b, i, h)
    const float l = half ? l1 : l0;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + head * D + nt * 8 + 2 * tq) =
            rt::pack_bf16(acc[nt][2 * half] * inv, acc[nt][2 * half + 1] * inv);
      if (lse != nullptr && tq == 0) {
        // natural-log units of the logits: max * mult * ln 2 + ln(sum)
        const float m = half ? m1 : m0;
        lse[((size_t)b * hq + kh * rep + R % rep) * S + R / rep] =
            l > 0.f ? m * mult * rt::kLn2 + logf(l) : rt::kNegInf;
      }
    } else {
      // (max, sum) in natural-log units of the logits, as combine_splits
      // reads them; a split with nothing visible keeps rt::kNegInf
      const float m = half ? m1 : m0;
      const size_t slot = head * splits + split;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(part + slot * D + nt * 8 + 2 * tq) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      if (tq == 0) {
        ml[slot * 2] = m == -INFINITY ? rt::kNegInf : m * mult * rt::kLn2;
        ml[slot * 2 + 1] = l;
      }
    }
  }
}

// ----------------------------------------------------------------- f32 route
constexpr int BQ = 16;    // query rows per block
constexpr int BKF = 32;   // keys per shared-memory tile
constexpr int NT = 128;   // threads per block: 8 per query row
constexpr int TPR = NT / BQ;

template <int D>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, Keys<float> keys, const int* __restrict__ q_pos,
                 float* __restrict__ out, float* __restrict__ ml, float* __restrict__ part,
                 float* __restrict__ lse, int S, int hq, int causal, int window, float scale,
                 float softcap, int splits) {
  constexpr int CPT = D / TPR;   // output columns per thread
  constexpr int SPT = BKF / TPR; // scores per thread per key tile
  constexpr int VEC = 4;         // floats per 16-byte load
  extern __shared__ float smem_f[];
  float(*Qs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem_f);
  float(*Ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem_f + BQ * (D + 1));
  float(*Vs)[D] = reinterpret_cast<float(*)[D]>(smem_f + (BQ + BKF) * (D + 1));
  float(*Ps)[BKF + 1] =
      reinterpret_cast<float(*)[BKF + 1]>(smem_f + (BQ + BKF) * (D + 1) + BKF * D);
  int* qp_s = reinterpret_cast<int*>(smem_f + (BQ + BKF) * (D + 1) + BKF * D + BQ * (BKF + 1));
  int* kp_s = qp_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int kh = h / (hq / keys.hkv);
  const int tid = threadIdx.x;
  const int i = tid / TPR;  // query row of this thread within the tile
  const int c = tid % TPR;  // its column group
  const int Tk = keys.n + keys.C;

  // this split's key range, in whole tiles
  const int tiles = (Tk + BKF - 1) / BKF;
  const int per = (tiles + splits - 1) / splits;
  const int t_begin = split * per * BKF;
  const int t_end = min(Tk, (split + 1) * per * BKF);

  for (int idx = tid * VEC; idx < BQ * D; idx += NT * VEC) {
    const int r = idx / D, d = idx % D, row = qt * BQ + r;
    float x[VEC];
    if (row < S) {
      rt::load_f32<float, VEC>(q + (((size_t)b * S + row) * hq + h) * D + d, x);
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

  for (int t0 = t_begin; t0 < t_end; t0 += BKF) {
    int live = 0;
    if (tid < BKF) {
      const int j = t0 + tid;
      const int p = j < t_end ? *keys.pos_ptr(b, j) : -1;
      kp_s[tid] = p;
      live = p >= 0 && (!causal || p <= qmax) && (window <= 0 || p > qmin - window);
    }
    if (!__syncthreads_or(live)) continue;  // nothing in this tile is visible

    for (int idx = tid * VEC; idx < BKF * D; idx += NT * VEC) {
      const int jj = idx / D, d = idx % D, j = t0 + jj;
      float kx[VEC], vx[VEC];
      if (j < t_end) {
        const size_t off = keys.row(b, j, kh) * D + d;
        rt::load_f32<float, VEC>(keys.kbase(j) + off, kx);
        rt::load_f32<float, VEC>(keys.vbase(j) + off, vx);
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
      ok[u] = row_ok && visible(kp_s[c + TPR * u], qp, causal, window);
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
    for (int jj = 0; jj < BKF; ++jj) {
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
    for (int e = 0; e < CPT; ++e) out[head * D + c + TPR * e] = acc[e] * inv;
    if (lse != nullptr && c == 0)
      lse[((size_t)b * hq + h) * S + qt * BQ + i] = l > 0.f ? m + logf(l) : rt::kNegInf;
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

template <int D>
constexpr size_t f32_smem_bytes() {
  return ((BQ + BKF) * (D + 1) + BKF * D + BQ * (BKF + 1)) * sizeof(float) +
         (BQ + BKF) * sizeof(int);
}
static_assert(f32_smem_bytes<256>() <= 232448, "f32 flash block within 227 KB");

// Raise a kernel's dynamic shared-memory limit once per instance (the size
// is a constant of the instance).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const Keys<T>& keys, const int* qp, T* out, float* work,
                     float* lse, int B, int S, int hq, int splits, int causal, int window,
                     float scale, float softcap, cudaStream_t st) {
  float* ml = work;
  float* part = work == nullptr ? nullptr : work + (size_t)B * S * hq * splits * 2;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t bytes = TcLayout<D>::bytes;
    static const cudaError_t attr = allow_smem(flash_tc_kernel<D>, bytes);
    if (attr != cudaSuccess) return attr;
    const int rows = S * (hq / keys.hkv);
    flash_tc_kernel<D><<<dim3((rows + BM - 1) / BM, keys.hkv, B * splits), kThreads, bytes, st>>>(
        q, keys, qp, out, ml, part, lse, S, hq, causal, window, scale, softcap, splits);
  } else {
    constexpr size_t bytes = f32_smem_bytes<D>();
    static const cudaError_t attr = allow_smem(flash_f32_kernel<D>, bytes);
    if (attr != cudaSuccess) return attr;
    flash_f32_kernel<D><<<dim3((S + BQ - 1) / BQ, hq, B * splits), NT, bytes, st>>>(
        q, keys, qp, out, ml, part, lse, S, hq, causal, window, scale, softcap, splits);
  }
  if (splits > 1) rt::combine_splits<T, D><<<B * S * hq, D, 0, st>>>(ml, part, out, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* kc,
                     const void* vc, const int* qp, const int* kp, const int* cp, void* out,
                     float* work, float* lse, int B, int S, int C, int n, int hq, int hkv, int d,
                     int splits, int causal, int window, float scale, float softcap,
                     cudaStream_t st) {
  const Keys<T> keys{static_cast<const T*>(k), static_cast<const T*>(v), kp,
                     static_cast<const T*>(kc), static_cast<const T*>(vc), cp, C, n, hkv};
  const T* qq = static_cast<const T*>(q);
  T* oo = static_cast<T*>(out);
  switch (d) {
    case 64: return launch_d<T, 64>(qq, keys, qp, oo, work, lse, B, S, hq, splits, causal, window, scale, softcap, st);
    case 128: return launch_d<T, 128>(qq, keys, qp, oo, work, lse, B, S, hq, splits, causal, window, scale, softcap, st);
    case 256: return launch_d<T, 256>(qq, keys, qp, oo, work, lse, B, S, hq, splits, causal, window, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,Hq,D), chunk k/v (B,C,Hkv,D), out (B,S,Hq,D): contiguous, one
// dtype; q_pos (B,S), k_pos (B,C) int32.  With a ring (n > 0): k_cache /
// v_cache (B,n,Hkv,D) of the same dtype and cache_pos (B,n) int32, whose
// keys precede the chunk's; with n == 0 they may be null.  `work` holds
// B * S * Hq * splits * (D + 2) floats when splits > 1 (unused otherwise).
// `lse`, null on the serving path, takes each row's log-sum-exp of its
// visible logits, (B,Hq,S) f32 (rt::kNegInf where none is visible), for the
// backward; it needs splits == 1.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* k_cache, const void* v_cache,
                                      const void* q_pos, const void* k_pos,
                                      const void* cache_pos, void* out, void* work, void* lse,
                                      int B,
                                      int S, int C, int n, int hq, int hkv, int d, int dtype,
                                      int splits, int causal, int window, float scale,
                                      float softcap, void* stream) {
  if (B <= 0 || S <= 0 || C < 0 || n < 0 || C + n <= 0 || hkv <= 0 || hq % hkv != 0 ||
      hq > 65535 || splits < 1 || (long long)B * splits > 65535 ||
      (splits > 1 && work == nullptr) || (splits > 1 && lse != nullptr) ||
      (n > 0 && (k_cache == nullptr || v_cache == nullptr || cache_pos == nullptr)))
    return cudaErrorInvalidValue;
  const int tk = dtype == rt::kBFloat16 ? (d >= 256 ? 32 : 64) : BKF;  // keys per tile
  if ((C + n + tk - 1) / tk > (long long)splits * kMaxTiles) return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const int* cp = static_cast<const int*>(cache_pos);
  float* ww = static_cast<float*>(work);
  float* ll = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_t<float>(q, k, v, k_cache, v_cache, qp, kp, cp, out, ww, ll, B, S, C, n, hq, hkv, d, splits, causal, window, scale, softcap, st);
  if (dtype == rt::kBFloat16)
    return launch_t<bf16>(q, k, v, k_cache, v_cache, qp, kp, cp, out, ww, ll, B, S, C, n, hq, hkv, d, splits, causal, window, scale, softcap, st);
  return cudaErrorInvalidValue;
}
