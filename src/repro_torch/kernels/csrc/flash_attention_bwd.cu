// Backward of the fused attention with position masks: dQ, dK and dV.
//
// The TPU kernel repro/kernels/flash_attention.py (flash_attention ->
// _flash_kernel) has no backward of its own: the JAX package differentiates
// its jnp path.  The port's forward is the Hopper kernel of
// flash_attention.cu, so its gradient needs this kernel, the half of the
// kernel that jax.grad gives the reference for free.  Same masks as the
// forward: key j is visible to query i when k_pos[b,j] >= 0, and
// k_pos <= q_pos when causal, and k_pos > q_pos - window.  D 64, 128 and 256
// (the wrapper refuses the rest, and a ring of cached keys).
//
// FlashAttention-2's recompute from the forward's log-sum-exp, in float32
// for bf16 and f32 inputs alike:
//   delta_i = rowsum(dO_i * O_i)                       (flash_bwd_delta)
//   P = exp(S * scale - lse),  dP = dO V^T,  dS = P * (dP - delta)
//   dV = P^T dO,  dK = dS^T Q * scale                  (flash_bwd_dkdv_*)
//   dQ = dS K * scale                                  (flash_bwd_dq_*)
// With a softcap c (gemma-style tanh capping of the logits, as the forward
// applies it) the logits are s = c * t, t = tanh(S * scale / c), the lse is
// the capped logits' (the forward's), and dS takes the cap's derivative:
//   P = exp(s - lse),  dS = P * (dP - delta) * (1 - t^2)
// the rest unchanged.  Both kernels recompute t with tanhf, the forward's
// function, and scale dS before it is split or stored; the cap is a
// template flag (kCap), so a call without one runs the uncapped code.
// Deterministic, no float atomics: a dK/dV block owns one key tile of one
// KV head and walks every query tile of every query head of its GQA group
// (at D 256 of one head group, whose partial sums a second kernel adds in
// group order), so the sums are taken in a fixed order; a dQ block owns
// one query tile of one head and walks the key tiles.  A tile pair that no
// (query, key) of it can see, by the positions, is skipped.
//
// Bound on the card: operations (FA2's five products over the visible
// pairs; the two recomputed score products make seven).  bf16 design
// (flash_bwd_dkdv_tc, flash_bwd_dq_tc), on the tensor cores through
// tc.cuh (mma.sync.m16n8k16, bf16 operands by ldmatrix, f32 sums):
//   * dK/dV: a 64-key tile stays in shared memory; two sets of four
//     warps, 16 keys a warp, take the even and the odd (query tile, head)
//     pairs of the GQA group, and set 1's sums are added to set 0's at the
//     end (a fixed order), so the key tile that every causal query sees
//     takes half the time.  S^T = K Q^T and dP^T = V dO^T come out as f32
//     C fragments whose rows are the warp's keys; P^T and dS^T are formed
//     in place, and the C fragments of two neighbouring 8-query tiles are
//     the A fragment of the next product (tc.cuh's note), so
//     dV += P^T dO and dK += dS^T Q run from registers, dO and Q read as B
//     through ldmatrix .trans.  The accumulators stay in registers across
//     the pairs, which stream through cp.async stages (two a set): the
//     next two are requested before the current two are computed.  32
//     queries a pair at D 128 (the 128 f32 accumulators a thread leave
//     room for 32 of scores), 64 at D 64;
//   * D 256 (recurrentgemma-9b's local attention): dK and dV of 16 keys x
//     256 would be 256 f32 accumulators a thread, past the 255 registers,
//     so a dK/dV block owns half of their columns (DC = 128) and there are
//     two blocks a key tile; each recomputes S and dP over all 256 of the
//     depth: a pair costs 8 of one 64-key x 32-query x 256 product (S,
//     dP, and dV and dK as hi + lo, in each half) against 6 for one block
//     over all the columns, a third more tensor-core work, with a block's
//     registers as at D 128.  Under MQA (16 query heads over 1) a block that walked every
//     head of its key tile would make 64 blocks at B 2, S 1024 (half the
//     132 SMs idle), the first key tile's walking 512 pairs against an
//     average of 272; what bounds the kernel there is how the pairs spread
//     over the SMs, not the SM's own rate.  So at D 256 the pairs of a key
//     tile are split by head group: a block owns (tile pair, head group,
//     batch row, column half), walks only its group's heads, and takes key
//     tiles tp and nkt - 1 - tp one after the other, whose causal pair
//     counts add up to the same for every tp.  The groups are equal, the
//     fewest that give each SM a block (the wrapper's bwd_kv_groups): 8
//     groups of 2 heads at B 2, S 1024, 256 blocks of 68 pairs each.  Each
//     block writes its f32 partial dK, dV to a workspace, and
//     flash_bwd_dkdv_reduce adds the partials in group order, applies the
//     scale to dK and rounds once to bf16;
//   * dQ: four warps, 16 query rows each, of a 64-row tile (Q and dO stay
//     in shared memory); K/V tiles of 64 keys (32 at D 256, whose 128
//     accumulators a thread leave room for 32 keys of scores; one block an
//     SM) stream through two cp.async stages; S = Q K^T, dP = dO V^T, then
//     dQ += dS K with K read through ldmatrix .trans;
//   * P and dS are f32 and the oracle keeps them so: each is split into
//     hi = bf16(x) and lo = bf16(x - hi) and both halves are multiplied
//     (dS = P (dP - delta) cancels, so it needs the split more than P):
//     ten products in all, S, dP, dV twice and dK twice in one kernel, S,
//     dP and dQ twice in the other;
//   * a prologue turns the positions into a bitmask of the tiles that
//     meet the block's own (query tiles for dK/dV, key tiles for dQ);
//     only those are requested.  Masks are applied score by score;
//   * grids are 1-D and ordered so that the heaviest causal blocks start
//     first (low key tiles for dK/dV at D 64 and 128, late query tiles for
//     dQ).
// f32 inputs (the identity checks, held at 2e-5) take a CUDA-core body,
// flash_bwd_dkdv_f32 / flash_bwd_dq_f32, selected by dtype: 64 x 64 f32
// tiles in shared memory (32 x 32 at D 256, where four 64-row tiles of 256
// floats would pass the SM's shared memory), a 4 x 4 (2 x 2) register tile
// of scores a thread.  This is a dispatch by dtype, not a fallback: both
// routes launch or fail.
#include <climits>

#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool visible(int p, int qp, int causal, int window) {
  return p >= 0 && (!causal || p <= qp) && (window <= 0 || p > qp - window);
}

// Whether some query in [qlo, qhi] can see some key in [klo, khi].
__device__ __forceinline__ bool tiles_meet(int qlo, int qhi, int klo, int khi, int causal,
                                           int window) {
  if (klo > khi || qlo > qhi) return false;
  return (!causal || klo <= qhi) && (window <= 0 || khi > qlo - window);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
                int B, int S, int hq, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
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

// ---------------------------------------------------------------- bf16 route
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // a dQ block
constexpr int kKvThreads = 2 * kThreads;  // a dK/dV block: two sets of kWarps
constexpr int kRows = 16 * kWarps;   // keys of a dK/dV block, queries of a dQ block
constexpr int kMaxTiles = 8192;      // tiles a bitmask covers

template <int D>
struct KvLayout {  // flash_bwd_dkdv_tc, bytes
  static constexpr int BQ = D >= 128 ? 32 : 64;  // queries of a streamed pair
  static constexpr int DC = D > 128 ? 128 : D;   // dK/dV columns a block owns
  static constexpr int LD = D + 8;               // padded row, bf16
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kRows * LD * sizeof(bf16);
  static constexpr size_t stage0 = v + kRows * LD * sizeof(bf16);
  // a stage: Q, dO (BQ rows), then lse, delta and positions (BQ each);
  // four of them, two for each set of warps
  static constexpr size_t s_do = BQ * LD * sizeof(bf16);
  static constexpr size_t s_lse = 2 * s_do;
  static constexpr size_t s_delta = s_lse + BQ * sizeof(float);
  static constexpr size_t s_qpos = s_delta + BQ * sizeof(float);
  static constexpr size_t stage = s_qpos + BQ * sizeof(int);
  static constexpr size_t bits = stage0 + 4 * stage;
  static constexpr size_t bytes = bits + kMaxTiles / 8;
  static_assert(stage % 16 == 0 && s_do % 16 == 0, "16-byte rows");
  // at the end the second set's dK and dV (f32) pass through the stages
  static_assert(2 * kRows * DC * sizeof(float) <= 4 * stage, "dK/dV exchange fits the stages");
  static_assert(bytes + 1024 <= 233472, "a dK/dV block within the SM");
};

template <int D>
struct QLayout {  // flash_bwd_dq_tc, bytes
  static constexpr int BK = D > 128 ? 32 : 64;   // keys of a streamed tile
  static constexpr int LD = D + 8;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + kRows * LD * sizeof(bf16);
  static constexpr size_t stage0 = dout + kRows * LD * sizeof(bf16);
  // a stage: K, V (BK rows), then the keys' positions
  static constexpr size_t s_v = BK * LD * sizeof(bf16);
  static constexpr size_t s_kpos = 2 * s_v;
  static constexpr size_t stage = s_kpos + BK * sizeof(int);
  static constexpr size_t bits = stage0 + 2 * stage;
  static constexpr size_t bytes = bits + kMaxTiles / 8;
  static_assert(stage % 16 == 0 && s_v % 16 == 0, "16-byte rows");
  // two dQ blocks an SM, one at D 256
  static_assert((D > 128 ? 1 : 2) * (bytes + 1024) <= 233472, "dQ blocks within the SM");
};

// min and max over the warp of the live positions lo/hi (INT_MAX / INT_MIN
// where none).
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// Bitmask (smem, kMaxTiles bits) of the n tiles of `len` positions each,
// starting at pos, that meet [olo, ohi] on the other side: warp w takes
// tiles w, w + warps, ...  keys: positions < 0 are holes.  The block
// synchronises before and after.  Returns the number of live tiles.
__device__ int live_tiles(uint32_t* bits, const int* __restrict__ pos, int total, int len,
                          int n, bool keys, int olo, int ohi, int causal, int window) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int w = threadIdx.x; w < (n + 31) / 32; w += blockDim.x) bits[w] = 0;
  __syncthreads();
  for (int t = warp; t < n; t += warps) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < len; r += 32) {
      const int i = t * len + r;
      if (i < total) {
        const int p = pos[i];
        if (!keys || p >= 0) {
          lo = min(lo, p);
          hi = max(hi, p);
        }
      }
    }
    warp_range(lo, hi);
    const bool meet = keys ? tiles_meet(olo, ohi, lo, hi, causal, window)
                           : tiles_meet(lo, hi, olo, ohi, causal, window);
    if (lane == 0 && meet) atomicOr(&bits[t / 32], 1u << (t % 32));
  }
  __syncthreads();
  int live = 0;
  for (int w = 0; w < (n + 31) / 32; ++w) live += __popc(bits[w]);
  return live;
}

// The first live tile at or after `from` (n when none).
__device__ __forceinline__ int next_live(const uint32_t* bits, int from, int n) {
  for (int w = from / 32; w * 32 < n; ++w) {
    const uint32_t m = bits[w] & (w == from / 32 ? ~0u << (from % 32) : ~0u);
    if (m) return w * 32 + __ffs(m) - 1;
  }
  return n;
}

// c += A·B over a 16 x NB tile: A rows from `a` (row-major, LD), B^T rows
// (n) from `bt` (row-major [n][k], LD), depth D; the warp's scores of Q·Kᵀ.
template <int D, int NB, int LD>
__device__ __forceinline__ void scores16(float (&c)[NB / 8][4], const bf16* a, const bf16* bt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NB / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    rt::ldmatrix_x4(af, a + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nn = 0; nn < NB / 16; ++nn) {
      uint32_t bf[4];
      rt::ldmatrix_x4(bf, bt + (nn * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                              ((lane / 8) % 2) * 8);
      rt::mma_bf16(c[2 * nn], af, bf[0], bf[1]);
      rt::mma_bf16(c[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += X·M, X the warp's f32 C fragments (16 x NK), split into
// bf16 hi + lo; M rows (k) from `m` (row-major [k][d], LD) through
// ldmatrix .trans.
template <int D, int NK, int LD>
__device__ __forceinline__ void accumulate_split(float (&acc)[D / 8][4], const float (&x)[NK / 8][4],
                                                 const bf16* m) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t hi[4], lo[4];
    rt::split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    rt::split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    rt::split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    rt::split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bm[4];
      rt::ldmatrix_x4_trans(bm, m + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dn * 16 +
                                    (lane / 16) * 8);
      rt::mma_bf16(acc[2 * dn], hi, bm[0], bm[1]);
      rt::mma_bf16(acc[2 * dn], lo, bm[0], bm[1]);
      rt::mma_bf16(acc[2 * dn + 1], hi, bm[2], bm[3]);
      rt::mma_bf16(acc[2 * dn + 1], lo, bm[2], bm[3]);
    }
  }
}

// The warp's 16 rows of acc * mult as bf16 into rows row0.. of dst (row r
// at dst + r * stride), rows >= nrows skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t stride,
                                           const float (&acc)[D / 8][4], int row0, int nrows,
                                           float mult) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= nrows) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + r * stride + nt * 8 + 2 * tq) =
          rt::pack_bf16(acc[nt][2 * half] * mult, acc[nt][2 * half + 1] * mult);
  }
}

// The warp's 16 rows of acc as f32 into rows row0.. of dst (row r at dst +
// r * stride), rows >= nrows skipped.
template <int DC>
__device__ __forceinline__ void store_part(float* __restrict__ dst, size_t stride,
                                           const float (&acc)[DC / 8][4], int row0, int nrows) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= nrows) continue;
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt)
      *reinterpret_cast<float2*>(dst + r * stride + nt * 8 + 2 * tq) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// dK, dV of 64-key tiles of KV head kh, batch row b (columns [c0, c0 + DC)
// of them: both halves at D 256).  Two sets of four warps (16 keys a warp
// each) share the K/V tile: set 0 takes the even (query tile, head) pairs
// and set 1 the odd ones, so a key tile that every query sees takes half as
// long; at the end set 1's sums are added to set 0's, a fixed order.
//   D 64, 128: block (key tile, batch row, KV head), the key tile slowest,
//   so that the low tiles, which the most causal queries see, start first;
//   it walks every head of the GQA group and rounds dK, dV to bf16.
//   D 256: block (tile pair, head group, batch row, KV head, column half);
//   it takes key tiles tp and nkt - 1 - tp one after the other (their
//   causal pair counts add up to the same for every tp), walks the heads
//   of its group only, and writes f32 partials that flash_bwd_dkdv_reduce
//   adds in group order.
template <int D, bool kCap>
__global__ void __launch_bounds__(kKvThreads)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                  int groups, int B, int S, int T_, int hq, int hkv, int causal, int window,
                  float scale, float softcap) {
  using L = KvLayout<D>;
  constexpr bool kSplit = D > 128;
  constexpr int BQ = L::BQ, LD = L::LD, CPR = D / 8, DC = L::DC, NH = D / DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* Ks = reinterpret_cast<const bf16*>(smem + L::k);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L::v);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::bits);

  int x = blockIdx.x;
  const int c0 = x % NH * DC;
  x /= NH;
  const int kh = x % hkv;
  x /= hkv;
  const int b = x % B;
  x /= B;
  const int g = kSplit ? x % groups : 0, kt0 = kSplit ? x / groups : x;
  const int rep = hq / hkv, nkt = (T_ + kRows - 1) / kRows;
  // the group's heads kh * rep + [hlo, hlo + nh)
  const int hlo = kSplit ? g * rep / groups : 0;
  const int nh = kSplit ? (g + 1) * rep / groups - hlo : rep;
  const int units = kSplit && nkt - 1 - kt0 != kt0 ? 2 : 1;
  const int tid = threadIdx.x, lane = tid % 32, g4 = lane / 4, tq = lane % 4;
  const int set = tid / kThreads, kw = (tid / 32) % kWarps;  // the warp's keys: kw * 16..
  const int ntq = (S + BQ - 1) / BQ;
  // logits enter exp2 in log2 units: S * c2, or under a cap s * c2
  const float c2 = (kCap ? 1.f : scale) * rt::kLog2e, su = kCap ? scale / softcap : 0.f;

  for (int u = 0; u < units; ++u) {
    const int kt = u == 0 ? kt0 : nkt - 1 - kt0;
    const int k0 = kt * kRows, nk = min(kRows, T_ - k0);
    // the resident K and V tiles (rows >= nk zero)
    const size_t kbase = (((size_t)b * T_ + k0) * hkv + kh) * D;
    for (int idx = tid; idx < kRows * CPR; idx += kKvThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = r < nk;
      const size_t off = ok ? kbase + (size_t)r * hkv * D + c * 8 : 0;
      rt::cp_async16(smem + L::k + (r * LD + c * 8) * sizeof(bf16), k + off, ok);
      rt::cp_async16(smem + L::v + (r * LD + c * 8) * sizeof(bf16), v + off, ok);
    }
    rt::cp_async_commit();

    // positions of this thread's two keys, and the tile's live range
    const int kr = kw * 16 + g4;
    const int* kpb = k_pos + (size_t)b * T_ + k0;
    const int kp0 = kr < nk ? kpb[kr] : -1, kp1 = kr + 8 < nk ? kpb[kr + 8] : -1;
    int klo = INT_MAX, khi = INT_MIN;
    for (int c = lane; c < nk; c += 32) {
      const int p = kpb[c];
      if (p >= 0) {
        klo = min(klo, p);
        khi = max(khi, p);
      }
    }
    warp_range(klo, khi);
    const int nlive = live_tiles(bits, q_pos + (size_t)b * S, S, BQ, ntq, false, klo, khi, causal,
                                 window);

    // pair (query tile t, head kh * rep + hlo + hh) into stage s (0..3)
    auto request = [&](int t, int hh, int s) {
      unsigned char* st = smem + L::stage0 + s * L::stage;
      const int q0 = t * BQ, h = kh * rep + hlo + hh;
      for (int idx = tid; idx < BQ * CPR; idx += kKvThreads) {
        const int r = idx / CPR, c = idx % CPR;
        const bool ok = q0 + r < S;
        const size_t off = ok ? (((size_t)b * S + q0 + r) * hq + h) * D + c * 8 : 0;
        rt::cp_async16(st + (r * LD + c * 8) * sizeof(bf16), q + off, ok);
        rt::cp_async16(st + L::s_do + (r * LD + c * 8) * sizeof(bf16), dout + off, ok);
      }
      float* ls = reinterpret_cast<float*>(st + L::s_lse);
      float* dl = reinterpret_cast<float*>(st + L::s_delta);
      int* qp = reinterpret_cast<int*>(st + L::s_qpos);
      for (int r = tid; r < BQ; r += kKvThreads) {
        const int i = q0 + r;
        if (i < S) {
          const size_t at = ((size_t)b * hq + h) * S + i;
          rt::cp_async4(ls + r, lse + at);
          rt::cp_async4(dl + r, delta + at);
          rt::cp_async4(qp + r, q_pos + (size_t)b * S + i);
        } else {  // a row past S: P = exp2(-inf) = 0
          ls[r] = INFINITY;
          dl[r] = 0.f;
          qp[r] = 0;
        }
      }
    };
    // the pairs in order, query tile by query tile, head by head: pairs
    // 2i and 2i + 1 go to stages 2 (i % 2) and 2 (i % 2) + 1
    int rt_ = next_live(bits, 0, ntq), rh = 0;  // the next pair to request
    auto request_two = [&](int parity) {
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        if (rt_ >= ntq) break;
        request(rt_, rh, 2 * parity + s2);
        if (++rh == nh) rh = 0, rt_ = next_live(bits, rt_ + 1, ntq);
      }
    };

    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int i = 0; i < DC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

    const int pairs = nlive * nh;
    request_two(0);
    rt::cp_async_commit();
    for (int it = 0; 2 * it < pairs; ++it) {
      rt::cp_async_wait<0>();
      __syncthreads();  // pairs 2 it, 2 it + 1 have landed; the stages read at it - 1 are free
      request_two((it + 1) % 2);
      rt::cp_async_commit();
      if (2 * it + set >= pairs) continue;  // set 1 past an odd count (warp-uniform)

      const unsigned char* st = smem + L::stage0 + (2 * (it % 2) + set) * L::stage;
      const bf16* Qs = reinterpret_cast<const bf16*>(st);
      const bf16* Os = reinterpret_cast<const bf16*>(st + L::s_do);
      const float* ls = reinterpret_cast<const float*>(st + L::s_lse);
      const float* dl = reinterpret_cast<const float*>(st + L::s_delta);
      const int* qp = reinterpret_cast<const int*>(st + L::s_qpos);

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BQ queries
      float sc[BQ / 8][4], dp[BQ / 8][4];
      scores16<D, BQ, LD>(sc, Ks + kw * 16 * LD, Qs);
      scores16<D, BQ, LD>(dp, Vs + kw * 16 * LD, Os);
      // P^T and dS^T = P^T * (dP^T - delta) (times 1 - t^2 under a cap) in
      // place; query column c
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * tq + e;
          const int qq = qp[c];
          const float l2 = ls[c] * rt::kLog2e, d = dl[c];
          float x0 = sc[nt][e], x1 = sc[nt][e + 2], t0 = 0.f, t1 = 0.f;
          if constexpr (kCap) {
            t0 = tanhf(x0 * su);
            t1 = tanhf(x1 * su);
            x0 = softcap * t0;
            x1 = softcap * t1;
          }
          const float p0 = visible(kp0, qq, causal, window)
                               ? rt::exp2_approx(fmaf(x0, c2, -l2)) : 0.f;
          const float p1 = visible(kp1, qq, causal, window)
                               ? rt::exp2_approx(fmaf(x1, c2, -l2)) : 0.f;
          sc[nt][e] = p0;
          sc[nt][e + 2] = p1;
          dp[nt][e] = p0 * (dp[nt][e] - d);
          dp[nt][e + 2] = p1 * (dp[nt][e + 2] - d);
          if constexpr (kCap) {
            dp[nt][e] *= fmaf(-t0, t0, 1.f);
            dp[nt][e + 2] *= fmaf(-t1, t1, 1.f);
          }
        }
      }
      accumulate_split<DC, BQ, LD>(dva, sc, Os + c0);  // dV += P^T dO
      accumulate_split<DC, BQ, LD>(dka, dp, Qs + c0);  // dK += dS^T Q
    }
    rt::cp_async_wait<0>();
    __syncthreads();  // every stage is consumed: they carry set 1's sums

    // set 1 hands its fragments to the set-0 thread of the same (warp,
    // lane), which holds the same elements; lanes on consecutive words
    float* xk = reinterpret_cast<float*>(smem + L::stage0);
    float* xv = xk + kRows * DC;
    auto at = [&](int nt, int e) { return ((kw * (DC / 8) + nt) * 4 + e) * 32 + lane; };
    if (set == 1) {
#pragma unroll
      for (int nt = 0; nt < DC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xk[at(nt, e)] = dka[nt][e];
          xv[at(nt, e)] = dva[nt][e];
        }
    }
    __syncthreads();
    if (set == 0) {
#pragma unroll
      for (int nt = 0; nt < DC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dka[nt][e] += xk[at(nt, e)];
          dva[nt][e] += xv[at(nt, e)];
        }
      const size_t stride = (size_t)hkv * D;
      if (kSplit) {  // group g's partials: planes [groups][B][T][hkv][D], dK's then dV's
        const size_t plane = (size_t)B * T_ * hkv * D;
        store_part<DC>(part + g * plane + kbase + c0, stride, dka, kw * 16, nk);
        store_part<DC>(part + (groups + g) * plane + kbase + c0, stride, dva, kw * 16, nk);
      } else {
        store_rows<DC>(dk + kbase + c0, stride, dka, kw * 16, nk, scale);
        store_rows<DC>(dv + kbase + c0, stride, dva, kw * 16, nk, 1.f);
      }
    }
    __syncthreads();  // the exchange is read and the tiles free before the next unit
  }
}

// dK = scale * (sum of the groups' partials), dV = their sum, each added in
// group order and rounded once to bf16: four elements a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_reduce(const float* __restrict__ part, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, long long n4, int groups, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const size_t plane = (size_t)n4 * 4;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int gg = 0; gg < groups; ++gg) {
    const float4 a = reinterpret_cast<const float4*>(part + gg * plane)[i];
    const float4 c = reinterpret_cast<const float4*>(part + (groups + gg) * plane)[i];
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += c.x;
    sv.y += c.y;
    sv.z += c.z;
    sv.w += c.w;
  }
  reinterpret_cast<uint2*>(dk)[i] =
      make_uint2(rt::pack_bf16(sk.x * scale, sk.y * scale), rt::pack_bf16(sk.z * scale, sk.w * scale));
  reinterpret_cast<uint2*>(dv)[i] = make_uint2(rt::pack_bf16(sv.x, sv.y), rt::pack_bf16(sv.z, sv.w));
}

// dQ of one 64-query tile of head h, batch row b.  Block index: (query
// tile, batch row, head), the tile slowest and, when causal, last first:
// the late queries see the most keys.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                bf16* __restrict__ dq, int B, int S, int T_, int hq, int hkv, int causal,
                int window, float scale, float softcap) {
  using L = QLayout<D>;
  constexpr int BK = L::BK, LD = L::LD, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* Qs = reinterpret_cast<const bf16*>(smem + L::q);
  const bf16* Os = reinterpret_cast<const bf16*>(smem + L::dout);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L::bits);

  const int per_tile = B * hq, ntq = (S + kRows - 1) / kRows;
  const int ti = blockIdx.x / per_tile;
  const int qt = causal ? ntq - 1 - ti : ti;
  const int b = (blockIdx.x % per_tile) / hq, h = blockIdx.x % hq;
  const int kh = h / (hq / hkv), q0 = qt * kRows, nq = min(kRows, S - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;

  // the resident Q and dO tiles (rows >= nq zero)
  const size_t base = (((size_t)b * S + q0) * hq + h) * D;
  for (int idx = tid; idx < kRows * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < nq;
    const size_t off = ok ? base + (size_t)r * hq * D + c * 8 : 0;
    rt::cp_async16(smem + L::q + (r * LD + c * 8) * sizeof(bf16), q + off, ok);
    rt::cp_async16(smem + L::dout + (r * LD + c * 8) * sizeof(bf16), dout + off, ok);
  }
  rt::cp_async_commit();

  // this thread's two query rows: position, lse (log2 units; +inf past S,
  // so P = 0 there), delta; and the tile's range
  const int qr = warp * 16 + g;
  const int* qpb = q_pos + (size_t)b * S + q0;
  const float* lsb = lse + ((size_t)b * hq + h) * S + q0;
  const float* dlb = delta + ((size_t)b * hq + h) * S + q0;
  const int qp0 = qr < nq ? qpb[qr] : 0, qp1 = qr + 8 < nq ? qpb[qr + 8] : 0;
  const float l20 = qr < nq ? lsb[qr] * rt::kLog2e : INFINITY;
  const float l21 = qr + 8 < nq ? lsb[qr + 8] * rt::kLog2e : INFINITY;
  const float dl0 = qr < nq ? dlb[qr] : 0.f, dl1 = qr + 8 < nq ? dlb[qr + 8] : 0.f;
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = lane; r < nq; r += 32) {
    qlo = min(qlo, qpb[r]);
    qhi = max(qhi, qpb[r]);
  }
  warp_range(qlo, qhi);
  const int ntk = (T_ + BK - 1) / BK;
  const int nlive = live_tiles(bits, k_pos + (size_t)b * T_, T_, BK, ntk, true, qlo, qhi, causal,
                               window);

  const int* kpg = k_pos + (size_t)b * T_;
  auto request = [&](int t, int s) {
    unsigned char* st = smem + L::stage0 + s * L::stage;
    const int j0 = t * BK;
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = j0 + r < T_;
      const size_t off = ok ? (((size_t)b * T_ + j0 + r) * hkv + kh) * D + c * 8 : 0;
      rt::cp_async16(st + (r * LD + c * 8) * sizeof(bf16), k + off, ok);
      rt::cp_async16(st + L::s_v + (r * LD + c * 8) * sizeof(bf16), v + off, ok);
    }
    int* kp = reinterpret_cast<int*>(st + L::s_kpos);
    for (int r = tid; r < BK; r += kThreads) {
      if (j0 + r < T_)
        rt::cp_async4(kp + r, kpg + j0 + r);
      else
        kp[r] = -1;
    }
  };

  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  const float c2 = (kCap ? 1.f : scale) * rt::kLog2e, su = kCap ? scale / softcap : 0.f;

  int req = next_live(bits, 0, ntk);
  if (req < ntk) {
    request(req, 0);
    req = next_live(bits, req + 1, ntk);
  }
  rt::cp_async_commit();
  for (int it = 0; it < nlive; ++it) {
    rt::cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; the stage read at it - 1 is free
    if (req < ntk) {
      request(req, (it + 1) % 2);
      req = next_live(bits, req + 1, ntk);
    }
    rt::cp_async_commit();

    const unsigned char* st = smem + L::stage0 + (it % 2) * L::stage;
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    const bf16* Vs = reinterpret_cast<const bf16*>(st + L::s_v);
    const int* kp = reinterpret_cast<const int*>(st + L::s_kpos);

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x BK keys
    float sc[BK / 8][4], dp[BK / 8][4];
    scores16<D, BK, LD>(sc, Qs + warp * 16 * LD, Ks);
    scores16<D, BK, LD>(dp, Os + warp * 16 * LD, Vs);
    // dS = P * (dP - delta) (times 1 - t^2 under a cap) into dp; key
    // column c
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = kp[nt * 8 + 2 * tq + e];
        float x0 = sc[nt][e], x1 = sc[nt][e + 2], t0 = 0.f, t1 = 0.f;
        if constexpr (kCap) {
          t0 = tanhf(x0 * su);
          t1 = tanhf(x1 * su);
          x0 = softcap * t0;
          x1 = softcap * t1;
        }
        const float p0 = visible(p, qp0, causal, window)
                             ? rt::exp2_approx(fmaf(x0, c2, -l20)) : 0.f;
        const float p1 = visible(p, qp1, causal, window)
                             ? rt::exp2_approx(fmaf(x1, c2, -l21)) : 0.f;
        dp[nt][e] = p0 * (dp[nt][e] - dl0);
        dp[nt][e + 2] = p1 * (dp[nt][e + 2] - dl1);
        if constexpr (kCap) {
          dp[nt][e] *= fmaf(-t0, t0, 1.f);
          dp[nt][e + 2] *= fmaf(-t1, t1, 1.f);
        }
      }
    }
    accumulate_split<D, BK, LD>(dqa, dp, Ks);  // dQ += dS K
  }
  rt::cp_async_wait<0>();
  store_rows<D>(dq + base, (size_t)hq * D, dqa, warp * 16, nq, scale);
}

// ----------------------------------------------------------------- f32 route
constexpr int NT = 256;     // threads per block

template <int D>
struct Layout {  // shared memory, in floats (ints after)
  // query rows and keys a tile: 64, or 32 at D 256 (four 64-row tiles of
  // 256 floats would pass the SM's shared memory); R = BT / 16 rows of
  // scores a thread
  static constexpr int BT = D > 128 ? 32 : 64, R = BT / 16;
  static constexpr int LD = D + 1, LDP = BT + 1;
  static constexpr int q = 0;
  static constexpr int dout = q + BT * LD;
  static constexpr int k = dout + BT * LD;
  static constexpr int v = k + BT * LD;
  static constexpr int p = v + BT * LD;
  static constexpr int ds = p + BT * LDP;
  static constexpr int lse = ds + BT * LDP;
  static constexpr int delta = lse + BT;
  static constexpr int qpos = delta + BT;  // int
  static constexpr int kpos = qpos + BT;   // int
  static constexpr size_t bytes = (size_t)(kpos + BT) * 4;
  static_assert(bytes <= 232448, "flash backward block within 227 KB");
};

// rows x D floats at src (row r at src + r * stride) into the shared tile
// dst (row length LD); rows >= nrows are zero.  16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          size_t stride, int nrows, int rows) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x * 4; idx < rows * D; idx += NT * 4) {
    const int r = idx / D, d = idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nrows) rt::load_f32<float, 4>(src + r * stride + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * LD + d + e] = x[e];
  }
}

// shared tile (row length D + 1) to rows at dst, times mult.
template <int D>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src,
                                           size_t stride, int nrows, float mult) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < nrows * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r * stride + d] = src[r * LD + d] * mult;
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

// The warp-synchronous score tile: rows tr + 16 i and keys tc + 16 j of the
// shared Q/dO and K/V tiles; S = Q K^T and dP = dO V^T, R x R per thread.
template <int D>
__device__ __forceinline__ void scores(const float* sm, int tr, int tc,
                                       float (&s)[Layout<D>::R][Layout<D>::R],
                                       float (&dp)[Layout<D>::R][Layout<D>::R]) {
  using L = Layout<D>;
  constexpr int LD = L::LD, R = L::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qd[R], od[R], kd[R], vd[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qd[i] = sm[L::q + (tr + 16 * i) * LD + d];
      od[i] = sm[L::dout + (tr + 16 * i) * LD + d];
      kd[i] = sm[L::k + (tc + 16 * i) * LD + d];
      vd[i] = sm[L::v + (tc + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
        dp[i][j] = fmaf(od[i], vd[j], dp[i][j]);
      }
  }
}

// P and dS of the tile into shared memory (P only where want_p); under a
// cap the logits are softcap * tanh(S * scale / softcap), as the forward's
// rt::soft_cap, and dS takes 1 - t^2.
template <int D, bool kCap>
__device__ __forceinline__ void probs(float* sm, int q0, int k0, int S, int T, int causal,
                                      int window, float scale, float softcap, bool want_p) {
  using L = Layout<D>;
  constexpr int R = L::R, LDP = L::LDP;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int* qps = reinterpret_cast<const int*>(sm + L::qpos);
  const int* kps = reinterpret_cast<const int*>(sm + L::kpos);
  float s[R][R], dp[R][R];
  scores<D>(sm, tr, tc, s, dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = tr + 16 * i;
    const float lse = sm[L::lse + r], dl = sm[L::delta + r];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tc + 16 * j;
      const bool vis = q0 + r < S && k0 + c < T && visible(kps[c], qps[r], causal, window);
      float p, t = 0.f;
      if constexpr (kCap) {
        t = tanhf(s[i][j] * scale / softcap);
        p = vis ? expf(softcap * t - lse) : 0.f;
      } else {
        p = vis ? expf(fmaf(s[i][j], scale, -lse)) : 0.f;
      }
      if (want_p) sm[L::p + r * LDP + c] = p;
      sm[L::ds + r * LDP + c] = p * (dp[i][j] - dl) * (kCap ? fmaf(-t, t, 1.f) : 1.f);
    }
  }
}

// Loads of one (query tile, head) into shared memory: Q, dO, lse, delta,
// the query positions.
template <int D>
__device__ __forceinline__ void load_queries(float* sm, const float* q, const float* dout,
                                             const float* lse, const float* delta, const int* qp,
                                             int b, int h, int q0, int S, int hq) {
  using L = Layout<D>;
  constexpr int BQ = L::BT;
  const int nq = min(BQ, S - q0);
  const size_t base = (((size_t)b * S + q0) * hq + h) * D;
  load_tile<D>(sm + L::q, q + base, (size_t)hq * D, nq, BQ);
  load_tile<D>(sm + L::dout, dout + base, (size_t)hq * D, nq, BQ);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool ok = r < nq;
    const size_t at = ((size_t)b * hq + h) * S + q0 + r;
    sm[L::lse + r] = ok ? lse[at] : 0.f;
    sm[L::delta + r] = ok ? delta[at] : 0.f;
    reinterpret_cast<int*>(sm + L::qpos)[r] = ok ? qp[(size_t)b * S + q0 + r] : 0;
  }
}

// dK, dV of one key tile of KV head kh, batch row b: block (key tile, kh, b).
template <int D, bool kCap>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int T_, int hq, int hkv,
                   int causal, int window, float scale, float softcap) {
  using L = Layout<D>;
  constexpr int LD = L::LD, E = D / 16, R = L::R, BQ = L::BT, BKV = L::BT, LDP = L::LDP;
  extern __shared__ float sm[];
  int* qps = reinterpret_cast<int*>(sm + L::qpos);
  int* kps = reinterpret_cast<int*>(sm + L::kpos);
  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv, nk = min(BKV, T_ - k0);
  const size_t kbase = (((size_t)b * T_ + k0) * hkv + kh) * D;
  load_tile<D>(sm + L::k, k + kbase, (size_t)hkv * D, nk, BKV);
  load_tile<D>(sm + L::v, v + kbase, (size_t)hkv * D, nk, BKV);
  for (int c = threadIdx.x; c < BKV; c += NT) kps[c] = c < nk ? k_pos[(size_t)b * T_ + k0 + c] : -1;
  __syncthreads();
  int klo, khi;
  pos_range(kps, BKV, true, klo, khi);

  // this thread's share of dK and dV: keys kc + 16 j, columns dc + 16 e
  const int kc = threadIdx.x % 16, dc = threadIdx.x / 16;
  float ak[R][E], av[R][E];
#pragma unroll
  for (int j = 0; j < R; ++j)
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
      load_queries<D>(sm, q, dout, lse, delta, q_pos, b, h, q0, S, hq);
      __syncthreads();
      probs<D, kCap>(sm, q0, k0, S, T_, causal, window, scale, softcap, true);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pj[R], sj[R], od[E], qd[E];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          pj[j] = sm[L::p + r * LDP + kc + 16 * j];
          sj[j] = sm[L::ds + r * LDP + kc + 16 * j];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          od[e] = sm[L::dout + r * LD + dc + 16 * e];
          qd[e] = sm[L::q + r * LD + dc + 16 * e];
        }
#pragma unroll
        for (int j = 0; j < R; ++j)
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
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sm[L::k + (kc + 16 * j) * LD + dc + 16 * e] = ak[j][e];
      sm[L::v + (kc + 16 * j) * LD + dc + 16 * e] = av[j][e];
    }
  __syncthreads();
  store_tile<D>(dk + kbase, sm + L::k, (size_t)hkv * D, nk, scale);
  store_tile<D>(dv + kbase, sm + L::v, (size_t)hkv * D, nk, 1.f);
}

// dQ of one query tile of head h, batch row b: block (query tile, h, b).
template <int D, bool kCap>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                 float* __restrict__ dq, int S, int T_, int hq, int hkv, int causal, int window,
                 float scale, float softcap) {
  using L = Layout<D>;
  constexpr int LD = L::LD, E = D / 16, R = L::R, BQ = L::BT, BKV = L::BT, LDP = L::LDP;
  extern __shared__ float sm[];
  int* qps = reinterpret_cast<int*>(sm + L::qpos);
  int* kps = reinterpret_cast<int*>(sm + L::kpos);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (hq / hkv), nq = min(BQ, S - q0);
  load_queries<D>(sm, q, dout, lse, delta, q_pos, b, h, q0, S, hq);
  __syncthreads();
  int qlo, qhi;
  pos_range(qps, nq, false, qlo, qhi);

  // this thread's share of dQ: rows rq + 16 i, columns dc + 16 e
  const int rq = threadIdx.x % 16, dc = threadIdx.x / 16;
  float aq[R][E];
#pragma unroll
  for (int i = 0; i < R; ++i)
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
    load_tile<D>(sm + L::k, k + kbase, (size_t)hkv * D, nk, BKV);
    load_tile<D>(sm + L::v, v + kbase, (size_t)hkv * D, nk, BKV);
    __syncthreads();
    probs<D, kCap>(sm, q0, k0, S, T_, causal, window, scale, softcap, false);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      float sd[R], kd[E];
#pragma unroll
      for (int i = 0; i < R; ++i) sd[i] = sm[L::ds + (rq + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < E; ++e) kd[e] = sm[L::k + c * LD + dc + 16 * e];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) aq[i][e] = fmaf(sd[i], kd[e], aq[i][e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) sm[L::q + (rq + 16 * i) * LD + dc + 16 * e] = aq[i][e];
  __syncthreads();
  const size_t base = (((size_t)b * S + q0) * hq + h) * D;
  store_tile<D>(dq + base, sm + L::q, (size_t)hq * D, nq, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
void launch_delta(const T* out, const T* dout, float* delta, int B, int S, int hq, int D,
                  cudaStream_t st) {
  const long long rows = (long long)B * S * hq;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(out, dout, delta, B, S, hq, D);
}

template <int D, bool kCap>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                      const bf16* dout, const float* lse, const int* qp, const int* kp,
                      float* delta, float* part, int groups, bf16* dq, bf16* dk, bf16* dv, int B,
                      int S, int T_, int hq, int hkv, int causal, int window, float scale,
                      float softcap, cudaStream_t st) {
  using LK = KvLayout<D>;
  using LQ = QLayout<D>;
  constexpr bool kSplit = D > 128;
  if ((S + LK::BQ - 1) / LK::BQ > kMaxTiles || (T_ + LQ::BK - 1) / LQ::BK > kMaxTiles)
    return cudaErrorInvalidValue;
  if (kSplit && (part == nullptr || groups < 1 || groups > hq / hkv)) return cudaErrorInvalidValue;
  static const cudaError_t a1 = allow_smem(flash_bwd_dkdv_tc<D, kCap>, LK::bytes);
  static const cudaError_t a2 = allow_smem(flash_bwd_dq_tc<D, kCap>, LQ::bytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  launch_delta<bf16>(out, dout, delta, B, S, hq, D, st);
  const long long nkt = (T_ + kRows - 1) / kRows;
  // D 256: tile pairs x head groups; otherwise key tiles
  const long long kv_blocks =
      (kSplit ? (nkt + 1) / 2 * groups : nkt) * B * hkv * (D / LK::DC);
  const long long q_blocks = (long long)((S + kRows - 1) / kRows) * B * hq;
  const long long n4 = (long long)B * T_ * hkv * D / 4;
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX || (n4 + 255) / 256 > INT_MAX)
    return cudaErrorInvalidValue;
  flash_bwd_dkdv_tc<D, kCap><<<(unsigned)kv_blocks, kKvThreads, LK::bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dk, dv, part, groups, B, S, T_, hq, hkv, causal, window,
      scale, softcap);
  if (kSplit)
    flash_bwd_dkdv_reduce<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(part, dk, dv, n4, groups,
                                                                         scale);
  flash_bwd_dq_tc<D, kCap><<<(unsigned)q_blocks, kThreads, LQ::bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dq, B, S, T_, hq, hkv, causal, window, scale, softcap);
  return cudaGetLastError();
}

template <int D, bool kCap>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* out,
                       const float* dout, const float* lse, const int* qp, const int* kp,
                       float* delta, float* dq, float* dk, float* dv, int B, int S, int T_,
                       int hq, int hkv, int causal, int window, float scale, float softcap,
                       cudaStream_t st) {
  constexpr size_t bytes = Layout<D>::bytes;
  constexpr int BT = Layout<D>::BT;
  static const cudaError_t a1 = allow_smem(flash_bwd_dkdv_f32<D, kCap>, bytes);
  static const cudaError_t a2 = allow_smem(flash_bwd_dq_f32<D, kCap>, bytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  launch_delta<float>(out, dout, delta, B, S, hq, D, st);
  flash_bwd_dkdv_f32<D, kCap><<<dim3((T_ + BT - 1) / BT, hkv, B), NT, bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dk, dv, S, T_, hq, hkv, causal, window, scale, softcap);
  flash_bwd_dq_f32<D, kCap><<<dim3((S + BT - 1) / BT, hq, B), NT, bytes, st>>>(
      q, k, v, dout, lse, delta, qp, kp, dq, S, T_, hq, hkv, causal, window, scale, softcap);
  return cudaGetLastError();
}

// Every instantiation of one cap flag, by dtype and head_dim.
template <bool kCap>
cudaError_t launch_all(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* l, const int* qp, const int* kp, float* dl,
                       float* pt, void* dq, void* dk, void* dv, int B, int S, int T, int hq,
                       int hkv, int d, int dtype, int causal, int window, int groups, float scale,
                       float softcap, cudaStream_t st) {
  if (dtype == rt::kFloat32) {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    auto m = [](void* p) { return static_cast<float*>(p); };
    if (d == 64)
      return launch_f32<64, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, m(dq), m(dk),
                                  m(dv), B, S, T, hq, hkv, causal, window, scale, softcap, st);
    if (d == 128)
      return launch_f32<128, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, m(dq), m(dk),
                                   m(dv), B, S, T, hq, hkv, causal, window, scale, softcap, st);
    if (d == 256)
      return launch_f32<256, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, m(dq), m(dk),
                                   m(dv), B, S, T, hq, hkv, causal, window, scale, softcap, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == rt::kBFloat16) {
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    auto m = [](void* p) { return static_cast<bf16*>(p); };
    if (d == 64)
      return launch_tc<64, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, pt, 1, m(dq),
                                 m(dk), m(dv), B, S, T, hq, hkv, causal, window, scale, softcap,
                                 st);
    if (d == 128)
      return launch_tc<128, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, pt, 1, m(dq),
                                  m(dk), m(dv), B, S, T, hq, hkv, causal, window, scale, softcap,
                                  st);
    if (d == 256)
      return launch_tc<256, kCap>(c(q), c(k), c(v), c(out), c(dout), l, qp, kp, dl, pt, groups,
                                  m(dq), m(dk), m(dv), B, S, T, hq, hkv, causal, window, scale,
                                  softcap, st);
    return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq (B,S,Hq,D); k, v, dk, dv (B,T,Hkv,D): contiguous, one
// dtype, 16-byte aligned.  lse (B,Hq,S) f32 from the forward (of the capped
// logits under a softcap); q_pos (B,S), k_pos (B,T) int32; delta: B * Hq * S
// floats of scratch.  D 64, 128 or 256.  softcap > 0 caps the logits as the
// forward does, 0 (or less) leaves them uncapped.
// bf16 at D 256: part holds 2 * groups * B * T * Hkv * D floats, groups in
// 1..Hq/Hkv (the dK/dV grid's head groups); ignored otherwise.  Launches on
// `stream`: delta, dK/dV, (bf16 D 256) the partials' sum, dQ.  Returns
// cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          const void* q_pos, const void* k_pos, void* delta,
                                          void* part, void* dq, void* dk, void* dv, int B, int S,
                                          int T, int hq, int hkv, int d, int dtype, int causal,
                                          int window, int groups, float scale, float softcap,
                                          void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f)
    return launch_all<true>(q, k, v, out, dout, l, qp, kp, dl, pt, dq, dk, dv, B, S, T, hq, hkv,
                            d, dtype, causal, window, groups, scale, softcap, st);
  return launch_all<false>(q, k, v, out, dout, l, qp, kp, dl, pt, dq, dk, dv, B, S, T, hq, hkv, d,
                           dtype, causal, window, groups, scale, 0.f, st);
}
