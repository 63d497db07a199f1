// Backward of Mamba2's chunked SSD scan from a zero state: the gradients
// with respect to x, dt, a_log, B, C and d_skip of the function
// ref.ssd_chunked computes (ssd_scan.cu's forward).
//
// The TPU kernel repro/kernels/ssd_scan.py (ssd -> _ssd_kernel) has no
// backward: the JAX package differentiates its jnp path.  The port's
// forward is the kernel of ssd_scan.cu, so its gradient is a kernel too.
// Per batch row b and head h, in float32 for bf16 and f32 inputs alike,
// with a = -exp(a_log), l_t = dt_t a, xb_t = x_t dt_t, and inside chunk c
// of Q steps cum_i = l_0 + .. + l_i, total = cum_{Q-1}, L_ij = exp(cum_i -
// cum_j) for j <= i (0 above):
//   y_i   = sum_{j<=i} (C_i.B_j) L_ij xb_j + exp(cum_i) C_i^T H_c + D x_i
//   S_c   = sum_j exp(total - cum_j) B_j xb_j^T          (N x P)
//   H_0 = 0,  H_{c+1} = exp(total_c) H_c + S_c
// The forward's output is rounded, so nothing of it is read: the chunk
// states and the incoming states H_c are recomputed from the inputs.  The
// gradient of the carried state runs in reverse,
//   G_c = exp(total_c) G_{c+1} + sum_i exp(cum_i) C_i dy_i^T,  G_nc = 0,
// and G_{c+1} is the gradient of S_c.  Then, chunk by chunk, with M1 =
// (C B^T) * L, DX_ij = dy_i . xb_j and M2 = L * DX:
//   d xb = M1^T dy + diag(exp(total - cum)) B G_{c+1}
//   dC   = M2 B + diag(exp(cum)) dy H_c^T       (this head's share)
//   dB   = M2^T C + diag(exp(total - cum)) xb G_{c+1}^T
//   d cum_i = rowsum_i(M1 * DX) - colsum_i(M1 * DX) + exp(cum_i) dy_i^T
//             H_c^T C_i - w_i,   w_j = exp(total - cum_j) B_j^T G xb_j
//   d total = sum_j w_j + exp(total) <G_{c+1}, H_c>, added to d cum_{Q-1}
// and a reverse cumsum inside the chunk turns d cum into dl; then d dt =
// dl a + d xb . x, dx = d xb dt + D dy, d a = sum dl dt, d a_log = d a a,
// d D = sum dy . x.
//
// Five launches on one stream, all sums in a fixed order (no float
// atomics: two runs give the same bits):
//   ssd_bwd_states  one block a (b, c, h): S_c and the local term of G_c
//                   (two 128 x 64 products over the chunk), the total;
//   ssd_bwd_carry   one thread a (b, h, n, p): the sequential pass over
//                   chunks, forward (S_c -> H_c in place) and in reverse
//                   (local term -> G_{c+1} in place);
//   ssd_bwd_chunk   one block a (b, c, h): every term above, five products
//                   of 128 x 128 or 128 x 64 tiles; dx and d dt written,
//                   the head's dB and dC to a per-head f32 plane;
//   ssd_bwd_reduce  dB and dC summed over heads in head order;
//   ssd_bwd_params  d a_log and d D summed over (b, c) in order.
// Bound on the card: operations (the chunk kernel's products: about 23
// MFLOP a (b, c, h) at Q 128, N 128, P 64, on the CUDA cores in f32).
// Design: a simple one that is right; the products are tiles of 128 rows
// by 64 or 128 columns, 256 threads each holding an 8 x 4 or 8 x 8 tile of
// the sum, their operands staged through shared memory 16 of the depth at
// a time by loaders that compute each element (decays, dt, masks) as it is
// fetched, the next step's fetched while this one's are multiplied.  The
// (Q x Q) M1 and M2 stay in shared memory (66 KB each), one block an SM.
// The tensor cores are later work (ROADMAP.md §3).
#include "common.cuh"

namespace {

constexpr int NT = 256;      // threads a block: 16 x 16
constexpr int MQ = 128;      // rows of every product tile: Q or N, at most 128
constexpr int KC = 16;       // depth staged a step
constexpr int LDQ = MQ + 1;  // row of a (Q x Q) tile in shared memory
constexpr int PMAX = 64, NMAX = 128;

struct Dims {
  int B, S, H, P, N, Q, nc;
};

// One product tile: acc[i][j] += sum_k A(tr + 16 i, k) Bm(k, tc + 16 j),
// k < K, where tr = tid / 16, tc = tid % 16.  fa(r, k) and fb(k, col)
// give the operands (0 outside their ranges); each is staged KC deep into
// sa / sb (rows of RM * 16 + 1 and RN * 16 + 1 floats).  a_kfast /
// b_kfast: whether consecutive threads fetch consecutive k (an operand
// whose rows run along k in memory) or consecutive rows / columns.  The
// next step's operands are fetched into registers while this step's are
// multiplied, so their loads' latency overlaps the products.
template <int RM, int RN, bool a_kfast, bool b_kfast, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[RM][RN], int K, FA fa, FB fb, float* sa,
                                     float* sb) {
  constexpr int WA = RM * 16, WB = RN * 16;
  constexpr int NA = KC * WA / NT, NB = KC * WB / NT;  // elements a thread stages
  static_assert(KC * WA % NT == 0 && KC * WB % NT == 0, "whole staging rounds");
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float ra[NA], rb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int idx = tid + u * NT;
      const int kk = a_kfast ? idx % KC : idx / WA, r = a_kfast ? idx / KC : idx % WA;
      ra[u] = k0 + kk < K ? fa(r, k0 + kk) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = tid + u * NT;
      const int kk = b_kfast ? idx % KC : idx / WB, c = b_kfast ? idx / KC : idx % WB;
      rb[u] = k0 + kk < K ? fb(k0 + kk, c) : 0.f;
    }
  };
  if (K > 0) fetch(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int idx = tid + u * NT;
      const int kk = a_kfast ? idx % KC : idx / WA, r = a_kfast ? idx / KC : idx % WA;
      sa[kk * (WA + 1) + r] = ra[u];
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int idx = tid + u * NT;
      const int kk = b_kfast ? idx % KC : idx / WB, c = b_kfast ? idx / KC : idx % WB;
      sb[kk * (WB + 1) + c] = rb[u];
    }
    __syncthreads();
    if (k0 + KC < K) fetch(k0 + KC);
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sa[kk * (WA + 1) + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = sb[kk * (WB + 1) + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads of a row of the thread grid (a half warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The chunk's per-step scalars in shared memory: dt, cum, exp(cum),
// exp(total - cum); the cumulative sum taken in step order by one thread
// (both kernels that need it take it the same way).  Returns total.
template <typename T>
__device__ float chunk_scalars(const T* __restrict__ dt, float a, const Dims& d, int b, int c,
                               int h, float* dts, float* cum, float* e, float* f) {
  const size_t s0 = (size_t)b * d.S + (size_t)c * d.Q;
  for (int i = threadIdx.x; i < d.Q; i += NT) dts[i] = rt::to_f32(dt[(s0 + i) * d.H + h]);
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < d.Q; ++i) {
      run += dts[i] * a;
      cum[i] = run;
    }
  }
  __syncthreads();
  const float total = cum[d.Q - 1];
  for (int i = threadIdx.x; i < d.Q; i += NT) {
    e[i] = expf(cum[i]);
    f[i] = expf(total - cum[i]);
  }
  __syncthreads();
  return total;
}

template <typename T>
struct In {
  const T* x;
  const T* dt;
  const float* a_log;
  const T* bm;
  const T* cm;
  const float* dskip;
  const T* dy;
};

// Workspace planes (f32): hs (B, nc, H, N, P): the chunk states, then the
// incoming states; gs (same): the local terms, then G_{c+1}; dbh, dch (B, S,
// H, N); tot, apart, dpart (B, nc, H).
struct Work {
  float *hs, *gs, *dbh, *dch, *tot, *apart, *dpart;
};

Work carve(float* w, const Dims& d) {
  const size_t plane = (size_t)d.B * d.nc * d.H * d.N * d.P;
  const size_t heads = (size_t)d.B * d.S * d.H * d.N;
  const size_t small = (size_t)d.B * d.nc * d.H;
  Work k;
  k.hs = w;
  k.gs = k.hs + plane;
  k.dbh = k.gs + plane;
  k.dch = k.dbh + heads;
  k.tot = k.dch + heads;
  k.apart = k.tot + small;
  k.dpart = k.apart + small;
  return k;
}

struct StatesSmem {
  float sa[KC * (MQ + 1)], sb[KC * (PMAX + 1)];
  float dts[MQ], cum[MQ], e[MQ], f[MQ];
};

// S_c = sum_j f_j B_j (x_j dt_j)^T and the local term sum_i e_i C_i dy_i^T,
// (N x P) each, for block (b, c, h); the chunk's total.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_states(In<T> in, Dims d, Work w) {
  __shared__ StatesSmem sm;
  const int h = blockIdx.x % d.H, c = (blockIdx.x / d.H) % d.nc, b = blockIdx.x / (d.H * d.nc);
  const float a = -expf(in.a_log[h]);
  const float total = chunk_scalars(in.dt, a, d, b, c, h, sm.dts, sm.cum, sm.e, sm.f);
  const size_t s0 = (size_t)b * d.S + (size_t)c * d.Q;
  const int N = d.N, P = d.P, H = d.H, Q = d.Q;
  const size_t plane = (((size_t)b * d.nc + c) * H + h) * N * P;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    zero(acc);
    const T* rows = pass == 0 ? in.bm : in.cm;
    const T* vals = pass == 0 ? in.x : in.dy;
    const float* wt = pass == 0 ? sm.f : sm.e;
    gemm<8, 4, false, false>(
        acc, Q,
        [&](int n, int j) { return n < N ? rt::to_f32(rows[(s0 + j) * N + n]) : 0.f; },
        [&](int j, int p) {
          if (p >= P) return 0.f;
          const float v = rt::to_f32(vals[((s0 + j) * H + h) * P + p]);
          return pass == 0 ? v * sm.dts[j] * wt[j] : v * wt[j];
        },
        sm.sa, sm.sb);
    float* out = (pass == 0 ? w.hs : w.gs) + plane;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tr + 16 * i, p = tc + 16 * j;
        if (n < N && p < P) out[(size_t)n * P + p] = acc[i][j];
      }
  }
  if (threadIdx.x == 0) w.tot[((size_t)b * d.nc + c) * H + h] = total;
}

// The sequential pass over chunks of element (n, p) of head h, row b:
// forward, hs[c] <- H_c (from the chunk states); in reverse, gs[c] <-
// G_{c+1} (from the local terms).  Each step's operand is requested a step
// ahead, so a load is in flight while the last one is written back.
__global__ void __launch_bounds__(NT) ssd_bwd_carry(Dims d, Work w) {
  const size_t np = (size_t)d.N * d.P;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)d.B * d.H * np) return;
  const size_t e = idx % np, bh = idx / np;
  const int h = bh % d.H, b = bh / d.H, nc = d.nc;
  const size_t stride = (size_t)d.H * np;  // from one chunk to the next
  float* __restrict__ hs = w.hs + ((size_t)b * nc * d.H + h) * np + e;
  float* __restrict__ gs = w.gs + ((size_t)b * nc * d.H + h) * np + e;
  const float* __restrict__ tot = w.tot + (size_t)b * nc * d.H + h;
  float run = 0.f, next = hs[0];
  for (int c = 0; c < nc; ++c) {
    const float s = next;
    if (c + 1 < nc) next = hs[(size_t)(c + 1) * stride];
    hs[(size_t)c * stride] = run;
    run = expf(tot[(size_t)c * d.H]) * run + s;
  }
  run = 0.f;
  next = gs[(size_t)(nc - 1) * stride];
  for (int c = nc - 1; c >= 0; --c) {
    const float l = next;
    if (c > 0) next = gs[(size_t)(c - 1) * stride];
    gs[(size_t)c * stride] = run;
    run = l + expf(tot[(size_t)c * d.H]) * run;
  }
}

struct ChunkSmem {
  float m1[MQ * LDQ];  // M1 = (C B^T) * L, then free
  float m2[MQ * LDQ];  // M1 * DX (for d cum), then M2 = L * DX
  float sa[KC * (MQ + 1)], sb[KC * (NMAX + 1)];
  float dts[MQ], cum[MQ], e[MQ], f[MQ], dcum[MQ], ddt[MQ];
  float red[NT];
};

// Every term of block (b, c, h): dx and the dx-part of d dt, this head's
// dB and dC, d cum, and from them d dt and the partials of d a and d D.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_chunk(In<T> in, Dims d, Work w, T* __restrict__ dx, T* __restrict__ ddt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int h = blockIdx.x % d.H, c = (blockIdx.x / d.H) % d.nc, b = blockIdx.x / (d.H * d.nc);
  const int N = d.N, P = d.P, H = d.H, Q = d.Q;
  const float a = -expf(in.a_log[h]);
  const float total = chunk_scalars(in.dt, a, d, b, c, h, sm.dts, sm.cum, sm.e, sm.f);
  const float dsk = in.dskip != nullptr ? in.dskip[h] : 0.f;
  const size_t s0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t plane = (((size_t)b * d.nc + c) * H + h) * N * P;
  const float* hin = w.hs + plane;  // H_c (N x P)
  const float* gst = w.gs + plane;  // G_{c+1}, the gradient of S_c
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  auto xv = [&](int i, int p) { return rt::to_f32(in.x[((s0 + i) * H + h) * P + p]); };
  auto dyv = [&](int i, int p) { return rt::to_f32(in.dy[((s0 + i) * H + h) * P + p]); };
  auto bv = [&](int i, int n) { return rt::to_f32(in.bm[(s0 + i) * N + n]); };
  auto cv = [&](int i, int n) { return rt::to_f32(in.cm[(s0 + i) * N + n]); };
  auto lmask = [&](int i, int j) {
    return i < Q && j <= i ? expf(sm.cum[i] - sm.cum[j]) : 0.f;
  };

  // M1 = (C B^T) * L
  float big[8][8];
  zero(big);
  gemm<8, 8, true, true>(
      big, N, [&](int i, int n) { return i < Q ? cv(i, n) : 0.f; },
      [&](int n, int j) { return j < Q ? bv(j, n) : 0.f; }, sm.sa, sm.sb);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, cc = tc + 16 * j;
      sm.m1[r * LDQ + cc] = big[i][j] * lmask(r, cc);
    }
  // DX = dy xb^T; M1 * DX gives d cum's intra-chunk part
  zero(big);
  gemm<8, 8, true, true>(
      big, P, [&](int i, int p) { return i < Q ? dyv(i, p) : 0.f; },
      [&](int p, int j) { return j < Q ? xv(j, p) * sm.dts[j] : 0.f; }, sm.sa, sm.sb);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, cc = tc + 16 * j;
      sm.m2[r * LDQ + cc] = sm.m1[r * LDQ + cc] * big[i][j];
    }
  __syncthreads();
  if (tid < MQ) {  // row sums
    float s = 0.f;
    for (int j = 0; j < Q; ++j) s += sm.m2[tid * LDQ + j];
    sm.dcum[tid] = s;
  }
  __syncthreads();
  if (tid < MQ) {  // column sums
    float s = 0.f;
    for (int i = 0; i < Q; ++i) s += sm.m2[i * LDQ + tid];
    sm.dcum[tid] -= s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, cc = tc + 16 * j;
      sm.m2[r * LDQ + cc] = big[i][j] * lmask(r, cc);  // M2 = L * DX
    }

  // d xb = M1^T dy + diag(f) B G; then dx and d dt's dx-part, d D's partial
  float mid[8][4];
  zero(mid);
  gemm<8, 4, true, false>(
      mid, Q, [&](int j, int i) { return sm.m1[i * LDQ + j]; },
      [&](int i, int p) { return p < P ? dyv(i, p) : 0.f; }, sm.sa, sm.sb);
  gemm<8, 4, true, false>(
      mid, N, [&](int j, int n) { return j < Q ? sm.f[j] * bv(j, n) : 0.f; },
      [&](int n, int p) { return p < P ? gst[(size_t)n * P + p] : 0.f; }, sm.sa, sm.sb);
  float dpart = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tc + 16 * j;
      if (r < Q && p < P) {
        const float xr = xv(r, p), dyr = dyv(r, p);
        dot = fmaf(mid[i][j], xr, dot);
        dpart = fmaf(dyr, xr, dpart);
        dx[((s0 + r) * H + h) * P + p] = rt::from_f32<T>(mid[i][j] * sm.dts[r] + dsk * dyr);
      }
    }
    dot = row_sum16(dot);
    if (tc == 0 && r < Q) sm.ddt[r] = dot;
  }

  // dC = diag(e) dy H^T + M2 B; the carried part first, for d cum
  zero(big);
  gemm<8, 8, true, true>(
      big, P, [&](int i, int p) { return i < Q ? sm.e[i] * dyv(i, p) : 0.f; },
      [&](int p, int n) { return n < N ? hin[(size_t)n * P + p] : 0.f; }, sm.sa, sm.sb);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tc + 16 * j;
      if (r < Q && n < N) dot = fmaf(big[i][j], cv(r, n), dot);
    }
    dot = row_sum16(dot);
    if (tc == 0 && r < Q) sm.dcum[r] += dot;
  }
  gemm<8, 8, true, false>(
      big, Q, [&](int i, int j) { return sm.m2[i * LDQ + j]; },
      [&](int j, int n) { return j < Q && n < N ? bv(j, n) : 0.f; }, sm.sa, sm.sb);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, n = tc + 16 * j;
      if (r < Q && n < N) w.dch[((s0 + r) * H + h) * N + n] = big[i][j];
    }

  // dB = diag(f) xb G^T + M2^T C; the state part first, for w_j
  zero(big);
  gemm<8, 8, true, true>(
      big, P, [&](int j, int p) { return j < Q ? sm.f[j] * sm.dts[j] * xv(j, p) : 0.f; },
      [&](int p, int n) { return n < N ? gst[(size_t)n * P + p] : 0.f; }, sm.sa, sm.sb);
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr + 16 * i;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tc + 16 * j;
      if (r < Q && n < N) dot = fmaf(big[i][j], bv(r, n), dot);
    }
    dot = row_sum16(dot);
    if (tc == 0 && r < Q) {
      sm.dcum[r] -= dot;
      wsum += dot;
    }
  }
  gemm<8, 8, true, false>(
      big, Q, [&](int j, int i) { return sm.m2[i * LDQ + j]; },
      [&](int i, int n) { return i < Q && n < N ? cv(i, n) : 0.f; }, sm.sa, sm.sb);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, n = tc + 16 * j;
      if (r < Q && n < N) w.dbh[((s0 + r) * H + h) * N + n] = big[i][j];
    }

  // d total = sum w + exp(total) <G, H>: thread partials, added in order
  float gh = 0.f;
  for (int k = tid; k < N * P; k += NT) gh = fmaf(gst[k], hin[k], gh);
  sm.red[tid] = wsum + expf(total) * gh;
  __syncthreads();
  float* dp = sm.red;  // reused below for d D once d total is read
  if (tid == 0) {
    float dtot = 0.f;
    for (int k = 0; k < NT; ++k) dtot += dp[k];
    sm.dcum[Q - 1] += dtot;
    // the reverse cumsum: dl_i = sum_{i' >= i} d cum_i'
    float run = 0.f, apart = 0.f;
    for (int i = Q - 1; i >= 0; --i) {
      run += sm.dcum[i];
      ddt[(s0 + i) * H + h] = rt::from_f32<T>(run * a + sm.ddt[i]);
      apart = fmaf(run, sm.dts[i], apart);
    }
    w.apart[((size_t)b * d.nc + c) * H + h] = apart;
  }
  __syncthreads();
  dp[tid] = dpart;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < NT; ++k) s += dp[k];
    w.dpart[((size_t)b * d.nc + c) * H + h] = s;
  }
}

// dB[b, s, n] and dC[b, s, n]: the heads' shares added in head order.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(Dims d, Work w, T* __restrict__ db, T* __restrict__ dc) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)d.B * d.S * d.N) return;
  const size_t n = idx % d.N, bs = idx / d.N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < d.H; ++h) {
    sb += w.dbh[(bs * d.H + h) * d.N + n];
    sc += w.dch[(bs * d.H + h) * d.N + n];
  }
  db[idx] = rt::from_f32<T>(sb);
  dc[idx] = rt::from_f32<T>(sc);
}

// d a_log[h] = a_h sum_{b, c} (sum dl dt) and d D[h] = sum_{b, c} (sum dy.x),
// in (b, c) order.
__global__ void __launch_bounds__(NT)
ssd_bwd_params(Dims d, Work w, const float* __restrict__ a_log, float* __restrict__ da_log,
               float* __restrict__ dd) {
  for (int h = threadIdx.x; h < d.H; h += NT) {
    float sa = 0.f, sd = 0.f;
    for (int bc = 0; bc < d.B * d.nc; ++bc) {
      sa += w.apart[(size_t)bc * d.H + h];
      sd += w.dpart[(size_t)bc * d.H + h];
    }
    da_log[h] = sa * -expf(a_log[h]);
    if (dd != nullptr) dd[h] = sd;
  }
}

template <typename T>
cudaError_t launch_t(const In<T>& in, const Dims& d, float* work, void* dx, void* ddt, void* db,
                     void* dc, float* da_log, float* dd, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(ChunkSmem));
  if (attr != cudaSuccess) return attr;
  const Work w = carve(work, d);
  const long long blocks = (long long)d.B * d.nc * d.H;
  const long long carry = ((long long)d.B * d.H * d.N * d.P + NT - 1) / NT;
  const long long rows = ((long long)d.B * d.S * d.N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL || carry > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_bwd_states<T><<<(unsigned)blocks, NT, 0, st>>>(in, d, w);
  ssd_bwd_carry<<<(unsigned)carry, NT, 0, st>>>(d, w);
  ssd_bwd_chunk<T><<<(unsigned)blocks, NT, sizeof(ChunkSmem), st>>>(in, d, w,
                                                                     static_cast<T*>(dx),
                                                                     static_cast<T*>(ddt));
  ssd_bwd_reduce<T><<<(unsigned)rows, NT, 0, st>>>(d, w, static_cast<T*>(db),
                                                   static_cast<T*>(dc));
  ssd_bwd_params<<<1, NT, 0, st>>>(d, w, in.a_log, da_log, dd);
  return cudaGetLastError();
}

static_assert(sizeof(ChunkSmem) <= 232448, "the chunk block within the SM's shared memory");

}  // namespace

// x, dy, dx (B,S,H,P); dt, ddt (B,S,H); b, c, db, dc (B,S,N): contiguous,
// one dtype.  a_log (H,) f32, d_skip (H,) f32 or null; da_log (H,) f32
// out, dd (H,) f32 out or null.  chunk divides S, at most 128; P a multiple
// of 16 up to 64, N of 16 up to 128.  work: the wrapper's bwd_workspace
// floats.  Five launches.  Returns cudaGetLastError().
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a_log,
                                   const void* b, const void* c, const void* d_skip,
                                   const void* dy, void* dx, void* ddt, void* db, void* dc,
                                   void* da_log, void* dd, void* work, int B, int S, int H,
                                   int P, int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || P % 16 || N <= 0 || N > NMAX ||
      N % 16 || chunk <= 0 || chunk > MQ || S % chunk || work == nullptr)
    return cudaErrorInvalidValue;
  const Dims d{B, S, H, P, N, chunk, S / chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* da = static_cast<float*>(da_log);
  float* ddp = static_cast<float*>(dd);
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  if (dtype == rt::kFloat32) {
    using T = float;
    const In<T> in{static_cast<const T*>(x), static_cast<const T*>(dt), al,
                   static_cast<const T*>(b), static_cast<const T*>(c), ds,
                   static_cast<const T*>(dy)};
    return launch_t<T>(in, d, wk, dx, ddt, db, dc, da, ddp, st);
  }
  if (dtype == rt::kBFloat16) {
    using T = __nv_bfloat16;
    const In<T> in{static_cast<const T*>(x), static_cast<const T*>(dt), al,
                   static_cast<const T*>(b), static_cast<const T*>(c), ds,
                   static_cast<const T*>(dy)};
    return launch_t<T>(in, d, wk, dx, ddt, db, dc, da, ddp, st);
  }
  return cudaErrorInvalidValue;
}
