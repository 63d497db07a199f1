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
//   states  S_c and the local term of G_c, the chunk's total;
//   carry   one thread a (b, h, n, p): the sequential pass over chunks,
//           forward (S_c -> H_c in place) and in reverse (local term ->
//           G_{c+1} in place), shared by both routes;
//   chunk   every term above; dx and d dt written, dB's and dC's shares to
//           f32 planes;
//   reduce  dB and dC: the planes' shares summed in plane order;
//   params  d a_log and d D summed over (b, c) in order.
// Bound on the card: operations.  chip_smoke.ssd_bwd_flops counts the
// products the function needs (16.9 MFLOP a (b, c, h) at Q 128, N 128, P
// 64: B C^T once a (b, c), the lower triangles of the Q x Q products), at
// the tensor cores' rate for bf16 inputs; the f32 route forms 27.3 (B C^T
// once a head, the Q x Q products as full squares).
// bf16 design (ssd_bwd_states_tc, ssd_bwd_chunk_tc), the forward's route
// (ssd_scan.cu): mma.sync.m16n8k16 through tc.cuh, every product with one
// exact bf16 operand (x, dy, B or C) and f32 sums; dt and the decays go
// into score matrices and row or column scales, never into x; the other
// operand, where f32 (the weighted B and C, M1 = (C B^T) * L, M2 = L * DX,
// G, H), is split into bf16 hi + lo (rt::split_bf16), two products.
//   * A block owns a (b, chunk) and a group of heads (the wrapper's
//     bwd_head_group: 6 of mamba2-780m's 48 at B 2, S 1024, 128 blocks, one
//     an SM) and walks them in order.  B C^T is formed once for the group,
//     each thread's fragments kept in shared memory; each head takes it
//     through its own decay mask elementwise.
//   * Eight warps, one a 16-row tile of the chunk, the chunk padded to 16
//     rows and masked (chunks 1-128).  As rows j, a warp holds M1^T and
//     M2^T as C fragments, which are the A fragments of d xb = f (B G) +
//     M1^T dy and dB = f dt (x G^T) + M2^T C, and forms M1 * DX's sums for d
//     cum (its row sums; its column sums per warp, added over the warps in
//     order); as rows i it recomputes DX (one exact product) for M2, the A
//     fragment of dC = e (dy H^T) + M2 B.  The lower triangle only: j <= i.
//   * dB and dC of the group's heads are added in head order into one f32
//     plane a group (a block alone writes its rows), 1/6 of the per-head
//     planes' bytes; reduce sums the 8 groups in order.
//   * What bounds it (measured on the card): with one block of 8 warps an SM
//     (its 225 KB of shared memory) and 255 registers a thread, the
//     products' latency, not their rate: about a third of the chunk
//     kernel's time is its per-head loads, scans and the planes'
//     read-modify-write.
// f32 inputs (the identity checks, held at 2e-5) take the CUDA-core body,
// selected by dtype: ssd_bwd_states and ssd_bwd_chunk, one block a (b, c,
// h), products of 128-row tiles by 64 or 128 columns, 256 threads each
// holding an 8 x 4 or 8 x 8 tile of the sum, operands staged through shared
// memory 16 of the depth at a time by loaders that compute each element
// (decays, dt, masks) as it is fetched, the next step's fetched while this
// one's are multiplied; M1 and M2 in shared memory (66 KB each); per-head
// planes.  This is a dispatch by dtype, not a fallback: both routes launch
// or fail.
#include "common.cuh"
#include "tc.cuh"

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
// planes, N): the shares of dB and dC of each head (f32 route) or head
// group (bf16 route); tot, apart, dpart (B, nc, H).
struct Work {
  float *hs, *gs, *dbh, *dch, *tot, *apart, *dpart;
};

Work carve(float* w, const Dims& d, int planes) {
  const size_t plane = (size_t)d.B * d.nc * d.H * d.N * d.P;
  const size_t heads = (size_t)d.B * d.S * planes * d.N;
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

// dB[b, s, n] and dC[b, s, n]: the planes' shares (heads or head groups)
// added in order.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(Dims d, Work w, int planes, T* __restrict__ db, T* __restrict__ dc) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)d.B * d.S * d.N) return;
  const size_t n = idx % d.N, bs = idx / d.N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < planes; ++h) {
    sb += w.dbh[(bs * planes + h) * d.N + n];
    sc += w.dch[(bs * planes + h) * d.N + n];
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

// ---------------------------------------------------------------- bf16 route
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;     // 8 warps: a warp a 16-row tile of the chunk
constexpr int kTcTiles = MQ / 16;   // row tiles of a chunk, at most
constexpr int kMaxGroup = 8;        // heads a block takes, at most
constexpr unsigned kFull = 0xffffffffu;

constexpr __host__ __device__ int pad16(int q) { return (q + 15) / 16 * 16; }

// Shared memory of the bf16 kernels, bytes: C and B rows ([Qp][N + 8]
// bf16), the head's x and dy rows ([Qp][P + 8]), its G_{c+1} and H_c as
// bf16 hi and lo planes ([N][P + 8] each; the chunk kernel only), then f32:
// the group's dt ([kMaxGroup][Qp]), cum, exp(cum), exp(total - cum), d xb .
// x, d cum ([Qp] each), the warps' column sums of M1 * DX ([8][Qp]), two
// block reductions, and (the chunk kernel) each thread's C fragments of B
// C^T, tile by tile of its warp (Qp/16 (Qp/16 + 1) / 2 tiles of 1 KB).
struct TcLayout {
  int qp = 0, ldn = 0, ldp = 0;
  size_t c = 0, b = 0, x = 0, y = 0, gh = 0, gl = 0, hh = 0, hl = 0, dt = 0, cum = 0, e = 0, f = 0,
         dxx = 0, dcum = 0, red = 0, red2 = 0, cb = 0, bytes = 0;
  constexpr __host__ __device__ TcLayout(int q, int n, int p, bool chunk) {
    qp = pad16(q);
    ldn = n + 8;
    ldp = p + 8;
    const size_t rows_n = (size_t)qp * ldn * sizeof(bf16), rows_p = (size_t)qp * ldp * sizeof(bf16);
    const size_t state = chunk ? (size_t)n * ldp * sizeof(bf16) : 0;
    c = 0;
    b = c + rows_n;
    x = b + rows_n;
    y = x + rows_p;
    gh = y + rows_p;
    gl = gh + state;
    hh = gl + state;
    hl = hh + state;
    dt = hl + state;
    cum = dt + (size_t)kMaxGroup * qp * sizeof(float);
    e = cum + qp * sizeof(float);
    f = e + qp * sizeof(float);
    dxx = f + qp * sizeof(float);
    dcum = dxx + qp * sizeof(float);
    red = dcum + qp * sizeof(float);
    red2 = red + (size_t)(kTcThreads / 32) * qp * sizeof(float);
    cb = red2 + 2 * kTcThreads * sizeof(float);
    const int tiles = qp / 16;
    bytes = cb + (chunk ? (size_t)tiles * (tiles + 1) / 2 * 256 * sizeof(float) : 0);
  }
};

// The first of warp w's tiles in the B C^T store: its tiles are it = w ..
// tiles - 1.
__device__ __forceinline__ int cb_tile0(int w, int tiles) { return w * tiles - w * (w - 1) / 2; }

// A fragment (16 x 16) of rows r0.. and depth k0.. of a row-major tile.
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int ld, int r0, int k0) {
  const int lane = threadIdx.x % 32;
  rt::ldmatrix_x4(a, t + (r0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}

// B fragments of the 8-column tiles n0.. and n0 + 8.. (b[0..1], b[2..3]) at
// depth k0..k0 + 15, from a tile stored [n][k] ...
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t, int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  rt::ldmatrix_x4(b, t + (n0 + (lane / 16) * 8 + lane % 8) * ld + k0 + ((lane / 8) % 2) * 8);
}

// ... and from a tile stored [k][n].
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t, int ld, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  rt::ldmatrix_x4_trans(b, t + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * ld + n0 + (lane / 16) * 8);
}

// The f32 C fragments of two neighbouring 8-column tiles as the A fragment
// of one 16-deep step, split into bf16 hi + lo.
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&x0)[4],
                                        const float (&x1)[4]) {
  rt::split_bf16(x0[0], x0[1], hi[0], lo[0]);
  rt::split_bf16(x0[2], x0[3], hi[1], lo[1]);
  rt::split_bf16(x1[0], x1[1], hi[2], lo[2]);
  rt::split_bf16(x1[2], x1[3], hi[3], lo[3]);
}

// c += (hi + lo) . b for the 16-column pair (c0, c1).
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], const uint32_t (&b)[4]) {
  rt::mma_bf16(c0, hi, b[0], b[1]);
  rt::mma_bf16(c0, lo, b[0], b[1]);
  rt::mma_bf16(c1, hi, b[2], b[3]);
  rt::mma_bf16(c1, lo, b[2], b[3]);
}

// c += a . (hi + lo) for the 16-column pair (c0, c1).
__device__ __forceinline__ void mma2b(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                      const uint32_t (&bh)[4], const uint32_t (&bl)[4]) {
  rt::mma_bf16(c0, a, bh[0], bh[1]);
  rt::mma_bf16(c0, a, bl[0], bl[1]);
  rt::mma_bf16(c1, a, bh[2], bh[3]);
  rt::mma_bf16(c1, a, bl[2], bl[3]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// rows x cols (a multiple of 8) bf16 at src (row i at src + i * stride)
// into the tile dst (row length ld) by cp.async; rows in [rows, qp) zero.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                           int rows, int qp, int cols) {
  const int cpr = cols / 8;
  for (int idx = threadIdx.x; idx < qp * cpr; idx += blockDim.x) {
    const int i = idx / cpr, cc = idx % cpr;
    const bool ok = i < rows;
    rt::cp_async16(dst + i * ld + cc * 8, ok ? src + i * stride + cc * 8 : src, ok);
  }
}

// The group's dt in f32 (dtg [kMaxGroup][qp], rows past Q and heads past
// H zero): once a block, before the head loop's barrier.
__device__ __forceinline__ void load_dt(float* dtg, const bf16* __restrict__ dt, const Dims& d,
                                        size_t s0, int h0, int h1, int qp) {
  for (int idx = threadIdx.x; idx < kMaxGroup * qp; idx += blockDim.x) {
    const int hh = idx / qp, i = idx % qp;
    dtg[idx] = i < d.Q && h0 + hh < h1 ? rt::to_f32(dt[(s0 + i) * d.H + h0 + hh]) : 0.f;
  }
}

// cum, exp(cum) and exp(total - cum) of a head from its dt (dts, [qp]; rows
// past Q: dt 0, so cum there is the total): warp 0 takes the inclusive
// prefix sum of dt a, 32 steps at a time (a shuffle scan), as both bf16
// kernels take it.  Ends with a barrier.  Returns total.
__device__ float tc_scalars(const float* dts, float a, int Q, int qp, float* cum, float* e,
                            float* f) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int base = 0; base < qp; base += 32) {
      const int i = base + lane;
      float v = i < qp ? dts[i] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (i < qp) cum[i] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int i = threadIdx.x; i < qp; i += blockDim.x) {
    e[i] = expf(cum[i]);
    f[i] = expf(total - cum[i]);
  }
  __syncthreads();
  return total;
}

// The group's sum so far at the warp's rows j0, j1 (16 nu columns from n0)
// of a group plane (row j at plane + j * stride), into old: loaded before
// the products that add to it, so that their latency overlaps them.
__device__ __forceinline__ void load_rows(float2 (&old)[8][2], const float* __restrict__ plane,
                                          size_t stride, int j0, int j1, int Q, int n0, int nu) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = hf ? j1 : j0;
      old[nt][hf] = nt < 2 * nu && j < Q
                        ? *reinterpret_cast<const float2*>(plane + j * stride + n0 + nt * 8 + 2 * tq)
                        : make_float2(0.f, 0.f);
    }
}

// Those rows of acc into the plane: as they are for the group's first head,
// else added to old, the sum so far.
__device__ __forceinline__ void add_rows(float* __restrict__ plane, size_t stride,
                                         const float (&acc)[8][4], const float2 (&old)[8][2], int j0,
                                         int j1, int Q, int n0, int nu, bool first) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= 2 * nu) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = hf ? j1 : j0;
      if (j >= Q) continue;
      float2 v = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      if (!first) v = make_float2(old[nt][hf].x + v.x, old[nt][hf].y + v.y);
      *reinterpret_cast<float2*>(plane + j * stride + n0 + nt * 8 + 2 * tq) = v;
    }
  }
}

// S_c = (B * exp(total - cum) dt)^T x and the local term of G_c, (C *
// exp(cum))^T dy (N x P each), of the heads of group g, for batch row b and
// chunk c; the chunk's total.  Warp w owns the 16-row tiles w, w + 8 of the
// state; the weighted B and C are split into hi + lo, x and dy are exact.
template <int P>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_states_tc(In<bf16> in, Dims d, Work w, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(d.Q, d.N, P, false);
  const int ng = (d.H + group - 1) / group;
  const int g = blockIdx.x % ng, c = (blockIdx.x / ng) % d.nc, b = blockIdx.x / (ng * d.nc);
  const int h0 = g * group, h1 = min(d.H, h0 + group), N = d.N, Q = d.Q, H = d.H;
  const size_t s0 = (size_t)b * d.S + (size_t)c * Q;
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* Ys = reinterpret_cast<bf16*>(smem + L.y);
  float* dtg = reinterpret_cast<float*>(smem + L.dt);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* ev = reinterpret_cast<float*>(smem + L.e);
  float* fv = reinterpret_cast<float*>(smem + L.f);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g4 = lane / 4, tq = lane % 4;
  stage_rows(Cs, L.ldn, in.cm + s0 * N, N, Q, L.qp, N);
  stage_rows(Bs, L.ldn, in.bm + s0 * N, N, Q, L.qp, N);
  load_dt(dtg, in.dt, d, s0, h0, h1, L.qp);
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the last head's rows and scalars are read
    stage_rows(Xs, L.ldp, in.x + (s0 * H + h) * P, (size_t)H * P, Q, L.qp, P);
    stage_rows(Ys, L.ldp, in.dy + (s0 * H + h) * P, (size_t)H * P, Q, L.qp, P);
    rt::cp_async_commit();
    const float* dts = dtg + (h - h0) * L.qp;
    const float total = tc_scalars(dts, -expf(in.a_log[h]), Q, L.qp, cum, ev, fv);
    rt::cp_async_wait<0>();
    __syncthreads();
    const size_t plane = (((size_t)b * d.nc + c) * H + h) * N * P;
    for (int mt = warp; mt < N / 16; mt += kTcThreads / 32) {
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const bf16* rows = pass == 0 ? Bs : Cs;
        const bf16* vals = pass == 0 ? Xs : Ys;
        float acc[P / 8][4];
#pragma unroll
        for (int i = 0; i < P / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        for (int ks = 0; ks < L.qp / 16; ++ks) {
          // A = (weighted rows)^T: rows n, depth j; stored [j][n], so the
          // fragments come transposed
          uint32_t a[4], ah[4], al[4];
          rt::ldmatrix_x4_trans(a, rows + (ks * 16 + lane % 8 + (lane / 16) * 8) * L.ldn + mt * 16 +
                                       ((lane / 8) % 2) * 8);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = ks * 16 + 2 * tq + (r / 2) * 8;
            const float w0 = pass == 0 ? fv[j] * dts[j] : ev[j];
            const float w1 = pass == 0 ? fv[j + 1] * dts[j + 1] : ev[j + 1];
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[r]));
            rt::split_bf16(v.x * w0, v.y * w1, ah[r], al[r]);
          }
#pragma unroll
          for (int dn = 0; dn < P / 16; ++dn) {
            uint32_t bv[4];
            ldb_kn(bv, vals, L.ldp, ks * 16, dn * 16);
            mma2(acc[2 * dn], acc[2 * dn + 1], ah, al, bv);
          }
        }
        float* out = (pass == 0 ? w.hs : w.gs) + plane;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          float* r = out + (size_t)(mt * 16 + g4) * P + nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(r) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(r + 8 * P) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    if (tid == 0) w.tot[((size_t)b * d.nc + c) * H + h] = total;
  }
}

// Every term of the heads of group g, batch row b, chunk c.  A warp owns
// one 16-row tile of the chunk, rows r0..r0 + 15, in two orientations:
//   as rows j, the transposed matrices M1^T = (B C^T) * L^T and M2^T = L^T *
//   DX^T sit in its registers as C fragments, which are the A fragments of
//   d xb = f (B G) + M1^T dy and dB = f dt (x G^T) + M2^T C, and of M1 * DX's
//   sums (its row sums are -d cum_j's, its column sums the other half of d
//   cum, added over the warps in order);
//   as rows i, M2 = L * DX (DX recomputed: one exact product) is the A
//   fragment of dC = e (dy H^T) + M2 B.
// B C^T is formed once for the group.  The f32 matrices (M1, M2, G, H) are
// split into bf16 hi + lo; x, dy, B and C are exact.  dB and dC are added
// head by head into the group's plane (this block alone writes its rows).
template <int P>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bwd_chunk_tc(In<bf16> in, Dims d, Work w, int group, bf16* __restrict__ dx,
                 bf16* __restrict__ ddt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(d.Q, d.N, P, true);
  const int ng = (d.H + group - 1) / group;
  const int g = blockIdx.x % ng, c = (blockIdx.x / ng) % d.nc, b = blockIdx.x / (ng * d.nc);
  const int h0 = g * group, h1 = min(d.H, h0 + group), N = d.N, Q = d.Q, H = d.H, qp = L.qp;
  const size_t s0 = (size_t)b * d.S + (size_t)c * Q;
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* Ys = reinterpret_cast<bf16*>(smem + L.y);
  bf16* Gh = reinterpret_cast<bf16*>(smem + L.gh);
  bf16* Gl = reinterpret_cast<bf16*>(smem + L.gl);
  bf16* Hh = reinterpret_cast<bf16*>(smem + L.hh);
  bf16* Hl = reinterpret_cast<bf16*>(smem + L.hl);
  float* dtg = reinterpret_cast<float*>(smem + L.dt);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* ev = reinterpret_cast<float*>(smem + L.e);
  float* fv = reinterpret_cast<float*>(smem + L.f);
  float* dxx = reinterpret_cast<float*>(smem + L.dxx);
  float* dcum = reinterpret_cast<float*>(smem + L.dcum);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* red2 = reinterpret_cast<float*>(smem + L.red2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g4 = lane / 4, tq = lane % 4;
  const int nqt = qp / 16, r0 = warp * 16, j0 = r0 + g4, j1 = j0 + 8;
  // this warp's tiles of B C^T, 1 KB each: a thread's 8 floats at lane
  float4* cbw = reinterpret_cast<float4*>(smem + L.cb) + (size_t)cb_tile0(warp, nqt) * 64;
  const bool active = warp < nqt;  // warp-uniform
  float* dbg = w.dbh + (s0 * ng + g) * N;  // row j at dbg + j * ng * N
  float* dcg = w.dch + (s0 * ng + g) * N;
  const size_t gstride = (size_t)ng * N;

  stage_rows(Cs, L.ldn, in.cm + s0 * N, N, Q, qp, N);
  stage_rows(Bs, L.ldn, in.bm + s0 * N, N, Q, qp, N);
  rt::cp_async_commit();
  load_dt(dtg, in.dt, d, s0, h0, h1, qp);
  rt::cp_async_wait<0>();
  __syncthreads();
  // B C^T, rows j of the warp's tile, column tiles it >= warp, formed once
  // for the group; each thread keeps its C fragments in shared memory
  if (active) {
    for (int it = warp; it < nqt; ++it) {
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t a[4], bk[4];
        lda(a, Bs, L.ldn, r0, ks * 16);
        ldb_nk(bk, Cs, L.ldn, it * 16, ks * 16);
        rt::mma_bf16(cb[0], a, bk[0], bk[1]);
        rt::mma_bf16(cb[1], a, bk[2], bk[3]);
      }
      cbw[(it - warp) * 64 + lane] = make_float4(cb[0][0], cb[0][1], cb[0][2], cb[0][3]);
      cbw[(it - warp) * 64 + 32 + lane] = make_float4(cb[1][0], cb[1][1], cb[1][2], cb[1][3]);
    }
  }

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the last head's tiles, scalars and sums are read
    stage_rows(Xs, L.ldp, in.x + (s0 * H + h) * P, (size_t)H * P, Q, qp, P);
    stage_rows(Ys, L.ldp, in.dy + (s0 * H + h) * P, (size_t)H * P, Q, qp, P);
    rt::cp_async_commit();
    // G_{c+1} and H_c split into hi + lo planes; <G, H> in f32
    const size_t plane = (((size_t)b * d.nc + c) * H + h) * N * P;
    float ghp = 0.f;
    constexpr int kU = 4;  // float4 pairs a thread has in flight
    for (int base = tid; base < N * P / 4; base += kU * kTcThreads) {
      float4 gv[kU], hv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = base + u * kTcThreads;
        if (idx >= N * P / 4) continue;
        gv[u] = *reinterpret_cast<const float4*>(w.gs + plane + (size_t)idx * 4);
        hv[u] = *reinterpret_cast<const float4*>(w.hs + plane + (size_t)idx * 4);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = base + u * kTcThreads;
        if (idx >= N * P / 4) continue;
        const int n = idx / (P / 4), p = idx % (P / 4) * 4;
        ghp = fmaf(gv[u].x, hv[u].x, ghp);
        ghp = fmaf(gv[u].y, hv[u].y, ghp);
        ghp = fmaf(gv[u].z, hv[u].z, ghp);
        ghp = fmaf(gv[u].w, hv[u].w, ghp);
        uint2 hi, lo;
        rt::split_bf16(gv[u].x, gv[u].y, hi.x, lo.x);
        rt::split_bf16(gv[u].z, gv[u].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(Gh + n * L.ldp + p) = hi;
        *reinterpret_cast<uint2*>(Gl + n * L.ldp + p) = lo;
        rt::split_bf16(hv[u].x, hv[u].y, hi.x, lo.x);
        rt::split_bf16(hv[u].z, hv[u].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(Hh + n * L.ldp + p) = hi;
        *reinterpret_cast<uint2*>(Hl + n * L.ldp + p) = lo;
      }
    }
    const float a = -expf(in.a_log[h]);
    const float dsk = in.dskip != nullptr ? in.dskip[h] : 0.f;
    const float* dts = dtg + (h - h0) * qp;
    const float total = tc_scalars(dts, a, Q, qp, cum, ev, fv);
    rt::cp_async_wait<0>();
    __syncthreads();

    float dc0 = 0.f, dc1 = 0.f;  // d cum of rows j0, j1 (the quad's lane 0)
    float wpart = 0.f, dpart = 0.f;
    if (active) {
      const float dt0 = dts[j0], dt1 = dts[j1], cj0 = cum[j0], cj1 = cum[j1];
      const float f0 = fv[j0], f1 = fv[j1];
      // ---- rows j: DX^T = x dy^T (times dt_j below), tiles it >= warp
      float mt2[kTcTiles][2][4];  // DX^T, then M2^T
#pragma unroll
      for (int it = 0; it < kTcTiles; ++it)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt2[it][0][e] = mt2[it][1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t ax[4];
        lda(ax, Xs, L.ldp, r0, ks * 16);
#pragma unroll
        for (int it = 0; it < kTcTiles; ++it) {
          if (it < warp || it >= nqt) continue;
          uint32_t bk[4];
          ldb_nk(bk, Ys, L.ldp, it * 16, ks * 16);
          rt::mma_bf16(mt2[it][0], ax, bk[0], bk[1]);
          rt::mma_bf16(mt2[it][1], ax, bk[2], bk[3]);
        }
      }
      // d xb = f (B G), then + M1^T dy
      float acc[P / 8][4];
#pragma unroll
      for (int i = 0; i < P / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t ab[4];
        lda(ab, Bs, L.ldn, r0, ks * 16);
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          uint32_t bh[4], bl[4];
          ldb_kn(bh, Gh, L.ldp, ks * 16, dn * 16);
          ldb_kn(bl, Gl, L.ldp, ks * 16, dn * 16);
          mma2b(acc[2 * dn], acc[2 * dn + 1], ab, bh, bl);
        }
      }
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        acc[nt][0] *= f0;
        acc[nt][1] *= f0;
        acc[nt][2] *= f1;
        acc[nt][3] *= f1;
      }
      float* redw = red + warp * qp;  // this warp's column sums of M1 * DX
      for (int i = lane; i < qp; i += 32) redw[i] = 0.f;
      __syncwarp();
      float rs0 = 0.f, rs1 = 0.f;  // row sums of M1^T * DX^T
#pragma unroll
      for (int it = 0; it < kTcTiles; ++it) {
        if (it < warp || it >= nqt) continue;
        const float4 k0 = cbw[(it - warp) * 64 + lane], k1 = cbw[(it - warp) * 64 + 32 + lane];
        const float cbt[2][4] = {{k0.x, k0.y, k0.z, k0.w}, {k1.x, k1.y, k1.z, k1.w}};
        float m1[2][4];
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = it * 16 + nh * 8 + 2 * tq + e;
            const float ci = cum[i];
            const float l0 = i < Q && i >= j0 ? expf(ci - cj0) : 0.f;
            const float l1 = i < Q && i >= j1 ? expf(ci - cj1) : 0.f;
            const float x0 = mt2[it][nh][e] * dt0, x1 = mt2[it][nh][e + 2] * dt1;
            m1[nh][e] = cbt[nh][e] * l0;
            m1[nh][e + 2] = cbt[nh][e + 2] * l1;
            const float t0 = m1[nh][e] * x0, t1 = m1[nh][e + 2] * x1;
            rs0 += t0;
            rs1 += t1;
            float cs = t0 + t1;  // column i over the warp's 16 rows
            cs += __shfl_xor_sync(kFull, cs, 4);
            cs += __shfl_xor_sync(kFull, cs, 8);
            cs += __shfl_xor_sync(kFull, cs, 16);
            if (g4 == 0) redw[i] = cs;
            mt2[it][nh][e] = l0 * x0;
            mt2[it][nh][e + 2] = l1 * x1;
          }
        }
        uint32_t hi[4], lo[4];
        split_a(hi, lo, m1[0], m1[1]);
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          uint32_t bv[4];
          ldb_kn(bv, Ys, L.ldp, it * 16, dn * 16);
          mma2(acc[2 * dn], acc[2 * dn + 1], hi, lo, bv);
        }
      }
      dc0 = -quad_sum(rs0);
      dc1 = -quad_sum(rs1);
      // dx = d xb dt + D dy; d xb . x; dy . x for d D
      float xx0 = 0.f, xx1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int p = nt * 8 + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = hf ? j1 : j0;
          const float dtj = hf ? dt1 : dt0;
          const float2 xv = bf2(Xs + j * L.ldp + p), yv = bf2(Ys + j * L.ldp + p);
          const float v0 = acc[nt][2 * hf], v1 = acc[nt][2 * hf + 1];
          const float xd = fmaf(v1, xv.y, v0 * xv.x);
          if (hf) xx1 += xd; else xx0 += xd;
          dpart = fmaf(yv.y, xv.y, fmaf(yv.x, xv.x, dpart));
          if (j < Q)
            *reinterpret_cast<uint32_t*>(dx + ((s0 + j) * H + h) * P + p) =
                rt::pack_bf16(fmaf(v0, dtj, dsk * yv.x), fmaf(v1, dtj, dsk * yv.y));
        }
      }
      xx0 = quad_sum(xx0);
      xx1 = quad_sum(xx1);
      if (tq == 0) {
        dxx[j0] = xx0;
        dxx[j1] = xx1;
      }
      // dB = f dt (x G^T), w_j from it, then + M2^T C; 64 columns a pass
      float wr0 = 0.f, wr1 = 0.f;
      for (int n0 = 0; n0 < N; n0 += 64) {
        const int nu = min(4, (N - n0) / 16);
        float2 old[8][2];
        if (h > h0) load_rows(old, dbg, gstride, j0, j1, Q, n0, nu);
        float acc2[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < P / 16; ++ks) {
          uint32_t ax[4];
          lda(ax, Xs, L.ldp, r0, ks * 16);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            if (nn >= nu) continue;
            uint32_t bh[4], bl[4];
            ldb_nk(bh, Gh, L.ldp, n0 + nn * 16, ks * 16);
            ldb_nk(bl, Gl, L.ldp, n0 + nn * 16, ks * 16);
            mma2b(acc2[2 * nn], acc2[2 * nn + 1], ax, bh, bl);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= 2 * nu) continue;
          const int n = n0 + nt * 8 + 2 * tq;
          const float2 b0 = bf2(Bs + j0 * L.ldn + n), b1 = bf2(Bs + j1 * L.ldn + n);
          wr0 = fmaf(acc2[nt][1], b0.y, fmaf(acc2[nt][0], b0.x, wr0));
          wr1 = fmaf(acc2[nt][3], b1.y, fmaf(acc2[nt][2], b1.x, wr1));
          acc2[nt][0] *= f0 * dt0;
          acc2[nt][1] *= f0 * dt0;
          acc2[nt][2] *= f1 * dt1;
          acc2[nt][3] *= f1 * dt1;
        }
#pragma unroll
        for (int it = 0; it < kTcTiles; ++it) {
          if (it < warp || it >= nqt) continue;
          uint32_t hi[4], lo[4];
          split_a(hi, lo, mt2[it][0], mt2[it][1]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            if (nn >= nu) continue;
            uint32_t bc[4];
            ldb_kn(bc, Cs, L.ldn, it * 16, n0 + nn * 16);
            mma2(acc2[2 * nn], acc2[2 * nn + 1], hi, lo, bc);
          }
        }
        add_rows(dbg, gstride, acc2, old, j0, j1, Q, n0, nu, h == h0);  // head order
      }
      wr0 = quad_sum(wr0) * (f0 * dt0);
      wr1 = quad_sum(wr1) * (f1 * dt1);
      dc0 -= wr0;
      dc1 -= wr1;
      if (tq == 0) wpart = wr0 + wr1;

      // ---- rows i: M2 = L * DX, DX = dy x^T times dt_j, tiles jt <= warp
      const int i0 = j0, i1 = j1;
      const float ci0 = cj0, ci1 = cj1, e0 = ev[i0], e1 = ev[i1];
#pragma unroll
      for (int it = 0; it < kTcTiles; ++it)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt2[it][0][e] = mt2[it][1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t ay[4];
        lda(ay, Ys, L.ldp, r0, ks * 16);
#pragma unroll
        for (int jt = 0; jt < kTcTiles; ++jt) {
          if (jt > warp) continue;
          uint32_t bk[4];
          ldb_nk(bk, Xs, L.ldp, jt * 16, ks * 16);
          rt::mma_bf16(mt2[jt][0], ay, bk[0], bk[1]);
          rt::mma_bf16(mt2[jt][1], ay, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < kTcTiles; ++jt) {
        if (jt > warp) continue;
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jt * 16 + nh * 8 + 2 * tq + e;
            const float cj = cum[j], dtj = dts[j];
            const float l0 = j <= i0 ? expf(ci0 - cj) : 0.f;
            const float l1 = j <= i1 ? expf(ci1 - cj) : 0.f;
            mt2[jt][nh][e] = l0 * (mt2[jt][nh][e] * dtj);
            mt2[jt][nh][e + 2] = l1 * (mt2[jt][nh][e + 2] * dtj);
          }
      }
      // dC = e (dy H^T), its d cum term from it, then + M2 B
      float cr0 = 0.f, cr1 = 0.f;
      for (int n0 = 0; n0 < N; n0 += 64) {
        const int nu = min(4, (N - n0) / 16);
        float2 old[8][2];
        if (h > h0) load_rows(old, dcg, gstride, i0, i1, Q, n0, nu);
        float acc2[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < P / 16; ++ks) {
          uint32_t ay[4];
          lda(ay, Ys, L.ldp, r0, ks * 16);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            if (nn >= nu) continue;
            uint32_t bh[4], bl[4];
            ldb_nk(bh, Hh, L.ldp, n0 + nn * 16, ks * 16);
            ldb_nk(bl, Hl, L.ldp, n0 + nn * 16, ks * 16);
            mma2b(acc2[2 * nn], acc2[2 * nn + 1], ay, bh, bl);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= 2 * nu) continue;
          const int n = n0 + nt * 8 + 2 * tq;
          const float2 c0v = bf2(Cs + i0 * L.ldn + n), c1v = bf2(Cs + i1 * L.ldn + n);
          cr0 = fmaf(acc2[nt][1], c0v.y, fmaf(acc2[nt][0], c0v.x, cr0));
          cr1 = fmaf(acc2[nt][3], c1v.y, fmaf(acc2[nt][2], c1v.x, cr1));
          acc2[nt][0] *= e0;
          acc2[nt][1] *= e0;
          acc2[nt][2] *= e1;
          acc2[nt][3] *= e1;
        }
#pragma unroll
        for (int jt = 0; jt < kTcTiles; ++jt) {
          if (jt > warp) continue;
          uint32_t hi[4], lo[4];
          split_a(hi, lo, mt2[jt][0], mt2[jt][1]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            if (nn >= nu) continue;
            uint32_t bb[4];
            ldb_kn(bb, Bs, L.ldn, jt * 16, n0 + nn * 16);
            mma2(acc2[2 * nn], acc2[2 * nn + 1], hi, lo, bb);
          }
        }
        add_rows(dcg, gstride, acc2, old, i0, i1, Q, n0, nu, h == h0);
      }
      dc0 += quad_sum(cr0) * e0;
      dc1 += quad_sum(cr1) * e1;
    }
    __syncthreads();  // every warp's column sums are in red
    if (active && tq == 0) {  // + the row sums of M1 * DX, over the warps in order
      float s0_ = 0.f, s1_ = 0.f;
      for (int ww = 0; ww < nqt; ++ww) {
        s0_ += red[ww * qp + j0];
        s1_ += red[ww * qp + j1];
      }
      dcum[j0] = dc0 + s0_;
      dcum[j1] = dc1 + s1_;
    }
    red2[tid] = fmaf(expf(total), ghp, wpart);  // d total's terms
    red2[kTcThreads + tid] = dpart;
    __syncthreads();
    if (warp == 0) {
      float dtot = 0.f, dd = 0.f;
      for (int k = lane; k < kTcThreads; k += 32) {
        dtot += red2[k];
        dd += red2[kTcThreads + k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dtot += __shfl_xor_sync(kFull, dtot, o);
        dd += __shfl_xor_sync(kFull, dd, o);
      }
      const size_t bch = ((size_t)b * d.nc + c) * H + h;
      if (lane == 0) {
        dcum[Q - 1] += dtot;
        w.dpart[bch] = dd;
      }
      __syncwarp();
      // the reverse cumsum dl_i = sum_{i' >= i} d cum_i', 32 rows a step
      float carry = 0.f, ap = 0.f;
      for (int end = Q; end > 0; end -= 32) {
        const int i = end - 1 - lane;
        float v = i >= 0 ? dcum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i >= 0) {
          ddt[(s0 + i) * H + h] = __float2bfloat16(fmaf(v, a, dxx[i]));
          ap = fmaf(v, dts[i], ap);
        }
        carry = __shfl_sync(kFull, v, 31);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ap += __shfl_xor_sync(kFull, ap, o);
      if (lane == 0) w.apart[bch] = ap;
    }
  }
}

// f32 route: the CUDA-core kernels, one block a (b, c, h), per-head planes.
cudaError_t launch_f32(const In<float>& in, const Dims& d, float* work, float* dx, float* ddt,
                       float* db, float* dc, float* da_log, float* dd, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_chunk<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(ChunkSmem));
  if (attr != cudaSuccess) return attr;
  const Work w = carve(work, d, d.H);
  const long long blocks = (long long)d.B * d.nc * d.H;
  const long long carry = ((long long)d.B * d.H * d.N * d.P + NT - 1) / NT;
  const long long rows = ((long long)d.B * d.S * d.N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL || carry > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_bwd_states<float><<<(unsigned)blocks, NT, 0, st>>>(in, d, w);
  ssd_bwd_carry<<<(unsigned)carry, NT, 0, st>>>(d, w);
  ssd_bwd_chunk<float><<<(unsigned)blocks, NT, sizeof(ChunkSmem), st>>>(in, d, w, dx, ddt);
  ssd_bwd_reduce<float><<<(unsigned)rows, NT, 0, st>>>(d, w, d.H, db, dc);
  ssd_bwd_params<<<1, NT, 0, st>>>(d, w, in.a_log, da_log, dd);
  return cudaGetLastError();
}

// bf16 route: the tensor-core kernels, one block a (b, c, group of heads),
// per-group planes.
template <int P>
cudaError_t launch_tc(const In<bf16>& in, const Dims& d, int group, float* work, bf16* dx,
                      bf16* ddt, bf16* db, bf16* dc, float* da_log, float* dd, cudaStream_t st) {
  // set once per instance, to the most any valid launch asks for
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk_tc<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TcLayout(MQ, NMAX, P, true).bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_bwd_states_tc<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)TcLayout(MQ, NMAX, P, false).bytes);
  }();
  if (attr != cudaSuccess) return attr;
  const int ng = (d.H + group - 1) / group;
  const Work w = carve(work, d, ng);
  const long long blocks = (long long)d.B * d.nc * ng;
  const long long carry = ((long long)d.B * d.H * d.N * d.P + NT - 1) / NT;
  const long long rows = ((long long)d.B * d.S * d.N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL || carry > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ssd_bwd_states_tc<P><<<(unsigned)blocks, kTcThreads, TcLayout(d.Q, d.N, P, false).bytes, st>>>(
      in, d, w, group);
  ssd_bwd_carry<<<(unsigned)carry, NT, 0, st>>>(d, w);
  ssd_bwd_chunk_tc<P><<<(unsigned)blocks, kTcThreads, TcLayout(d.Q, d.N, P, true).bytes, st>>>(
      in, d, w, group, dx, ddt);
  ssd_bwd_reduce<bf16><<<(unsigned)rows, NT, 0, st>>>(d, w, ng, db, dc);
  ssd_bwd_params<<<1, NT, 0, st>>>(d, w, in.a_log, da_log, dd);
  return cudaGetLastError();
}

static_assert(sizeof(ChunkSmem) <= 232448, "the chunk block within the SM's shared memory");
static_assert(TcLayout(MQ, NMAX, PMAX, true).bytes <= 232448,
              "the bf16 chunk block within the SM's shared memory");

}  // namespace

// x, dy, dx (B,S,H,P); dt, ddt (B,S,H); b, c, db, dc (B,S,N): contiguous,
// one dtype, bf16 x, dy, b and c 16-byte aligned.  a_log (H,) f32, d_skip
// (H,) f32 or null; da_log (H,) f32 out, dd (H,) f32 out or null.  chunk
// divides S, at most 128; N a multiple of 16 up to 128; P a multiple of 16
// up to 64 (f32), 16, 32 or 64 (bf16).  group: heads a block of the bf16
// route takes (1 for f32).  work: the wrapper's bwd_workspace floats.  Five
// launches.  Returns cudaGetLastError().
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* a_log,
                                   const void* b, const void* c, const void* d_skip,
                                   const void* dy, void* dx, void* ddt, void* db, void* dc,
                                   void* da_log, void* dd, void* work, int B, int S, int H,
                                   int P, int N, int chunk, int group, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || P % 16 || N <= 0 || N > NMAX ||
      N % 16 || chunk <= 0 || chunk > MQ || S % chunk || work == nullptr || group < 1 ||
      group > H)
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
    if (group != 1) return cudaErrorInvalidValue;
    const In<T> in{static_cast<const T*>(x), static_cast<const T*>(dt), al,
                   static_cast<const T*>(b), static_cast<const T*>(c), ds,
                   static_cast<const T*>(dy)};
    return launch_f32(in, d, wk, static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<T*>(db),
                      static_cast<T*>(dc), da, ddp, st);
  }
  if (dtype == rt::kBFloat16) {
    using T = bf16;
    if (group > kMaxGroup) return cudaErrorInvalidValue;
    const In<T> in{static_cast<const T*>(x), static_cast<const T*>(dt), al,
                   static_cast<const T*>(b), static_cast<const T*>(c), ds,
                   static_cast<const T*>(dy)};
    auto o = [](void* p) { return static_cast<T*>(p); };
    switch (P) {
      case 16: return launch_tc<16>(in, d, group, wk, o(dx), o(ddt), o(db), o(dc), da, ddp, st);
      case 32: return launch_tc<32>(in, d, group, wk, o(dx), o(ddt), o(db), o(dc), da, ddp, st);
      case 64: return launch_tc<64>(in, d, group, wk, o(dx), o(ddt), o(db), o(dc), da, ddp, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
