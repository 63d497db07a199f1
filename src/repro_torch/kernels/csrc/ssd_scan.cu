// Mamba2 SSD (state-space duality) chunked scan from a zero state.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py (ssd -> _ssd_kernel);
// oracle ref.ssd_chunked.  For each (batch row b, head h), chunk by chunk of
// Q positions, with ld = dt * -exp(a_log[h]) and cum the inclusive prefix
// sum of ld inside the chunk:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra-chunk)
//       + exp(cum_i) C_i . h_in                                 (carried state)
//       + d_skip[h] x_i
//   h   = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T  (N x P, f32)
// The TPU kernel ran the chunks as the sequential axis of its grid with h in
// VMEM scratch.  Blocks of a Hopper grid run in parallel and in no order.
//
// Bound on the card: at the serving chunk (32 tokens, 48 heads of 64, state
// 128) a launch reads and writes well under a megabyte, so its bytes take
// well under a microsecond and launch latency dominates; at a 1024-token
// prompt the products (O(S Q N) per head) and the carried states' bytes.
// bf16 design, chunk-parallel on the tensor cores (mma.sync.m16n8k16, f32
// sums of exact bf16 products):
//   * dt is folded into the score and the state weights, not into x, so
//     that every product has one exact bf16 operand (x, C or B):
//       y_diag  = (C·Bᵀ ∘ exp(cum_i - cum_j) ∘ dt_j) · x,
//       state_c = (B ∘ exp(cum_Q - cum_j) ∘ dt_j)ᵀ · x,
//       y_off   = exp(cum_i) · C · h_in;
//     the other operand (the decayed score, the decayed B, the carried
//     state) is f32, and is split into bf16 hi + lo (rt::split_bf16, two
//     products), which keeps the f32 oracle's precision to about 2^-17;
//   * one chunk (S = Q, the serving path's 32-token chunk): one launch of
//     ssd_chunk_out_kernel, no state computed or carried (h is zero going
//     in and never an output);
//   * several chunks: ssd_chunk_state_kernel computes every chunk's state
//     but the last in parallel, one block per (chunk, 2 heads, batch row);
//     ssd_state_pass_kernel runs the short sequential pass over chunks,
//     h <- exp(total_c) h + state_c in f32, one thread per state element,
//     writing each chunk's incoming state as bf16 hi and lo planes; then
//     ssd_chunk_out_kernel computes all chunks' outputs in parallel.  The
//     states live in an f32 workspace the wrapper allocates;
//   * ssd_chunk_out_kernel: one block per (chunk, 2 heads, batch row), one
//     warp per 16 rows of the chunk.  C.Bᵀ is computed once per block, tile
//     by tile in registers, and serves both heads; exp(cum_i - cum_j) is
//     taken only on the causal triangle (j <= i), where it is <= 1;
//   * the chunk width Q is a run-time argument from 1 to 128, padded to the
//     mma tile (16) with zero rows and masked; d_skip x is added in f32
//     before the one rounding of y to bf16.
// The tensor-core route takes P in {16, 32, 64} and N a multiple of 16 up to
// 128 (mamba2-780m: P 64, N 128); the wrapper refuses other bf16 widths.
// f32 inputs (the identity checks, held at 2e-5) take the CUDA-core body
// ssd_kernel, selected by dtype: the chunk loop runs inside one block per
// (16 columns of P, head, batch row), with h in shared memory from the
// first chunk to the last, all products f32 fmaf.  This is a dispatch by
// dtype, not a fallback: both routes launch or fail.
#include "common.cuh"
#include "tc.cuh"

namespace {

// ----------------------------------------------------------------- f32 route
constexpr int PB = 16;          // columns of P per block
constexpr int NT = 32;          // rows of the state per tile
constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kOwn = kMaxChunk * PB / kThreads;  // outputs per thread, at most

__host__ __device__ inline int pad_state(int n) { return (n + NT - 1) / NT * NT; }

__host__ inline size_t smem_bytes(int q, int n) {
  const size_t floats = (size_t)q * (q + 1)        // score
                        + 2 * (size_t)q * (NT + 1)  // C and B tiles
                        + (size_t)q * PB            // xb
                        + (size_t)pad_state(n) * PB // h
                        + 2 * (size_t)q;            // cum, exp(total - cum)
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           T* __restrict__ y, int S, int H, int P, int N, int Q) {
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int npad = pad_state(N);
  const int ld_g = Q + 1, ld_t = NT + 1;

  extern __shared__ float smem[];
  float* G = smem;                  // [Q][Q + 1] decay-weighted C.B^T
  float* Cs = G + Q * ld_g;         // [Q][NT + 1]
  float* Bs = Cs + Q * ld_t;        // [Q][NT + 1]
  float* xb = Bs + Q * ld_t;        // [Q][PB]
  float* hs = xb + Q * PB;          // [npad][PB] carried state (f32)
  float* cum = hs + npad * PB;      // [Q]
  float* dout = cum + Q;            // [Q] exp(cum_Q - cum_j)

  const float A = -expf(a_log[h]);
  const float dsk = d_skip == nullptr ? 0.f : d_skip[h];
  for (int i = tid; i < npad * PB; i += kThreads) hs[i] = 0.f;
  const int own = (Q * PB + kThreads - 1) / kThreads;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // xb = x dt and the log-decays of this chunk
    for (int idx = tid; idx < Q * PB; idx += kThreads) {
      const int i = idx / PB, p = idx % PB;
      const size_t row = ((size_t)b * S + c0 + i) * H + h;
      xb[idx] = rt::to_f32(x[row * P + p0 + p]) * rt::to_f32(dt[row]);
    }
    for (int i = tid; i < Q; i += kThreads)
      cum[i] = rt::to_f32(dt[((size_t)b * S + c0 + i) * H + h]) * A;
    for (int idx = tid; idx < Q * ld_g; idx += kThreads) G[idx] = 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive prefix sum, one warp, 32 entries at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? cum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    const float keep = expf(total);
    for (int j = tid; j < Q; j += kThreads) dout[j] = expf(total - cum[j]);

    float yint[kOwn];
#pragma unroll
    for (int k = 0; k < kOwn; ++k) yint[k] = 0.f;

    for (int n0 = 0; n0 < npad; n0 += NT) {
      for (int idx = tid; idx < Q * NT; idx += kThreads) {
        const int i = idx / NT, nn = idx % NT, n = n0 + nn;
        const size_t off = ((size_t)b * S + c0 + i) * N + n;
        Cs[i * ld_t + nn] = n < N ? rt::to_f32(cm[off]) : 0.f;
        Bs[i * ld_t + nn] = n < N ? rt::to_f32(bm[off]) : 0.f;
      }
      __syncthreads();
      // score C.B^T (lower triangle) and the carried-state term C.h
      for (int idx = tid; idx < Q * Q; idx += kThreads) {
        const int i = idx / Q, j = idx % Q;
        if (j > i) continue;
        float s = 0.f;
#pragma unroll 8
        for (int nn = 0; nn < NT; ++nn) s = fmaf(Cs[i * ld_t + nn], Bs[j * ld_t + nn], s);
        G[i * ld_g + j] += s;
      }
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int idx = tid + k * kThreads;
        if (k < own && idx < Q * PB) {
          const int i = idx / PB, p = idx % PB;
          float s = yint[k];
#pragma unroll 8
          for (int nn = 0; nn < NT; ++nn) s = fmaf(Cs[i * ld_t + nn], hs[(n0 + nn) * PB + p], s);
          yint[k] = s;
        }
      }
      __syncthreads();
      // this tile's rows of h: decay the old state, add the chunk's inputs
      for (int idx = tid; idx < NT * PB; idx += kThreads) {
        const int nn = idx / PB, p = idx % PB;
        float s = 0.f;
        for (int j = 0; j < Q; ++j) s = fmaf(Bs[j * ld_t + nn] * dout[j], xb[j * PB + p], s);
        float* hp = hs + (n0 + nn) * PB + p;
        *hp = fmaf(keep, *hp, s);
      }
      __syncthreads();
    }

    // fold the decay into the score, then y
    for (int idx = tid; idx < Q * Q; idx += kThreads) {
      const int i = idx / Q, j = idx % Q;
      if (j <= i) G[i * ld_g + j] *= expf(cum[i] - cum[j]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int idx = tid + k * kThreads;
      if (k < own && idx < Q * PB) {
        const int i = idx / PB, p = idx % PB;
        float s = 0.f;
        for (int j = 0; j <= i; ++j) s = fmaf(G[i * ld_g + j], xb[j * PB + p], s);
        const size_t at = (((size_t)b * S + c0 + i) * H + h) * P + p0 + p;
        const float out = s + expf(cum[i]) * yint[k] + dsk * rt::to_f32(x[at]);
        y[at] = rt::from_f32<T>(out);
      }
    }
    __syncthreads();  // xb, cum and the score are rewritten by the next chunk
  }
}

// ---------------------------------------------------------------- bf16 route
using bf16 = __nv_bfloat16;
constexpr int HB = 2;          // heads per block: C.Bᵀ is computed once for both
constexpr int kMaxStateTc = 128;

__host__ __device__ inline int pad16(int q) { return (q + 15) / 16 * 16; }

// Shared-memory layout of one (chunk, head pair) block, in bytes: C and B
// rows ([Qp][N + 8] bf16), the heads' x rows ([HB][Qp][P + 8] bf16), their
// carried states' hi and lo planes ([HB][2][N][P + 8] bf16, output kernel
// of a multi-chunk scan only), cum and dt or the state weights ([HB][Qp]
// f32 each).
struct TcLayout {
  int qp, ldc, ldx;
  size_t c, b, x, h, cum, w, bytes;
  __host__ __device__ TcLayout(int q, int n, int p, bool with_c, bool with_h) {
    qp = pad16(q);
    ldc = n + 8;
    ldx = p + 8;
    c = 0;
    b = c + (with_c ? (size_t)qp * ldc * sizeof(bf16) : 0);
    x = b + (size_t)qp * ldc * sizeof(bf16);
    h = x + (size_t)HB * qp * ldx * sizeof(bf16);
    cum = h + (with_h ? (size_t)HB * 2 * n * ldx * sizeof(bf16) : 0);
    w = cum + (size_t)HB * qp * sizeof(float);
    bytes = w + (size_t)HB * qp * sizeof(float);
  }
};

// Stage the chunk's B (and C) rows and the head pair's x rows by cp.async
// (rows past the chunk, and a head past H, zero-filled); dt of both heads
// into w and the inclusive prefix sum of ld = dt * A into cum (padded rows
// have dt 0, so their cum repeats the last row's).  Ends with every copy
// landed and a barrier.
template <int P>
__device__ __forceinline__ void stage_chunk(const TcLayout& L, unsigned char* smem,
                                            const bf16* x, const bf16* dt, const float* a_log,
                                            const bf16* bm, const bf16* cm, int b, int c0,
                                            int h0, int S, int H, int N, int Q) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cpr_n = N / 8, cpr_p = P / 8;  // 16-byte chunks per row
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  for (int idx = tid; idx < L.qp * cpr_n; idx += nthreads) {
    const int i = idx / cpr_n, cc = idx % cpr_n;
    const bool ok = i < Q;
    const size_t off = ok ? ((size_t)b * S + c0 + i) * N + cc * 8 : 0;
    rt::cp_async16(Bs + i * L.ldc + cc * 8, bm + off, ok);
    if (cm != nullptr) rt::cp_async16(Cs + i * L.ldc + cc * 8, cm + off, ok);
  }
  for (int idx = tid; idx < HB * L.qp * cpr_p; idx += nthreads) {
    const int hh = idx / (L.qp * cpr_p), rest = idx % (L.qp * cpr_p);
    const int i = rest / cpr_p, cc = rest % cpr_p;
    const bool ok = i < Q && h0 + hh < H;
    const size_t off = ok ? (((size_t)b * S + c0 + i) * H + h0 + hh) * P + cc * 8 : 0;
    rt::cp_async16(Xs + (hh * L.qp + i) * L.ldx + cc * 8, x + off, ok);
  }
  rt::cp_async_commit();
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* w = reinterpret_cast<float*>(smem + L.w);
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  for (int hh = warp; hh < HB; hh += nwarps) {  // one warp per head
    const int h = h0 + hh;
    const float A = h < H ? -expf(a_log[h]) : 0.f;
    float carry = 0.f;
    for (int base = 0; base < L.qp; base += 32) {
      const int i = base + lane;
      const float d = (i < Q && h < H) ? rt::to_f32(dt[((size_t)b * S + c0 + i) * H + h]) : 0.f;
      float v = d * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (i < L.qp) {
        cum[hh * L.qp + i] = v;
        w[hh * L.qp + i] = d;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();
}

// Every chunk's state but the last, (B ∘ exp(cum_Q - cum_j) ∘ dt_j)ᵀ · x:
// one block per (chunk, head pair, batch row), one warp per 16 rows of the
// state (N / 16 warps); the weighted B is split into hi + lo.  Writes the
// f32 state [N][P] and the chunk's log-decay total cum_Q of each head.
template <int P>
__global__ void __launch_bounds__(256, 1)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                       const float* __restrict__ a_log, const bf16* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ totals, int S, int H,
                       int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const TcLayout L(Q, N, P, false, false);
  const int c = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z, nc1 = gridDim.x;
  stage_chunk<P>(L, smem, x, dt, a_log, bm, nullptr, b, c * Q, h0, S, H, N, Q);
  const bf16* Bs = reinterpret_cast<const bf16*>(smem + L.b);
  const bf16* Xs = reinterpret_cast<const bf16*>(smem + L.x);
  const float* cum = reinterpret_cast<const float*>(smem + L.cum);
  float* w = reinterpret_cast<float*>(smem + L.w);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  // state weights exp(cum_Q - cum_j) dt_j (zero on padded rows: dt is 0)
  for (int idx = tid; idx < HB * L.qp; idx += blockDim.x) {
    const int hh = idx / L.qp;
    const float total = cum[hh * L.qp + Q - 1];
    w[idx] *= rt::exp2_approx(fminf(total - cum[idx], 0.f) * rt::kLog2e);
  }
  __syncthreads();
  const size_t np = (size_t)N * P;
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
    const float* wh = w + hh * L.qp;
    const bf16* Xh = Xs + hh * L.qp * L.ldx;
    for (int mt = warp; mt < N / 16; mt += blockDim.x / 32) {
      float acc[P / 8][4];
#pragma unroll
      for (int i = 0; i < P / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int ks = 0; ks < L.qp / 16; ++ks) {
        // A = (weighted B)ᵀ: rows n, depth j; B is stored [j][n], so the
        // fragments come transposed
        uint32_t a[4];
        rt::ldmatrix_x4_trans(a, Bs + (ks * 16 + lane % 8 + (lane / 16) * 8) * L.ldc + mt * 16 +
                                     ((lane / 8) % 2) * 8);
        const int j = ks * 16 + 2 * tq;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = j + (r / 2) * 8;
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[r]));
          rt::split_bf16(f.x * wh[jj], f.y * wh[jj + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          uint32_t bv[4];
          rt::ldmatrix_x4_trans(bv, Xh + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L.ldx +
                                        dn * 16 + (lane / 16) * 8);
          rt::mma_bf16(acc[2 * dn], ah, bv[0], bv[1]);
          rt::mma_bf16(acc[2 * dn], al, bv[0], bv[1]);
          rt::mma_bf16(acc[2 * dn + 1], ah, bv[2], bv[3]);
          rt::mma_bf16(acc[2 * dn + 1], al, bv[2], bv[3]);
        }
      }
      float* st = states + (((size_t)b * nc1 + c) * H + h) * np;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        float* r = st + (size_t)(mt * 16 + g) * P + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(r) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(r + 8 * P) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    if (tid == 0) totals[((size_t)b * nc1 + c) * H + h] = cum[hh * L.qp + Q - 1];
  }
}

// The sequential pass over chunks, one thread per state element of one
// (head, batch row): h <- exp(total_c) h + state_c in f32, from zero; the
// state entering chunk c + 1 is written as bf16 hi and lo planes.  The
// inputs of 8 chunks are loaded ahead of the dependent chain.
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ totals,
                      bf16* __restrict__ hin, int H, int np, int nc1) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= np) return;
  constexpr int kAhead = 8;  // chunks whose inputs are loaded before they are folded in
  float hc = 0.f;
  for (int c0 = 0; c0 < nc1; c0 += kAhead) {
    float keep[kAhead], add[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t at = ((size_t)b * nc1 + c0 + u) * H + h;
      keep[u] = c0 + u < nc1 ? totals[at] : 0.f;
      add[u] = c0 + u < nc1 ? states[at * np + e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u >= nc1) break;
      const size_t at = ((size_t)b * nc1 + c0 + u) * H + h;
      hc = fmaf(expf(keep[u]), hc, add[u]);
      const bf16 hi = __float2bfloat16(hc);
      hin[at * 2 * np + e] = hi;
      hin[at * 2 * np + np + e] = __float2bfloat16(hc - __bfloat162float(hi));
    }
  }
}

// Every chunk's output: one block per (chunk, head pair, batch row), one
// warp per 16 rows of the chunk.  With a carried state (chunks after the
// first of a multi-chunk scan) the warp first forms exp(cum_i) C·h_in from
// its hi and lo planes; then, tile by tile of 16 columns on and below the
// diagonal, C·Bᵀ once for both heads, its decayed and dt-weighted copy per
// head split into hi + lo, times x.
template <int P>
__global__ void __launch_bounds__(256, 1)
ssd_chunk_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                     const float* __restrict__ a_log, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, const float* __restrict__ d_skip,
                     const bf16* __restrict__ hin, bf16* __restrict__ y, int S, int H, int N,
                     int Q) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const int c = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z, nc = gridDim.x;
  const TcLayout L(Q, N, P, true, nc > 1);
  const bool carried = c > 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t np = (size_t)N * P;
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  if (carried) {  // the head pair's incoming states, hi and lo: [HB][2][N][P + 8]
    const int cpr = P / 8;
    for (int idx = tid; idx < HB * 2 * N * cpr; idx += blockDim.x) {
      const int plane = idx / (N * cpr), rest = idx % (N * cpr);  // plane = hh * 2 + part
      const int n = rest / cpr, cc = rest % cpr, hh = plane / 2;
      const bool ok = h0 + hh < H;
      const size_t at = ((size_t)b * (nc - 1) + c - 1) * H + h0 + hh;
      rt::cp_async16(Hs + ((size_t)plane * N + n) * L.ldx + cc * 8,
                     ok ? hin + (at * 2 + plane % 2) * np + (size_t)n * P + cc * 8 : hin, ok);
    }
  }
  stage_chunk<P>(L, smem, x, dt, a_log, bm, cm, b, c * Q, h0, S, H, N, Q);
  const bf16* Cs = reinterpret_cast<const bf16*>(smem + L.c);
  const bf16* Bs = reinterpret_cast<const bf16*>(smem + L.b);
  const bf16* Xs = reinterpret_cast<const bf16*>(smem + L.x);
  const float* cum = reinterpret_cast<const float*>(smem + L.cum);
  const float* dtv = reinterpret_cast<const float*>(smem + L.w);

  const int i0 = warp * 16;  // the warp's rows
  float acc[HB][P / 8][4];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int i = 0; i < P / 8; ++i) acc[hh][i][0] = acc[hh][i][1] = acc[hh][i][2] = acc[hh][i][3] = 0.f;

  if (carried) {
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t a[4];
      rt::ldmatrix_x4(a, Cs + (i0 + lane % 16) * L.ldc + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        const bf16* hi = Hs + (size_t)(hh * 2) * N * L.ldx;
        const bf16* lo = hi + (size_t)N * L.ldx;
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          const int at = (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L.ldx + dn * 16 +
                         (lane / 16) * 8;
          uint32_t bh[4], bl[4];
          rt::ldmatrix_x4_trans(bh, hi + at);
          rt::ldmatrix_x4_trans(bl, lo + at);
          rt::mma_bf16(acc[hh][2 * dn], a, bh[0], bh[1]);
          rt::mma_bf16(acc[hh][2 * dn], a, bl[0], bl[1]);
          rt::mma_bf16(acc[hh][2 * dn + 1], a, bh[2], bh[3]);
          rt::mma_bf16(acc[hh][2 * dn + 1], a, bl[2], bl[3]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float e0 = rt::exp2_approx(cum[hh * L.qp + i0 + g] * rt::kLog2e);
      const float e1 = rt::exp2_approx(cum[hh * L.qp + i0 + g + 8] * rt::kLog2e);
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        acc[hh][nt][0] *= e0;
        acc[hh][nt][1] *= e0;
        acc[hh][nt][2] *= e1;
        acc[hh][nt][3] *= e1;
      }
    }
  }

  for (int jt = 0; jt <= warp; ++jt) {  // column tiles on and below the diagonal
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t a[4], bk[4];
      rt::ldmatrix_x4(a, Cs + (i0 + lane % 16) * L.ldc + ks * 16 + (lane / 16) * 8);
      rt::ldmatrix_x4(bk, Bs + (jt * 16 + (lane / 16) * 8 + lane % 8) * L.ldc + ks * 16 +
                              ((lane / 8) % 2) * 8);
      rt::mma_bf16(sc[0], a, bk[0], bk[1]);
      rt::mma_bf16(sc[1], a, bk[2], bk[3]);
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float* ch = cum + hh * L.qp;
      const float* dh = dtv + hh * L.qp;
      const float ci0 = ch[i0 + g], ci1 = ch[i0 + g + 8];
      float v[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt * 16 + nt * 8 + 2 * tq + e;
          const float cj = ch[j], dj = dh[j];  // dt is 0 past the chunk
          // the decay only on the causal triangle, where it is <= 1
          v[nt][e] = j <= i0 + g
                         ? sc[nt][e] * rt::exp2_approx(fminf(ci0 - cj, 0.f) * rt::kLog2e) * dj
                         : 0.f;
          v[nt][e + 2] = j <= i0 + g + 8
                             ? sc[nt][e + 2] * rt::exp2_approx(fminf(ci1 - cj, 0.f) * rt::kLog2e) * dj
                             : 0.f;
        }
      }
      uint32_t ph[4], pl[4];
      rt::split_bf16(v[0][0], v[0][1], ph[0], pl[0]);
      rt::split_bf16(v[0][2], v[0][3], ph[1], pl[1]);
      rt::split_bf16(v[1][0], v[1][1], ph[2], pl[2]);
      rt::split_bf16(v[1][2], v[1][3], ph[3], pl[3]);
      const bf16* Xh = Xs + hh * L.qp * L.ldx;
#pragma unroll
      for (int dn = 0; dn < P / 16; ++dn) {
        uint32_t bv[4];
        rt::ldmatrix_x4_trans(bv, Xh + (jt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L.ldx +
                                      dn * 16 + (lane / 16) * 8);
        rt::mma_bf16(acc[hh][2 * dn], ph, bv[0], bv[1]);
        rt::mma_bf16(acc[hh][2 * dn], pl, bv[0], bv[1]);
        rt::mma_bf16(acc[hh][2 * dn + 1], ph, bv[2], bv[3]);
        rt::mma_bf16(acc[hh][2 * dn + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // y = acc + d_skip x in f32, rounded once
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    if (h >= H) break;
    const float dsk = d_skip == nullptr ? 0.f : d_skip[h];
    const bf16* Xh = Xs + hh * L.qp * L.ldx;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf;
      if (i >= Q) continue;
      bf16* yr = y + (((size_t)b * S + c * Q + i) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int p = nt * 8 + 2 * tq;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xh + i * L.ldx + p));
        *reinterpret_cast<uint32_t*>(yr + p) =
            rt::pack_bf16(acc[hh][nt][2 * hf] + dsk * xv.x, acc[hh][nt][2 * hf + 1] + dsk * xv.y);
      }
    }
  }
}

template <int P>
cudaError_t launch_tc(const bf16* x, const bf16* dt, const float* a_log, const bf16* bm,
                      const bf16* cm, const float* d_skip, bf16* y, float* work, int B, int S,
                      int H, int N, int Q, cudaStream_t st) {
  // set once per instance, to the most any valid launch asks for
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_out_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TcLayout(kMaxChunk, kMaxStateTc, P, true, true).bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_chunk_state_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)TcLayout(kMaxChunk, kMaxStateTc, P, false, false).bytes);
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = S / Q, groups = (H + HB - 1) / HB, np = N * P;
  float* states = work;
  bf16* hin = nullptr;
  float* totals = nullptr;
  if (nc > 1) {
    const size_t n_states = (size_t)B * (nc - 1) * H * np;
    hin = reinterpret_cast<bf16*>(states + n_states);
    totals = states + 2 * n_states;
    ssd_chunk_state_kernel<P><<<dim3(nc - 1, groups, B), 32 * (N / 16),
                                TcLayout(Q, N, P, false, false).bytes, st>>>(
        x, dt, a_log, bm, states, totals, S, H, N, Q);
    ssd_state_pass_kernel<<<dim3((np + 255) / 256, H, B), 256, 0, st>>>(states, totals, hin, H,
                                                                        np, nc - 1);
  }
  ssd_chunk_out_kernel<P><<<dim3(nc, groups, B), 32 * (pad16(Q) / 16),
                            TcLayout(Q, N, P, true, nc > 1).bytes, st>>>(
      x, dt, a_log, bm, cm, d_skip, hin, y, S, H, N, Q);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* dt, const float* a_log,
                       const void* bm, const void* cm, const float* d_skip,
                       void* y, int B, int S, int H, int P, int N, int Q,
                       cudaStream_t st) {
  using T = float;
  const size_t bytes = smem_bytes(Q, N);
  // set once per instance, to the most any valid launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxChunk, 512));
  if (attr != cudaSuccess) return attr;
  ssd_kernel<T><<<dim3(P / PB, H, B), kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a_log,
      static_cast<const T*>(bm), static_cast<const T*>(cm), d_skip,
      static_cast<T*>(y), S, H, P, N, Q);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* dt, const float* a_log, const void* bm,
                        const void* cm, const float* d_skip, void* y, float* work, int B, int S,
                        int H, int P, int N, int Q, cudaStream_t st) {
  if (N % 16 != 0 || N > kMaxStateTc || (S / Q > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* dd = static_cast<const bf16*>(dt);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cc = static_cast<const bf16*>(cm);
  bf16* yy = static_cast<bf16*>(y);
  switch (P) {
    case 16: return launch_tc<16>(xx, dd, a_log, bb, cc, d_skip, yy, work, B, S, H, N, Q, st);
    case 32: return launch_tc<32>(xx, dd, a_log, bb, cc, d_skip, yy, work, B, S, H, N, Q, st);
    case 64: return launch_tc<64>(xx, dd, a_log, bb, cc, d_skip, yy, work, B, S, H, N, Q, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), b/c (B,S,N), y (B,S,H,P): contiguous, one dtype.
// a_log (H,) and d_skip (H,) or null: float32.  1 <= chunk <= 128 dividing
// S.  f32: P a multiple of 16, N at most 512.  bf16: P 16, 32 or 64, N a
// multiple of 16 up to 128, x/b/c 16-byte aligned, and with nc = S / chunk
// > 1 `work` holds B * (nc - 1) * H * (2 N P + 1) floats (unused
// otherwise).  Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a_log,
                               const void* b_mat, const void* c_mat,
                               const void* d_skip, void* y, void* work, int B,
                               int S, int H, int P, int N, int chunk, int dtype,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P % PB ||
      N <= 0 || N > 512 || chunk < 1 || chunk > kMaxChunk || S % chunk)
    return cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* ds = static_cast<const float*>(d_skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return launch_f32(x, dt, al, b_mat, c_mat, ds, y, B, S, H, P, N, chunk, st);
  if (dtype == rt::kBFloat16)
    return launch_bf16(x, dt, al, b_mat, c_mat, ds, y, static_cast<float*>(work), B, S, H, P, N,
                       chunk, st);
  return cudaErrorInvalidValue;
}
