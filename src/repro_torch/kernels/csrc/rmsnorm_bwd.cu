// Backward of the (1 + scale) RMSNorm in the four forms the training path
// calls it in: the norm, the qk pair, the residual add with the next norm
// and Mamba2's gated norm (rmsnorm.cu's kNorm, its two-segment launch,
// kAdd and kGated).
//
// The TPU kernel repro/kernels/rmsnorm.py (rmsnorm -> _rmsnorm_kernel) has
// no backward: the JAX package differentiates its jnp norm.  The port's
// forward is the kernel of rmsnorm.cu, so its gradient is a kernel too.
// With w = 1 + scale and r = rsqrt(mean(v^2) + eps), recomputed from the
// saved input v (kNorm: x; kAdd: the saved sum s = x + y; kGated: v = y *
// silu(z), formed from the saved y and z and rounded as the forward rounds
// it, silu to T first, then the product):
//   dv     = r * (dy * w - v * r^2 * mean(dy * w * v))   (+ dres for kAdd:
//            the gradient of the sum output, so dx = dy_in = dres + dnorm)
//   dscale = sum over rows of dy * v * r, in float32;
//   kGated: dy_in = dv * silu(z) (the rounded silu the forward multiplied
//           by) and dz = dv * y * sigmoid(z) * (1 + z * (1 - sigmoid(z))),
//           silu's derivative, in float32.
// Each gradient is computed in float32 and rounded once to the input's
// type.  dscale is deterministic, without atomics: each block writes its
// rows' partial sum per column (norm_bwd_kernel) and a second kernel adds the blocks'
// partials in a fixed order (dscale_kernel).  The pair's two segments (q
// and k, each with its own gain) share one launch of each kernel.
//
// Bound on the card: bytes (x, dy and dres or z read once, dx and dz
// written once; about ten operations an element, thirty gated).  Design:
//   * a row belongs to a group of G threads (8 to 256: KC chunks of 8
//     columns a thread, four or five), so a block of 256 threads has
//     256 / G rows in flight, and a narrow group (G <= 32) takes R rows
//     at once; bf16 keeps to 128 registers a thread, two blocks an SM;
//   * the gated form is an instantiation of its own (the form, and the
//     block's threads, are template parameters), with tiles that leave no
//     chunk of a thread dead; at 3072 a block of 384 threads owns one row,
//     a chunk each, three blocks an SM (36 warps; 56 registers; 16 warps
//     of two rows a block ran 23% slower).  Its gate is computed once an
//     element, in the sums' loop: e = exp(-z), d = 1 + e, silu = round(z /
//     d) (the forward's expression, so v = round(y silu) is bit-equal to
//     what the forward normalised), sigmoid = 1 / d and silu's derivative
//     from it; silu (exact in T, packed as T) and the derivative (f32) are
//     kept for the output loop, and z is then dead.  One exp, one divide
//     and one reciprocal an element, where the form shared with the norm
//     took four exps and four divides, with the same arithmetic, so the
//     same bits;
//   * every load of a row (x, dy, dres or z) is issued, 16 bytes a thread,
//     before the row's reduction, so their latencies overlap;
//   * the row's two sums are reduced by warp shuffles; a group of two to
//     eight warps (G 64 to 256) adds its warps' sums through shared memory
//     behind a named barrier of its own warps, not the block's;
//   * each thread adds its rows' dscale terms into its group's row of
//     shared memory (registers stay for the loads); the block adds its
//     groups' partials in group order, and dscale_kernel adds the blocks'
//     in a fixed order: a block of 32 warps owns 32 columns, warp w adds
//     blocks w, w + 32, ... and then the warps' sums in warp order.
// A width that is not a multiple of 8, or a row that is not 16-byte
// aligned, takes the same kernel with element loads (`vec` = 0).
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kThreads = 256;  // a block of the norm, pair and add forms

struct Seg {
  const void* x;     // rows of D (kAdd: the sum s)
  const void* dy;    // gradient of the normalised output
  const void* dres;  // kAdd: gradient of the sum output, else null
  const void* z;     // kGated: the gate (x is then y), else null
  const float* gain;
  void* dx;          // kGated: the gradient of y
  void* dz;          // kGated: the gradient of z, else null
  int rows;
};

// Eight consecutive elements of a row, as they sit in memory (16 bytes of
// bf16, 32 of f32).
template <typename T>
struct Chunk {
  static constexpr int W = sizeof(T) / 2;
  uint4 w[W];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ float elem(const Chunk<T>& c, int e);
template <>
__device__ __forceinline__ float elem<float>(const Chunk<float>& c, int e) {
  return __uint_as_float(word(c.w[e / 4], e % 4));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const Chunk<__nv_bfloat16>& c, int e) {
  const uint32_t u = word(c.w[0], e / 2);
  return __uint_as_float(e % 2 ? (u & 0xffff0000u) : (u << 16));
}

// x rounded to T and back, as the forward rounds its gated input.
template <typename T>
__device__ __forceinline__ float round_t(float x) { return rt::to_f32(rt::from_f32<T>(x)); }

// Eight floats (each exact in T where T is bf16) packed as a Chunk.
template <typename T>
__device__ __forceinline__ Chunk<T> pack_chunk(const float (&v)[8]) {
  Chunk<T> c;
  if constexpr (sizeof(T) == 2) {
    c.w[0] = make_uint4(rt::pack_bf16(v[0], v[1]), rt::pack_bf16(v[2], v[3]),
                        rt::pack_bf16(v[4], v[5]), rt::pack_bf16(v[6], v[7]));
  } else {
    c.w[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                        __float_as_uint(v[3]));
    c.w[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                        __float_as_uint(v[7]));
  }
  return c;
}

__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// Columns c0 .. c0 + 7 of a row (zero past D); vec: one or two 16-byte loads.
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* __restrict__ row, int c0, int D, bool vec) {
  Chunk<T> c;
  if (vec) {
#pragma unroll
    for (int i = 0; i < Chunk<T>::W; ++i) c.w[i] = __ldg(reinterpret_cast<const uint4*>(row + c0) + i);
    return c;
  }
  constexpr int per = 4 / sizeof(T);  // elements a 32-bit word
  uint32_t u[4 * Chunk<T>::W];
#pragma unroll
  for (int i = 0; i < 4 * Chunk<T>::W; ++i) {
    u[i] = 0;
#pragma unroll
    for (int e = 0; e < per; ++e) {
      const int col = c0 + i * per + e;
      if (col < D) u[i] |= bits_of(row[col]) << (16 * e);
    }
  }
#pragma unroll
  for (int i = 0; i < Chunk<T>::W; ++i)
    c.w[i] = make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]);
  return c;
}

template <typename T>
__device__ __forceinline__ Chunk<T> zero_chunk() {
  Chunk<T> c;
#pragma unroll
  for (int i = 0; i < Chunk<T>::W; ++i) c.w[i] = make_uint4(0u, 0u, 0u, 0u);
  return c;
}

// v rounded once to T into columns c0 .. c0 + 7 of a row (those < D).
template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c0, int D, bool vec,
                                            const float (&v)[8]) {
  if (!vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c0 + e < D) row[c0 + e] = rt::from_f32<T>(v[e]);
    return;
  }
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(row + c0) =
        make_uint4(rt::pack_bf16(v[0], v[1]), rt::pack_bf16(v[2], v[3]),
                   rt::pack_bf16(v[4], v[5]), rt::pack_bf16(v[6], v[7]));
  } else {
    *reinterpret_cast<float4*>(row + c0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + c0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// w = 1 + gain over columns c0 .. c0 + 7 (0 past D).
__device__ __forceinline__ void load_w(const float* __restrict__ gain, int c0, int D, bool vec,
                                       float (&w)[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(gain + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(gain + c0) + 1);
    w[0] = 1.f + a.x, w[1] = 1.f + a.y, w[2] = 1.f + a.z, w[3] = 1.f + a.w;
    w[4] = 1.f + b.x, w[5] = 1.f + b.y, w[6] = 1.f + b.z, w[7] = 1.f + b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = c0 + e < D ? 1.f + gain[c0 + e] : 0.f;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The sums of a row over its group of G threads, into every thread of the
// group.  G > 32: the group's warps meet at named barrier 1 + grp, through
// `slot` (one float2 a warp; callers alternate two slots by iteration, so
// that one barrier a row suffices).
template <int G>
__device__ __forceinline__ float2 group_sum2(float2 v, float2* slot, int grp) {
  constexpr int W = G < 32 ? G : 32;
  v.x = rt::group_sum<W>(v.x);
  v.y = rt::group_sum<W>(v.y);
  if constexpr (G > 32) {
    constexpr int warps = G / 32;
    if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] = v;
    named_barrier(1 + grp, G);
    v = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < warps; ++w) {
      v.x += slot[grp * warps + w].x;
      v.y += slot[grp * warps + w].y;
    }
  }
  return v;
}

// Groups of G threads, R rows a group at a time; a thread owns the chunks
// of columns (lane + G k) * 8, k < KC, and adds its rows' dscale terms
// into its group's row of acc_s.  Partials: (gridDim.x, 2, D) floats.
// Gated: segment 0 is the gated form (Seg::z set), else the norm, pair or
// add form.  MinB blocks an SM bound the registers.
template <typename T, bool Gated, int NT, int G, int KC, int R, int MinB>
__global__ void __launch_bounds__(NT, MinB)
norm_bwd_kernel(Seg s0, Seg s1, int D, float eps, int vec, float* __restrict__ partial) {
  static_assert(G <= 32 || R == 1, "a row wider than a warp is reduced one at a time");
  extern __shared__ __align__(16) float acc_s[];  // (groups, D) partial sums
  __shared__ float2 red[2][NT / 32];
  constexpr int groups = NT / G;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const float invD = 1.f / D;
  float* mine = acc_s + grp * D;
  for (int seg = 0; seg < 2; ++seg) {
    // the segment's fields, chosen one by one (a reference to a parameter
    // struct would put both structs in local memory)
    const int rows = seg ? s1.rows : s0.rows;
    if (seg == 1 && rows == 0) break;  // uniform: no second segment
    const T* xs = static_cast<const T*>(seg ? s1.x : s0.x);
    const T* dys = static_cast<const T*>(seg ? s1.dy : s0.dy);
    const T* dres = static_cast<const T*>(seg ? s1.dres : s0.dres);
    const T* zs = static_cast<const T*>(seg ? s1.z : s0.z);
    const float* gain = seg ? s1.gain : s0.gain;
    T* dxs = static_cast<T*>(seg ? s1.dx : s0.dx);
    T* dzs = static_cast<T*>(seg ? s1.dz : s0.dz);
    const T* rs = Gated ? zs : dres;  // rv holds z (gated) or dres
    for (int c = threadIdx.x; c < groups * D; c += NT) acc_s[c] = 0.f;
    __syncthreads();

    // every group of the block runs the same iterations, a row past the
    // end as zeros: groups narrower than a warp share its shuffles
    const int step = gridDim.x * groups * R;
    int it = 0;
    for (int first = blockIdx.x * groups * R; first < rows; first += step, ++it) {
      const int base = first + grp * R;
      // every load of the group's R rows first
      Chunk<T> xv[R][KC], gv[R][KC], rv[R][KC];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const size_t row = (size_t)(base + j) * D;
        const bool live = base + j < rows;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int c0 = (lane + G * k) * 8;
          const bool ok = live && c0 < D;
          xv[j][k] = ok ? load_chunk<T>(xs + row, c0, D, vec) : zero_chunk<T>();
          gv[j][k] = ok ? load_chunk<T>(dys + row, c0, D, vec) : zero_chunk<T>();
          rv[j][k] = ok && rs != nullptr ? load_chunk<T>(rs + row, c0, D, vec)
                                         : zero_chunk<T>();
        }
      }
      // (sum v^2, sum dy w v) of each row; gated: silu(z) and its
      // derivative kept, z then dead
      float2 sums[R];
      Chunk<T> sq[Gated ? R : 1][Gated ? KC : 1];
      float dsq[Gated ? R : 1][Gated ? KC : 1][8];
#pragma unroll
      for (int j = 0; j < R; ++j) sums[j] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c0 = (lane + G * k) * 8;
        if (c0 >= D) continue;
        float w[8];
        load_w(gain, c0, D, vec, w);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float sf[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float xf = elem<T>(xv[j][k], e);
            if constexpr (Gated) {
              // the gate once: e = exp(-z), d = 1 + e; silu = round(z / d),
              // the forward's; sigmoid = 1 / d for silu's derivative
              const float z = elem<T>(rv[j][k], e);
              const float d = 1.f + expf(-z);
              const float sig = 1.f / d;
              sf[e] = round_t<T>(z / d);
              dsq[j][k][e] = sig * (1.f + z * (1.f - sig));
              xf = round_t<T>(xf * sf[e]);
            }
            const float gf = elem<T>(gv[j][k], e);
            sums[j].x = fmaf(xf, xf, sums[j].x);
            sums[j].y = fmaf(gf * w[e], xf, sums[j].y);
          }
          if constexpr (Gated) sq[j][k] = pack_chunk<T>(sf);
        }
      }
      float r[R], coef[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float2 s = group_sum2<G>(sums[j], red[it & 1], grp);
        r[j] = rsqrtf(s.x * invD + eps);
        coef[j] = r[j] * r[j] * s.y * invD;
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c0 = (lane + G * k) * 8;
        if (c0 >= D) continue;
        float w[8], a[8];
        load_w(gain, c0, D, vec, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (base + j >= rows) continue;
          float o[8], oz[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float yf = elem<T>(xv[j][k], e);
            float xf = yf;
            if constexpr (Gated) xf = round_t<T>(yf * elem<T>(sq[j][k], e));  // v again
            const float gf = elem<T>(gv[j][k], e);
            o[e] = r[j] * (gf * w[e] - xf * coef[j]);
            if constexpr (Gated) {
              // through v = y * silu(z): dy = dv silu(z), dz = dv y silu'(z)
              oz[e] = o[e] * yf * dsq[j][k][e];
              o[e] *= elem<T>(sq[j][k], e);
            } else {
              if (dres != nullptr) o[e] += elem<T>(rv[j][k], e);
            }
            a[e] = fmaf(gf, xf * r[j], a[e]);
          }
          store_chunk<T>(dxs + (size_t)(base + j) * D, c0, D, vec, o);
          if constexpr (Gated) store_chunk<T>(dzs + (size_t)(base + j) * D, c0, D, vec, oz);
        }
        // the group's own row of acc_s: no other thread touches these
        if (vec) {
          float4* p = reinterpret_cast<float4*>(mine + c0);
          float4 u = p[0], v = p[1];
          p[0] = make_float4(u.x + a[0], u.y + a[1], u.z + a[2], u.w + a[3]);
          p[1] = make_float4(v.x + a[4], v.y + a[5], v.z + a[6], v.w + a[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c0 + e < D) mine[c0 + e] += a[e];
        }
      }
    }
    // the groups' partials, added in group order
    __syncthreads();
    float* out = partial + ((size_t)blockIdx.x * 2 + seg) * D;
    for (int c = threadIdx.x; c < D; c += NT) {
      float t = 0.f;
      for (int g = 0; g < groups; ++g) t += acc_s[g * D + c];
      out[c] = t;
    }
    __syncthreads();
  }
}

// dscale of segment blockIdx.y: each column's partials over the blocks,
// added in a fixed order.  A block owns 32 columns; warp w adds blocks w,
// w + 32, ... in turn, then warp 0 adds the 32 warps' sums in warp order.
constexpr int DS_NT = 1024;

__global__ void __launch_bounds__(DS_NT)
dscale_kernel(const float* __restrict__ partial, int blocks, int D, float* __restrict__ dg0,
              float* __restrict__ dg1) {
  constexpr int warps = DS_NT / 32;
  __shared__ float sums[warps][33];
  const int seg = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += warps) t += partial[((size_t)b * 2 + seg) * D + c];
  }
  sums[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && c < D) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < warps; ++w) s += sums[w][lane];
    (seg ? dg1 : dg0)[c] = s;
  }
}

// The SMs of the current device (the gated form sizes its grid by them).
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

template <typename T, bool Gated, int G, int KC, int R, int NT = kThreads>
cudaError_t launch_k(const Seg& s0, const Seg& s1, int D, float eps, int vec, float* partial,
                     int max_blocks, int& blocks, cudaStream_t st) {
  // f32 (the identity checks) takes one row at a time: its chunks are
  // twice as many registers
  constexpr int RR = sizeof(T) == 2 ? R : 1;
  constexpr int per_pass = (NT / G) * RR;
  // blocks an SM: bf16 two of 256 threads (128 registers a thread), or
  // three of 384 (the gated form's one-row blocks: 56); f32 one
  constexpr int MinB = sizeof(T) != 2 ? 1 : NT == kThreads ? 2 : 3;
  // the groups' partials: (NT / G) rows of at most G * KC * 8 columns
  static_assert((size_t)NT * KC * 8 * sizeof(float) <= 48 * 1024, "partials within 48 KB");
  const int rows = max(s0.rows, s1.rows);
  blocks = max(1, min((rows + per_pass - 1) / per_pass,
                      Gated ? min(max_blocks, MinB * sm_count()) : max_blocks));
  const size_t smem = (size_t)(NT / G) * D * sizeof(float);
  norm_bwd_kernel<T, Gated, NT, G, KC, RR, MinB><<<blocks, NT, smem, st>>>(s0, s1, D, eps, vec,
                                                                          partial);
  return cudaGetLastError();
}

// The group width G, chunks a thread KC and rows a group R for a width:
// four to five chunks of each input in flight a thread (bf16: 48 to 60
// registers of data), so that two blocks fit an SM.
template <typename T>
cudaError_t launch_norm(const Seg& s0, const Seg& s1, int D, float eps, int vec, float* partial,
                        int max_blocks, int& blocks, cudaStream_t st) {
  const int chunks = (D + 7) / 8;
#define NORM_K(G, KC, R) \
  return launch_k<T, false, G, KC, R>(s0, s1, D, eps, vec, partial, max_blocks, blocks, st)
  if (chunks <= 8) NORM_K(8, 1, 4);
  if (chunks <= 16) NORM_K(16, 1, 4);
  if (chunks <= 32) NORM_K(32, 1, 4);
  if (chunks <= 64) NORM_K(32, 2, 2);
  if (chunks <= 128) NORM_K(32, 4, 1);
  if (chunks <= 256) NORM_K(64, 4, 1);
  if (chunks <= 320) NORM_K(64, 5, 1);
  if (chunks <= 512) NORM_K(128, 4, 1);
  NORM_K(256, 4, 1);
#undef NORM_K
}

// The gated form's tiles: the widest group whose chunks a thread (three,
// else four) are all live at the width's multiples of three groups; past
// 2048 columns up to 3072 (mamba2-780m's 3072), one row a block of 384
// threads, a chunk each, three blocks an SM.
template <typename T>
cudaError_t launch_gated(const Seg& s0, const Seg& s1, int D, float eps, int vec, float* partial,
                         int max_blocks, int& blocks, cudaStream_t st) {
  const int chunks = (D + 7) / 8;
#define GATED_K(G, KC, R) \
  return launch_k<T, true, G, KC, R>(s0, s1, D, eps, vec, partial, max_blocks, blocks, st)
  if (chunks <= 8) GATED_K(8, 1, 3);
  if (chunks <= 16) GATED_K(16, 1, 3);
  if (chunks <= 32) GATED_K(32, 1, 3);
  if (chunks <= 96) GATED_K(32, 3, 1);
  if (chunks <= 128) GATED_K(32, 4, 1);
  if (chunks <= 192) GATED_K(64, 3, 1);
  if (chunks <= 256) GATED_K(64, 4, 1);
  if (chunks <= 384)
    return launch_k<T, true, 384, 1, 1, 384>(s0, s1, D, eps, vec, partial, max_blocks, blocks,
                                             st);
  if (chunks <= 512) GATED_K(128, 4, 1);
  if (chunks <= 768) GATED_K(256, 3, 1);
  GATED_K(256, 4, 1);
#undef GATED_K
}

template <typename T>
cudaError_t launch_t(const Seg& s0, const Seg& s1, int D, float eps, int vec, float* partial,
                     int max_blocks, int& blocks, cudaStream_t st) {
  if (s0.z != nullptr)
    return launch_gated<T>(s0, s1, D, eps, vec, partial, max_blocks, blocks, st);
  return launch_norm<T>(s0, s1, D, eps, vec, partial, max_blocks, blocks, st);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Segment 0: x0 (rows0, D) (kAdd: the saved sum; kGated: y), dy0, dres0
// (null unless the add form), z0 (null unless the gated form), gain0, dx0
// out (kGated: the gradient of y), dz0 out (kGated only); segment 1
// (rows1 > 0: the pair's k): x1, dy1, gain1, dx1.  All rows contiguous, one
// dtype, D <= 8192.  The first kernel runs at most `blocks` blocks of 256
// threads (at most two an SM; the gated form's one-row blocks of 384, three
// an SM), each striding over both segments' rows; partial: blocks * 2 * D
// floats of scratch.  dgain0/dgain1: (D,) f32 out (dgain1 null without
// segment 1).  Two launches.  Returns cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(int dtype, int D, float eps, const void* x0, const void* dy0,
                                  const void* dres0, const void* z0, const void* gain0, void* dx0,
                                  void* dz0, int rows0, const void* x1, const void* dy1,
                                  const void* gain1, void* dx1, int rows1, float* partial,
                                  int blocks, float* dgain0, float* dgain1, void* stream) {
  if (D <= 0 || D > 8192 || rows0 < 0 || rows1 < 0 || blocks <= 0 || partial == nullptr ||
      dgain0 == nullptr || (rows1 > 0 && dgain1 == nullptr) ||
      (z0 != nullptr && (dz0 == nullptr || dres0 != nullptr || rows1 > 0)))
    return cudaErrorInvalidValue;
  const Seg s0{x0, dy0, dres0, z0, static_cast<const float*>(gain0), dx0, dz0, rows0};
  const Seg s1{x1, dy1, nullptr, nullptr, static_cast<const float*>(gain1), dx1, nullptr, rows1};
  const int vec = D % 8 == 0 && aligned16(x0) && aligned16(dy0) && aligned16(dres0) &&
                  aligned16(z0) && aligned16(dz0) && aligned16(gain0) && aligned16(dx0) &&
                  (rows1 == 0 || (aligned16(x1) && aligned16(dy1) && aligned16(gain1) &&
                                  aligned16(dx1)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int used = 0;
  cudaError_t e;
  if (dtype == rt::kFloat32) e = launch_t<float>(s0, s1, D, eps, vec, partial, blocks, used, st);
  else if (dtype == rt::kBFloat16)
    e = launch_t<__nv_bfloat16>(s0, s1, D, eps, vec, partial, blocks, used, st);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  dscale_kernel<<<dim3((D + 31) / 32, rows1 > 0 ? 2 : 1), DS_NT, 0, st>>>(partial, used, D,
                                                                          dgain0, dgain1);
  return cudaGetLastError();
}
