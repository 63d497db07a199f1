// RMSNorm with the gemma-style (1 + scale) gain, and the three fused forms
// the model calls it in.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py (rmsnorm ->
// _rmsnorm_kernel): out = v * rsqrt(mean(v^2) + eps) * (1 + scale), float32
// statistics, out in v's type.  One kernel body; its prologue forms the row
// v by mode:
//   kNorm   v = x;
//   kAdd    s = x + y rounded to T (PyTorch's rounding of the sum), written
//           out, and v = s;
//   kGated  v = y * silu(z), silu rounded to T first, then the product, as
//           PyTorch rounds `y * F.silu(z)`.
// A launch takes two row segments, each with its own rows, inputs, gain and
// output: the qk-norm normalises q and k (one head_dim row per head, each
// tensor with its own gain) in one launch.
//
// Bound on the card: bytes (each input read once, each output written once,
// about four operations per element).  Every serving shape is tiny (8 rows
// of 2560 at decode, 40 KB), so a launch costs its fixed overhead plus one
// DRAM round trip, and the design saves launches (the pair, the residual
// add, Mamba2's gate) and keeps the trip to one:
//   * narrow rows (head_dim 128 or 256): a group of 4-32 lanes per row, 16
//     bytes a lane per load, the sum a shuffle; blocks of 32-128 threads, as
//     few rows a block as keeps the grid over the SMs (decode's 320 qk rows
//     of 128 bf16 give 160 blocks);
//   * wide rows (d_model 1536-5376, Mamba2's 3072): one block per row,
//     every thread holding its 16-byte vectors of the row and of the gain in
//     registers; all of them are loaded before the block's reduction, so the
//     row costs one round trip;
//   * any other width up to 16384 (odd, or rows whose stride or base is not
//     16-byte aligned): the block path with element-wise loads and a masked
//     tail.
// Inputs are read through a row stride, so a slice of a wider projection
// (Mamba2's z) needs no copy; outputs are contiguous.
#include "common.cuh"

namespace {

enum Mode : int { kNorm = 0, kAdd = 1, kGated = 2 };

// One segment of rows.  a: x (kNorm, kAdd) or y (kGated); b: the addend y
// (kAdd) or the gate z (kGated).  sa, sb: row strides in elements.
struct Seg {
  const void* a;
  const void* b;
  long long sa, sb;
  const float* gain;
  void* out;
  void* sum;  // kAdd: x + y
  int rows;
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return rt::to_f32(rt::from_f32<T>(v));
}

// V contiguous elements as float32: 16-byte (or wider) vector loads where
// V * sizeof(T) allows, else element by element.
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&o)[V]) {
  if constexpr (V * sizeof(T) >= 16) {
    rt::load_f32<T, V>(p, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = rt::to_f32(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = rt::from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = rt::from_f32<T>(v[j]);
  }
}

// The row's elements [e, e + V) after the mode's prologue, into v; the
// gain's into g.  kAdd also writes the rounded sum.
template <typename T, int V>
__device__ __forceinline__ void load_row(const Seg& s, int mode, size_t row, int D, int e,
                                         float (&v)[V], float (&g)[V]) {
  load_v<T, V>(static_cast<const T*>(s.a) + row * s.sa + e, v);
  load_v<float, V>(s.gain + e, g);
  if (mode == kNorm) return;
  float w[V];
  load_v<T, V>(static_cast<const T*>(s.b) + row * s.sb + e, w);
  if (mode == kAdd) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = round_to<T>(v[j] + w[j]);
    store_v<T, V>(static_cast<T*>(s.sum) + row * D + e, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float silu = round_to<T>(w[j] / (1.f + expf(-w[j])));
      v[j] = round_to<T>(v[j] * silu);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(const Seg& s, size_t row, int D, int e, float r,
                                          float (&v)[V], const float (&g)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = v[j] * r * (1.f + g[j]);
  store_v<T, V>(static_cast<T*>(s.out) + row * D + e, v);
}

// Row `grow` of the two segments: the segment (chosen field by field, so
// that no parameter's address is taken) and the row within it.
__device__ __forceinline__ Seg pick(const Seg& s0, const Seg& s1, int grow, size_t& row) {
  const bool second = grow >= s0.rows;
  row = second ? grow - s0.rows : grow;
  Seg s;
  s.a = second ? s1.a : s0.a;
  s.b = second ? s1.b : s0.b;
  s.sa = second ? s1.sa : s0.sa;
  s.sb = second ? s1.sb : s0.sb;
  s.gain = second ? s1.gain : s0.gain;
  s.out = second ? s1.out : s0.out;
  s.sum = second ? s1.sum : s0.sum;
  s.rows = second ? s1.rows : s0.rows;
  return s;
}

// Narrow rows: a group of kGW lanes per row, kPer vectors of V elements a
// lane (vector k of lane l covers [(k kGW + l) V, +V)).  D % V == 0.
template <typename T, int kGW, int kPer, int V>
__global__ void __launch_bounds__(128)
norm_group_kernel(Seg s0, Seg s1, int D, float eps, int mode) {
  const int lane = threadIdx.x % kGW;
  const int grow = blockIdx.x * (blockDim.x / kGW) + threadIdx.x / kGW;
  const bool live = grow < s0.rows + s1.rows;
  size_t row;
  const Seg s = pick(s0, s1, grow, row);
  const int nv = D / V;
  float v[kPer][V], g[kPer][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int vi = k * kGW + lane;
    if (live && vi < nv) {
      load_row<T, V>(s, mode, row, D, vi * V, v[k], g[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) ss += v[k][j] * v[k][j];
  ss = rt::group_sum<kGW>(ss);  // every lane of the warp takes part
  const float r = rsqrtf(ss / D + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int vi = k * kGW + lane;
    if (live && vi < nv) store_row<T, V>(s, row, D, vi * V, r, v[k], g[k]);
  }
}

// Wide rows, and every width the vector path does not take: one block per
// row, kPer chunks of V elements a thread (chunk k of thread t covers
// [(k blockDim + t) V, +V)); the last chunk may be partial only when V == 1.
template <typename T, int kPer, int V>
__global__ void __launch_bounds__(512)
norm_block_kernel(Seg s0, Seg s1, int D, float eps, int mode) {
  __shared__ float s_part[32];
  size_t row;
  const Seg s = pick(s0, s1, blockIdx.x, row);
  const int nv = D / V;
  float v[kPer][V], g[kPer][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int vi = k * blockDim.x + threadIdx.x;
    if (vi < nv) {
      load_row<T, V>(s, mode, row, D, vi * V, v[k], g[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) ss += v[k][j] * v[k][j];
  ss = rt::group_sum<32>(ss);
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) s_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = threadIdx.x < nwarps ? s_part[threadIdx.x] : 0.f;
    ss = rt::group_sum<32>(ss);
    if (threadIdx.x == 0) s_part[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(s_part[0] / D + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int vi = k * blockDim.x + threadIdx.x;
    if (vi < nv) store_row<T, V>(s, row, D, vi * V, r, v[k], g[k]);
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Every pointer and row stride of the segment allows 16-byte vectors.
template <typename T>
bool vector_ok(const Seg& s, int mode) {
  if (s.rows == 0) return true;
  const long long vec = 16 / sizeof(T);
  bool ok = aligned16(s.a) && aligned16(s.gain) && aligned16(s.out) && s.sa % vec == 0;
  if (mode != kNorm) ok = ok && aligned16(s.b) && s.sb % vec == 0;
  if (mode == kAdd) ok = ok && aligned16(s.sum);
  return ok;
}

template <typename T, int kGW>
void launch_group(const Seg& s0, const Seg& s1, int D, float eps, int mode, int per,
                  int threads, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int rows = s0.rows + s1.rows, per_block = threads / kGW;
  const dim3 grid((rows + per_block - 1) / per_block);
  if (per == 1)
    norm_group_kernel<T, kGW, 1, V><<<grid, threads, 0, st>>>(s0, s1, D, eps, mode);
  else
    norm_group_kernel<T, kGW, 2, V><<<grid, threads, 0, st>>>(s0, s1, D, eps, mode);
}

template <typename T>
cudaError_t launch_t(const Seg& s0, const Seg& s1, int D, float eps, int mode,
                     cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int rows = s0.rows + s1.rows;
  if (rows == 0) return cudaSuccess;
  const bool vec = D % V == 0 && vector_ok<T>(s0, mode) && vector_ok<T>(s1, mode);
  if (vec && D / V <= 64) {
    // narrow rows: the group covers the row in one or two vectors a lane
    const int nv = D / V;
    const int gw = nv <= 4 ? 4 : nv <= 8 ? 8 : nv <= 16 ? 16 : 32;
    const int per = nv > 32 ? 2 : 1;
    int threads = 128;
    while (threads > 32 && ((long long)rows * gw + threads - 1) / threads < sm_count())
      threads /= 2;
    switch (gw) {
      case 4: launch_group<T, 4>(s0, s1, D, eps, mode, per, threads, st); break;
      case 8: launch_group<T, 8>(s0, s1, D, eps, mode, per, threads, st); break;
      case 16: launch_group<T, 16>(s0, s1, D, eps, mode, per, threads, st); break;
      default: launch_group<T, 32>(s0, s1, D, eps, mode, per, threads, st); break;
    }
    return cudaGetLastError();
  }
  if (vec && D / V <= 512 * 4) {
    // wide rows: the fewest vectors a thread that keep the block <= 512
    const int nv = D / V;
    const int per = nv <= 512 ? 1 : nv <= 1024 ? 2 : 4;
    const int threads = ((nv + per - 1) / per + 31) / 32 * 32;
    switch (per) {
      case 1: norm_block_kernel<T, 1, V><<<rows, threads, 0, st>>>(s0, s1, D, eps, mode); break;
      case 2: norm_block_kernel<T, 2, V><<<rows, threads, 0, st>>>(s0, s1, D, eps, mode); break;
      default: norm_block_kernel<T, 4, V><<<rows, threads, 0, st>>>(s0, s1, D, eps, mode); break;
    }
    return cudaGetLastError();
  }
  // element-wise loads (and vectors past 512 x 4 a row): any width up to
  // 512 * 32
  if (D > 512 * 32) return cudaErrorInvalidValue;
  const int per = D <= 512 * 8 ? 8 : 32;
  const int threads = ((D + per - 1) / per + 31) / 32 * 32;
  if (per == 8)
    norm_block_kernel<T, 8, 1><<<rows, threads, 0, st>>>(s0, s1, D, eps, mode);
  else
    norm_block_kernel<T, 32, 1><<<rows, threads, 0, st>>>(s0, s1, D, eps, mode);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 norm, 1 add (b0 = y, sum0 = x + y out), 2 gated (b0 = z).  The
// second segment (rows1 > 0: the qk-norm pair) takes mode 0 only.  a, b:
// rows of D with row strides sa, sb (elements); gain: (D,) float32; out,
// sum: contiguous (rows, D).  dtype: rt::DType of every row tensor.
// Returns cudaGetLastError().
extern "C" int rmsnorm_launch(int mode, int dtype, int D, float eps, const void* a0,
                              const void* b0, long long sa0, long long sb0,
                              const void* gain0, void* out0, void* sum0, int rows0,
                              const void* a1, long long sa1, const void* gain1, void* out1,
                              int rows1, void* stream) {
  if (D <= 0 || rows0 < 0 || rows1 < 0 || mode < kNorm || mode > kGated ||
      (rows1 > 0 && mode != kNorm) || (long long)rows0 + rows1 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Seg s0{a0, b0, sa0, sb0, static_cast<const float*>(gain0), out0, sum0, rows0};
  const Seg s1{a1, nullptr, sa1, 0, static_cast<const float*>(gain1), out1, nullptr, rows1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch_t<float>(s0, s1, D, eps, mode, st);
  if (dtype == rt::kBFloat16) return launch_t<__nv_bfloat16>(s0, s1, D, eps, mode, st);
  return cudaErrorInvalidValue;
}
