// RG-LRU linear recurrence (Griffin) from a zero state.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py (rglru ->
// _rglru_kernel); oracle ref.rglru_chunked.  Per channel d:
//   a_t = exp(log_a_t),  b_t = sqrt(max(1 - exp(2 log_a_t), 0)) gate_t x_t,
//   h_t = a_t h_{t-1} + b_t,  h_0 = 0,  y_t = h_t rounded to x's type,
// with a and b computed in f32 from the (bf16) inputs inside the kernel.
//
// Bound on the card: bytes.  Three inputs are read and one output written,
// once each (1024 x 4096 bf16: 32 MB, 10 us at 3.35 TB/s); the channels are
// independent and the work is a scan along time.  Read once: every input
// element is loaded once and its a and b (two exp, one sqrt: the oracle's
// own expressions) computed once.  A block owns 32 neighbouring channels,
// one a lane, and cuts time into tiles of `segs` segments of `per` steps,
// one segment a warp.  A tile is scanned in three moves: each warp scans its
// segment from zero and keeps the local states and decay prefixes in
// registers; the segments' (decay product, end state) pairs meet in shared
// memory and become each segment's incoming state; each warp applies its
// incoming state to the values it kept and writes h.
//
//   * One tile (S <= 128; the 32-token serving chunk is 16 warps of two
//     steps): the inputs go straight from global memory to registers, every
//     load of a lane issued before the first use, and each warp folds the
//     (at most 15) pairs before its own.  One launch, one pass, 128 blocks at
//     D 4096: 128 of the 132 SMs.  More blocks would have to cut the 32 steps
//     between blocks, which needs a carry from block to block (a look-back
//     and its zeroed workspace, or a second launch) on a launch that its
//     fixed cost already holds; the channels are already one a lane.
//   * Several tiles (whole prompts): tiles of 32 segments of 8 steps (256
//     steps) pass through a ring of shared-memory stages, filled by 16-byte
//     cp.async copies two tiles (f32: one) ahead of the tile being scanned.
//     Warp w scans channel w's 32 pairs across its lanes with shuffles (five
//     steps) and keeps the channel's carry along time in registers, so a
//     long prompt is one launch, with no workspace and no look-back.
//     Chosen over a decoupled look-back (one block a tile, a ticket and a
//     zeroed workspace) and over two launches (aggregates, then a second read
//     from L2): a version with the look-back ran slower on the H100, its
//     blocks each loading, scanning and storing in one burst, all in step,
//     while here the next tiles' loads are in flight during each scan.
//     Under autograd the staged path also writes each tile's incoming f32
//     state (the carry, tile 1 on) to a small checkpoint, so that the
//     backward kernel reads each input once; y does not change with it.
// A warp's row of a tile is 32 channels, 64 bytes in bf16.  Two channels a
// lane (a 128-byte row, 64 blocks at D 4096) ran slower at every shape
// tried: the chunk and the one-token launch are held by how many SMs issue
// their loads, a prompt by the SMs' instruction issue.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kGroup = 32;            // channels a block, one a lane
constexpr int kSegs = 32;             // warps of a staged tile
constexpr int kSteps = 8;             // steps a segment holds at most
constexpr int kRows = kSegs * kSteps;  // steps of a staged tile
constexpr int kOneSegs = 16;          // most warps of a one-tile launch

// Shared-memory stages of the staged path: three in bf16, two in f32.
template <typename T>
struct Stages {
  static constexpr int kCount = sizeof(T) == 2 ? 3 : 2;
  T in[kCount][3][kRows][kGroup];  // x, log_a, gate of each staged tile
};

struct Ctx {
  int S, D, seg, lane, ch;
  size_t row0;  // element offset of (b, t = 0, ch)
};

// Scan a segment of n steps from zero; fetch(u, l, g, x) gives step u's
// inputs as float32.  a[u]: the decay prefix through step u; h[u]: the
// state from zero; (prod, state): the segment's pair.
template <typename Fetch>
__device__ __forceinline__ void scan_segment(int n, Fetch fetch, float (&a)[kSteps],
                                             float (&h)[kSteps], float& prod, float& state) {
  prod = 1.f, state = 0.f;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (u < n) {
      float l, g, xv;
      fetch(u, l, g, xv);
      const float at = expf(l);
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * l), 0.f));
      state = at * state + beta * g * xv;
      prod *= at;
      h[u] = state;
      a[u] = prod;
    }
  }
}

// The staged tile's segment pairs are in s_seg.  Warp w scans channel w's
// pairs across its lanes, lane s taking segment s, writes each segment's
// incoming state to s_in, and moves `carry` (channel w's state before the
// tile) past the tile.  Then one barrier.
__device__ __forceinline__ void segment_states(const Ctx& k, float2 (*s_seg)[kGroup],
                                               float (*s_in)[kGroup], float& carry) {
  static_assert(kSegs == kGroup && kSegs == 32, "one channel a warp, one segment a lane");
  const int s = k.lane, c = k.seg;
  float2 v = s_seg[s][c];
  // inclusive scan of the maps h -> v.x h + v.y, earlier segments first
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float pa = __shfl_up_sync(0xffffffffu, v.x, o);
    const float ph = __shfl_up_sync(0xffffffffu, v.y, o);
    if (s >= o) v = make_float2(pa * v.x, v.x * ph + v.y);
  }
  const float pa = __shfl_up_sync(0xffffffffu, v.x, 1);
  const float ph = __shfl_up_sync(0xffffffffu, v.y, 1);
  s_in[s][c] = s == 0 ? carry : pa * carry + ph;
  carry = __shfl_sync(0xffffffffu, v.x, 31) * carry + __shfl_sync(0xffffffffu, v.y, 31);
  __syncthreads();
}

// Apply the segment's incoming state and write its n outputs.
template <typename T>
__device__ __forceinline__ void write_segment(const Ctx& k, T* __restrict__ y, int t_lo, int n,
                                              float hin, const float (&a)[kSteps],
                                              const float (&h)[kSteps]) {
  T* out = y + k.row0 + (size_t)t_lo * k.D;
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
    if (u < n) out[(size_t)u * k.D] = rt::from_f32<T>(h[u] + a[u] * hin);
}

// One tile: segs warps of per steps, the inputs straight into registers.
template <typename T>
__global__ void __launch_bounds__(kOneSegs * 32)
rglru_one_tile_kernel(const T* __restrict__ x, const T* __restrict__ log_a,
                      const T* __restrict__ gate, T* __restrict__ y, int S, int D, int per) {
  __shared__ float2 s_seg[kOneSegs][kGroup];
  const int groups = (D + kGroup - 1) / kGroup;
  Ctx k;
  k.S = S, k.D = D, k.seg = threadIdx.x / 32, k.lane = threadIdx.x % 32;
  k.ch = blockIdx.x % groups * kGroup + k.lane;
  k.row0 = (size_t)(blockIdx.x / groups) * S * D + k.ch;
  const int t_lo = k.seg * per;
  const int n = k.ch < D ? max(0, min(per, S - t_lo)) : 0;
  T xr[kSteps], lr[kSteps], gr[kSteps];  // every load first, then the terms
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (u < n) {
      const size_t off = k.row0 + (size_t)(t_lo + u) * D;
      xr[u] = x[off];
      lr[u] = log_a[off];
      gr[u] = gate[off];
    }
  }
  float a[kSteps], h[kSteps], prod, state;
  scan_segment(
      n,
      [&](int u, float& l, float& g, float& xv) {
        l = rt::to_f32(lr[u]);
        g = rt::to_f32(gr[u]);
        xv = rt::to_f32(xr[u]);
      },
      a, h, prod, state);
  s_seg[k.seg][k.lane] = make_float2(prod, state);
  __syncthreads();
  // this segment's incoming state: the segments before it, folded from zero
  float hin = 0.f;
  for (int s = 0; s < k.seg; ++s) {
    const float2 v = s_seg[s][k.lane];
    hin = v.x * hin + v.y;
  }
  write_segment(k, y, t_lo, n, hin, a, h);
}

// Stage tile `tile` (steps [tile * kRows, +kRows) of the block's channels
// from row plane b) into st.in[slot]: 16-byte cp.async chunks where the
// rows allow (vec), zero-filled past S or D; else element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(const Ctx& k, int b, int g, const T* __restrict__ x,
                                           const T* __restrict__ log_a,
                                           const T* __restrict__ gate, int tile, int slot,
                                           bool vec, Stages<T>& st) {
  const int t0 = tile * kRows;
  const size_t plane = (size_t)b * k.S;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);    // elements a chunk
    constexpr int kChunks = kGroup / kPer;  // chunks a row
#pragma unroll
    for (int arr = 0; arr < 3; ++arr) {
      const T* base = arr == 0 ? x : arr == 1 ? log_a : gate;
      for (int j = threadIdx.x; j < kRows * kChunks; j += blockDim.x) {
        const int r = j / kChunks, c = j % kChunks;
        const int t = t0 + r, ch = g * kGroup + c * kPer;
        const bool ok = t < k.S && ch < k.D;
        rt::cp_async16(&st.in[slot][arr][r][c * kPer],
                       ok ? base + (plane + t) * k.D + ch : base, ok);
      }
    }
  } else {
#pragma unroll
    for (int arr = 0; arr < 3; ++arr) {
      const T* base = arr == 0 ? x : arr == 1 ? log_a : gate;
      for (int j = threadIdx.x; j < kRows * kGroup; j += blockDim.x) {
        const int r = j / kGroup, c = j % kGroup;
        const int t = t0 + r, ch = g * kGroup + c;
        st.in[slot][arr][r][c] =
            t < k.S && ch < k.D ? base[(plane + t) * k.D + ch] : rt::from_f32<T>(0.f);
      }
    }
  }
}

// Several tiles of kSegs x kSteps, each staged kCount - 1 tiles ahead.
template <typename T>
__global__ void __launch_bounds__(kSegs * 32)
rglru_staged_kernel(const T* __restrict__ x, const T* __restrict__ log_a,
                    const T* __restrict__ gate, T* __restrict__ y, float* __restrict__ ckpt,
                    int S, int D, bool vec) {
  constexpr int kStages = Stages<T>::kCount;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stages<T>& st = *reinterpret_cast<Stages<T>*>(smem_raw);
  __shared__ float2 s_seg[kSegs][kGroup];
  __shared__ float s_in[kSegs][kGroup];
  const int groups = (D + kGroup - 1) / kGroup;
  const int g = blockIdx.x % groups, b = blockIdx.x / groups;
  Ctx k;
  k.S = S, k.D = D, k.seg = threadIdx.x / 32, k.lane = threadIdx.x % 32;
  k.ch = g * kGroup + k.lane;
  k.row0 = (size_t)b * S * D + k.ch;
  const int tiles = (S + kRows - 1) / kRows;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < tiles) stage_tile(k, b, g, x, log_a, gate, p, p, vec, st);
    rt::cp_async_commit();
  }
  float carry = 0.f;  // warp w: channel w's state before the tile
  for (int t = 0; t < tiles; ++t) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's stage is free
    if (t + kStages - 1 < tiles)
      stage_tile(k, b, g, x, log_a, gate, t + kStages - 1, (t + kStages - 1) % kStages, vec,
                 st);
    rt::cp_async_commit();
    const int slot = t % kStages, r0 = k.seg * kSteps;
    const int t_lo = t * kRows + r0;
    const int n = k.ch < D ? max(0, min(kSteps, S - t_lo)) : 0;
    float a[kSteps], h[kSteps], prod, state;
    scan_segment(
        n,
        [&](int u, float& l, float& gv, float& xv) {
          l = rt::to_f32(st.in[slot][1][r0 + u][k.lane]);
          gv = rt::to_f32(st.in[slot][2][r0 + u][k.lane]);
          xv = rt::to_f32(st.in[slot][0][r0 + u][k.lane]);
        },
        a, h, prod, state);
    s_seg[k.seg][k.lane] = make_float2(prod, state);
    __syncthreads();
    segment_states(k, s_seg, s_in, carry);
    // the next tile's incoming state, for the backward kernel
    if (ckpt != nullptr && t + 1 < tiles && k.lane == 0 && g * kGroup + k.seg < D)
      ckpt[((size_t)b * (tiles - 1) + t) * D + g * kGroup + k.seg] = carry;
    write_segment(k, y, t_lo, n, s_in[k.seg][k.lane], a, h);
  }
}

bool aligned(const void* p, size_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

template <typename T>
cudaError_t launch_t(const void* x, const void* la, const void* g, void* y, float* ckpt, int B,
                     int S, int D, int segs, int per, cudaStream_t st) {
  const long long blocks = (long long)((D + kGroup - 1) / kGroup) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* lt = static_cast<const T*>(la);
  const T* gt = static_cast<const T*>(g);
  T* yt = static_cast<T*>(y);
  if (segs <= kOneSegs) {
    rglru_one_tile_kernel<T><<<(unsigned)blocks, segs * 32, 0, st>>>(xt, lt, gt, yt, S, D, per);
    return cudaGetLastError();
  }
  static const cudaError_t attr =
      cudaFuncSetAttribute(rglru_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Stages<T>));
  if (attr != cudaSuccess) return attr;
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned(x, 16) && aligned(la, 16) &&
                   aligned(g, 16);
  rglru_staged_kernel<T><<<(unsigned)blocks, kSegs * 32, sizeof(Stages<T>), st>>>(
      xt, lt, gt, yt, ckpt, S, D, vec);
  return cudaGetLastError();
}

}  // namespace

// x, log_a, gate, y: (B,S,D) contiguous, one dtype.  segs x per: the cut of
// time (the wrapper's `plan`): one tile of segs <= 16 warps of per <= 8
// steps covering S, or (32, 8), tiles of 256 steps through the staged
// pipeline.  ckpt: null, or (B, tiles - 1, D) f32 that the staged
// pipeline fills with each tile's incoming state, tile 1 on (the backward
// kernel's checkpoint; y is the same either way).  Returns
// cudaGetLastError().
extern "C" int rglru_scan_launch(const void* x, const void* log_a, const void* gate,
                                 void* y, void* ckpt, int B, int S, int D, int segs, int per,
                                 int dtype, void* stream) {
  const bool one = segs >= 1 && segs <= kOneSegs && per >= 1 && per <= kSteps &&
                   (long long)segs * per >= S;
  const bool staged = segs == kSegs && per == kSteps;
  if (B <= 0 || S <= 0 || D <= 0 || !(one || staged)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* c = static_cast<float*>(ckpt);
  if (dtype == rt::kFloat32) return launch_t<float>(x, log_a, gate, y, c, B, S, D, segs, per, st);
  if (dtype == rt::kBFloat16)
    return launch_t<__nv_bfloat16>(x, log_a, gate, y, c, B, S, D, segs, per, st);
  return cudaErrorInvalidValue;
}
