// Backward of the RG-LRU linear recurrence (Griffin) from a zero state:
// the gradients with respect to x, log_a and gate of rglru_scan.cu's
// function.
//
// The TPU kernel repro/kernels/rglru_scan.py (rglru -> _rglru_kernel) has
// no backward: the JAX package differentiates its jnp path.  The port's
// forward is the kernel of rglru_scan.cu, so its gradient is a kernel too.
// Per channel, with a_t = exp(log_a_t), beta_t = sqrt(max(1 - exp(2
// log_a_t), 0)), b_t = beta_t gate_t x_t and h_t = a_t h_{t-1} + b_t:
//   dh_t   = dy_t + a_{t+1} dh_{t+1}          (reverse time, dh_S = 0)
//   dx_t   = dh_t beta_t gate_t,   dgate_t = dh_t x_t beta_t,
//   dlog_a_t = dh_t h_{t-1} a_t + d beta_t * dbeta/dlog_a, d beta_t = dh_t
//              x_t gate_t,
// where dbeta/dlog_a is taken as jax.grad takes it: sqrt's 0.5 / beta,
// max's 1 above 0, 0.5 at 0 and 0 below, then -2 exp(2 log_a).  So where
// 1 - a^2 = 0 (log_a = 0, or so near it that exp(2 log_a) rounds to 1)
// dlog_a is -inf (+inf) where dh x gate is positive (negative) and NaN where
// it is 0, as jax.grad of ref.rglru_chunked gives.  All in float32 from the
// inputs, each gradient rounded once to x's type.  h_{t-1} is the f32
// state: the forward's output is rounded, so the states are recomputed.
//
// Bound on the card: bytes (four inputs read, three outputs written, and
// the forward's checkpoint of (B, tiles - 1, D) f32 states read).  The
// forward's cut of time (rglru_scan.py's plan: one tile of up to 16
// segments of up to 8 steps for S <= 128, else tiles of 32 segments of 8
// steps), one segment a warp and 32 channels a block, one a lane, walked
// last tile to first in one launch:
//   * a tile's four inputs come through a ring of shared-memory stages,
//     filled by 16-byte cp.async copies two tiles (f32: none) ahead of the
//     tile being scanned, so each input is read once and the next tiles'
//     loads are in flight during each scan;
//   * the tile's incoming state is the forward's checkpoint (rglru_scan.cu
//     writes it when asked; RGLRUFn keeps it), so no pass recomputes the
//     states of the tiles before;
//   * each warp scans its segment forward from zero (a and b kept in
//     registers); warp w scans channel w's 32 (decay product, end state)
//     pairs across its lanes with shuffles (rglru_scan.cu's
//     segment_states) for each segment's incoming state, then runs its
//     segment again from that state, keeping h_{t-1} in b's registers;
//   * each warp folds its segment in reverse from zero to the pair (the
//     product of its a's, a_0 dh_0 from zero); warp w scans channel w's
//     pairs in reversed lane order for each segment's carry of a dh from
//     the later segments, and keeps the carry from the later tiles in
//     registers; then each warp walks its segment in reverse from that
//     carry, computing dh and the three gradients step by step.
// Registers hold two 8-float arrays a thread (a, and b then h_{t-1}), so
// the block of 1024 threads fits its 64 registers a thread.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kGroup = 32;  // channels a block, one a lane
constexpr int kMaxSegs = 32;
constexpr int kSteps = 8;   // most steps a segment
constexpr int kMaxRows = kMaxSegs * kSteps;

// Shared-memory stages: three in bf16, one in f32 (the identity checks).
template <typename T>
struct BwdStages {
  static constexpr int kCount = sizeof(T) == 2 ? 3 : 1;
};

struct Ptrs {
  const void *x, *la, *g, *dy;
  const float* ckpt;  // (B, tiles - 1, D): each tile's incoming state
  void *dx, *dla, *dg;
};

// The maps h -> v.x h + v.y of a warp's lanes, lane 0's applied first:
// `before` gets the lanes before this one applied to `carry`; returns all
// 32 applied to `carry` (rglru_scan.cu's segment_states, five shuffle steps).
__device__ __forceinline__ float scan_maps(float2 v, float carry, float& before) {
  const int s = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float pa = __shfl_up_sync(0xffffffffu, v.x, o);
    const float ph = __shfl_up_sync(0xffffffffu, v.y, o);
    if (s >= o) v = make_float2(pa * v.x, v.x * ph + v.y);
  }
  const float pa = __shfl_up_sync(0xffffffffu, v.x, 1);
  const float ph = __shfl_up_sync(0xffffffffu, v.y, 1);
  before = s == 0 ? carry : pa * carry + ph;
  return __shfl_sync(0xffffffffu, v.x, 31) * carry + __shfl_sync(0xffffffffu, v.y, 31);
}

template <typename T>
__global__ void __launch_bounds__(kMaxSegs * 32)
rglru_bwd_kernel(Ptrs p, int S, int D, int segs, int per, bool vec) {
  constexpr int kStages = BwdStages<T>::kCount;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // [stage][4][rows][kGroup]: x, log_a, gate, dy
  __shared__ float2 s_pair[kMaxSegs][kGroup + 1];
  __shared__ float s_in[kMaxSegs][kGroup + 1];
  const T* x = static_cast<const T*>(p.x);
  const T* la = static_cast<const T*>(p.la);
  const T* gt = static_cast<const T*>(p.g);
  const T* dy = static_cast<const T*>(p.dy);
  T* dxo = static_cast<T*>(p.dx);
  T* dlao = static_cast<T*>(p.dla);
  T* dgo = static_cast<T*>(p.dg);
  const int rows = segs * per, tiles = (S + rows - 1) / rows;
  const int groups = (D + kGroup - 1) / kGroup;
  const int grp = blockIdx.x % groups, b = blockIdx.x / groups;
  const int seg = threadIdx.x / 32, lane = threadIdx.x % 32, ch = grp * kGroup + lane;
  const size_t plane = (size_t)b * S;

  // stage tile t into slot: 16-byte cp.async chunks where the rows allow
  // (vec), zero-filled past S or D; else element by element
  auto stage = [&](int t, int slot) {
    const int t0 = t * rows;
    T* dst = st + (size_t)slot * 4 * rows * kGroup;
    if (vec) {
      constexpr int kPer = 16 / sizeof(T);    // elements a chunk
      constexpr int kChunks = kGroup / kPer;  // chunks a row
#pragma unroll
      for (int arr = 0; arr < 4; ++arr) {
        const T* src = arr == 0 ? x : arr == 1 ? la : arr == 2 ? gt : dy;
        for (int j = threadIdx.x; j < rows * kChunks; j += blockDim.x) {
          const int r = j / kChunks, c = j % kChunks, tt = t0 + r, cc = grp * kGroup + c * kPer;
          const bool ok = tt < S && cc < D;
          rt::cp_async16(dst + ((size_t)arr * rows + r) * kGroup + c * kPer,
                         ok ? src + (plane + tt) * D + cc : src, ok);
        }
      }
    } else {
      for (int arr = 0; arr < 4; ++arr) {
        const T* src = arr == 0 ? x : arr == 1 ? la : arr == 2 ? gt : dy;
        for (int j = threadIdx.x; j < rows * kGroup; j += blockDim.x) {
          const int r = j / kGroup, c = j % kGroup, tt = t0 + r, cc = grp * kGroup + c;
          dst[((size_t)arr * rows + r) * kGroup + c] =
              tt < S && cc < D ? src[(plane + tt) * D + cc] : rt::from_f32<T>(0.f);
        }
      }
    }
  };

  // the carry of a dh from the later tiles: warp w's, channel w (staged
  // path only: one tile has no later tile)
  float carry_g = 0.f;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < tiles) stage(tiles - 1 - q, q);
    rt::cp_async_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    const int t = tiles - 1 - i;
    if constexpr (kStages == 1) {
      __syncthreads();  // the previous tile's stage is consumed
      stage(t, 0);
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
      __syncthreads();
    } else {
      rt::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile t has landed; the previous tile's stage is free
      if (i + kStages - 1 < tiles) stage(tiles - 1 - (i + kStages - 1), (i + kStages - 1) % kStages);
      rt::cp_async_commit();
    }
    const T* tile = st + (size_t)(i % kStages) * 4 * rows * kGroup;
    const int r0 = seg * per;
    auto at = [&](int arr, int u) {
      return rt::to_f32(tile[((size_t)arr * rows + r0 + u) * kGroup + lane]);
    };
    const int n = ch < D ? max(0, min(per, S - (t * rows + r0))) : 0;

    // forward: the segment from zero; a[u] and bh[u] = b_u kept
    float a[kSteps], bh[kSteps];
    float prod = 1.f, state = 0.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < n) {
        const float l = at(1, u);
        const float at_ = expf(l);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * l), 0.f));
        const float bu = beta * at(2, u) * at(0, u);
        state = at_ * state + bu;
        prod *= at_;
        a[u] = at_, bh[u] = bu;
      }
    }
    s_pair[seg][lane] = make_float2(prod, state);
    __syncthreads();
    // warp c: channel c's segments, earlier first, from the checkpoint
    for (int c = seg; c < kGroup; c += segs) {
      const int cc = grp * kGroup + c;
      const float carry = t > 0 && cc < D ? p.ckpt[((size_t)b * (tiles - 1) + t - 1) * D + cc] : 0.f;
      float before;
      scan_maps(lane < segs ? s_pair[lane][c] : make_float2(1.f, 0.f), carry, before);
      if (lane < segs) s_in[lane][c] = before;
    }
    __syncthreads();
    // the segment again from its incoming state: bh[u] becomes h_{u-1}
    {
      float h = s_in[seg][lane];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (u < n) {
          const float bu = bh[u];
          bh[u] = h;
          h = a[u] * h + bu;
        }
      }
    }
    // reverse: the segment from zero, to (product of its a's, a_0 dh_0)
    {
      float run = 0.f, pr = 1.f;
#pragma unroll
      for (int u = kSteps - 1; u >= 0; --u) {
        if (u < n) {
          run = (u + 1 < n ? a[u + 1] * run : 0.f) + at(3, u);
          pr *= a[u];
        }
      }
      s_pair[seg][lane] = n > 0 ? make_float2(pr, a[0] * run) : make_float2(1.f, 0.f);
    }
    __syncthreads();
    // warp c: channel c's segments, later first (lane s takes segment
    // segs - 1 - s), from the carry of the later tiles
    for (int c = seg; c < kGroup; c += segs) {
      const float carry = segs == kMaxSegs ? carry_g : 0.f;
      const int k = segs - 1 - lane;
      float before;
      carry_g = scan_maps(lane < segs ? s_pair[k][c] : make_float2(1.f, 0.f), carry, before);
      if (lane < segs) s_in[k][c] = before;
    }
    __syncthreads();
    // the segment in reverse from its carry: dh and the gradients
    float dh = 0.f;
    const float gin = s_in[seg][lane];
    const size_t t_lo = (size_t)t * rows + r0;
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      if (u < n) {
        dh = at(3, u) + (u + 1 < n ? a[u + 1] * dh : gin);
        const float l = at(1, u), gv = at(2, u), xv = at(0, u);
        const float e2 = expf(2.f * l), uu = 1.f - e2;
        const float beta = sqrtf(fmaxf(uu, 0.f));
        const float coef = uu > 0.f ? 1.f : (uu == 0.f ? 0.5f : 0.f);
        const float dhx = dh * xv;
        const float dla = dh * bh[u] * a[u] - (dhx * gv * (0.5f / beta)) * coef * e2 * 2.f;
        const size_t off = (plane + t_lo + u) * D + ch;
        dxo[off] = rt::from_f32<T>(dh * (beta * gv));
        dlao[off] = rt::from_f32<T>(dla);
        dgo[off] = rt::from_f32<T>(dhx * beta);
      }
    }
  }
}

bool aligned(const void* q, size_t n) { return (reinterpret_cast<uintptr_t>(q) % n) == 0; }

template <typename T>
cudaError_t launch_t(const Ptrs& p, int B, int S, int D, int segs, int per, cudaStream_t st) {
  const long long blocks = (long long)((D + kGroup - 1) / kGroup) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int kStages = BwdStages<T>::kCount;
  const size_t smem = (size_t)kStages * 4 * segs * per * kGroup * sizeof(T);
  static const cudaError_t attr =
      cudaFuncSetAttribute(rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(kStages * 4 * kMaxRows * kGroup * sizeof(T)));
  if (attr != cudaSuccess) return attr;
  const bool vec = D % (16 / sizeof(T)) == 0 && aligned(p.x, 16) && aligned(p.la, 16) &&
                   aligned(p.g, 16) && aligned(p.dy, 16);
  rglru_bwd_kernel<T><<<(unsigned)blocks, segs * 32, smem, st>>>(p, S, D, segs, per, vec);
  return cudaGetLastError();
}

template <typename T>
constexpr size_t smem_bytes() {
  return BwdStages<T>::kCount * 4 * kMaxRows * kGroup * sizeof(T) +
         kMaxSegs * (kGroup + 1) * (sizeof(float2) + sizeof(float));
}
static_assert(smem_bytes<__nv_bfloat16>() <= 232448, "the bf16 ring within the SM's shared memory");
static_assert(smem_bytes<float>() <= 232448, "the f32 stage within the SM's shared memory");

}  // namespace

// x, log_a, gate, dy and the outputs dx, dlog_a, dgate: (B,S,D) contiguous,
// one dtype.  segs x per: the forward's cut of time (rglru_scan.py's plan):
// one tile of segs <= 16 warps of per <= 8 steps covering S, or (32, 8),
// tiles of 256 steps.  ckpt: (B, tiles - 1, D) f32, each tile's incoming
// state as rglru_scan_launch writes it (null only with one tile).  One
// launch.  Returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const void* x, const void* log_a, const void* gate,
                                     const void* dy, void* dx, void* dlog_a, void* dgate,
                                     const void* ckpt, int B, int S, int D, int segs, int per,
                                     int dtype, void* stream) {
  const bool one = segs >= 1 && segs <= 16 && per >= 1 && per <= kSteps &&
                   (long long)segs * per >= S;
  const bool staged = segs == kMaxSegs && per == kSteps;
  if (B <= 0 || S <= 0 || D <= 0 || !(one || staged) ||
      (S > segs * per && ckpt == nullptr))
    return cudaErrorInvalidValue;
  const Ptrs p{x, log_a, gate, dy, static_cast<const float*>(ckpt), dx, dlog_a, dgate};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch_t<float>(p, B, S, D, segs, per, st);
  if (dtype == rt::kBFloat16) return launch_t<__nv_bfloat16>(p, B, S, D, segs, per, st);
  return cudaErrorInvalidValue;
}
