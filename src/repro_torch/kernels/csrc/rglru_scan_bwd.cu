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
// Bound on the card: bytes (four inputs read, three outputs written; a
// prompt's inputs are read twice, once by each pass).  The forward's cut of
// time (rglru_scan.py's plan: one tile of up to 16 segments for S <= 128,
// else tiles of 32 segments of 8 steps), one segment a warp and 32
// channels a block, one a lane, run backward:
//   * pass 1 (several tiles only) walks the tiles forward as the forward
//     kernel does and leaves each tile's incoming state, its checkpoint, in
//     a (B, tiles - 1, D) f32 workspace;
//   * pass 2 walks the tiles last to first.  A tile's four inputs are
//     staged in shared memory; each warp scans its segment forward from
//     zero (local states and decay prefixes in registers) and folds the
//     earlier segments' (decay product, end state) pairs onto the tile's
//     checkpoint for its incoming state; then it scans its segment in
//     reverse from zero for the local dh and the products of the a's after
//     each step, and folds the later segments' (decay product, a dh at the
//     segment's start) pairs onto the carry from the later tile.  The fold
//     is serial in each lane (at most 31 pairs, two FMAs each).
// A simple design that is right; the forward's cp.async pipeline is not
// carried over (each tile is staged, then scanned).
#include "common.cuh"

namespace {

constexpr int kGroup = 32;  // channels a block, one a lane
constexpr int kMaxSegs = 32;
constexpr int kSteps = 8;   // most steps a segment
constexpr int kMaxRows = kMaxSegs * kSteps;

struct Ptrs {
  const void *x, *la, *g, *dy;
  void *dx, *dla, *dg;
  float* work;
};

template <typename T>
__global__ void __launch_bounds__(kMaxSegs * 32)
rglru_bwd_kernel(Ptrs p, int S, int D, int segs, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // [4][rows][kGroup]: x, log_a, gate, dy
  __shared__ float2 fwd[kMaxSegs][kGroup], rev[kMaxSegs][kGroup];
  __shared__ float carry_h[kGroup], carry_g[kGroup];
  const T* x = static_cast<const T*>(p.x);
  const T* la = static_cast<const T*>(p.la);
  const T* gt = static_cast<const T*>(p.g);
  const T* dy = static_cast<const T*>(p.dy);
  const int rows = segs * per, tiles = (S + rows - 1) / rows;
  const int groups = (D + kGroup - 1) / kGroup;
  const int grp = blockIdx.x % groups, b = blockIdx.x / groups;
  const int seg = threadIdx.x / 32, lane = threadIdx.x % 32, ch = grp * kGroup + lane;
  const size_t plane = (size_t)b * S;
  auto at = [&](int arr, int r) -> T& { return st[((size_t)arr * rows + r) * kGroup + lane]; };

  // stage `narr` of the four inputs of tile t (zeros past S or D)
  auto stage = [&](int t, int narr) {
    __syncthreads();  // the previous tile's stage is consumed
    const int t0 = t * rows;
    for (int arr = 0; arr < narr; ++arr) {
      const T* src = arr == 0 ? x : arr == 1 ? la : arr == 2 ? gt : dy;
      for (int j = threadIdx.x; j < rows * kGroup; j += blockDim.x) {
        const int r = j / kGroup, c = j % kGroup, tt = t0 + r, cc = grp * kGroup + c;
        st[((size_t)arr * rows + r) * kGroup + c] =
            tt < S && cc < D ? src[(plane + tt) * D + cc] : rt::from_f32<T>(0.f);
      }
    }
    __syncthreads();
  };
  auto steps_of = [&](int t) {
    return ch < D ? max(0, min(per, S - (t * rows + seg * per))) : 0;
  };
  // the forward scan of this segment of tile t from zero; the pair to fwd,
  // then the segment's incoming state from the tile's carry_h
  float a[kSteps], hl[kSteps], pre[kSteps];
  auto forward = [&](int t) {
    const int n = steps_of(t), r0 = seg * per;
    float prod = 1.f, state = 0.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < n) {
        const float l = rt::to_f32(at(1, r0 + u));
        const float at_ = expf(l);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * l), 0.f));
        state = at_ * state + beta * rt::to_f32(at(2, r0 + u)) * rt::to_f32(at(0, r0 + u));
        prod *= at_;
        a[u] = at_, hl[u] = state, pre[u] = prod;
      }
    }
    fwd[seg][lane] = make_float2(prod, state);
    __syncthreads();
    float hin = carry_h[lane];
    for (int s = 0; s < seg; ++s) hin = fwd[s][lane].x * hin + fwd[s][lane].y;
    return hin;
  };
  // after forward(): the tile's outgoing state into carry_h
  auto advance = [&](float hin) {
    __syncthreads();  // every lane has read carry_h
    if (seg == segs - 1) carry_h[lane] = fwd[seg][lane].x * hin + fwd[seg][lane].y;
    __syncthreads();
  };

  // pass 1: each tile's incoming state, tile 1 on, to the workspace
  float* ckpt = p.work + (size_t)b * (tiles - 1) * D;
  if (seg == 0) carry_h[lane] = 0.f;
  for (int t = 0; t + 1 < tiles; ++t) {
    stage(t, 3);
    advance(forward(t));
    if (seg == 0 && ch < D) ckpt[(size_t)t * D + ch] = carry_h[lane];
  }

  // pass 2: the tiles last to first
  if (seg == 0) carry_g[lane] = 0.f;
  T* dxo = static_cast<T*>(p.dx);
  T* dlao = static_cast<T*>(p.dla);
  T* dgo = static_cast<T*>(p.dg);
  for (int t = tiles - 1; t >= 0; --t) {
    stage(t, 4);
    if (seg == 0) carry_h[lane] = t == 0 || ch >= D ? 0.f : ckpt[(size_t)(t - 1) * D + ch];
    __syncthreads();
    const float hin = forward(t);
    const int n = steps_of(t), r0 = seg * per;
    // the reverse scan from zero: dl[u] = dy_u + a_{u+1} dl[u+1]; q[u] = the
    // product of the a's after step u in the segment
    float dl[kSteps], q[kSteps];
    float run = 0.f, qq = 1.f;
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      if (u < n) {
        if (u + 1 < n) {
          run *= a[u + 1];
          qq *= a[u + 1];
        }
        run += rt::to_f32(at(3, r0 + u));
        dl[u] = run, q[u] = qq;
      }
    }
    // (the product of every a of the segment, a dh at its first step)
    rev[seg][lane] = n > 0 ? make_float2(a[0] * q[0], a[0] * dl[0]) : make_float2(1.f, 0.f);
    __syncthreads();
    float gin = carry_g[lane];  // a dh at the first step after the segment
    for (int s = segs - 1; s > seg; --s) gin = rev[s][lane].y + rev[s][lane].x * gin;
    const size_t t_lo = (size_t)t * rows + r0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < n) {
        const float hprev = u == 0 ? hin : hl[u - 1] + pre[u - 1] * hin;
        const float dh = dl[u] + q[u] * gin;
        const float l = rt::to_f32(at(1, r0 + u)), gv = rt::to_f32(at(2, r0 + u));
        const float xv = rt::to_f32(at(0, r0 + u));
        const float e2 = expf(2.f * l), uu = 1.f - e2;
        const float beta = sqrtf(fmaxf(uu, 0.f));
        const float coef = uu > 0.f ? 1.f : (uu == 0.f ? 0.5f : 0.f);
        const float dhx = dh * xv;
        const float dla = dh * hprev * a[u] - (dhx * gv * (0.5f / beta)) * coef * e2 * 2.f;
        const size_t off = (plane + t_lo + u) * D + ch;
        dxo[off] = rt::from_f32<T>(dh * (beta * gv));
        dlao[off] = rt::from_f32<T>(dla);
        dgo[off] = rt::from_f32<T>(dhx * beta);
      }
    }
    __syncthreads();  // every lane has read carry_g
    if (seg == 0) carry_g[lane] = rev[0][lane].y + rev[0][lane].x * gin;
  }
}

template <typename T>
cudaError_t launch_t(const Ptrs& p, int B, int S, int D, int segs, int per, cudaStream_t st) {
  const long long blocks = (long long)((D + kGroup - 1) / kGroup) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * segs * per * kGroup * sizeof(T);
  static const cudaError_t attr =
      cudaFuncSetAttribute(rglru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(4 * kMaxRows * kGroup * sizeof(T)));
  if (attr != cudaSuccess) return attr;
  rglru_bwd_kernel<T><<<(unsigned)blocks, segs * 32, smem, st>>>(p, S, D, segs, per);
  return cudaGetLastError();
}

static_assert(4 * kMaxRows * kGroup * sizeof(float) + 2 * 2 * kMaxSegs * kGroup * sizeof(float) +
                      2 * kGroup * sizeof(float) <=
                  232448,
              "the staged f32 tile within the SM's shared memory");

}  // namespace

// x, log_a, gate, dy and the outputs dx, dlog_a, dgate: (B,S,D) contiguous,
// one dtype.  segs x per: the forward's cut of time (rglru_scan.py's plan):
// one tile of segs <= 16 warps of per <= 8 steps covering S, or (32, 8),
// tiles of 256 steps.  work: B * (tiles - 1) * D floats (at least one).
// One launch.  Returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const void* x, const void* log_a, const void* gate,
                                     const void* dy, void* dx, void* dlog_a, void* dgate,
                                     void* work, int B, int S, int D, int segs, int per,
                                     int dtype, void* stream) {
  const bool one = segs >= 1 && segs <= 16 && per >= 1 && per <= kSteps &&
                   (long long)segs * per >= S;
  const bool staged = segs == kMaxSegs && per == kSteps;
  if (B <= 0 || S <= 0 || D <= 0 || !(one || staged) || work == nullptr)
    return cudaErrorInvalidValue;
  const Ptrs p{x, log_a, gate, dy, dx, dlog_a, dgate, static_cast<float*>(work)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32) return launch_t<float>(p, B, S, D, segs, per, st);
  if (dtype == rt::kBFloat16) return launch_t<__nv_bfloat16>(p, B, S, D, segs, per, st);
  return cudaErrorInvalidValue;
}
