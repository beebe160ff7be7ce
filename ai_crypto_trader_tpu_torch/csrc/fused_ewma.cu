// fused_ewma.cu — the EMA family as one deterministic single-pass launch.
//
// Replaces the TPU kernel ai_crypto_trader_tpu/ops/pallas_kernels.py
// fused_ewma_pallas (pl.pallas_call at :88, kernel _ewma_kernel :47-74,
// wrapper fused_ewma :102): K first-order recursions
//     y_k[t] = a_k[t] * y_k[t-1] + b_k[t]
// over [B, T] series in one pass.  The port also wires it where the JAX
// package runs _ewm's associative scans (ops/indicators.py:110-122), so the
// element maps are built inline exactly as _ewm builds them for a seed index
// `start`: x -> nan_to_num(x); t < start: (0, 0); t == start: (0, x[t]);
// t > start: (1 - alpha_k, alpha_k * x[t]).  Positions before `start` are
// written as NaN.  One launch takes up to kMaxJobs independent jobs, each
// its own (x, K alphas, start, out), so the indicator table's EMA family is
// two launches.
//
// What bounds it on this card: bytes.  A job must read x once (4·B·T bytes)
// and write K outputs (4·K·B·T bytes); the arithmetic is about five float32
// operations per element and output, far below the card's rate.  On the
// main path a launch moves 4 to 19 MB, a few microseconds at 3.35 TB/s, so
// fixed costs — launches, a second read of x, a pass that leaves the card
// idle — decide its time.
//
// What the design does about it: one cooperative launch of a persistent
// grid, as many blocks as the card holds co-resident (occupancy × SMs, and
// no more than there are tiles).  Each row of each job is cut into tiles of
// kTile candles; the tiles of all jobs are numbered in order and every
// block owns a contiguous run of them.
//   1. A block stages each of its tiles of x in shared memory once (16-byte
//      loads where the row is aligned), composes each thread's kItems maps
//      in sequence, scans the threads' maps across the block, and publishes
//      the tile's K aggregates (A, B) to a small global buffer.
//   2. One grid-wide barrier (cooperative_groups::this_grid().sync()).
//   3. For each of its tiles, warp k composes the aggregates of the tiles
//      before it in its row, in tile order, as a fixed tree (each lane a run
//      of them in sequence, then a warp scan), and applies the result to
//      y = 0.  The block then applies that carried-in y to the tile still staged in
//      shared memory and writes the K outputs through a shared-memory tile
//      with 16-byte stores.
// x is read from device memory once and each output written once.  When
// the co-resident blocks cannot keep every tile they own (B·T beyond what
// shared memory holds), one slot is transient and a block reads x again
// for the tiles that pass through it.
//
// Determinism.  The composition order depends only on kTile, kItems and
// the data — not on the grid size, not on timing: the aggregate of a tile
// is a fixed tree, and so is the carry into it, whichever block computes
// it.  A decoupled look-back scan would be single-pass too,
// but which predecessor's prefix a block finds depends on timing, so its
// rounding would change from run to run; MACD is the difference of two
// EMAs that nearly cancel, and a sweep would then flip different signals on
// different runs.  The compose (a1, b1) then (a2, b2) -> (a1·a2,
// a2·b1 + b2) is the combine of ops/indicators.first_order_recursion,
// built with --fmad=false: the product and the sum are rounded separately,
// as in the plain PyTorch version.  Tensor cores do not serve here: the
// chunked recurrence written as a product with a matrix of decay powers
// would run in TF32 or bf16 and lose the float32 digits MACD depends on,
// and the work is bound by bytes anyway.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // per SM: caps registers at 64 a thread
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kPadTile = kTile + kTile / 32;  // one float of padding per 32
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kMaxJobs = 4;
constexpr int kMaxSlots = 12;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Job {
  const float* x;   // [B, T]
  float* out;       // [K, B, T]
  long long T;
  long long tile0;  // number of the job's first tile
  int B, K, start, C;  // C = tiles in a row
  float alpha[kMaxK];
  float decay[kMaxK];  // 1 - alpha, rounded once from double on the host
};

struct Plan {
  Job job[kMaxJobs];
  float* agg;  // [n_tiles, kMaxK, 2]
  long long n_tiles;
  int n_jobs;
  int kmax;      // the largest K of the jobs
  int slots;     // tiles of x a block keeps in shared memory
  int resident;  // 1: every block keeps every tile it owns
};

struct Affine {  // y -> a * y + b
  float a, b;
};

__device__ __forceinline__ Affine identity() { return Affine{1.f, 0.f}; }

// `first` applied, then `then`.
__device__ __forceinline__ Affine compose(Affine first, Affine then) {
  return Affine{first.a * then.a, then.a * first.b + then.b};
}

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// The map of tile element i; rel = start - (the tile's first candle),
// clamped to [-1, kTile].
__device__ __forceinline__ Affine element(float x, int i, int rel, float alpha,
                                          float decay) {
  if (i < rel) return Affine{0.f, 0.f};
  if (i == rel) return Affine{0.f, x};
  return Affine{decay, alpha * x};
}

// Position of tile element i in a padded shared-memory tile: a thread's
// kItems consecutive elements, and a warp's 16-byte columns, then fall in
// distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ Affine warp_inclusive_scan(Affine v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Affine up{__shfl_up_sync(kFull, v.a, off), __shfl_up_sync(kFull, v.b, off)};
    if (lane >= off) v = compose(up, v);
  }
  return v;
}

// Exclusive scan of one map per thread over the block: returns the
// composition of every earlier thread's map, and the whole block's in *total.
__device__ Affine block_exclusive_scan(Affine v, Affine* total) {
  __shared__ float wa[kWarps], wb[kWarps];
  __shared__ float ta, tb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Affine inc = warp_inclusive_scan(v, lane);
  Affine exc{__shfl_up_sync(kFull, inc.a, 1), __shfl_up_sync(kFull, inc.b, 1)};
  if (lane == 0) exc = identity();
  if (lane == 31) {
    wa[warp] = inc.a;
    wb[warp] = inc.b;
  }
  __syncthreads();
  if (warp == 0) {
    const Affine w = lane < kWarps ? Affine{wa[lane], wb[lane]} : identity();
    const Affine winc = warp_inclusive_scan(w, lane);
    Affine wexc{__shfl_up_sync(kFull, winc.a, 1),
                __shfl_up_sync(kFull, winc.b, 1)};
    if (lane == 0) wexc = identity();
    if (lane < kWarps) {
      wa[lane] = wexc.a;
      wb[lane] = wexc.b;
    }
    if (lane == kWarps - 1) {
      ta = winc.a;
      tb = winc.b;
    }
  }
  __syncthreads();
  const Affine res = compose(Affine{wa[warp], wb[warp]}, exc);
  *total = Affine{ta, tb};
  __syncthreads();  // the shared slots are reused by the next call
  return res;
}

struct Tile {
  int j, b, c;          // job, row, tile within the row
  int n;                // candles in the tile
  int rel;              // the job's start less t0, clamped to [-1, kTile]
  long long t0;         // first candle
  long long row_tile0;  // number of the row's first tile
};

__device__ Tile locate(const Job* jobs, int n_jobs, long long i) {
  int j = 0;
  while (j + 1 < n_jobs && i >= jobs[j + 1].tile0) ++j;
  const Job& jb = jobs[j];
  const long long r = i - jb.tile0;
  Tile t;
  t.j = j;
  t.b = static_cast<int>(r / jb.C);
  t.c = static_cast<int>(r % jb.C);
  t.t0 = static_cast<long long>(t.c) * kTile;
  const long long left = jb.T - t.t0;
  t.n = left < kTile ? static_cast<int>(left) : kTile;
  const long long rel = jb.start - t.t0;
  t.rel = rel < -1 ? -1 : (rel > kTile ? kTile : static_cast<int>(rel));
  t.row_tile0 = jb.tile0 + static_cast<long long>(t.b) * jb.C;
  return t;
}

// x[t0, t0 + n) -> padded shared tile, nan_to_num applied.
__device__ void load_tile(const float* __restrict__ src, int n, float* dst) {
  if (n == kTile && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int r = 0; r < kTile / 4 / kThreads; ++r) {
      const int q = threadIdx.x + r * kThreads;
      const float4 v = __ldg(s4 + q);
      float* d = dst + padded(4 * q);
      d[0] = nan_to_num(v.x);
      d[1] = nan_to_num(v.y);
      d[2] = nan_to_num(v.z);
      d[3] = nan_to_num(v.w);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      dst[padded(e)] = nan_to_num(__ldg(src + e));
  }
}

// padded shared tile -> out[t0, t0 + n).
__device__ void store_tile(const float* src, int n, float* __restrict__ dst) {
  if (n == kTile && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int r = 0; r < kTile / 4 / kThreads; ++r) {
      const int q = threadIdx.x + r * kThreads;
      const float* s = src + padded(4 * q);
      d4[q] = make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src[padded(e)];
  }
}

// A thread's kItems candles of a padded tile start at i0 + (i0 >> 5).
static_assert(32 % kItems == 0, "a thread's candles must not cross a padding float");
__device__ __forceinline__ int thread_base(int i0) { return i0 + (i0 >> 5); }

// The composition of this thread's kItems maps of the staged tile, its
// candles at `mine`.  In a full tile past the seed index every map is
// (decay, alpha·x), and the loop does the same operations without the tests.
__device__ __forceinline__ Affine thread_maps(const float* mine, const Tile& t, int i0,
                                              float alpha, float decay) {
  Affine acc = identity();
  if (t.n == kTile && t.rel < 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) acc = compose(acc, Affine{decay, alpha * mine[i]});
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (i0 + i < t.n) acc = compose(acc, element(mine[i], i0 + i, t.rel, alpha, decay));
  }
  return acc;
}

// Shared memory: `slots` slots, each a padded x tile followed by the
// threads' exclusive prefixes for kmax maps (float2 [kmax][kThreads]), then
// one padded output tile.  Padding one float in 32 puts a thread's kItems
// consecutive candles, and a warp's 16-byte columns, in distinct banks.
__host__ __device__ __forceinline__ int slot_floats(int kmax) {
  return kPadTile + 2 * kmax * kThreads;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) ewma_tiles(const Plan p) {
  extern __shared__ float smem[];
  __shared__ Job jobs[kMaxJobs];
  __shared__ float carry[kMaxK];
  if (threadIdx.x < p.n_jobs) jobs[threadIdx.x] = p.job[threadIdx.x];
  __syncthreads();

  const long long begin = static_cast<long long>(blockIdx.x) * p.n_tiles / gridDim.x;
  const long long end = static_cast<long long>(blockIdx.x + 1) * p.n_tiles / gridDim.x;
  const int stride = slot_floats(p.kmax);
  float* outs = smem + p.slots * stride;
  const int transient = p.slots - 1;
  const int i0 = threadIdx.x * kItems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. stage, compose, publish
  for (long long i = begin; i < end; ++i) {
    const Tile t = locate(jobs, p.n_jobs, i);
    const Job& jb = jobs[t.j];
    const bool kept = p.resident || i - begin < transient;
    float* xs = smem + (kept ? static_cast<int>(i - begin) : transient) * stride;
    float2* pre_s = reinterpret_cast<float2*>(xs + kPadTile);
    load_tile(jb.x + static_cast<long long>(t.b) * jb.T + t.t0, t.n, xs);
    __syncthreads();
    for (int k = 0; k < jb.K; ++k) {
      Affine total;
      const Affine pre = block_exclusive_scan(
          thread_maps(xs + thread_base(i0), t, i0, jb.alpha[k], jb.decay[k]), &total);
      if (kept) pre_s[k * kThreads + threadIdx.x] = make_float2(pre.a, pre.b);
      if (threadIdx.x == 0) {
        p.agg[(i * kMaxK + k) * 2] = total.a;
        p.agg[(i * kMaxK + k) * 2 + 1] = total.b;
      }
    }
    __syncthreads();
  }

  // 2. every tile's aggregates are published
  cg::this_grid().sync();

  // 3. carry in, apply, write
  for (long long i = begin; i < end; ++i) {
    const Tile t = locate(jobs, p.n_jobs, i);
    const Job& jb = jobs[t.j];
    const bool kept = p.resident || i - begin < transient;
    float* xs = smem + (kept ? static_cast<int>(i - begin) : transient) * stride;
    const float* mine = xs + thread_base(i0);
    const float2* pre_s = reinterpret_cast<const float2*>(xs + kPadTile);
    if (!kept) load_tile(jb.x + static_cast<long long>(t.b) * jb.T + t.t0, t.n, xs);
    // Warp k: y entering the tile, from y = 0 through the aggregates of the
    // row's earlier tiles composed in tile order as a fixed tree — each lane
    // composes a run of ceil(c / 32) of them in sequence, then the warp scans
    // the lanes' maps.  The tree depends on c alone, not on the grid.
    if (warp < jb.K) {
      const int per = (t.c + 31) / 32;
      const float* ag = p.agg + (t.row_tile0 * kMaxK + warp) * 2;
      Affine acc = identity();
#pragma unroll 4
      for (int q = 0; q < per; ++q) {
        const int c = lane * per + q;
        if (c < t.c)
          acc = compose(acc, Affine{__ldcg(ag + c * kMaxK * 2), __ldcg(ag + c * kMaxK * 2 + 1)});
      }
      const Affine inc = warp_inclusive_scan(acc, lane);
      if (lane == 31) carry[warp] = inc.b;
    }
    __syncthreads();
    const bool full = t.n == kTile && t.rel < 0;
    float* out_mine = outs + thread_base(i0);
    for (int k = 0; k < jb.K; ++k) {
      const float alpha = jb.alpha[k], decay = jb.decay[k];
      Affine pre;
      if (kept) {
        const float2 v = pre_s[k * kThreads + threadIdx.x];
        pre = Affine{v.x, v.y};
      } else {  // a transient tile's prefixes were overwritten: compose again
        Affine total;
        pre = block_exclusive_scan(thread_maps(mine, t, i0, alpha, decay), &total);
      }
      float y = pre.a * carry[k] + pre.b;
      if (full) {  // every map (decay, alpha·x): the same operations, no tests
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          y = decay * y + alpha * mine[it];
          out_mine[it] = y;
        }
      } else {
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          if (i0 + it < t.n) {
            const Affine e = element(mine[it], i0 + it, t.rel, alpha, decay);
            y = e.a * y + e.b;
            out_mine[it] = i0 + it < t.rel ? NAN : y;
          }
        }
      }
      __syncthreads();
      store_tile(outs, t.n,
                 jb.out + (static_cast<long long>(k) * jb.B + t.b) * jb.T + t.t0);
      __syncthreads();
    }
  }
}

// The floor under ewma_tiles: the same grid crossing its one barrier, and
// nothing else.
__global__ void __launch_bounds__(kThreads, kMinBlocks) ewma_barrier_only() {
  cg::this_grid().sync();
}

size_t smem_bytes(int slots, int kmax) {
  return (static_cast<size_t>(slots) * slot_floats(kmax) + kPadTile) * sizeof(float);
}

// Blocks per SM for each (kmax, slots) (0: does not fit), per device.
struct Occupancy {
  bool ready;
  int sms;
  int per_sm[kMaxK + 1][kMaxSlots + 1];
};
Occupancy g_occupancy[kMaxDevices];

cudaError_t occupancy(Occupancy** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Occupancy& o = g_occupancy[dev];
  if (!o.ready) {
    int optin = 0;
    cudaFuncAttributes attr;
    if ((e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (e = cudaFuncGetAttributes(&attr, ewma_tiles)))
      return e;
    const size_t dyn_max = optin - attr.sharedSizeBytes;
    if ((e = cudaFuncSetAttribute(ewma_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(dyn_max))))
      return e;
    for (int k = 1; k <= kMaxK; ++k)
      for (int s = 1; s <= kMaxSlots; ++s) {
        o.per_sm[k][s] = 0;
        if (smem_bytes(s, k) <= dyn_max &&
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &o.per_sm[k][s], ewma_tiles, kThreads, smem_bytes(s, k))))
          return e;
      }
    o.ready = true;
  }
  *out = &o;
  return cudaSuccess;
}

// The grid for n_tiles: the fewest slots with which the co-resident blocks
// keep every tile they own; failing that, the slot count that keeps the most
// tiles with one slot transient.
cudaError_t plan_grid(long long n_tiles, int kmax, int* grid, int* slots, int* resident) {
  Occupancy* o = nullptr;
  cudaError_t e = occupancy(&o);
  if (e != cudaSuccess) return e;
  for (int s = 1; s <= kMaxSlots; ++s) {
    const long long blocks = static_cast<long long>(o->per_sm[kmax][s]) * o->sms;
    if (blocks > 0 && blocks * s >= n_tiles) {
      *grid = static_cast<int>(blocks < n_tiles ? blocks : n_tiles);
      *slots = s;
      *resident = 1;
      return cudaSuccess;
    }
  }
  long long best = 0;
  for (int s = 2; s <= kMaxSlots; ++s) {
    const long long blocks = static_cast<long long>(o->per_sm[kmax][s]) * o->sms;
    if (blocks * (s - 1) > best) {
      best = blocks * (s - 1);
      *grid = static_cast<int>(blocks);
      *slots = s;
      *resident = 0;
    }
  }
  return best > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" int fused_ewma_tile_len() { return kTile; }

extern "C" int fused_ewma_max_k() { return kMaxK; }

extern "C" int fused_ewma_max_jobs() { return kMaxJobs; }

extern "C" const char* fused_ewma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch's grid on the current device for n_tiles tiles whose largest
// K is kmax: out = {blocks, slots, resident, dynamic shared memory bytes}.
extern "C" int fused_ewma_plan(long long n_tiles, int kmax, int* out) {
  if (n_tiles < 1 || kmax < 1 || kmax > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = plan_grid(n_tiles, kmax, out, out + 1, out + 2);
  out[3] = static_cast<int>(smem_bytes(out[1], kmax));
  return static_cast<int>(e);
}

// n_jobs jobs: x[j] [B[j], T[j]] f32 contiguous, out[j] [K[j], B[j], T[j]];
// alpha and decay hold kMaxK host floats per job; agg is a device buffer of
// n_tiles · kMaxK · 2 floats, n_tiles = sum of B[j] · ceil(T[j] / kTile).
// One cooperative launch on `stream`.
extern "C" int fused_ewma_launch(int n_jobs, const float* const* x,
                                 float* const* out, const long long* T,
                                 const int* B, const int* K, const int* start,
                                 const float* alpha, const float* decay,
                                 float* agg, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  Plan p = {};
  long long tiles = 0;
  for (int j = 0; j < n_jobs; ++j) {
    if (K[j] < 1 || K[j] > kMaxK || B[j] < 1 || T[j] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    Job& jb = p.job[j];
    jb.x = x[j];
    jb.out = out[j];
    jb.T = T[j];
    jb.tile0 = tiles;
    jb.B = B[j];
    jb.K = K[j];
    jb.start = start[j];
    jb.C = static_cast<int>((T[j] + kTile - 1) / kTile);
    for (int k = 0; k < kMaxK; ++k) {
      jb.alpha[k] = k < K[j] ? alpha[j * kMaxK + k] : 0.f;
      jb.decay[k] = k < K[j] ? decay[j * kMaxK + k] : 0.f;
    }
    tiles += static_cast<long long>(jb.B) * jb.C;
    p.kmax = p.kmax > jb.K ? p.kmax : jb.K;
  }
  p.agg = agg;
  p.n_tiles = tiles;
  p.n_jobs = n_jobs;
  int grid = 0;
  cudaError_t e = plan_grid(tiles, p.kmax, &grid, &p.slots, &p.resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ewma_tiles), dim3(grid),
                                  dim3(kThreads), args, smem_bytes(p.slots, p.kmax),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A cooperative launch of the grid fused_ewma_launch takes for n_tiles
// tiles whose largest K is kmax, with its dynamic shared memory, that only
// crosses the grid barrier: the fixed cost under every launch, for timing.
extern "C" int fused_ewma_barrier_launch(long long n_tiles, int kmax, void* stream) {
  if (n_tiles < 1 || kmax < 1 || kmax > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0, slots = 0, resident = 0;
  cudaError_t e = plan_grid(n_tiles, kmax, &grid, &slots, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(slots, kmax);
  if ((e = cudaFuncSetAttribute(ewma_barrier_only, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))))
    return static_cast<int>(e);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ewma_barrier_only), dim3(grid),
                                  dim3(kThreads), nullptr, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
