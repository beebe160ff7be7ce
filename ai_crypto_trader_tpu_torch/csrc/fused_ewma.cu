// fused_ewma.cu — the EMA family as a chunked scan over affine maps.
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
// written as NaN.
//
// What bounds it on this card: bytes.  Per call it must read x once
// (4·B·T bytes) and write K outputs (4·K·B·T bytes); the arithmetic is
// about five float32 operations per element and output, far below the
// card's rate.  On the main path B is 1 to 3 and T = 525,600, so one thread
// per series — the TPU kernel's layout, with the batch on the lanes and the
// sequential grid carrying y across time tiles — would leave all but a few
// SMs idle, and the card has no sequential grid to carry state with.
//
// What the design does about it: the time axis is cut into chunks of
// kChunk = 2048 candles, one block each (257 blocks per series on the main
// path), in three launches on the caller's stream:
//   1. every block composes its chunk's maps — each thread its kItems
//      consecutive elements in sequence, then a shuffle scan across the
//      block — and writes the chunk's aggregate (A, B);
//   2. one block per series scans the chunk aggregates the same way and
//      writes the value of y entering every chunk;
//   3. every block redoes step 1's composition, applies its exclusive
//      prefix to the carried-in y and runs the recursion over its elements,
//      writing y.
// x is read twice and each output written once; nothing but the
// (A, B) pair per chunk and one float per chunk reaches device memory
// between the launches.  The composition is the combine of
// ops/indicators.first_order_recursion, (a1, b1) then (a2, b2) ->
// (a1·a2, a2·b1 + b2), built with --fmad=false: the product and the sum are
// rounded separately, as in the plain PyTorch version.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Coefs {
  float alpha[kMaxK];
  float decay[kMaxK];  // 1 - alpha, rounded once from double on the host
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

__device__ __forceinline__ Affine element(float x, long long t, int start,
                                          float alpha, float decay) {
  if (t < start) return Affine{0.f, 0.f};
  if (t == start) return Affine{0.f, x};
  return Affine{decay, alpha * x};
}

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

// Launches 1 (kWrite = false) and 3 (kWrite = true): grid (chunks, B).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    ewma_chunks(const float* __restrict__ x, float* __restrict__ out,
                float* __restrict__ agg, const float* __restrict__ carry,
                Coefs co, int K, int B, long long T, int start, int C) {
  const int c = blockIdx.x, b = blockIdx.y;
  const long long t0 = (long long)c * kChunk + (long long)threadIdx.x * kItems;
  const float* xr = x + (long long)b * T;
  float xv[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    xv[i] = t0 + i < T ? nan_to_num(xr[t0 + i]) : 0.f;

  for (int k = 0; k < K; ++k) {
    const float alpha = co.alpha[k], decay = co.decay[k];
    Affine acc = identity();
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (t0 + i < T) acc = compose(acc, element(xv[i], t0 + i, start, alpha, decay));
    Affine total;
    const Affine pre = block_exclusive_scan(acc, &total);
    const long long series = (long long)k * B + b;
    if (!kWrite) {
      if (threadIdx.x == 0) {
        agg[2 * (series * C + c)] = total.a;
        agg[2 * (series * C + c) + 1] = total.b;
      }
    } else {
      float y = pre.a * carry[series * C + c] + pre.b;
      float* orow = out + series * T;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long t = t0 + i;
        if (t < T) {
          const Affine e = element(xv[i], t, start, alpha, decay);
          y = e.a * y + e.b;
          orow[t] = t < start ? NAN : y;
        }
      }
    }
  }
}

// Launch 2: one block per series (k, b) scans its C chunk aggregates and
// writes y entering each chunk (y[-1] = 0, so that is the prefix's b).
__global__ void __launch_bounds__(kThreads)
    ewma_carry(const float* __restrict__ agg, float* __restrict__ carry, int C) {
  const long long series = blockIdx.x;
  const float* ag = agg + 2 * series * C;
  float* cr = carry + series * C;
  const int per = (C + kThreads - 1) / kThreads;
  const int c0 = threadIdx.x * per;
  Affine acc = identity();
  for (int i = 0; i < per; ++i) {
    const int c = c0 + i;
    if (c < C) acc = compose(acc, Affine{ag[2 * c], ag[2 * c + 1]});
  }
  Affine total;
  const Affine pre = block_exclusive_scan(acc, &total);
  float y = pre.b;
  for (int i = 0; i < per; ++i) {
    const int c = c0 + i;
    if (c < C) {
      cr[c] = y;
      y = ag[2 * c] * y + ag[2 * c + 1];
    }
  }
}

}  // namespace

extern "C" int fused_ewma_chunk_len() { return kChunk; }

extern "C" int fused_ewma_max_k() { return kMaxK; }

extern "C" const char* fused_ewma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, T] f32 contiguous; out [K, B, T]; agg [K·B·C·2] and carry [K·B·C]
// work buffers, C = ceil(T / kChunk); alpha and decay are K host floats.
extern "C" int fused_ewma_launch(const float* x, float* out, float* agg,
                                 float* carry, const float* alpha,
                                 const float* decay, int K, int B, long long T,
                                 int start, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Coefs co;
  for (int k = 0; k < kMaxK; ++k) {
    co.alpha[k] = k < K ? alpha[k] : 0.f;
    co.decay[k] = k < K ? decay[k] : 0.f;
  }
  const int C = static_cast<int>((T + kChunk - 1) / kChunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(C, B);
  ewma_chunks<false><<<grid, kThreads, 0, s>>>(x, out, agg, carry, co, K, B, T,
                                               start, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ewma_carry<<<K * B, kThreads, 0, s>>>(agg, carry, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ewma_chunks<true><<<grid, kThreads, 0, s>>>(x, out, agg, carry, co, K, B, T,
                                              start, C);
  return static_cast<int>(cudaGetLastError());
}
