// replay_sweep.cu — the population replay backtest as an event walk, one
// warp per strategy.
//
// Replaces the TPU kernel ai_crypto_trader_tpu/ops/pallas_backtest.py
// sweep_pallas (pl.pallas_call at :259; kernel body from _make_kernel,
// :87-196): engine.sweep's use_param_sl_tp replay, no reference quirks, no
// sell exits, and optionally the [B, T] equity curve.  Per candle and
// strategy the reference does an SL/TP check on pnl% and the close
// bookkeeping (_book_close), the entry gate (confidence >= threshold,
// strength >= minimum, signal == decision == BUY), the position sizer
// (signals.position_size) and the equity point, drawdown and return
// moments; at the end the open position closes at close[T-1] and 15 stats
// are written.
//
// What bounds it on this card: neither bytes nor the arithmetic rate, but
// the walk's latency.  The streams are 9·T·4 bytes (18.9 MB at T = 525,600)
// and stay in the 50 MB L2; the exit test is a handful of float32
// operations per in-position candle and strategy.  Each strategy is a
// serial chain of events (an entry, then the first candle whose pnl% hits
// SL or TP, then the next entry), and the card is only busy when enough
// strategies walk at once to hide each chain's load and division latency.
//
// What the design does about it.  Out of a position nothing but the entry
// gate can happen, and the gate depends on the candles alone; in a position
// nothing but the exit can happen, and the exit depends only on the entry.
// So the kernel jumps from event to event instead of stepping every candle,
// and gives the candles in between to the 32 lanes of a warp:
//   * a pre-pass (replay_gate_kernel) evaluates the gate once per candle,
//     not once per strategy, into a bitmask of ceil(T/32) words;
//   * out of a position each lane tests one word of the mask, and
//     __ballot_sync/__ffs find the next gate bit, 1,024 candles a step;
//   * in a position each lane tests 4 consecutive candles of close (one
//     16-byte load) with the exact pnl% test of replay_step, and a ballot
//     finds the first candle that hits, 128 candles a step;
//   * the event bookkeeping (book_close, position_size, the equity point)
//     runs once per event with replay_step's operands in replay_step's
//     order, on a carry that every lane of the warp holds alike.
// That skipping keeps every bit: out of a position a candle books r = (b -
// b)/b, which adds nothing to the sums and leaves max_equity and the
// drawdown as they were, so a run of such candles is booked once and
// counted into n_r; in a position a candle that does not close books
// nothing at all.  A close on candle x books its equity point at x and may
// re-open at x, as the reference runs the gate after _book_close.  Which of
// SL and TP hit does not matter: both close at close[x].
// One warp per strategy puts 4,096 warps on the card at B = 4096 (~31 per
// SM); __launch_bounds__ caps registers at 64 a thread so all are resident.
// Built with --fmad=false, so no product is fused into a sum: the plain
// PyTorch loop rounds each step the same way, and a one-ulp shift in pnl%
// would flip `pnl_pct <= -sl` on a borderline candle and change the trade.
// volume / 50000 is a multiply by the float32 reciprocal, as the compiled
// JAX engine and the port's sizer compute it.  Ragged T and B are masked in
// the kernels: no padding pass, and the end-of-test close reads close[T-1].
// The curve variant (a template flag, so the stats-only walk carries no
// curve code) writes the balance after each candle, which changes only at
// closes, as runs between closes; each warp writes its own row.
// Rows form (the GA's fitness, where every genome has its own signal rule
// and exits): signal, decision, strength, confidence, volatility and the
// SL/TP overrides may each be one [T] stream shared by every strategy (row
// stride 0) or [B, T] rows (row stride T); close and volume are shared.
// When any gate stream is rows the pre-pass writes one mask row per
// strategy, [B, ceil(T/32)], and warp b walks row b; the walk reads a row
// of volatility and the overrides only at an entry, as replay_step uses
// them only there.  The shared form (every stride 0) is its own
// instantiation (kRows false), the walk of the main path as it was, with
// no row offsets: the same launches, the same bits and the same time.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // strategies per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 8;             // 32 warps an SM: <= 64 registers
constexpr int kPerLane = 4;               // candles a lane tests per step
constexpr int kGateThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b < a ? b : a);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b > a ? b : a);
}

// signals.position_size(...).size.
__device__ __forceinline__ float position_size(float balance, float vol,
                                               float volume) {
  const bool hi = vol > 0.02f;
  const bool mid = !hi && vol > 0.01f;
  const float pct = hi ? 0.25f : (mid ? 0.20f : 0.15f);
  const float sl = hi ? 0.02f : (mid ? 0.015f : 0.01f);
  const float volume_factor = min_nan(volume * (1.0f / 50000.0f), 1.f);
  float size = balance * pct * volume_factor;
  size = min_nan(size, balance * 0.15f / sl);
  size = min_nan(size, balance * 0.20f);
  size = max_nan(size, balance * 0.10f);
  size = max_nan(size, 40.f);
  return size;
}

struct Carry {
  float balance, entry, qty, sl, tp, max_equity, max_dd, max_dd_pct;
  float total_profit, total_loss, sum_r, sum_r2, sum_neg_r2;
  bool in_pos;
  int trades, wins, n_r, cur_win, cur_loss, max_win, max_loss;
};

// engine._book_close for a position that closes at `price`.
__device__ __forceinline__ void book_close(Carry& c, float price) {
  const float pnl = (price - c.entry) * c.qty;
  const bool win = pnl > 0.f;
  c.balance = c.balance + pnl;
  c.in_pos = false;
  c.trades += 1;
  if (win) {
    c.wins += 1;
    c.total_profit = c.total_profit + pnl;
    c.cur_win += 1;
    c.cur_loss = 0;
  } else {
    c.total_loss = c.total_loss + (-pnl);
    c.cur_loss += 1;
    c.cur_win = 0;
  }
  c.max_win = max(c.max_win, c.cur_win);
  c.max_loss = max(c.max_loss, c.cur_loss);
}

// replay_step's equity point on a booked candle whose balance was
// `prev_balance` before it.  Applying it twice with prev_balance ==
// c.balance changes nothing but n_r: max_nan is idempotent, the drawdown
// test fails the second time, and r = (b - b)/b is a zero (or the NaN the
// first application already added).
__device__ __forceinline__ void equity_point(Carry& c, float prev_balance) {
  const float equity = c.balance;
  c.max_equity = max_nan(c.max_equity, equity);
  const float dd = c.max_equity - equity;
  if (dd > c.max_dd) {
    c.max_dd = dd;
    c.max_dd_pct = dd / c.max_equity * 100.f;
  }
  const float r = (equity - prev_balance) / prev_balance;
  c.sum_r = c.sum_r + r;
  c.sum_r2 = c.sum_r2 + r * r;
  if (r < 0.f) c.sum_neg_r2 = c.sum_neg_r2 + r * r;
  c.n_r += 1;
}

// The first candle >= t whose gate bit is set, or T.  Lane l tests word
// (t/32 + l) of each step; the bits of the mask past T are 0.
__device__ __forceinline__ int next_gate(const unsigned* __restrict__ mask,
                                         int nwords, int t, int T, int lane) {
  const int w0 = t >> 5;
  for (int w = w0; w < nwords; w += 32) {
    const int mine = w + lane;
    unsigned word = mine < nwords ? __ldg(mask + mine) : 0u;
    if (mine == w0) word &= ~0u << (t & 31);
    const unsigned any = __ballot_sync(kFull, word != 0u);
    if (any) {
      const int f = __ffs(any) - 1;
      const unsigned hit = __shfl_sync(kFull, word, f);
      return ((w + f) << 5) + __ffs(hit) - 1;
    }
  }
  return T;
}

// The first candle >= t whose close hits the position's SL or TP, or T.
// The test is replay_step's: (close - entry) / entry_safe * 100 against
// -sl and tp.  Lane l tests candles base + 4l .. base + 4l + 3 (base
// aligned to 4, so one 16-byte load); candles before t or from T on are
// masked.
__device__ __forceinline__ int next_exit(const float* __restrict__ close,
                                         int T, int t, float entry,
                                         float entry_safe, float neg_sl,
                                         float tp, int lane) {
  for (int base = t & ~(kPerLane - 1); base < T; base += kPerLane * 32) {
    const int i0 = base + kPerLane * lane;
    float v[kPerLane];
    if (i0 + kPerLane <= T) {
#pragma unroll
      for (int q = 0; q < kPerLane / 4; ++q) {
        const float4 f4 = __ldg(reinterpret_cast<const float4*>(close + i0) + q);
        v[4 * q] = f4.x, v[4 * q + 1] = f4.y, v[4 * q + 2] = f4.z, v[4 * q + 3] = f4.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        v[k] = i0 + k < T ? __ldg(close + i0 + k) : 0.f;
    }
    unsigned hits = 0u;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const float pnl_pct = (v[k] - entry) / entry_safe * 100.f;
      const bool hit = pnl_pct <= neg_sl || pnl_pct >= tp;
      const int i = i0 + k;
      if (hit && i >= t && i < T) hits |= 1u << k;
    }
    const unsigned any = __ballot_sync(kFull, hits != 0u);
    if (any) {
      const int f = __ffs(any) - 1;
      const unsigned hit = __shfl_sync(kFull, hits, f);
      return base + kPerLane * f + __ffs(hit) - 1;
    }
  }
  return T;
}

// row[from:to] = v, the warp's lanes on consecutive addresses.
__device__ __forceinline__ void fill(float* __restrict__ row, int from, int to,
                                     float v, int lane) {
  for (int i = from + lane; i < to; i += 32) row[i] = v;
}

// Row r of the mask from the streams' row r (each stream's row stride is
// 0 or T); blocks tile each row, tiles_per_row of them a row.
__global__ void __launch_bounds__(kGateThreads)
    replay_gate_kernel(const float* __restrict__ confidence,
                       const float* __restrict__ strength,
                       const int* __restrict__ signal,
                       const int* __restrict__ decision,
                       unsigned* __restrict__ mask, int T, int warmup,
                       float conf_thr, float min_strength, int tiles_per_row,
                       long long conf_stride, long long strength_stride,
                       long long signal_stride, long long decision_stride) {
  const int r = blockIdx.x / tiles_per_row;
  const int t = (blockIdx.x - r * tiles_per_row) * kGateThreads + threadIdx.x;
  bool gate = false;
  if (t < T && t >= warmup) {
    const int dec = decision[r * decision_stride + t];
    gate = confidence[r * conf_stride + t] >= conf_thr &&
           strength[r * strength_stride + t] >= min_strength &&
           signal[r * signal_stride + t] == dec && dec == 1;
  }
  const unsigned bits = __ballot_sync(kFull, gate);
  if ((threadIdx.x & 31) == 0 && t < T)
    mask[static_cast<long long>(r) * ((T + 31) >> 5) + (t >> 5)] = bits;
}

template <bool kCurve, bool kRows>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    replay_walk_kernel(const float* __restrict__ close,
                       const float* __restrict__ volatility,
                       const float* __restrict__ volume,
                       const float* __restrict__ sl_override,
                       const float* __restrict__ tp_override,
                       const unsigned* __restrict__ mask,
                       const float* __restrict__ stop_loss,
                       const float* __restrict__ take_profit,
                       float* __restrict__ out_f, int* __restrict__ out_i,
                       float* __restrict__ curve, int B, int T, int warmup,
                       float initial_balance, long long mask_stride,
                       long long vol_stride, long long sl_stride,
                       long long tp_stride) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= B) return;  // the whole warp
  const float psl = stop_loss[j], ptp = take_profit[j];
  const int nwords = (T + 31) >> 5;
  float* row = kCurve ? curve + static_cast<long long>(j) * T : nullptr;
  // strategy j's rows (stride 0: the shared stream)
  const unsigned* __restrict__ mask_j = kRows ? mask + j * mask_stride : mask;
  const float* __restrict__ vol_j = kRows ? volatility + j * vol_stride : volatility;
  const float* __restrict__ sl_j = kRows ? sl_override + j * sl_stride : sl_override;
  const float* __restrict__ tp_j = kRows ? tp_override + j * tp_stride : tp_override;

  Carry c;
  c.balance = initial_balance;
  c.entry = c.qty = c.sl = c.tp = 0.f;
  c.max_equity = initial_balance;
  c.max_dd = c.max_dd_pct = 0.f;
  c.total_profit = c.total_loss = 0.f;
  c.sum_r = c.sum_r2 = c.sum_neg_r2 = 0.f;
  c.in_pos = false;
  c.trades = c.wins = 0;
  c.n_r = 1;  // the reference's initial zero-return equity point
  c.cur_win = c.cur_loss = c.max_win = c.max_loss = 0;

  int booked = warmup > 0 ? warmup : 0;  // first candle not yet booked
  int curve_from = 0;                    // first curve column not written
  int t = booked;                        // where the gate search starts
  while (t < T) {
    // out of a position: candles booked..g book r = 0 (g the entry)
    const int g = next_gate(mask_j, nwords, t, T, lane);
    const int count = (g < T ? g + 1 : T) - booked;
    if (count > 0) {
      equity_point(c, c.balance);
      c.n_r += count - 1;
    }
    if (g >= T) break;

    const float price = __ldg(close + g);
    const float size =
        position_size(c.balance, __ldg(vol_j + g), __ldg(volume + g));
    const float slo = __ldg(sl_j + g), tpo = __ldg(tp_j + g);
    c.in_pos = true;
    c.entry = price;
    c.qty = size / price;
    c.sl = isnan(slo) ? psl : slo;
    c.tp = isnan(tpo) ? ptp : tpo;

    // in a position: candles g+1..x-1 survive and book nothing
    const float entry_safe = c.entry == 0.f ? 1.f : c.entry;
    const int x = next_exit(close, T, g + 1, c.entry, entry_safe, -c.sl, c.tp,
                            lane);
    if (x >= T) break;
    const float prev_balance = c.balance;
    if (kCurve) {
      fill(row, curve_from, x, prev_balance, lane);
      curve_from = x;
    }
    book_close(c, __ldg(close + x));
    equity_point(c, prev_balance);
    booked = x + 1;
    t = x;  // the gate runs after the close: re-entry at x is possible
  }
  if (kCurve) fill(row, curve_from, T, c.balance, lane);

  if (c.in_pos) book_close(c, __ldg(close + T - 1));  // "End of Test"
  if (lane != 0) return;
  out_f[0 * B + j] = c.balance;
  out_f[1 * B + j] = c.total_profit;
  out_f[2 * B + j] = c.total_loss;
  out_f[3 * B + j] = c.max_dd;
  out_f[4 * B + j] = c.max_dd_pct;
  out_f[5 * B + j] = c.sum_r;
  out_f[6 * B + j] = c.sum_r2;
  out_f[7 * B + j] = c.sum_neg_r2;
  out_i[0 * B + j] = c.trades;
  out_i[1 * B + j] = c.wins;
  out_i[2 * B + j] = c.trades - c.wins;
  out_i[3 * B + j] = c.n_r;
  out_i[4 * B + j] = c.max_win;
  out_i[5 * B + j] = c.max_loss;
}

// T is carried as an int inside the kernels (and B·T as 64 bits).
bool bad_length(long long T) { return T < 1 || T > INT_MAX - 32 * kPerLane * 32; }

}  // namespace

extern "C" const char* replay_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The entry gate of every candle into mask [R, ceil(T/32)] (bit t % 32 of
// word t / 32 of row r).  confidence and strength f32, signal and decision
// int32, each [T] (row stride 0) or [R, T] (row stride T).
extern "C" int replay_gate_launch(const float* confidence,
                                  const float* strength, const int* signal,
                                  const int* decision, unsigned* mask,
                                  long long T, int R, long long conf_stride,
                                  long long strength_stride,
                                  long long signal_stride,
                                  long long decision_stride, int warmup,
                                  float conf_thr, float min_strength,
                                  void* stream) {
  if (bad_length(T) || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(T);
  const int tiles = (n + kGateThreads - 1) / kGateThreads;
  if (static_cast<long long>(tiles) * R > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  replay_gate_kernel<<<tiles * R, kGateThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      confidence, strength, signal, decision, mask, n, warmup, conf_thr,
      min_strength, tiles, conf_stride, strength_stride, signal_stride,
      decision_stride);
  return static_cast<int>(cudaGetLastError());
}

// The walk over the gate mask.  close (16-byte aligned) and volume [T] f32;
// volatility, sl_override, tp_override f32 [T] (row stride 0) or [B, T]
// (row stride T); mask [ceil(T/32)] (mask_stride 0) or [B, ceil(T/32)]
// (mask_stride ceil(T/32)); stop_loss and take_profit [B] f32; out_f [8, B]
// f32 and out_i [6, B] int32 (row order in ops/replay.py); curve [B, T]
// f32, or null for the stats alone.
extern "C" int replay_walk_launch(
    const float* close, const float* volatility, const float* volume,
    const float* sl_override, const float* tp_override, const unsigned* mask,
    const float* stop_loss, const float* take_profit, float* out_f,
    int* out_i, float* curve, int B, long long T, int warmup,
    float initial_balance, long long mask_stride, long long vol_stride,
    long long sl_stride, long long tp_stride, void* stream) {
  if (B < 1 || bad_length(T)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<std::uintptr_t>(close) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(T);
  const bool rows = (mask_stride | vol_stride | sl_stride | tp_stride) != 0;
  // one instantiation for each (curve, rows): the stats-only shared walk
  // carries neither curve code nor row offsets
  auto walk = rows ? (curve != nullptr ? replay_walk_kernel<true, true>
                                       : replay_walk_kernel<false, true>)
                   : (curve != nullptr ? replay_walk_kernel<true, false>
                                       : replay_walk_kernel<false, false>);
  walk<<<blocks, kThreads, 0, s>>>(close, volatility, volume, sl_override,
                                   tp_override, mask, stop_loss, take_profit,
                                   out_f, out_i, curve, B, n, warmup,
                                   initial_balance, mask_stride, vol_stride,
                                   sl_stride, tp_stride);
  return static_cast<int>(cudaGetLastError());
}
