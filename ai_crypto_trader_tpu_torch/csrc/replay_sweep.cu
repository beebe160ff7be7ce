// replay_sweep.cu — the population replay backtest, one thread per strategy.
//
// Replaces the TPU kernel ai_crypto_trader_tpu/ops/pallas_backtest.py
// sweep_pallas (pl.pallas_call at :259; kernel body from _make_kernel,
// :87-196): engine.sweep's use_param_sl_tp replay, no reference quirks, no
// sell exits.  Per candle and strategy: an SL/TP check on pnl% and the close
// bookkeeping (_book_close), the entry gate (confidence >= threshold,
// strength >= minimum, signal == decision == BUY), the position sizer
// (signals.position_size) and the equity point, drawdown and return
// moments; at the end the open position closes at close[T-1] and 15 stats
// are written.  Operands keep replay_step's order (engine.py:240-315):
// (close - entry) / entry_safe * 100, dd / max_eq * 100, size / close.
// Built with --fmad=false, so no product is fused into a sum: the plain
// PyTorch loop rounds each step the same way, and a one-ulp shift in pnl%
// would flip `pnl_pct <= -sl` on a borderline candle and change the trade.
// volume / 50000 is a multiply by the float32 reciprocal, as the compiled
// JAX engine and the port's sizer compute it.
//
// What bounds it on this card: neither bytes nor the arithmetic rate.  The
// nine [T] candle streams are 9·T·4 bytes (18.9 MB at T = 525,600), read
// once from device memory; the arithmetic is some 60 float32 operations per
// candle and strategy (1.3e11 at B = 4096), two milliseconds at the card's
// float32 rate.  The limit is each strategy's serial chain of dependent
// operations across T candles: the carry of candle t feeds candle t+1.
//
// What the design does about it: the whole carry (21 values, counters as
// int as in engine.py) lives in registers of the strategy's thread, so a
// candle costs no memory traffic for the state.  Each block of kBlock = 32
// strategies stages kStage candles of the nine streams into shared memory
// once, and all its threads read them from there as broadcasts; at B = 4096
// that is 128 blocks, one warp on most of the 132 SMs (128 threads per
// block would leave 100 SMs idle).  Ragged T and B are masked in the
// kernel: no padding pass, and the end-of-test close reads close[T-1].
// The TPU kernel's sequential grid carry over time chunks becomes a loop
// inside the block.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBlock = 32;
constexpr int kStage = 1024;

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

__global__ void __launch_bounds__(kBlock)
    replay_sweep_kernel(const float* __restrict__ close,
                        const int* __restrict__ signal,
                        const float* __restrict__ strength,
                        const float* __restrict__ volatility,
                        const float* __restrict__ volume,
                        const float* __restrict__ confidence,
                        const int* __restrict__ decision,
                        const float* __restrict__ sl_override,
                        const float* __restrict__ tp_override,
                        const float* __restrict__ stop_loss,
                        const float* __restrict__ take_profit,
                        float* __restrict__ out_f, int* __restrict__ out_i,
                        int B, long long T, int warmup, float initial_balance,
                        float conf_thr, float min_strength) {
  __shared__ float s_close[kStage], s_strength[kStage], s_vol[kStage],
      s_volume[kStage], s_conf[kStage], s_slo[kStage], s_tpo[kStage];
  __shared__ int s_signal[kStage], s_decision[kStage];

  const int j = blockIdx.x * kBlock + threadIdx.x;
  const bool live = j < B;
  const float psl = live ? stop_loss[j] : 0.f;
  const float ptp = live ? take_profit[j] : 0.f;

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

  for (long long t0 = 0; t0 < T; t0 += kStage) {
    const int n = static_cast<int>(T - t0 < kStage ? T - t0 : kStage);
    __syncthreads();  // the previous stage is fully consumed
    for (int i = threadIdx.x; i < n; i += kBlock) {
      s_close[i] = close[t0 + i];
      s_signal[i] = signal[t0 + i];
      s_strength[i] = strength[t0 + i];
      s_vol[i] = volatility[t0 + i];
      s_volume[i] = volume[t0 + i];
      s_conf[i] = confidence[t0 + i];
      s_decision[i] = decision[t0 + i];
      s_slo[i] = sl_override[t0 + i];
      s_tpo[i] = tp_override[t0 + i];
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const bool active = t0 + i >= warmup;
      const float price = s_close[i];
      const float prev_balance = c.balance;

      // --- SL/TP check on the open position ---
      const float entry_safe = c.entry == 0.f ? 1.f : c.entry;
      const float pnl_pct = (price - c.entry) / entry_safe * 100.f;
      const bool open = active && c.in_pos;
      const bool hit_sl = open && pnl_pct <= -c.sl;
      const bool hit_tp = open && !hit_sl && pnl_pct >= c.tp;
      const bool closing = hit_sl || hit_tp;
      const bool survived = c.in_pos && !closing;
      if (closing) book_close(c, price);

      // --- entry gate ---
      const int sig = s_signal[i], dec = s_decision[i];
      const bool gate = active && !c.in_pos && s_conf[i] >= conf_thr &&
                        s_strength[i] >= min_strength && sig == dec && dec == 1;
      if (gate) {
        const float size = position_size(c.balance, s_vol[i], s_volume[i]);
        const float slo = s_slo[i], tpo = s_tpo[i];
        c.in_pos = true;
        c.entry = price;
        c.qty = size / price;
        c.sl = isnan(slo) ? psl : slo;
        c.tp = isnan(tpo) ? ptp : tpo;
      }

      // --- equity point + drawdown on candles the reference reaches ---
      if (active && !survived) {
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
    }
  }

  if (!live) return;
  if (c.in_pos) book_close(c, close[T - 1]);  // "End of Test"
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

}  // namespace

extern "C" const char* replay_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Nine [T] streams (signal and decision int32, the rest f32), stop_loss and
// take_profit [B] f32; out_f [8, B] f32 and out_i [6, B] int32 (row order
// in ops/replay.py).
extern "C" int replay_sweep_launch(
    const float* close, const int* signal, const float* strength,
    const float* volatility, const float* volume, const float* confidence,
    const int* decision, const float* sl_override, const float* tp_override,
    const float* stop_loss, const float* take_profit, float* out_f,
    int* out_i, int B, long long T, int warmup, float initial_balance,
    float conf_thr, float min_strength, void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kBlock - 1) / kBlock;
  replay_sweep_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      close, signal, strength, volatility, volume, confidence, decision,
      sl_override, tp_override, stop_loss, take_profit, out_f, out_i, B, T,
      warmup, initial_balance, conf_thr, min_strength);
  return static_cast<int>(cudaGetLastError());
}
