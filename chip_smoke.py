#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, and check it.

    python3 chip_smoke.py

Runs from the root of a checkout of this repository and needs one NVIDIA
card (written for an H100, sm_90a), nvcc and PyTorch built for CUDA.  It
imports nothing of JAX or of the JAX package.  Phases, one JSON line each:

  0. device   — the card, and nvidia-smi's name and power limit;
  1. build    — both kernels compiled from ``ai_crypto_trader_tpu_torch/
                csrc/`` into the cache directory under ``.torch_kernels/``
                (one nvcc per source, run
                together), with cuobjdump's register and shared-memory
                report of each library;
  2. ewma     — the fused-EWMA kernel (K2) against its plain PyTorch
                version on the card: each of the two launches that
                compute_indicators makes on a year of 1-minute candles, on
                its own inputs; ragged shapes, a job list of four jobs with
                their own T, alphas and seeds; and x [64, 525,600] with K=2,
                more than the co-resident blocks keep in shared memory.
                Every case is launched twice and must give the same bits.
                Per-launch times beside two floors (the launch's grid
                crossing its barrier alone, and a device copy of the same
                bytes), the grid each launch takes, registers;
  2b. flips   — the year's indicator table built twice on the card, its EMA
                family once from the kernel and once from the plain version
                (the JAX package's rounding; every EWMA entry that
                compute_indicators calls is patched, and the plain table must
                launch no kernel), and every signal, strength-gate and
                sizer-bucket difference that follows counted and held to a
                threshold it sits on;
  3. replay   — the replay-sweep kernel (K1) against the engine's eager
                plain loop on the card, stats and equity curve, through both
                of its variants (stats alone, and with the curve): 4096
                strategies over the first 2048 candles of the main path's
                inputs, B=130 × T=1500, T=900 with SL/TP overrides and
                confidence gating, SL/TP so small that every position closes
                on the next candle and so large that only the end of the
                test closes one, SL/TP hit with equality, and a ragged T of
                4·1024 + 7 with warmup 2000; `run_backtest`'s param-SL/TP
                mode at B=1 × T=2048 with its curve; and the graph-replayed
                plain loop (below) bit for bit against the eager one;
  4. main     — the population backtest at the bench's full size (T =
                525,600 candles, B = 4096 strategies) through the port's
                entry points, with launch counts (exactly 2 of K2), stage times and a check
                that every metric is finite and trades happen; then the
                kernel's stats from that run against the plain loop on the
                same inputs and strategies, at full size, and the curve of
                the first 256 strategies over all T against the plain
                loop's; K1's pre-pass and walk timed alone, the walk of the
                strategy with the most trades alone, and the pre-pass's gate
                mask against its plain version;
  4b. split   — where the indicator stage's time goes, measured only: its
                parts (host-to-device copies, rolling sums, unfold max/min,
                rolling_std, the EMA family, nanfill over every column, the
                rest) between CUDA events, and torch.profiler's top 10
                device ops with their counts and the device's idle share
                over one whole call;
  5. ga       — the GA at the bench's full width (`GAParams(256, 3)` on the
                first 43,200 candles of the year, bench.py:1927-2003): the
                period-table build's K2 launches, as packed, against the
                plain version job by job and twice for the same bits, and
                the build with no synchronizing call of torch's; K1's
                rows form (a row of signal, strength, volatility and SL/TP
                per genome) against the plain loop bit for bit, stats and
                curve, on the GA's own fitness inputs and in edge cases;
                `run_backtest` on per-genome rows through K1; the whole GA
                through `backtest_fitness` and `run_ga` with exact launch
                counts and one host read, backtests/s and its time split;
                and K2's flips as the GA reads them (`ga_flips`);
  6. tick     — the live tick path at the bench's `tick_pipeline` width (64
                symbols × frames 1m/3m/5m/15m × a 256-candle window,
                bench.py:1323-1337, on the exchange's resampled klines):
                the three K2 launches of a step, recorded as the step makes
                them, against the plain version job by job and twice for
                the same bits (`tick_k2`); exactly 3 K2 launches and one
                host read a step, and no other synchronizing call of
                torch's in it; the ring delta bit for bit against a fresh
                seed; the pipelined tables bit for bit against the serial
                ones shifted by one tick; K2's flips over every window
                candle and in the tables (`tick_flips`); 20 timed polls in
                each mode, the modes in turns within one loop (ingest +
                step, split into scatter build, dispatch, the program's
                CUDA-event span and host read) and torch.profiler over one
                step;
  7. portfolio — 8 symbols, one left-padded: `stack_symbol_inputs` with
                exactly 2 K2 launches; capital silos in param-SL/TP mode at
                T = 8,192 through one `run_backtest` over [S, T], one K1
                launch per symbol, bit for bit against the plain loop over
                all symbols (graph-replayed), all S launches timed
                together beside the sum of their bounds; the
                sizer-ladder silos and the shared pool (both equity
                cadences), plain loops on the card at T = 512, against
                the port's CPU run of the same inputs;
  8. tenant   — the live decision path at full width: the tick phase's
                tape through a `TickEngine` into a `TenantEngine` of 256
                tenants × those 64 symbols (the fleet observatory and
                containment on, heterogeneous tenants, a live SL/TP
                override for half the run, venue syncs and one lane's
                balance poisoned with NaN mid-run); 20 polls of ingest →
                step → `feats_from_tick` → `decide`, each decide with one
                host read and no other synchronizing call, against a CPU
                engine fed the same features and calls (gate flips only
                within 1e-6 of a threshold, counted; floats bit for bit),
                the poisoned lane quarantined and its neighbours
                bit-identical to a run without the poison, the fleet
                aggregates equal to `host_aggregates` of the read-back
                table, exactly 3 K2 launches a tick step; the decide's
                and the poll's times, torch.profiler over one decide, and
                the decide at the capacity row's width (256 × 4 symbols);
  9. mc       — the Monte-Carlo service at the bench's width (10,000 paths
                × 30 days, bench.py:837-866): `run_simulation` (GBM,
                bootstrap), `stress_var_cvar` (flash_crash), the
                correlated 8-asset portfolio, and the trailing stops over
                a [256, 64] grid for 20 prices in all four strategies,
                each against the port's CPU run on the same draws (rtol
                1e-5; the stops exactly), with each call's p50 over 20
                calls;
 10. nn       — the model zoo through the prediction service's batched
                path: 256 lanes (the tick tape's 64 symbols × 4 frames),
                each its own model and 60-candle window, for each of the
                nine architectures `predict_prices_batched` on the card
                against the port's CPU run (scaled outputs atol 1e-5,
                prices rtol 1e-5), one host read and no other sync a call,
                three lanes of `predict_prices` equal to the batch, p50/p99
                of 10 calls; torch.profiler over one lstm call and cuDNN's
                `nn.LSTM` over the same windows as the library's time; then
                `cli train`'s seven feature columns over 64 symbols ×
                43,200 candles (exactly 2 K2 launches) and its lstm group;
 11. patterns — the three chart-pattern classifiers' `detect_patterns`
                over the 64 symbols' 256-candle `5m` windows against the
                port's CPU run (probabilities atol 1e-5, the same top 3 but
                for near-ties, counted), p50/p99 of 10 rounds;
 12. train    — training on the card: the bench's `nn` row (the zoo lstm,
                B 32 × T 60 × F 8, 32 batches an epoch, through
                `EpochTrainer`: ms per step amortised over 3 epochs, one
                read an epoch and no other sync, the epoch losses and
                parameters against the port's CPU run, the LSTM's
                hand-written backward against autograd of the plain loop,
                torch.profiler over one step, cuDNN's `nn.LSTM` forward +
                backward beside it); `cli train` at its defaults (7 days,
                epochs cut to 2; exactly 2 K2 launches, held against the
                plain EWMA); `PredictionService` at its defaults (epochs cut
                to 3) over 8
                symbols × 2 frames (the first cycle's 16 trainings and one
                batched predict, a cycle inside half an interval, one HPO
                request); the three pattern classifiers trained; feature
                importance of the `cli train` model against the CPU;
 13. rl       — the RL trainer on the card: (a) the bench's `rl` row
                (the year's indicator table, episode 512, 256 envs ×
                rollout 32, bench.py:695-723): env steps/s of 20 iterations
                in one `train_iterations` call, one host read and no other
                sync a call, torch.profiler over one iteration, and one
                iteration against the port's CPU run on the same state and
                draws (actions, replay writes, ε and learn steps equal but
                for a reported near-tie; parameters and moments within
                1e-5); (b) the `pbt` row (bench.py:726-834): its order-flow
                markets at 16 × 1,024 built on the card against the CPU run
                on the same draws (grid-roll flips reported and bounded),
                K2's two launches there held against the plain EWMA, then
                16 members × 3 generations × 64 iterations: fleet env
                steps/s, the single agent's over 192 iterations and
                `speedup_vs_single`, one host read a generation and no
                other sync; (c) the P = 1 fleet bit for bit against the
                single agent; (d) a NaN member quarantined, masked and
                healed; (e) `cli rl` at its defaults but 1 generation, and so
                with `--dynamics gbm`, as subprocesses (2 generation rows, 8 members, one
                winner each), with K2 held at `cli rl`'s 8 × 1,024;
 14. sim      — the adversarial simulator on the card: (a) the bench's
                `sim_sweep` row (4096 mixed scenarios × 512 candles, log
                capacity 128, bench.py:872-909): scenarios/s and
                candle-steps/s of 2 timed `sweep` calls after a warm one,
                one host read and no other sync, the first 256 scenarios'
                rollout equal bit for bit to the port's CPU run on the
                card's candles, dispatches a candle and torch.profiler over
                32 candles; (b) the `lob_events_per_sec` row (1024 × 256 ×
                32 levels, bench.py:911-950): events/s the same way, one
                read and no other sync, `rollout_lob` on recorded draws bit
                for bit against the CPU's, `lob_sweep` equal to it; (c)
                `backtest_under_stress` at its defaults (256 × 1024) for
                both market dynamics, with the sizer ladder (2 K2 launches,
                no K1) and a population of 64 (2 K2 and exactly 256 K1
                launches, one per scenario): K2's launches against the
                plain EWMA and its signal flips held to their thresholds,
                K1 bit for bit against the graph-replayed plain loop over
                all 16,384 rows, K1's 256 launches timed and profiled, the
                plain sizer-ladder loop timed;
 15. service  — the services on the card: (a) the continuous PBT trainer
                at the `pbt` row's width (16 members on 16 × 1,024 LOB
                markets, 4 ticks of 4 iterations, depth cut): a service
                killed after tick 2 and resumed from its journal bit for
                bit against an unbroken one, one host read a generation and
                one a checkpoint, a checkpoint write and the bench's
                `pbt_recovery_ms` row (P = 8) timed with the first resumed
                generation, an `adopt_winner` verdict into a registry, a
                recalibration from a depth journal of the book's own frames
                and one from that journal corrupted (last-good kept), and
                `cli rl --checkpoint / --resume / --registry`; (b) the
                regime service over 64 symbols' 1,000-candle 1m histories
                (k-means rounds timed, 4 K2 launches a `regime_features`
                call counted and one call's held against the plain EWMA,
                card-vs-CPU label flips per method, each near a tie, the
                GMM's, HMM's and rules' fits timed); (c) the order book
                (64 books of 100 levels: the signal and the clusters; a
                1,024-frame window: impact and pressure) against the CPU;
                (d) `ChartPatternService` over the 64 symbols' `5m`
                windows, its analyses and signals against the CPU;
 16. strategy — the strategy layer, the long-context model and the
                social analyzer on the card: (a) `cli generate` at its
                defaults (BTCUSDC, 7 days, 3 folds, pool 16; rounds cut
                to 2) as a
                subprocess, its JSON keys, rounds and registered versions;
                (b) `evaluate_structures` at that fold shape (3 × 2,352
                candles, the seed and 16 mutants): one host read a call,
                Sharpe ratios and trades bit for bit against the port's CPU
                run on the same fold features, dispatches a candle and
                torch.profiler over one call on 256-candle folds; (c) K2:
                one `fold_features` call's 3 launches and a
                `cross_validate` call's, each held against the plain EWMA,
                and the pool's signal flips on plain fold features held to
                their thresholds; (d) K1: `cross_validate(k=5)` over 43,200
                candles (5 launches) and `compare_strategies` over 8
                parameter sets (one rows launch), each bit for bit against
                the plain loop; `StrategyEvolver.evolve` through the GA at
                `EvolutionParams()` (11 K1 and 5 K2 launches, one read) and
                one `SystematicImprover` iteration, timed; (e) the
                long-context transformer at its defaults over 16,384 × 8:
                forward and loss + gradient times and peak memory, and at
                T = 2,048 against the CPU; (f) the social analyzer over 720
                × 8 hourly metrics against the CPU, times;
 17. live     — the live signal path at the `tick_pipeline` width (64
                symbols × 1m/3m/5m/15m × 256 candles on the resilient paper
                exchange, a virtual clock, bench_recovery's trading
                parameters): 6 ticks of advance → `MarketMonitor.poll` →
                `SignalAnalyzer` → `TradeExecutor` → `on_price`, each poll
                with exactly 3 K2 launches and one host read and no other
                sync, every launch held against the plain EWMA; the same
                ticks timed (tickpath's split of the poll, the stages,
                torch.profiler over one tick) and on the CPU (payloads
                within tests/test_torch_tick.py's bounds, label flips only
                near a threshold, trades equal where the decisions agree);
                the pipelined monitor over 5 ticks against the serial one
                shifted by one tick; the per-symbol path for one symbol
                (12 K2 launches); `cli scan` at its defaults (2 K2
                launches, the CPU's ranking); journal recovery of 1,000
                trades;
 18. trade    — the trading system (`TradingSystem`) at the same width on
                the same exchange, with a journal, a flight-recorder JSONL,
                a trace JSONL and a dashboard, and a tight trailing stop so
                that the tape's one BUY run opens and closes in the window:
                8 ticks from candle 3,858, each with exactly 3 K2
                launches (every one held against the plain EWMA), one
                tick-engine read and two risk-block reads; the same ticks
                on the CPU (each tick's return, status, trades, flight
                records and file, PnL attribution, alerts and dashboard;
                risk metrics and the correlation matrix within 1e-5; label
                flips only near a threshold); a run that dies after tick 4
                and a new system that recovers from its journal, its books
                against the unbroken run's; `cli trade --paper --ticks 12`
                and `cli why` as subprocesses against the same commands on
                the CPU; `device_liveness`;
                the tick's p50/p99, tickpath's waterfall and bottleneck,
                the stages' busy time and torch.profiler over one tick;
 19. stack    — the full service roster (`shell.stack.build_full_stack`:
                social, news, patterns, regime, nn, evolver, generator,
                grid, dca): (a) `TradingSystem` with the roster over phase
                trade's tape and exchange, 6 ticks from candle 3,854 on the
                card and on the CPU (the prediction service's epochs, HPO
                trials and frames cut; the evolver's GA at
                `EvolutionParams()`'s 20 × 10 on the same draws; the pattern
                classifier trained at start on the card, loaded from its
                checkpoint on the CPU): the roster and heartbeats, the
                social, news, grid and DCA state, the decisions (flips near
                a threshold only), the trades within 1e-5, the executor's
                social factors from a four-row snapshot; 3 monitor K2
                launches a tick plus 4 a `regime_features` call and the GA
                tables' 5, one tick-engine read a tick; the evolver's 11 K1
                launches bit for bit against the plain loop and every
                monitor and GA-table K2 launch against the plain EWMA; (b)
                `SocialMonitorService` over the 64 symbols, 64 polls (the
                anomaly model from poll 50, lead-lag and accuracy reports),
                card against CPU, one read a poll and a report; (c)
                `find_triangle_arbitrage` over 64 assets (262,144 cycles,
                three planted): the cycle tensor bit for bit, the lists
                equal, one read; (d) `SocialDataProvider.social_inputs` over
                21,600 1m candles from 15 days into `evolvable_backtest(
                social=...)` (16 genomes): its K1 launch bit for bit, its K2
                launches held, the stats against the CPU's; (e) `cli trade
                --paper --full-stack --ticks 10` as a subprocess in a
                temporary cwd;
 20. stream   — the streamed market path and the load harness: (a)
                bench_stream's path at its width (bench.py:1403-1560: 16
                symbols × 1m/3m/5m/15m × 256 candles from `generate_ohlcv(
                n=256·15 + 2·40 + 64, seed=17)`, 20 ticks a pass, cut from 40): kline
                frames offered to a `StreamSupervisor`, `MarketStream`'s
                books, `TickEngine.ingest_row`, one step (3 K2 launches,
                one host read) and the monitor's publication — a serial
                pass, a pass under `TickPathScope` (the waterfall) and a
                pipelined pass, zero REST kline calls in every timed
                window, every launch held against the plain EWMA, the
                serial payloads bit for bit against a monitor polling the
                same venue by REST and within `live_tolerance` of the CPU
                run, the pipelined ones the serial ones one drain later,
                event→publish p50/p99 a pass and torch.profiler over one
                drain; (b) `TradingSystem.attach_stream` over phase live's
                tape (64 × 4 × 256), 8 ticks from phase trade's cursor:
                the REST seed, zero REST at stream_mode 1, a
                `ChaosFrameSource` silence that degrades to polling
                (stream_mode 0, StreamDegradedToPoll) and the hand-back,
                payloads, decisions and trades bit for bit against a
                polled system on the same tape and within bounds of the
                CPU run; (c) the capacity row's path (bench.py:1715-1810):
                `run_load` at 256 tenants × 4 symbols vmapped (5 ticks a
                point, cut from 10), card
                against CPU (decisions, vetoes, balances, quarantines),
                its K2 launches held, and `ramp` in both modes (objects to
                8 tenants, vmapped to 256, SLO p99 250 ms); (d) `cli load
                --mode vmapped --tenants 256 --symbols 4` and `cli fleet`
                as subprocesses;
 21. serve    — the operator surface: (a) `TradingSystem` over phase
                live's tape (64 × 4 × 256), 6 ticks from phase trade's
                cursor with devprof, meshprof, tickpath, a fresh kernel
                cache (`aot_cache_dir`) and a `DashboardServer` on port 0,
                tick for tick against the same system with every
                observatory off: returns, status, books, decisions and
                journal bit for bit (the observatories' own alerts, whose
                rules read only observatory state, taken out first); its
                18 K2 launches held against the
                plain EWMA; (b) devprof on the card: the tick_engine card's
                argument/output bytes against its tensors, temp bytes > 0,
                the ring's donation, the allocator watermark, the tick and
                host_read SLO windows; `backtest.sweep` at 256 × 43,200 and
                `run_ga(GAParams(256, 3))` over the same candles under the
                observatory (`backtest_sweep`, `ga_scan` cards, the ga_scan
                layout card), their 5 K1 launches counted, the sweep's and
                the GA's first bit for bit against the plain loop; (c) the sync sentinel armed on the card: 0 over
                the steady ticks, exactly 1 for an `.item()` in a watch
                window, no rebuild after warm-up; (d) every route, the
                /state.json blocks and build, a 3 s `/profile` capture on a
                handler thread while the system ticks (its trace names K2's
                kernel) with a second capture refused, `cli status /
                latency / fleet / mesh --url`; (e) `cli profile --ticks 4`
                beside `cli trade --paper --ticks 2 --aot-cache DIR` twice
                (the second warm: nothing built), as subprocesses running
                beside (a)-(d); (f) the tick p50 with
                every observatory on and off, alternating;
 22. research — the research shell: (a) `cli fetch --days 7` (a
                subprocess) → `cli backtest` (one strategy, then a sweep of
                256, on the card) → `cli list` / `analyze` → `cli report`
                (a subprocess) in a temporary cwd: the backtest's numbers
                those of the fetched series, two runs listed, the best
                Sharpe's file as `best_run`, the HTML written; (b) 16 jobs
                (8 synthetic symbols × 2 parameter sets, 30 days of 1m
                candles each) through `BacktestQueue` on the card with a
                port `EventBus`: one K1 launch a job and the K2 launches
                counted, every record's metrics bit for bit against a
                direct `compute_metrics(evolvable_backtest(...))`, the first
                job's K1 launch bit for bit against the graph-replayed plain
                loop over its whole series and its K2 launches against the
                plain EWMA, ms a job and the queue latency; (c) the
                trade-outcome forest at the reference's defaults (100 trees,
                30 repeats) on 2,000 synthetic trades over the 19
                `FEATURE_GROUPS` features: the host fit's seconds, the
                permutation importance (one batched prediction, one read)
                beside the reference's loop order (571 `predict` calls, a
                read each), the two equal, and both equal to the port's CPU
                run of the same trees (a subprocess from the phase's
                start), probabilities within 1e-6, the two driver features
                ranked first; (d) `SignalAnalyzer.run_once` over phase
                live's tape for 2 ticks with a fitted
                `FeatureImportanceIntegrator` as its outcome gate, the
                signals equal to the port's CPU analyzer's on the same
                updates, the gate's ms a call;
 23. mesh     — the population seams on a `parallel.MeshPartitioner`
                over a virtual mesh of the card 4 times (and, with more
                than one card, over min(4, n) real ones for (a)-(b)): (a)
                the main path's sweep (T = 525,600, B = 4,096) in exactly 4
                K1 launches of 1,024, stats and metrics bit for bit against
                phase main's single launch, no other sync, and a ragged
                4,098 (padded to 4,100) against its single launch; (b)
                `run_ga` at `GAParams(256, 3)` × 43,200 and at a ragged
                250 bit for bit against the single device, (G + 1) · 4 K1
                launches and one host read a run; (c) `TenantEngine` at 256
                (and a ragged 250) tenants × 64 symbols, `lob_sweep` at
                1,024 × 32 levels (32 steps), one `pbt` generation (16
                members, 4 iterations), one `evaluate_structures` call at
                `cli generate`'s fold shape and an HPO farm of 4 trials,
                each against the single device (the HPO farm also over a
                mesh of the card and the CPU: the card's trials bit for
                bit, the draws shared); (d) `time_shard` over the
                year's close against `ops.indicators.ema` (its K2 launches
                held against the plain EWMA) and `rolling_mean`; (e) the
                long-context model at 16,384 × 8 with the ring against its
                dense attention, forward and gradient, with each one's ms
                and peak memory; (f) `initialize_distributed` over NCCL at
                world size 1 in a subprocess started at the phase's start,
                with one `population_eval` and one ring step (forward and
                gradient) through the process mesh over NCCL, then the
                same two on the hybrid mesh of the card twice; (g) after
                the timed parts, 2 rank processes that share the card over
                gloo (a process mesh, `python3 chip_smoke.py --mesh-rank
                RANK PORT DIR` each): the main path's sweep as 2 K1
                launches of 2,048 bit for bit against phase main's, the GA
                at 256 and 250, the pbt generation and the HPO farm bit for
                bit against (b)-(c)'s single device, `time_shard` over the
                year bit for bit against a one-controller mesh of 2, the
                long-context ring within (e)'s tolerances of the dense run;
                then in the same ranks the hybrid mesh over the same group,
                each rank driving the card twice (4 shards): the sweep as 2
                K1 launches of 1,024 a rank, the GA, pbt, HPO farm bit for
                bit as before, `time_shard` bit for bit against (d)'s
                one-controller mesh of 4, the ring as before; each rank's
                parts' seconds, K1/K2 launches (and their times, the two
                ranks contending), the transport's collectives, bytes and
                staging copies, the ring's peak memory;
 24. kernels  — one line with each kernel's launches, error, times and
                bound, at the main path's shapes, and each kernel's GA,
                tick, portfolio, tenant, `cli train`, training, RL,
                simulator, regime, strategy, live, trade, stack, stream,
                serve, research and mesh launches (`ga_tables`, `ga_rows`,
                `tick`, `portfolio`, `tenant`, `nn_cli_train`, `nn_train`,
                `rl`, `sim`, `regime`, `strategy`, `live`, `trade`,
                `stack`, `stream`, `serve`, `research`, `mesh`).

Every phase's seconds follow it on a line of their own
(``{"phase_time": ..., "phase_s": ...}``), and the script's total and every
phase's seconds on one line before the kernels line.  The kernels build
and load in the provenance-keyed cache directory under ``.torch_kernels/``
that the CLI's card commands use (`utils.cache`).  Any failed check raises,
so the script exits non-zero and never prints its last line,
``{"ok": true, "device": {...}}``.  Times are CUDA-event times
on the card; the bound of a kernel is the larger of its bytes over 3.35 TB/s
and its operations over 67 TFLOP/s (the H100 SXM's HBM rate and float32
rate outside the tensor cores, at the full 700 W power limit).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings

T_FULL = 525_600          # one year of 1-minute candles (bench.py:2051)
B_FULL = 4096             # strategies on one chip (bench.py:2054)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# operations the replay needs (counted from csrc/replay_sweep.cu): the entry
# gate once per candle; the SL/TP test (sub, div, mul, two compares) on each
# in-position candle and strategy; per close the bookkeeping and its equity
# point, per entry the sizer.  The bound of a replay that steps every candle
# and strategy (REPLAY_OPS_STEP each) is printed beside it.
REPLAY_OPS_GATE, REPLAY_OPS_EXIT = 6, 5
REPLAY_OPS_CLOSE, REPLAY_OPS_ENTRY, REPLAY_OPS_BOOK = 6, 16, 10
REPLAY_OPS_STEP = 12
CURVE_B = 256             # strategies whose full-T curve is checked
T_GA, POP_GA, GENS_GA = 43_200, 256, 3   # the bench's GA row (bench.py:1945-1949)
GA_CURVE_B = 32           # strategies whose curve the rows checks hold
S_TICK, T_TICK = 64, 256  # the bench's tick_pipeline row (bench.py:1323-1337)
TICK_FRAMES = ("1m", "3m", "5m", "15m")
TICK_POLLS = 20
LIVE_TICKS = 6            # ticks of the live path (phase live; cut from 20, 10 until PR 17)
LIVE_PIPE_TICKS = 5       # its pipelined monitor's ticks against the serial run's
S_PORT = 8                # portfolio symbols
T_PORT_K1, T_PORT_PLAIN = 8192, 512    # K1's check; the plain-loop modes (depth cut; 1,024
                                        # until PR 18)
N_TENANT = 256            # the capacity row's vmapped tenant cap (bench.py:1734)
S_CAP = 4                 # the capacity row's symbols (bench.py:1735)
TENANT_POLLS = 20
MC_SIMS, MC_DAYS, MC_PRICE = 10_000, 30, 40_000.0   # bench.py:837-866
MC_CALLS = 20
MC_RTOL = 1e-5
STOP_GRID, STOP_PRICES = (256, 64), 20
NN_UNITS, NN_SEQ = 64, 60          # build_model's defaults, the service's window
NN_CALLS = 10                      # calls or rounds a p50/p99 takes (depth cut from 20)
NN_ATOL, NN_RTOL = 1e-5, 1e-5      # scaled outputs / probabilities; prices
CLI_TRAIN_COLUMNS = ("close", "volume", "rsi", "macd", "bb_position", "stoch_k", "atr")
TRAIN_B, TRAIN_F, TRAIN_BATCHES = 32, 8, 32   # the bench's nn row (bench.py:1154-1262)
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-5  # epoch losses; parameters (card against the CPU)
LSTM_GRAD_RTOL = 1e-5                # LSTMScan's gradients against the plain loop's, of scale
CLI_TRAIN_EPOCHS = 1                 # cli train's 5 epochs, cut (2 until PR 17)
SVC_SYMBOLS, SVC_ROWS = 8, 256       # the service's pairs: symbols × (1m, 5m); kline rows
SVC_EPOCHS = 3                       # the service's epochs (its default 20, cut; 5 until PR 19)
IMPORTANCE_WINDOWS, IMPORTANCE_STEPS, IMPORTANCE_ATOL = 64, 32, 1e-5
RL_EPISODE, RL_ENVS, RL_ROLLOUT, RL_ITERS = 512, 256, 32, 20   # the bench's rl row (bench.py:695-723)
PBT_S, PBT_T, PBT_EPISODE = 16, 1024, 256      # the pbt row's markets (bench.py:746-747)
PBT_P, PBT_G, PBT_I, PBT_EVAL = 16, 3, 64, 4    # its fleet (bench.py:739-767)
CLI_RL_GENS = 1                # `cli rl --generations` (its default 4, cut; 2 until PR 17)
RL_ATOL = 1e-5                 # parameters, target, moments: the card against the CPU
RL_TIE_RTOL = 1e-5             # a differing greedy action is a near-tie within this of scale
ULP = 2.0 ** -24
LOB_LEVELS = 32
SIM_B, SIM_T, SIM_LOG = 4096, 512, 128      # the bench's sim_sweep row (bench.py:883-884)
SIM_CPU_B = 256                              # its first scenarios rolled out again on the CPU
LOB_B, LOB_T = 1024, 256                     # the bench's lob_events_per_sec row (bench.py:922-924)
STRESS_B, STRESS_T, STRESS_P = 256, 1024, 64  # backtest_under_stress's defaults; a population
SIM_REPS = 1                                 # timed calls a row (cut from 3; 2 until PR 18)
SIM_Q0 = 10_000.0                            # the rollouts' quote balance
SVC_TICKS, SVC_ITERS = 4, 4                  # the trainer service: ticks; iterations (depth cut;
                                             # 8 iterations until PR 19)
REC_P, REC_S, REC_T, REC_EPISODE, REC_ITERS = 8, 8, 512, 128, 4   # pbt_recovery (bench.py:1087-1150)
REGIME_S, REGIME_T, REGIME_ROUNDS = 64, 1000, 3   # tick universe; the venue's klines cap;
                                                  # rounds (5 until PR 19)
REGIME_TIE_RTOL = 1e-3                       # a card-vs-CPU label flip's margin to a tie
BOOK_N, BOOK_LEVELS, BOOK_FRAMES = 64, 100, 1024  # books; the venue's default depth; window
GEN_DAYS, GEN_SEED, GEN_FOLDS, GEN_POOL = 7, 0, 3, 16   # cli generate's defaults (cli.py:1101-1107)
GEN_CLI_ROUNDS = 1                           # `cli generate --rounds` (default 6; 2 until PR 17)
GEN_SHORT_T = 256                            # the short folds torch.profiler traces
FLIP_MARGIN = 1e-4                           # a K2 signal flip's distance to its threshold
T_CV, CV_K, CMP_S = 43_200, 5, 8             # cross_validate's and compare_strategies' cases
LC_F, LC_T, LC_T_CPU = 8, 16_384, 2_048      # the long-context model: features, T, CPU check
LC_ATOL, LC_GRAD_RTOL = 1e-5, 1e-4           # outputs; gradients, of each parameter's scale
SOC_T, SOC_F, SOC_LAG = 720, 8, 24           # 30 days of hourly social metrics
SOC_RTOL = 1e-4                              # anomaly scores, card against CPU
SHARED = {}               # what an earlier phase leaves for phase mesh


# per element and output of the EWMA: the element map (select, multiply)
# and the recursion (multiply, add) and the NaN mask
EWMA_OPS = 5


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs, after one warm
    run.  The stream first spins for ~50 ms (``torch.cuda._sleep``), so the
    host has enqueued the runs before the card reaches the start event: a
    short kernel is timed on the card alone, not at the host's enqueue rate.
    (Work whose enqueue outlasts the spin, as the plain loop's, is timed
    with the host's gaps in it.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi[0] if smi else None,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def refused_launch_raises():
    """A launch the C entry refuses (a job of K = 0 series maps) must raise
    in the wrapper's check, not pass silently."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import _cuda, ewma

    lib = _cuda.library("fused_ewma", ewma._SIGNATURES)
    x = torch.zeros((1, 16), device="cuda")
    ptr = lambda ctype, v: ctypes.cast((ctype * 1)(v), ctypes.c_void_p)  # noqa: E731
    zeros = ctypes.cast((ctypes.c_float * ewma.MAX_K)(), ctypes.c_void_p)
    rc = lib.fused_ewma_launch(
        1, ptr(ctypes.c_void_p, x.data_ptr()), ptr(ctypes.c_void_p, x.data_ptr()),
        ptr(ctypes.c_longlong, 16), ptr(ctypes.c_int, 1), ptr(ctypes.c_int, 0),
        ptr(ctypes.c_int, 0), zeros, zeros, x.data_ptr(), _cuda.stream_handle(x.device))
    try:
        _cuda.check(lib, "fused_ewma", rc)
    except RuntimeError as e:
        return str(e)
    fail("a refused kernel launch did not raise")


def resource_usage(path):
    """cuobjdump's registers and shared memory per kernel of a library (a
    diagnostic: the build does not depend on it)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", str(path)],
                         capture_output=True, text=True, timeout=60)
    kernels, name = [], None
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function"):
            name = line[len("Function"):].strip(" :")
        elif "REG:" in line:
            kernels.append({"function": name, "usage": line})
    return {"rc": out.returncode, "kernels": kernels}


def usage(report, library, fragment):
    """cuobjdump's whole resource line (registers, stack, static shared
    memory) of the first kernel of ``library`` whose name holds ``fragment``."""
    for k in report[library]["resources"]["kernels"]:
        if fragment in (k["function"] or ""):
            return k["usage"]
    return None


def registers(report, library, fragment):
    """REG of the first kernel of ``library`` whose name holds ``fragment``."""
    line = usage(report, library, fragment)
    return None if line is None else int(line.split("REG:")[1].split()[0])


def phase_build():
    from ai_crypto_trader_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    report = _cuda.build()
    libraries = {k: {**v, "resources": resource_usage(_cuda.library_path(k))}
                 for k, v in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libraries, "refused_launch": refused_launch_raises()})
    return libraries


def ewma_check(jobs, label):
    """One kernel launch over ``jobs`` [(name, x, alphas, start)] against
    the plain version of each job, and against a second launch of the same
    inputs, which must give the same bits.  Values must satisfy
    |kernel - plain| <= 1e-3 + 2e-5 * S, S = the plain EWMA of |x|: the
    magnitude the recursion sums, which is |plain| for a series of one sign
    (the tolerance of tests/test_pallas.py:23).  For a signed series the
    output can pass through zero while its rounding stays that of S."""
    import torch

    from ai_crypto_trader_tpu_torch.ops.ewma import (
        fused_ewma, fused_ewma_jobs, fused_ewma_plain, launch_plan, tile_count)

    args = [(x, alphas, start) for _, x, alphas, start in jobs]
    before = fused_ewma.launches
    got = fused_ewma_jobs(args, device="cuda")
    again = fused_ewma_jobs(args, device="cuda")
    torch.cuda.synchronize()
    if fused_ewma.launches != before + 2:
        fail(f"ewma {label}: a job list took {fused_ewma.launches - before} launches for 2 calls")
    out = []
    for (name, x, alphas, start), g, g2 in zip(jobs, got, again):
        if not same_bits(g, g2):
            fail(f"ewma {label}/{name}: two launches of the same input differ")
        ref = fused_ewma_plain(x, alphas, start)
        scale = fused_ewma_plain(torch.abs(x), alphas, start)
        nan_g, nan_r = torch.isnan(g), torch.isnan(ref)
        if not torch.equal(nan_g, nan_r):
            fail(f"ewma {label}/{name}: NaN masks differ")
        diff = torch.where(nan_r, 0.0, torch.abs(g - ref))
        sc = torch.where(nan_r, 0.0, scale)
        bad = diff > 1e-3 + 2e-5 * sc
        if bool(bad.any()):
            fail(f"ewma {label}/{name}: {int(bad.sum())} values outside 1e-3 + 2e-5*S")
        strict_bad = diff > 1e-3 + 2e-5 * torch.where(nan_r, 0.0, torch.abs(ref))
        rel = diff / torch.clamp_min(sc, 1e-30)
        out.append({"job": name, "shape": list(x.shape), "K": len(alphas), "start": start,
                    "max_abs_err": float(diff.max()), "max_rel_err": float(rel.max()),
                    "outside_rtol_of_value": int(strict_bad.sum())})
    return {"case": label, "jobs": out, "repeat_bitwise_equal": True,
            "plan": launch_plan(tile_count([x.shape for _, x, _, _ in jobs]),
                                max(len(a) for _, _, a, _ in jobs))}


def ewma_bound(jobs):
    """(bytes ms, operations ms) of jobs: x read once, K outputs written
    once, EWMA_OPS float32 operations per element and output."""
    n_bytes = sum(4 * x.numel() * (1 + len(a)) for _, x, a, _ in jobs)
    ops = sum(EWMA_OPS * len(a) * x.numel() for _, x, a, _ in jobs)
    return 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S


def phase_ewma(d, libraries):
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.ops import indicators as ind
    from ai_crypto_trader_tpu_torch.ops.ewma import (
        TILE_LEN, barrier_launch, fused_ewma_jobs, fused_ewma_plain, tile_count)

    close = torch.as_tensor(d["close"], device="cuda")
    high = torch.as_tensor(d["high"], device="cuda")
    low = torch.as_tensor(d["low"], device="cuda")
    e12, e26 = fused_ewma_plain(close[None], [2 / 13, 2 / 27], 0)[:, 0]
    line = ind._mask_warmup(e12 - e26, 26)
    up, dn = ind._rsi_moves(close)
    tr = ind.true_range(high, low, close)
    # the two launches of compute_indicators, on its own inputs
    main = {"A": [("close", close[None], [2 / 13, 2 / 27], 0),
                  ("rsi_atr", torch.stack([up, dn, tr]), [1 / 14], 1)],
            "B": [("macd_signal", line[None], [0.2], 25)]}
    checks, launches = [], {}
    bytes_ms = ops_ms = 0.0
    for name, jobs in main.items():
        checks.append(ewma_check(jobs, f"main_{name}"))
        args = [(x, a, s) for _, x, a, s in jobs]
        b_ms, o_ms = ewma_bound(jobs)
        bytes_ms, ops_ms = bytes_ms + b_ms, ops_ms + o_ms
        n_tiles = tile_count([x.shape for x, _, _ in args])
        kmax = max(len(a) for _, a, _ in args)
        # the floors under a launch: its grid crossing the barrier alone, and
        # a device copy of the same bytes (one torch copy per job: x read,
        # K outputs written)
        outs = [torch.empty((len(a),) + tuple(x.shape), device="cuda") for x, a, _ in args]
        copy = lambda: [o.copy_(x.expand_as(o)) for o, (x, _, _) in zip(outs, args)]  # noqa: E731
        launches[name] = {
            "jobs": [j[0] for j in jobs],
            "ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 50),
            "barrier_only_ms": cuda_ms(lambda: barrier_launch(n_tiles, kmax), 50),
            "copy_same_bytes_ms": cuda_ms(copy, 50), "copy_kernels": len(args),
            "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, s), 3) for x, a, s in args),
            "bound_ms": max(b_ms, o_ms), "plan": checks[-1]["plan"]}
        del outs, copy
    ms = sum(v["ms"] for v in launches.values())
    plain_ms = sum(v["plain_ms"] for v in launches.values())
    main_err = max(j["max_abs_err"] for c in checks for j in c["jobs"])
    main_rel = max(j["max_rel_err"] for c in checks for j in c["jobs"])

    rng = np.random.default_rng(1234)
    walk = lambda B, T: torch.as_tensor(  # noqa: E731
        (100.0 + np.cumsum(rng.normal(0, 1, (B, T)), axis=1)).astype(np.float32), device="cuda")
    ragged = torch.as_tensor(rng.normal(100, 5, (5, 1000)).astype(np.float32), device="cuda")
    for start in (0, 1, 25):
        checks.append(ewma_check([("ragged", ragged, [2 / 13, 2 / 27, 1 / 14], start)],
                                 f"ragged_start{start}"))
    checks.append(ewma_check(
        [("T37", walk(3, 37), [0.5], 0), ("T4097", walk(2, TILE_LEN + 1), [2 / 13, 0.01], 1),
         ("seed_past_tile", walk(1, 3 * TILE_LEN + 5), [1 / 14], TILE_LEN + 904),
         ("K8", walk(2, 9001), [2 / (n + 1) for n in range(2, 10)], 25)], "ragged_jobs"))
    # beyond what the co-resident blocks keep in shared memory: x is read
    # again for the tiles that pass through the transient slot
    big = [("B64", walk(64, T_FULL), [2 / 13, 2 / 27], 0)]
    checks.append(ewma_check(big, "beyond_residency"))
    if checks[-1]["plan"]["resident"]:
        fail("ewma beyond_residency: the launch kept every tile resident")
    big_args = [(x, a, s) for _, x, a, s in big]
    beyond = {"shape": [64, T_FULL], "K": 2, "plan": checks[-1]["plan"],
              "ms": cuda_ms(lambda: fused_ewma_jobs(big_args, device="cuda"), 10),
              "bound_ms": max(ewma_bound(big))}
    del big, big_args
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    result = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "launches": launches, "max_abs_err": main_err, "max_rel_err": main_rel,
              "beyond_residency": beyond,
              "registers": registers(libraries, "fused_ewma", "ewma_tiles"),
              "shared_memory": usage(libraries, "fused_ewma", "ewma_tiles")}
    emit({"phase": "ewma", "checks": checks, **result})
    return result


def replay_bound_ms(stats, B, T, warmup=10):
    """Least time for the replay at B × T on this run's data: the stream
    bytes read once and the stats written once, or the operations the data
    needed — the gate once per candle, the SL/TP test on every in-position
    candle (B·(T − warmup) − Σ(n_r − 1) that survive, and one per close),
    and each close and entry.  Also the bound of a replay that steps every
    candle and strategy: (ms, by, stepped_ms)."""
    trades = int(stats.total_trades.sum())
    books = int((stats.n_r - 1).sum())
    survived = B * (T - warmup) - books
    ops = (REPLAY_OPS_GATE * T + REPLAY_OPS_EXIT * (survived + trades)
           + (REPLAY_OPS_CLOSE + REPLAY_OPS_BOOK + REPLAY_OPS_ENTRY) * trades)
    stepped_ops = (REPLAY_OPS_STEP * B * T + (REPLAY_OPS_CLOSE + REPLAY_OPS_ENTRY) * trades
               + REPLAY_OPS_BOOK * books)
    n_bytes = 9 * 4 * T + 2 * 4 * B + 14 * 4 * B
    ms, by = max((n_bytes / HBM_BYTES_PER_S, "bytes"), (ops / F32_OPS_PER_S, "operations"))
    stepped_ms = max(n_bytes / HBM_BYTES_PER_S, stepped_ops / F32_OPS_PER_S)
    return 1e3 * ms, by, 1e3 * stepped_ms


def sweep_plain_graphed(inputs, params, steps=32, initial_balance=10_000.0,
                        ai_confidence_threshold=0.7, min_signal_strength=70.0,
                        warmup=10, curve_b=0):
    """`sweep_plain` — the engine's loop of `replay_step` in use_param_sl_tp
    mode — with ``steps`` candles of it captured in one CUDA graph and the
    graph replayed over T (the last T mod ``steps`` candles run eagerly).
    The ops and their order are the eager loop's, and so are the bits
    (phase 3 checks it); the card just stops waiting on the host, which
    issues the eager loop one op at a time and would take a quarter of an
    hour over 525,600 candles.  With ``curve_b`` the graph also writes the
    equity of the first ``curve_b`` strategies: (stats, curve [curve_b, T])."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import engine

    dev = inputs.close.device
    T, B = int(inputs.close.shape[-1]), int(params.stop_loss.shape[0])
    step = engine.replay_step(
        params, warmup=warmup, ai_confidence_threshold=ai_confidence_threshold,
        min_signal_strength=min_signal_strength, reference_quirks=False,
        use_param_sl_tp=True, return_curve=True, sell_exits=False)
    state = engine._init_state(initial_balance, (B,), dev)
    curve = torch.empty((curve_b, T), dtype=torch.float32, device=dev)
    t0 = torch.zeros((), dtype=torch.long, device=dev)
    offsets = torch.arange(steps, device=dev)

    def chunk():
        idx = t0 + offsets
        cols = [x.index_select(-1, idx) for x in inputs]
        s, equity = state, []
        for k in range(steps):
            s, eq = step(s, (idx[k],) + tuple(c[..., k] for c in cols))
            equity.append(eq[:curve_b])
        if curve_b:
            curve.index_copy_(1, idx, torch.stack(equity, 1))
        for dst, src in zip(state, s):
            dst.copy_(src)
        t0.add_(steps)

    side = torch.cuda.Stream(dev)               # warm-up off the capture
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chunk()
    torch.cuda.current_stream(dev).wait_stream(side)
    for dst, src in zip(state, engine._init_state(initial_balance, (B,), dev)):
        dst.copy_(src)
    t0.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chunk()
    n = T // steps
    for _ in range(n):
        graph.replay()
    s = state
    for t in range(n * steps, T):
        s, eq = step(s, (t,) + tuple(x[..., t] for x in inputs))
        curve[:, t] = eq[:curve_b]
    stats = engine.finalize_stats(s, inputs.close[..., -1], initial_balance)
    return (stats, curve) if curve_b else stats


def same_bits(g, r):
    """float32 tensors equal bit for bit."""
    import torch

    return g.shape == r.shape and torch.equal(g.contiguous().view(torch.int32),
                                              r.contiguous().view(torch.int32))


def compare_stats(got, ref, label, curve=None, ref_curve=None):
    """Every stat bit-identical (counts equal, floats equal bit for bit), and
    the curves too where given, and trades > 0."""
    import torch

    worst = 0.0
    for f in ref._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if r.dtype == torch.int32:
            if not torch.equal(g, r):
                fail(f"replay {label}: {f} differs in {int((g != r).sum())} strategies")
        else:
            worst = max(worst, float(torch.abs(g - r).max()))
            if not same_bits(g, r):
                fail(f"replay {label}: {f} not bit-identical (max abs err {worst})")
    out = {"case": label, "B": int(ref.total_trades.numel()),
           "trades": int(ref.total_trades.sum()), "max_abs_err": worst}
    if ref_curve is not None:
        if not same_bits(curve, ref_curve):
            fail(f"replay {label}: the curve is not bit-identical (max abs err "
                 f"{float(torch.abs(curve - ref_curve).max())})")
        out["curve_max_abs_err"] = float(torch.abs(curve - ref_curve).max())
    if out["trades"] <= 0:
        fail(f"replay {label}: no trades — the parity would be vacuous")
    return out


def timed(fn):
    """``fn()`` once between two CUDA events: (its result, ms)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def replay_check(inputs, params, label, **kw):
    """The kernel, both variants, against the engine's eager plain loop on
    the card, stats and curve; the plain loop's time rides along."""
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel, sweep_plain

    got = sweep_kernel(inputs, params, device="cuda", **kw)
    got_c, curve = sweep_kernel(inputs, params, device="cuda", return_curve=True, **kw)
    (ref, ref_curve), plain_ms = timed(
        lambda: sweep_plain(inputs, params, return_curve=True, **kw))
    compare_stats(got_c, ref, label + "/curve_variant", curve, ref_curve)
    check = {**compare_stats(got, ref, label), "T": int(inputs.close.shape[-1]),
             "curve_max_abs_err": 0.0}
    return check, (ref, ref_curve), plain_ms


def ewma_plain(x, alphas, start=0, device=None):
    """`ops.ewma.fused_ewma` through its plain version on any device (no
    kernel launch): what the flip phases patch in for every EWMA entry."""
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma_plain

    lead, T = x.shape[:-1], x.shape[-1]
    out = fused_ewma_plain(x.reshape(-1, T), alphas, start)
    return out.reshape((out.shape[0],) + tuple(lead) + (T,))


def jobs_plain(jobs, device=None):
    """`ops.ewma.fused_ewma_jobs` through the plain version."""
    return [ewma_plain(x, alphas, start) for x, alphas, start in jobs]


@contextlib.contextmanager
def recording_ewma(launches):
    """Every EWMA entry compute_indicators calls, patched to record each
    call's jobs [(x, alphas, start)] into ``launches`` before it runs."""
    from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod

    entries = {"fused_ewma": ind_mod.fused_ewma, "fused_ewma_jobs": ind_mod.fused_ewma_jobs}

    def recording(name):
        def call(*args, **kw):
            jobs = args[0] if name == "fused_ewma_jobs" else [(args[0], args[1], args[2])]
            launches.append([(x, a, st) for x, a, st in jobs])
            return entries[name](*args, **kw)
        return call

    ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = recording("fused_ewma"), recording("fused_ewma_jobs")
    try:
        yield launches
    finally:
        ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = entries["fused_ewma"], entries["fused_ewma_jobs"]


@contextlib.contextmanager
def plain_ewma(label):
    """Every EWMA entry of `ops.indicators` (which compute_indicators and
    the combination scores call) patched to the plain version; fails if K2
    launched inside."""
    from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    entries, before = (ind_mod.fused_ewma, ind_mod.fused_ewma_jobs), fused_ewma.launches
    ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = ewma_plain, jobs_plain
    try:
        yield
    finally:
        ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = entries
    if fused_ewma.launches != before:
        fail(f"{label}: the plain table launched K2 {fused_ewma.launches - before} times")


def plain_table(ohlcv, label):
    """`compute_indicators` on the card with every EWMA entry it calls
    patched to the plain version; fails if that table launched K2."""
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    with plain_ewma(label):
        return compute_indicators(ohlcv, device="cuda")


def signal_flips(tab_k, tab_p, phase):
    """The flips that K2's rounding makes where the backtest reads it, over
    two indicator tables of any leading shape (``tab_k`` with K2's EWMAs,
    ``tab_p`` with the plain version's): every candle whose signal,
    decision, strength gate (>= 70) or sizer bucket differs, each marked
    far if it sits farther than 1e-4 from a threshold on its input's scale
    (`phase_flips` states the rule).  Returns (report, inputs from
    ``tab_k``, inputs from ``tab_p``); `hold_flips` fails on the report."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import compute_signal_features, prepare_inputs

    inp_k, inp_p = (prepare_inputs(t, device="cuda") for t in (tab_k, tab_p))
    f = compute_signal_features(tab_p)
    n = int(f.close.numel())
    near_macd = torch.abs(f.macd) <= 1e-4 * f.close
    near_rsi = torch.minimum(torch.abs(f.rsi - 35.0), torch.abs(f.rsi - 45.0)) <= 1e-2
    near_str = torch.abs(inp_p.strength - 70.0) <= 1e-2
    vol_p, vol_k = inp_p.volatility, inp_k.volatility
    near_vol = torch.minimum(torch.abs(vol_p - 0.01) / 0.01,
                             torch.abs(vol_p - 0.02) / 0.02) <= 1e-4
    sig_flip = inp_k.signal != inp_p.signal
    kinds = {
        "signal": (sig_flip, near_macd | near_rsi),
        "decision": (inp_k.decision != inp_p.decision, near_macd | near_rsi),
        "strength_gate": (~sig_flip & ((inp_k.strength >= 70.0) != (inp_p.strength >= 70.0)),
                          near_macd | near_rsi | near_str),
        "sizer_bucket": (((vol_k > 0.02) != (vol_p > 0.02)) | ((vol_k > 0.01) != (vol_p > 0.01)),
                         near_vol),
    }
    entry = lambda i: (i.signal == i.decision) & (i.decision == 1) & (i.strength >= 70.0)  # noqa: E731
    report = {"phase": phase, "candles": n, "limit_per_kind": n // 1000,
              "plain_table_launches": 0,
              "entry_gate_differs": int((entry(inp_k) != entry(inp_p)).sum())}
    flat = lambda x: x.reshape(-1)  # noqa: E731
    for kind, (diff, near) in kinds.items():
        where = torch.nonzero(flat(diff)).flatten()
        report[kind] = {
            "count": int(where.numel()), "far_from_threshold": int((diff & ~near).sum()),
            "examples": [{"at": int(t), "close": float(flat(f.close)[t]),
                          "macd": float(flat(f.macd)[t]), "rsi": float(flat(f.rsi)[t]),
                          "strength": [float(flat(inp_p.strength)[t]),
                                       float(flat(inp_k.strength)[t])],
                          "volatility": float(flat(vol_p)[t])} for t in where[:3]]}
    return report, inp_k, inp_p


def hold_flips(report, label):
    """Fail if a flip of ``report`` sits far from its threshold, or a kind
    has more than one flip in 1,000 candles."""
    for kind in ("signal", "decision", "strength_gate", "sizer_bucket"):
        if report[kind]["far_from_threshold"]:
            fail(f"{label}: {report[kind]['far_from_threshold']} {kind} differences "
                 "sit farther than 1e-4 from any threshold")
        if report[kind]["count"] > report["limit_per_kind"]:
            fail(f"{label}: {report[kind]['count']} {kind} differences, over one in 1,000 "
                 "candles")


def phase_flips(d, params):
    """K2's rounding where the backtest reads it.  The kernel composes a
    chunk's affine maps in another order than `fused_ewma_plain`, which
    replays the JAX package's scan tree bit for bit.  MACD (two EMAs that
    nearly cancel) and RSI feed the signal's votes and its strength, and
    ATR the sizer's volatility buckets.  The year's table is built twice on
    the card, its EMA family once through the kernel and once through the
    plain version.  Every candle whose signal, strength gate (>= 70) or
    sizer bucket differs must sit within 1e-4 of a threshold on its input's
    scale — |macd| <= 1e-4·close (the vote is macd > 0, and the strength
    term min(|macd|, 1)·20 moves only below 1, which is below 1e-4 of any
    price here), RSI within 1e-2 of 35 or 45, strength within 1e-2 of 70,
    volatility within a relative 1e-4 of 0.01 or 0.02 — and each kind must
    be rare: at most one candle in 1,000.  The sweep over both inputs then
    counts the strategies that the differences change (reported only)."""
    from ai_crypto_trader_tpu_torch.backtest import sweep
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    tab_k = compute_indicators(d, device="cuda")
    tab_p = plain_table(d, "ewma flips")
    report, inp_k, inp_p = signal_flips(tab_k, tab_p, "ewma_flips")
    report["T"] = report["candles"]
    st_k, st_p = (sweep(i, params, device="cuda") for i in (inp_k, inp_p))
    report["strategies_changed"] = int(((st_k.total_trades != st_p.total_trades)
                                        | (st_k.final_balance != st_p.final_balance)).sum())
    report["strategies"] = int(params.stop_loss.shape[0])
    emit(report)
    hold_flips(report, "ewma flips")
    return report


def exact_tie(inp, e1=500, keep_from=2000):
    """Entries only at two candles (and from ``keep_from`` on, as the
    signals have them): at e1 a TP override equal to the float32 pnl% of a
    later candle x1, computed on the card with replay_step's operands, and
    SL out of reach; at e2 = x1 + 50 an SL override equal to minus the pnl%
    of a later candle x2.  Both exits are hit with equality.  Returns the
    inputs and (x1, x2)."""
    import torch

    close = inp.close
    c = close.cpu().numpy()

    def extreme(e, sign, nth):   # the nth new strict extreme after e
        best, found = sign * c[e], 0
        for t in range(e + 1, len(c)):
            if sign * c[t] > best:
                best, found = sign * c[t], found + 1
                if found == nth:
                    return t
        fail("exact tie: no such candle")

    x1 = extreme(e1, 1, 6)
    e2 = x1 + 50
    x2 = extreme(e2, -1, 4)
    if x2 >= keep_from:
        fail("exact tie: the second exit runs into the free entries")
    pnl = lambda e, t: (close[t] - close[e]) / close[e] * 100.0  # noqa: E731
    t = torch.arange(close.shape[0], device=close.device)
    hot = (t == e1) | (t == e2)
    sig = torch.where(hot, 1, torch.where(t >= keep_from, inp.signal, 0)).to(torch.int32)
    sl = torch.full_like(close, float("nan"))
    tp = torch.full_like(close, float("nan"))
    tp[e1], sl[e1] = pnl(e1, x1), 1e6
    sl[e2], tp[e2] = -pnl(e2, x2), 1e6
    return inp._replace(signal=sig, decision=sig, strength=torch.where(hot, 100.0, inp.strength),
                        sl_pct=sl, tp_pct=tp), (x1, x2)


def phase_replay(main_inputs, params, d_small):
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        default_params, prepare_inputs, run_backtest, sample_params)
    from ai_crypto_trader_tpu_torch.backtest.engine import replay
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    inputs_of = lambda n: prepare_inputs(  # noqa: E731
        compute_indicators(d_small(n), device="cuda"), device="cuda")
    T_HEAD = 2048            # cut from 8192 (4096 until PR 18): the eager loop's 2 ms a candle
    head = type(main_inputs)(*(x[:T_HEAD] for x in main_inputs))
    c, (ref_head, ref_curve), head_plain_ms = replay_check(head, params, "main_head")
    checks = [c]
    (graphed, graphed_curve), head_graphed_ms = timed(
        lambda: sweep_plain_graphed(head, params, curve_b=CURVE_B))
    for f in ref_head._fields:
        if not torch.equal(getattr(graphed, f), getattr(ref_head, f)):
            fail(f"the graph-replayed plain loop differs from the eager one in {f}")
    if not same_bits(graphed_curve, ref_curve[:CURVE_B]):
        fail("the graph-replayed plain loop's curve differs from the eager one's")
    head_ms = cuda_ms(lambda: sweep_kernel(head, params, device="cuda"), 10)

    checks.append(replay_check(inputs_of(1500), sample_params(gen(), 130, device="cuda"),
                               "B130_T1500")[0])

    inp = inputs_of(900)
    rng = np.random.default_rng(1)
    mask = torch.as_tensor(rng.random(900) < 0.33, device="cuda")
    conf = torch.where(torch.arange(900, device="cuda") % 3 == 0, 0.9, 0.2)
    inp = inp._replace(sl_pct=torch.where(mask, 1.5, torch.nan),
                       tp_pct=torch.where(mask, 3.0, torch.nan), confidence=conf)
    checks.append(replay_check(inp, sample_params(gen(), 32, device="cuda"),
                               "T900_overrides_gated")[0])

    inp = inputs_of(3000)
    p32 = sample_params(gen(), 32, device="cuda")
    for label, v in (("tiny_sl_tp_1e-4", 1e-4), ("huge_sl_tp_1e6", 1e6)):
        full = torch.full((32,), v, dtype=torch.float32, device="cuda")
        c, (ref, _), _ = replay_check(inp, p32._replace(stop_loss=full, take_profit=full), label)
        if v > 1 and not bool((ref.total_trades == 1).all()):
            fail("huge SL/TP: a position closed before the end of the test")
        if v < 1 and int(ref.total_trades.min()) <= 100:
            fail("tiny SL/TP: positions did not close on the next candle")
        checks.append(c)
    tie, exits = exact_tie(inp)
    c, (_, curve), _ = replay_check(tie, p32, "exact_tie")
    for x in exits:
        if not bool((curve[:, x] != curve[:, x - 1]).all()):
            fail(f"exact tie: not every strategy closed at candle {x}")
    checks.append({**c, "tie_exits": list(exits)})

    T_R = 4 * 1024 + 7       # ragged (cut from 32·1024 + 7, 8·1024 + 7 until PR 18: the
                             # eager loop's 2 ms a candle)
    checks.append(replay_check(inputs_of(T_R), sample_params(gen(), 256, device="cuda"),
                               f"ragged_T{T_R}_warmup2000", warmup=2000)[0])

    # run_backtest's param-SL/TP mode: one strategy through the kernel
    dp = default_params(device="cuda")
    before = sweep_kernel.launches
    got, curve = run_backtest(head, dp, use_param_sl_tp=True, return_curve=True, device="cuda")
    if sweep_kernel.launches != before + 1:
        fail("run_backtest(use_param_sl_tp=True) did not launch the replay kernel")
    if got.total_trades.shape != () or curve.shape != (T_HEAD,):
        fail(f"run_backtest shapes changed: {tuple(got.total_trades.shape)}, "
             f"{tuple(curve.shape)}")
    (ref, ref_c), _ = timed(lambda: replay(head, dp, use_param_sl_tp=True, return_curve=True))
    checks.append({**compare_stats(got, ref, f"run_backtest_B1_T{T_HEAD}", curve, ref_c),
                   "T": T_HEAD})
    emit({"phase": "replay", "checks": checks, "graphed_plain_bit_identical": True,
          "head": {"B": B_FULL, "T": T_HEAD, "ms": head_ms, "plain_ms": head_plain_ms,
                   "graphed_plain_ms": head_graphed_ms}})
    return checks


def run_main_path(d):
    """compute_indicators → prepare_inputs → sample_params → sweep →
    compute_metrics on the card, each stage between CUDA events."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        compute_metrics, prepare_inputs, sample_params, sweep)
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    names = ("indicators", "prepare_inputs", "sample_params", "sweep", "metrics")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    ind = compute_indicators(d, device="cuda")
    ev[1].record()
    inp = prepare_inputs(ind, device="cuda")
    ev[2].record()
    params = sample_params(torch.Generator().manual_seed(0), B_FULL, device="cuda")
    ev[3].record()
    stats = sweep(inp, params, device="cuda")
    ev[4].record()
    metrics = compute_metrics(stats, device="cuda")
    ev[5].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stage_ms = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    return inp, params, stats, metrics, stage_ms, wall


def phase_main(d):
    import torch

    from ai_crypto_trader_tpu_torch.backtest import BacktestStats, sweep
    from ai_crypto_trader_tpu_torch.ops import replay
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    run_main_path(d)                                   # warm run
    fused_ewma.launches = 0
    sweep_kernel.launches = 0
    inp, params, stats, metrics, stage_ms, wall = run_main_path(d)
    launches = {"fused_ewma": fused_ewma.launches,
                "replay_sweep": sweep_kernel.launches}
    if launches["fused_ewma"] != 2 or launches["replay_sweep"] < 1:
        fail(f"the main path did not go through both kernels as planned "
             f"(2 EWMA launches, the replay at least once): {launches}")
    for k, v in metrics.items():
        if v.shape not in ((), (B_FULL,)) or not bool(torch.isfinite(v).all()):
            fail(f"metric {k} is not finite of shape [{B_FULL}]")
    trades = int(stats.total_trades.sum())
    if trades <= 0:
        fail("the full-size sweep made no trades")
    # the kernel's launch on the main path, held against the plain loop on
    # the same inputs and strategies; the plain loop also writes the curve
    # of the first CURVE_B strategies, held against the curve variant's
    (plain, plain_curve), plain_ms = timed(
        lambda: sweep_plain_graphed(inp, params, curve_b=CURVE_B))
    full = compare_stats(stats, plain, "main_full")
    full["T"] = T_FULL
    head = params._replace(**{f: getattr(params, f)[:CURVE_B] for f in params._fields})
    got, curve = sweep(inp, head, return_curve=True, device="cuda")
    curve_check = compare_stats(got, BacktestStats(*(v[:CURVE_B] for v in plain)),
                                f"main_full_curve_B{CURVE_B}", curve, plain_curve)
    curve_check["T"] = T_FULL
    del curve, plain_curve
    ms = cuda_ms(lambda: sweep_kernel(inp, params, device="cuda"), 10)
    curve_ms = cuda_ms(lambda: sweep_kernel(inp, head, return_curve=True, device="cuda"), 3)
    # the pre-pass against its plain version, and each launch timed alone
    dev = inp.close.device
    lib, s, sl, tp, T = replay.kernel_operands(inp, params, dev)
    mask = replay.launch_gate(lib, s, T, 10, 0.7, 70.0, dev)
    if not torch.equal(mask, replay.gate_mask_plain(inp)):
        fail("the pre-pass's gate mask differs from its plain version")
    gate_ms = cuda_ms(lambda: replay.launch_gate(lib, s, T, 10, 0.7, 70.0, dev), 20)
    walk_ms = cuda_ms(lambda: replay.launch_walk(lib, s, mask, sl, tp, T, 10, 10_000.0,
                                                 False, dev), 10)
    # the walk of the strategy with the most trades, alone: its serial chain
    # of events is the least time the whole walk can take
    h = int(torch.argmax(stats.total_trades))
    heaviest = {"index": h, "trades": int(stats.total_trades[h]), "walk_ms": cuda_ms(
        lambda: replay.launch_walk(lib, s, mask, sl[h:h + 1], tp[h:h + 1], T, 10,
                                   10_000.0, False, dev), 10)}
    gate_bits = (mask.to(torch.int64)[:, None] >> torch.arange(32, device=dev)) & 1
    best = int(torch.argmax(metrics["sharpe_ratio"]))
    emit({"phase": "main", "T": T_FULL, "B": B_FULL, "launches": launches,
          "stage_ms": stage_ms, "wall_s": wall,
          "candles_per_sec": T_FULL * B_FULL / (stage_ms["sweep"] / 1e3),
          "end_to_end_candles_per_sec": T_FULL * B_FULL / wall,
          "total_trades": trades,
          "buy_signals": int((inp.signal == 1).sum()),
          "gate_candles": int(gate_bits.sum()),
          "full_check": full, "curve_check": curve_check, "kernel_ms": ms,
          "prepass_ms": gate_ms, "walk_ms": walk_ms, "curve_ms": curve_ms,
          "heaviest_strategy": heaviest, "plain_ms": plain_ms,
          "best": {k: float(v[best]) for k, v in metrics.items()
                   if k in ("sharpe_ratio", "final_balance", "total_trades",
                            "win_rate", "max_drawdown_pct")}})
    return launches, stats, [full, curve_check], {
        "ms": ms, "plain_ms": plain_ms, "prepass_ms": gate_ms, "walk_ms": walk_ms,
        "curve_ms": curve_ms, "heaviest": heaviest}


def device_profile(fn):
    """``fn()`` once under torch.profiler: the top 10 device ops by total
    time with their call counts, and the share of the span — from the
    host's first call to the device's last op — in which no device op ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_region"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    region = [e for e in events if e.name == "chip_smoke_region"
              and e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "chip_smoke_region" and not getattr(e, "is_user_annotation", False)]
    if not region or not dev:
        return {"measured": False, "reason": f"{len(dev)} device events, "
                                             f"{len(region)} region events in the trace"}
    by_name = {}
    for e in dev:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    t0 = region[0].time_range.start
    t1 = max(e.time_range.end for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(e.time_range.start, t0), e.time_range.end) for e in dev):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return {"measured": True, "span_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0), "device_ops": len(dev),
            "top10": [{"op": k[:120], "ms": v[0] / 1e3, "count": v[1]} for k, v in top]}


def phase_indicator_split(d):
    """Where the indicator stage's time goes, measured after the main
    path's warm run and without changing the stage: its parts re-run as
    groups of the calls compute_indicators makes, on the same inputs, each
    group between CUDA events (the least of three runs after a warm one);
    "rest" is the whole stage, timed the same way, less the parts.  Then
    torch.profiler over one whole call."""
    import torch

    from ai_crypto_trader_tpu_torch.device import to_device
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops import indicators as ind
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma, fused_ewma_jobs

    def h2d():
        out = {k: to_device(v, "cuda") for k, v in d.items()}
        return {k: v.float() if v.is_floating_point() else v for k, v in out.items()}

    cols = h2d()
    high, low, close, volume = (cols[k] for k in ("high", "low", "close", "volume"))
    tp = ind.div_const(high + low + close, 3.0) * volume

    def rolling_sums():      # sma ×3, vwap's two sums, %D, the Bollinger mid
        return [ind.sma(close, 20), ind.sma(close, 50), ind.sma(close, 200),
                ind.rolling_sum(tp, 14), ind.rolling_sum(volume, 14),
                ind.rolling_mean(close, 3), ind.rolling_mean(close, 20)]

    def unfold_max_min():    # stochastic, williams %R, ichimoku 9/26/52
        return [f(x, w) for w in (14, 14, 9, 26, 52)
                for f, x in ((ind.rolling_max, high), (ind.rolling_min, low))]

    def ema_family():        # the two K2 launches and what feeds them
        up, dn = ind._rsi_moves(close)
        a, b = fused_ewma_jobs([(close, [2 / 13, 2 / 27], 0),
                                (torch.stack([up, dn, ind.true_range(high, low, close)]),
                                 [1 / 14], 1)], device="cuda")
        line = ind._mask_warmup(ind._mask_warmup(a[0], 1) - ind._mask_warmup(a[1], 1), 26)
        return fused_ewma(line, [0.2], 25, device="cuda")

    raw = compute_indicators(d, fill=False, device="cuda")
    floats = [v for v in raw.values() if v.is_floating_point()]
    fn_all = lambda: compute_indicators(d, device="cuda")  # noqa: E731
    parts = {}
    for name, fn in (("h2d_copies", h2d), ("rolling_sums", rolling_sums),
                     ("unfold_max_min", unfold_max_min),
                     ("rolling_std", lambda: ind.rolling_std(close, 20)),
                     ("ema_family_k2", ema_family),
                     ("nanfill_all_columns", lambda: [ind.nanfill(v) for v in floats]),
                     ("stage", fn_all)):
        fn()
        parts[name] = min(timed(fn)[1] for _ in range(3))
    total = parts.pop("stage")
    parts["rest"] = total - sum(parts.values())
    try:
        profile = device_profile(fn_all)
    except Exception as e:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        profile = {"measured": False, "reason": repr(e)[:300]}
    report = {"phase": "indicator_split", "T": T_FULL, "stage_ms": total,
              "parts_ms": parts, "nanfill_columns": len(floats),
              "shares": {k: v / total for k, v in parts.items()}, "profile": profile}
    emit(report)
    return report


def _debug_mode_messages(fn):
    """What torch's sync debug mode says while ``fn()`` runs."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:200] for w in caught]


def sync_calls(fn):
    """The synchronizing calls torch's sync debug mode flags in ``fn()``:
    its message is learnt from a probe that must sync (an ``.item()``),
    apart from what the mode says of itself."""
    import torch

    quiet = set(_debug_mode_messages(lambda: None))
    probe = set(_debug_mode_messages(lambda: torch.ones(1, device="cuda").item())) - quiet
    if not probe:
        fail("torch's sync debug mode flagged no .item(): it cannot check for syncs")
    return [m for m in _debug_mode_messages(fn) if m in probe]


def ewma_jobs_bound(jobs):
    """(bytes ms, operations ms) of the EWMA function over ``jobs`` [(x,
    alphas, start)]: each distinct input series read once, every output
    row written once, EWMA_OPS float32 operations per output element."""
    inputs = {x.data_ptr(): x.numel() for x, _, _ in jobs}
    outputs = sum(len(a) * x.numel() for x, a, _ in jobs)
    return (1e3 * 4 * (sum(inputs.values()) + outputs) / HBM_BYTES_PER_S,
            1e3 * EWMA_OPS * outputs / F32_OPS_PER_S)


def replay_rows_bound_ms(stats, inputs, warmup=10):
    """`replay_bound_ms` for the rows form, on what this run's data needs.
    Bytes: each distinct stream read once — a tensor that two fields share
    (the GA's decision is its signal) once; the gate streams and the shared
    [T] streams in full; volatility, sl_pct and tp_pct, which the walk
    reads only at an entry, one 32-byte sector an entry each when they are
    rows [B, T] (every position closes by the end of the test, so entries
    = trades); the stats written once.  Operations: the gate on every
    candle of every row; the SL/TP test on every in-position candle; each
    close and entry.  (ms, by)."""
    B, T = int(stats.total_trades.numel()), int(inputs.close.shape[-1])
    trades = int(stats.total_trades.sum())
    books = int((stats.n_r - 1).sum())
    survived = B * (T - warmup) - books
    gate_rows = max(int(x.shape[0]) if x.ndim == 2 else 1
                    for x in (inputs.signal, inputs.decision, inputs.strength, inputs.confidence))
    ops = (REPLAY_OPS_GATE * gate_rows * T + REPLAY_OPS_EXIT * (survived + trades)
           + (REPLAY_OPS_CLOSE + REPLAY_OPS_BOOK + REPLAY_OPS_ENTRY) * trades)
    streams = {}
    for field, x in zip(inputs._fields, inputs):
        at_entries = field in ("volatility", "sl_pct", "tp_pct") and x.ndim == 2
        streams[x.data_ptr()] = 32 * trades if at_entries else 4 * x.numel()
    n_bytes = sum(streams.values()) + 2 * 4 * B + 14 * 4 * B
    ms, by = max((n_bytes / HBM_BYTES_PER_S, "bytes"), (ops / F32_OPS_PER_S, "operations"))
    return 1e3 * ms, by


def rows_head(inputs, params, n):
    """The first ``n`` strategies: their rows and params."""
    return (type(inputs)(*(x[:n] if x.ndim == 2 else x for x in inputs)),
            params._replace(**{f: getattr(params, f)[:n] for f in params._fields}))


def rows_check(inputs, params, label, eager=False, **kw):
    """K1's rows form, both variants (the curve on the first GA_CURVE_B
    strategies), against the plain loop bit for bit: the eager loop, or
    the graph-replayed one (phase 3 holds the two equal, and this phase
    holds them equal on rows)."""
    from ai_crypto_trader_tpu_torch.backtest import BacktestStats
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel, sweep_plain

    n = min(GA_CURVE_B, int(params.stop_loss.shape[0]))
    got = sweep_kernel(inputs, params, device="cuda", **kw)
    got_c, curve = sweep_kernel(*rows_head(inputs, params, n), device="cuda",
                                return_curve=True, **kw)
    if eager:
        (ref, ref_curve), plain_ms = timed(lambda: sweep_plain(inputs, params,
                                                               return_curve=True, **kw))
        ref_curve = ref_curve[:n]
    else:
        (ref, ref_curve), plain_ms = timed(lambda: sweep_plain_graphed(inputs, params,
                                                                       curve_b=n, **kw))
    check = {**compare_stats(got, ref, label), "T": int(inputs.close.shape[-1]),
             "rows": [k for k in inputs._fields if getattr(inputs, k).ndim == 2]}
    check["curve"] = compare_stats(got_c, BacktestStats(*(v[:n] for v in ref)),
                                   label + f"/curve_B{n}", curve, ref_curve)
    return check, ref, plain_ms


def ga_flips(d, fit_k, p0, cfg, seed_params):
    """K2's rounding where the GA reads it.  The period tables are built a
    second time with every EWMA entry of ops/dynamic.py patched to the plain
    version (which must launch no kernel); generation 0's genomes are
    evaluated on both.  Every signal flip, strength-gate (50) crossing and
    sizer-bucket crossing must sit within 1e-4 of a threshold on its
    input's scale — a MACD line within 1e-4·close of 0, an RSI within 1e-2
    of the genome's oversold, oversold+10 or overbought, the two trend
    EMAs within 1e-4·close of each other or the trend strength within 1e-2
    of 1, the strength within 1e-2 of 50, the volatility within a relative
    1e-4 of 0.01 or 0.02 — and no kind may exceed T/1000 on any genome.
    Then the GA from one seed on both tables: is the best genome the
    same?"""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import evolvable as ev
    from ai_crypto_trader_tpu_torch.evolve import ga
    from ai_crypto_trader_tpu_torch.ops import dynamic
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    kernel_entry = dynamic.fused_ewma_jobs
    dynamic.fused_ewma_jobs = jobs_plain
    before = fused_ewma.launches
    try:
        fit_p = ga.backtest_fitness(d, device="cuda")
    finally:
        dynamic.fused_ewma_jobs = kernel_entry
    if fused_ewma.launches != before:
        fail(f"ga flips: the plain tables launched the kernel {fused_ewma.launches - before} times")
    tab_k, tab_p = fit_k.tables, fit_p.tables
    inp_k, inp_p = (ev.evolvable_inputs(d, p0, tables=t, device="cuda") for t in (tab_k, tab_p))
    a = {k: torch.as_tensor(d[k], device="cuda") for k in ("close", "high", "low", "volume")}
    rsi, macd, _, ema_s, ema_l, _, _ = ev._filled_indicators(a, p0, tab_p)
    pc = ev._columns(p0)
    close = a["close"]
    trend = torch.abs((ema_s - ema_l) / ema_l * 100.0)
    near_votes = ((torch.abs(macd) <= 1e-4 * close)
                  | (torch.abs(rsi - pc.rsi_oversold) <= 1e-2)
                  | (torch.abs(rsi - (pc.rsi_oversold + 10.0)) <= 1e-2)
                  | (torch.abs(rsi - pc.rsi_overbought) <= 1e-2)
                  | (torch.abs(ema_s - ema_l) <= 1e-4 * close)
                  | (torch.abs(trend - 1.0) <= 1e-2))
    vol_p, vol_k = inp_p.volatility, inp_k.volatility
    sig_flip = inp_k.signal != inp_p.signal
    kinds = {
        "signal": (sig_flip, near_votes),
        "strength_gate": (~sig_flip & ((inp_k.strength >= 50.0) != (inp_p.strength >= 50.0)),
                          near_votes | (torch.abs(inp_p.strength - 50.0) <= 1e-2)),
        "sizer_bucket": (((vol_k > 0.02) != (vol_p > 0.02)) | ((vol_k > 0.01) != (vol_p > 0.01)),
                         torch.minimum(torch.abs(vol_p - 0.01) / 0.01,
                                       torch.abs(vol_p - 0.02) / 0.02) <= 1e-4),
    }
    T = int(close.shape[-1])
    report = {"phase": "ga_flips", "T": T, "genomes": int(p0.stop_loss.shape[0]),
              "limit_per_genome_per_kind": T // 1000, "plain_table_launches": 0}
    for kind, (diff, near) in kinds.items():
        where = torch.nonzero(diff)
        report[kind] = {"count": int(diff.sum()), "genomes": int(diff.any(-1).sum()),
                        "max_per_genome": int(diff.sum(-1).max()),
                        "far_from_threshold": int((diff & ~near).sum()),
                        "examples": [{"genome": int(g), "t": int(t),
                                      "macd": float(macd[g, t]), "rsi": float(rsi[g, t]),
                                      "ema_gap": float(ema_s[g, t] - ema_l[g, t]),
                                      "strength": [float(inp_p.strength[g, t]),
                                                   float(inp_k.strength[g, t])],
                                      "volatility": float(vol_p[g, t])}
                                     for g, t in where[:3].tolist()]}
    st_k, st_p = (ev.evolvable_fused_backtest(d, p0, t, device="cuda") for t in (tab_k, tab_p))
    report["genomes_with_other_stats"] = int(((st_k.total_trades != st_p.total_trades)
                                              | (st_k.final_balance != st_p.final_balance)).sum())
    f_k, f_p = fit_k(p0), fit_p(p0)
    report["max_fitness_difference"] = float(torch.abs(f_k - f_p).max())
    bests = [ga.run_ga(torch.Generator(device="cuda").manual_seed(7), f, cfg,
                       seed_params=seed_params, device="cuda")[0] for f in (fit_k, fit_p)]
    report["same_best_genome"] = all(bool(torch.equal(a_, b_)) for a_, b_ in zip(*bests))
    emit(report)
    for kind in kinds:
        if report[kind]["far_from_threshold"]:
            fail(f"ga flips: {report[kind]['far_from_threshold']} {kind} differences sit "
                 "farther than 1e-4 from any threshold")
        if report[kind]["max_per_genome"] > T // 1000:
            fail(f"ga flips: {report[kind]['max_per_genome']} {kind} differences on one "
                 "genome, over T/1000")
    return report


def phase_ga(d_year, info, libraries):
    """The GA on the card at the bench's full width (bench.py:1927-2003):
    `generate_ohlcv(525600, seed=3)` cut to its first 43,200 candles,
    `GAParams(256, 3)`.  K2's table-build launches and K1's rows form
    against their plain versions, `run_backtest` on per-genome rows, the
    whole GA through the port's entry points with its launch counts and
    its one host read, its time split, and K2's flips as the GA reads
    them."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        compute_metrics, default_params, run_backtest, sample_params)
    from ai_crypto_trader_tpu_torch.backtest import evolvable as ev
    from ai_crypto_trader_tpu_torch.backtest.strategy import unstack_params
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import ga
    from ai_crypto_trader_tpu_torch.ops import dynamic, replay
    from ai_crypto_trader_tpu_torch.ops.ewma import (
        barrier_launch, fused_ewma, fused_ewma_jobs, fused_ewma_plain, tile_count)
    from ai_crypto_trader_tpu_torch.ops.indicators import nanfill
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    d = {k: v[:T_GA] for k, v in d_year.items()}
    cfg = GAParams(population_size=POP_GA, generations=GENS_GA)
    seed_params = default_params(device="cuda")
    kw = dict(min_signal_strength=50.0, warmup=10)

    # --- 1. K2's launches of the table build, recorded as packed ---------
    launches = []
    kernel_entry = dynamic.fused_ewma_jobs

    def recording(jobs, device=None):
        launches.append([(x, alphas, start) for x, alphas, start in jobs])
        return kernel_entry(jobs, device=device)

    dynamic.fused_ewma_jobs = recording
    try:
        tables = ev.build_indicator_tables(d, device="cuda")
    finally:
        dynamic.fused_ewma_jobs = kernel_entry
    k2 = []
    for i, jobs in enumerate(launches):
        named = [(f"job{j}_K{len(a)}_start{st}", x.reshape(-1, x.shape[-1]), a, st)
                 for j, (x, a, st) in enumerate(jobs)]
        check = ewma_check(named, f"ga_tables_launch{i}")
        args = [(x, a, st) for _, x, a, st in named]
        n_tiles = tile_count([x.shape for x, _, _ in args])
        kmax = max(len(a) for _, a, _ in args)
        b_ms, o_ms = ewma_jobs_bound(jobs)
        k2.append({**check, "grid": check["plan"],
                   "ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 20),
                   "barrier_only_ms": cuda_ms(lambda: barrier_launch(n_tiles, kmax), 20),
                   "bytes_bound_ms": b_ms, "operations_bound_ms": o_ms,
                   "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, st), 3)
                                   for x, a, st in args)})
    # on arrays already on the card the build reads nothing back: torch's
    # sync debug mode flags no call in it
    d_cuda = {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}
    syncs = sync_calls(lambda: ev.build_indicator_tables(d_cuda, device="cuda"))
    if syncs:
        fail(f"the table build made {len(syncs)} synchronizing calls: {syncs[:3]}")
    all_jobs = [job for jobs in launches for job in jobs]
    b_ms, o_ms = ewma_jobs_bound(all_jobs)
    ga_tables = {"launches_per_build": len(launches), "host_syncs_per_build": len(syncs),
                 "jobs": [len(j) for j in launches],
                 "ms": sum(c["ms"] for c in k2), "plain_ms": sum(c["plain_ms"] for c in k2),
                 "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
                 "barrier_only_ms": sum(c["barrier_only_ms"] for c in k2),
                 "max_abs_err": max(j["max_abs_err"] for c in k2 for j in c["jobs"]),
                 "max_rel_err": max(j["max_rel_err"] for c in k2 for j in c["jobs"])}
    emit({"phase": "ga_tables", "T": T_GA, "launches": k2, **ga_tables})

    # --- 2. K1's rows form against the plain loop ------------------------
    genomes0 = ga.GeneratorDraws(torch.Generator(device="cuda").manual_seed(0)).init(POP_GA)
    genomes0[0] = torch.stack(list(seed_params))
    p0 = unstack_params(genomes0)
    inputs0 = ev.evolvable_inputs(d, p0, tables=tables, device="cuda")
    checks = []
    c, stats0, ga_plain_ms = rows_check(inputs0, p0, f"ga_fitness_B{POP_GA}_T{T_GA}", **kw)
    checks.append(c)
    if int(stats0.total_trades.sum()) <= 0:
        fail("ga: no genome of generation 0 trades")

    def d_small(n):
        from ai_crypto_trader_tpu_torch.data import generate_ohlcv
        return {k: v for k, v in generate_ohlcv(n=n, seed=3).items() if k != "regime"}

    def ga_rows(n, B, seed):
        dn = d_small(n)
        p = sample_params(torch.Generator().manual_seed(seed), B, device="cuda")
        return ev.evolvable_inputs(dn, p, tables=ev.build_indicator_tables(dn, device="cuda"),
                                   device="cuda"), p

    inp130, p130 = ga_rows(1500, 130, 1)
    c, ref130, _ = rows_check(inp130, p130, "rows_B130_T1500", eager=True, **kw)
    (graphed, graphed_curve), _ = timed(lambda: sweep_plain_graphed(inp130, p130, curve_b=32, **kw))
    for f in ref130._fields:
        if not torch.equal(getattr(graphed, f), getattr(ref130, f)):
            fail(f"ga: the graph-replayed plain loop differs from the eager one on rows in {f}")
    checks.append(c)
    T_R = 32 * 1024 + 7
    inp_r, p_r = ga_rows(T_R, 256, 2)
    checks.append(rows_check(inp_r, p_r, f"rows_ragged_T{T_R}_warmup2000",
                             min_signal_strength=50.0, warmup=2000)[0])
    for label, v in (("rows_tiny_sl_tp_1e-4", 1e-4), ("rows_huge_sl_tp_1e6", 1e6)):
        full = torch.full(inp130.sl_pct.shape, v, dtype=torch.float32, device="cuda")
        rows = inp130._replace(sl_pct=full, tp_pct=full)
        c, ref, _ = rows_check(rows, p130, label, **kw)
        # one position a genome that enters at all, closed by the end of the test
        enters = (replay.gate_mask_plain(rows, 0.7, 50.0, 10) != 0).any(-1)
        if v > 1 and not torch.equal(ref.total_trades, enters.to(torch.int32)):
            fail("ga rows, huge SL/TP: a position closed before the end of the test")
        # every position closes on the candle after its entry: almost no
        # candle survives in a position, and almost every one is booked
        if v < 1 and not bool((ref.n_r > inp130.close.shape[-1] // 2).all()):
            fail("ga rows, tiny SL/TP: positions did not close on the next candle")
        checks.append(c)
    # the pre-pass's mask rows against their plain version
    lib, s, sl, tp, T = replay.kernel_operands(inputs0, p0, inputs0.close.device)
    mask = replay.launch_gate(lib, s, T, 10, 0.7, 50.0, inputs0.close.device)
    if mask.shape != (POP_GA, -(-T_GA // 32)) or not torch.equal(
            mask, replay.gate_mask_plain(inputs0, 0.7, 50.0, 10)):
        fail("ga: the pre-pass's mask rows differ from their plain version")
    emit({"phase": "ga_rows", "checks": checks, "graphed_plain_bit_identical_on_rows": True,
          "mask_rows_equal_plain": True})

    # --- 3. run_backtest on CUDA with per-genome rows --------------------
    before = sweep_kernel.launches
    got = run_backtest(inp130, p130, use_param_sl_tp=True, device="cuda", **kw)
    if sweep_kernel.launches != before + 1:
        fail("run_backtest on per-genome rows did not launch the replay kernel once")
    run_backtest_check = compare_stats(got, ref130, "run_backtest_rows_B130_T1500")

    # --- 4. the whole GA at full width -----------------------------------
    def run(fit=None):
        f = fit or ga.backtest_fitness(d, device="cuda")
        return f, ga.run_ga(torch.Generator(device="cuda").manual_seed(0), f, cfg,
                            seed_params=seed_params, device="cuda")

    run()                                                  # warm run
    reads = []
    read = ga.host_read
    ga.host_read = lambda tree: (reads.append(1), read(tree))[1]
    fused_ewma.launches = 0
    sweep_kernel.launches = 0
    try:
        ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev_[0].record()
        fit = ga.backtest_fitness(d, device="cuda")
        ev_[1].record()
        t1 = time.perf_counter()
        best, hist = ga.run_ga(torch.Generator(device="cuda").manual_seed(0), fit, cfg,
                               seed_params=seed_params, device="cuda")
        ev_[2].record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        ga.host_read = read
    ga_launches = {"fused_ewma": fused_ewma.launches, "replay_sweep": sweep_kernel.launches}
    if ga_launches != {"fused_ewma": len(launches), "replay_sweep": GENS_GA + 1}:
        fail(f"the GA did not launch the kernels as planned ({len(launches)} EWMA launches, "
             f"{GENS_GA + 1} replays): {ga_launches}")
    if len(reads) != 1:
        fail(f"run_ga read the host {len(reads)} times, not once")
    values = [h[k] for h in hist for k in ("best_fitness", "mean_fitness", "diversity")]
    if len(hist) != GENS_GA or not all(math.isfinite(v) for v in values):
        fail(f"the GA's history is not {GENS_GA} finite records: {hist}")
    bf = [h["best_fitness"] for h in hist]
    if any(b2 < b1 for b1, b2 in zip(bf, bf[1:])):
        fail(f"best fitness fell between generations: {bf}")
    run_wall = t2 - t1

    # the time split, each part re-run alone between CUDA events (the least
    # of three runs after a warm one)
    f0 = fit(p0)
    state0 = ga.GAState(genomes0, f0, genomes0[0], f0.max())
    draws = ga._generation_draws(ga.GeneratorDraws(torch.Generator(device="cuda").manual_seed(3)),
                                 state0, cfg)
    bb_like = torch.where(torch.rand(inputs0.strength.shape, device="cuda") < 0.01, math.nan,
                          inputs0.strength)
    parts = {}
    for name, fn in (("table_build", lambda: ev.build_indicator_tables(d, device="cuda")),
                     ("gather_vote_nanfill", lambda: ev.evolvable_inputs(d, p0, tables=tables,
                                                                          device="cuda")),
                     ("of_which_nanfill_pop_x_T", lambda: nanfill(bb_like)),
                     ("k1_prepass_and_walk", lambda: sweep_kernel(inputs0, p0, device="cuda",
                                                                  **kw)),
                     ("compute_metrics", lambda: compute_metrics(stats0, device="cuda")),
                     ("evolve_core", lambda: ga._evolve_core(draws, state0, cfg)),
                     ("one_evaluation", lambda: fit(p0))):
        fn()
        parts[name] = min(timed(fn)[1] for _ in range(3))
    gate_ms = cuda_ms(lambda: replay.launch_gate(lib, s, T, 10, 0.7, 50.0, inputs0.close.device), 20)
    walk_ms = cuda_ms(lambda: replay.launch_walk(lib, s, mask, sl, tp, T, 10, 10_000.0, False,
                                                 inputs0.close.device), 10)
    k1_ms = cuda_ms(lambda: sweep_kernel(inputs0, p0, device="cuda", **kw), 10)
    try:
        profile = device_profile(lambda: fit(p0))
    except Exception as e:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        profile = {"measured": False, "reason": repr(e)[:300]}
    bound_ms, bound_by = replay_rows_bound_ms(stats0, inputs0)
    report = {"phase": "ga", "card": info["nvidia_smi"], "T": T_GA, "population": POP_GA,
              "generations": GENS_GA, "launches": ga_launches, "host_reads": len(reads),
              "history": hist, "best": {k: float(v) for k, v in best._asdict().items()},
              "table_build_ms": ev_[0].elapsed_time(ev_[1]),
              "run_ga_ms": ev_[1].elapsed_time(ev_[2]), "run_ga_wall_s": run_wall,
              "table_build_wall_s": t1 - t0,
              "backtests_per_s": POP_GA * (GENS_GA + 1) / run_wall,
              "gen0_trades": int(stats0.total_trades.sum()),
              "gen0_genomes_trading": int((stats0.total_trades > 0).sum()),
              "parts_ms": parts, "k1_ms": k1_ms, "k1_prepass_ms": gate_ms, "k1_walk_ms": walk_ms,
              "k1_plain_ms": ga_plain_ms, "k1_bound_ms": bound_ms, "k1_bound_by": bound_by,
              "run_backtest_rows": run_backtest_check, "profile_one_evaluation": profile}
    emit(report)

    # --- 5. flips ---------------------------------------------------------
    flips = ga_flips(d, fit, p0, cfg, seed_params)
    ga_rows_entry = {"launches": ga_launches["replay_sweep"], "ms": k1_ms,
                     "prepass_ms": gate_ms, "walk_ms": walk_ms, "plain_ms": ga_plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": max(max(c["max_abs_err"], c["curve"]["max_abs_err"])
                                        for c in checks),
                     "shape": f"rows B={POP_GA} x T={T_GA}",
                     "plain": "the engine's loop on the rows, 32 candles a CUDA graph"}
    ga_tables_entry = {"launches": ga_launches["fused_ewma"], **ga_tables,
                       "shape": f"141 EWMA rows at T={T_GA} in {len(launches)} launches"}
    return {"ga_rows": ga_rows_entry, "ga_tables": ga_tables_entry, "flips": flips}


class TickTape:
    """bench.py's `tick_pipeline` tape (bench.py:1323-1337): S symbols from
    `generate_ohlcv(n=T·15 + 64, seed=11)`, symbol i's prices scaled by
    1 + 0.03·i and its volume by 1 + 0.01·i, one candle a minute.  Its
    klines are what `FakeExchange.get_klines` serves (shell/exchange.py:
    254-275): bars of 1, 3, 5 or 15 minutes with absolute-time boundaries,
    the last bar the in-progress one, the newest ``limit`` of them."""

    FACTORS = {"1m": 1, "3m": 3, "5m": 5, "15m": 15}

    def __init__(self, S, T, seed=11):
        import numpy as np

        from ai_crypto_trader_tpu_torch.data import generate_ohlcv

        self.n = T * 15 + 64
        d = generate_ohlcv(n=self.n, seed=seed)
        self.symbols = [f"S{i:03d}USDC" for i in range(S)]
        self.ts = np.arange(self.n, dtype=np.int64) * 60_000
        self.cols, self.bars = [], []
        for i in range(S):
            scale = np.float64(1.0 + 0.03 * i)
            cols = [d[k] * scale for k in ("open", "high", "low", "close")]
            cols.append(d["volume"] * (1.0 + 0.01 * i))
            self.cols.append(cols)
            bars = {}
            for f in self.FACTORS.values():       # every complete bar
                m = self.n // f * f
                o, h, lo, c, v = (x[:m].reshape(-1, f) for x in cols)
                vsum = v[:, 0].astype(np.float64)  # summed in candle order in
                for j in range(1, f):              # float64, as the exchange's
                    vsum += v[:, j]                # Python sum of floats
                bars[f] = np.stack([o[:, 0], h.max(1), lo.min(1), c[:, -1], vsum], 1)
            self.bars.append(bars)

    def klines(self, i, interval, cursor, limit):
        import numpy as np

        f = self.FACTORS[interval]
        k = cursor // f
        o, h, lo, c, v = self.cols[i]
        a, b = k * f, cursor + 1
        last = [o[a], h[a:b].max(), lo[a:b].min(), c[b - 1], sum(v[a:b].tolist())]
        arr = np.vstack([self.bars[i][f][k - limit + 1:k], last])
        ts = self.ts[np.arange(k - limit + 1, k + 1) * f]
        return np.column_stack([ts, arr]).tolist()

    def feed(self, eng, cursor, limit):
        for i, s in enumerate(self.symbols):
            for iv in eng.intervals:
                eng.ingest(s, iv, self.klines(i, iv, cursor, limit))


def same_table(a, b):
    """Two tick tables equal bit for bit (float32 leaves as int32 views)."""
    import numpy as np

    if set(a) != set(b):
        return False
    for k in a:
        if isinstance(a[k], dict):
            if not same_table(a[k], b[k]):
                return False
        elif a[k].dtype != b[k].dtype or not np.array_equal(
                a[k].view(np.int32), b[k].view(np.int32)):
            return False
    return True


def percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def tick_flips(tape, cursor):
    """K2's rounding where the tick path reads it: every (symbol, frame)
    window of one poll — all S·F·T candles, not only the table's last
    candle — through compute_indicators with the kernel and with every EWMA
    entry patched to the plain version (which must launch no kernel), then
    the signal features and the signal.  Every candle whose signal or trend
    differs must sit within 1e-4 of a threshold on its input's scale (a
    MACD within 1e-4·close of 0, an RSI within 1e-2 of 35 or 45), and each
    kind must stay under one candle in 1,000.  The tick tables of one step
    with each EWMA are compared too: their signal and trend differences are
    counted and held the same way, the other fields reported."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.backtest import compute_signal_features, reference_signal
    from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod
    from ai_crypto_trader_tpu_torch.ops import tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    def engine_table():
        eng = tick_engine.TickEngine(tape.symbols, TICK_FRAMES, window=T_TICK, device="cuda")
        tape.feed(eng, cursor, T_TICK)
        return eng.step(), eng

    def windows(eng):
        w = torch.as_tensor(eng._win, device="cuda")
        return {k: w[..., j].contiguous() for j, k in
                enumerate(("open", "high", "low", "close", "volume"))}

    table_k, eng = engine_table()
    win = windows(eng)
    ind_k = ind_mod.compute_indicators(win, device="cuda")
    kernel_entries = ind_mod.fused_ewma, ind_mod.fused_ewma_jobs
    ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = ewma_plain, jobs_plain
    fused_ewma.launches = 0
    try:
        ind_p = ind_mod.compute_indicators(win, device="cuda")
        table_p, _ = engine_table()
    finally:
        ind_mod.fused_ewma, ind_mod.fused_ewma_jobs = kernel_entries
    if fused_ewma.launches:
        fail(f"tick flips: the plain EWMA launched the kernel {fused_ewma.launches} times")
    f_k, f_p = compute_signal_features(ind_k), compute_signal_features(ind_p)
    (sig_k, _), (sig_p, _) = reference_signal(f_k), reference_signal(f_p)
    near = ((torch.abs(f_p.macd) <= 1e-4 * f_p.close)
            | (torch.minimum(torch.abs(f_p.rsi - 35.0), torch.abs(f_p.rsi - 45.0)) <= 1e-2))
    n = int(sig_k.numel())
    counts = {v: int((sig_p == v).sum()) for v in (-1, 0, 1)}
    if not (counts[1] and counts[-1]):
        fail(f"tick flips: the windows hold no BUY or no SELL signal {counts}: vacuous")
    report = {"phase": "tick_flips", "candles": n, "limit_per_kind": n // 1000,
              "plain_launches": 0, "signals_sell_neutral_buy": list(counts.values())}
    for kind, diff in (("signal", sig_k != sig_p), ("trend", f_k.trend != f_p.trend)):
        where = torch.nonzero(diff)[:3].tolist()
        report[kind] = {"count": int(diff.sum()), "far_from_threshold": int((diff & ~near).sum()),
                        "examples": [{"lane_t": ix, "macd": float(f_p.macd[tuple(ix)]),
                                      "rsi": float(f_p.rsi[tuple(ix)]),
                                      "close": float(f_p.close[tuple(ix)])} for ix in where]}
    # the tables: the last candle of every lane
    last = {k: (v[..., -1] if v.ndim == 3 else v) for k, v in
            (("macd", f_p.macd), ("rsi", f_p.rsi), ("close", f_p.close))}
    near_last = ((np.abs(last["macd"].cpu().numpy()) <= 1e-4 * last["close"].cpu().numpy())
                 | (np.minimum(np.abs(last["rsi"].cpu().numpy() - 35.0),
                               np.abs(last["rsi"].cpu().numpy() - 45.0)) <= 1e-2))
    tables = {}
    for kind in ("signal", "trend"):
        diff = table_k[kind] != table_p[kind]
        tables[kind] = {"count": int(diff.sum()), "far_from_threshold": int((diff & ~near_last).sum())}
    flat = lambda t: {**{k: v for k, v in t.items() if k != "combo"},  # noqa: E731
                      **{"combo." + k: v for k, v in t["combo"].items()}}
    fk, fp = flat(table_k), flat(table_p)
    tables["max_abs_diff"] = {k: float(np.nanmax(np.abs(fk[k].astype(np.float64) - fp[k])))
                              for k in fp if k not in ("signal", "trend")}
    report["tables"] = tables
    emit(report)
    for kind in ("signal", "trend"):
        for where, r in (("windows", report[kind]), ("table", tables[kind])):
            if r["far_from_threshold"]:
                fail(f"tick flips: {r['far_from_threshold']} {kind} differences in the {where} "
                     "sit farther than 1e-4 from any threshold")
        if report[kind]["count"] > n // 1000:
            fail(f"tick flips: {report[kind]['count']} {kind} differences, over one in 1,000")
    return report


def phase_tick(info):
    """The live tick path at bench.py's `tick_pipeline` width (bench.py:
    1323-1337): 64 symbols × frames 1m/3m/5m/15m × a 256-candle window.
    The K2 launches of one step, recorded as the step makes them, against
    the plain version job by job and twice for the same bits; exactly 3 K2
    launches and one host read a step; no synchronizing call of torch's in
    a step but that read; the ring delta bit for bit against a fresh seed;
    the pipelined engine bit for bit against the serial one shifted by one
    tick; K2's flips (`tick_flips`); then timed polls (ingest + step) in
    both modes with their split, and torch.profiler over one step."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import (
        barrier_launch, fused_ewma, fused_ewma_jobs, fused_ewma_plain, tile_count)

    tape = TickTape(S_TICK, T_TICK)
    cursor = tape.n - 64                       # 63 candles of headroom
    make = lambda pipelined=False: tick_engine.TickEngine(  # noqa: E731
        tape.symbols, TICK_FRAMES, window=T_TICK, pipelined=pipelined, device="cuda")
    eng = make()
    tape.feed(eng, cursor, T_TICK)
    eng.step()                                 # the seed (and the first nvcc/launches)

    # --- 1. one steady step: its K2 launches, host reads and syncs ------
    launches, reads = [], []
    real_read = tick_engine.host_read

    def quiet_read(readback):                  # the one sanctioned sync
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_read(readback)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    cursor += 1
    tape.feed(eng, cursor, T_TICK)
    tick_engine.host_read = quiet_read
    fused_ewma.launches = 0
    try:
        with recording_ewma(launches):
            syncs = sync_calls(eng.step)
    finally:
        tick_engine.host_read = real_read
    n_launch = fused_ewma.launches
    if n_launch != 3 or len(launches) != 3 or len(reads) != 1:
        fail(f"a tick step made {n_launch} K2 launches ({len(launches)} calls) and "
             f"{len(reads)} host reads, not 3 and 1")
    if syncs:
        fail(f"a tick step made {len(syncs)} synchronizing calls besides its read: {syncs[:3]}")
    if eng.last_stats["full_seed"] or eng.last_stats["upload_rows"] <= 0:
        fail(f"the steady tick step re-seeded or uploaded nothing: {eng.last_stats}")
    k2 = []
    for i, jobs in enumerate(launches):
        named = [(f"job{j}_K{len(a)}_start{st}", x.reshape(-1, x.shape[-1]), a, st)
                 for j, (x, a, st) in enumerate(jobs)]
        check = ewma_check(named, f"tick_launch{i}")
        args = [(x, a, st) for _, x, a, st in named]
        n_tiles = tile_count([x.shape for x, _, _ in args])
        kmax = max(len(a) for _, a, _ in args)
        b_ms, o_ms = ewma_jobs_bound(args)
        k2.append({**check, "ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 50),
                   "barrier_only_ms": cuda_ms(lambda: barrier_launch(n_tiles, kmax), 50),
                   "bytes_bound_ms": b_ms, "operations_bound_ms": o_ms,
                   "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, st), 3)
                                   for x, a, st in args)})
    all_jobs = [(x.reshape(-1, x.shape[-1]), a, st) for jobs in launches for x, a, st in jobs]
    b_ms, o_ms = ewma_jobs_bound(all_jobs)
    k2_entry = {"launches_per_step": n_launch, "ms": sum(c["ms"] for c in k2),
                "ms_per_launch": [c["ms"] for c in k2],
                "plain_ms": sum(c["plain_ms"] for c in k2),
                "barrier_only_ms": sum(c["barrier_only_ms"] for c in k2),
                "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "plans": [c["plan"] for c in k2],
                "max_abs_err": max(j["max_abs_err"] for c in k2 for j in c["jobs"]),
                "max_rel_err": max(j["max_rel_err"] for c in k2 for j in c["jobs"]),
                "shape": f"S={S_TICK} x F={len(TICK_FRAMES)} x T={T_TICK}: compute_indicators' "
                         "two launches and rsi(close, 7)"}
    emit({"phase": "tick_k2", "launches": k2, "host_reads_per_step": len(reads),
          "host_syncs_per_step_besides_read": len(syncs), **k2_entry})

    # --- 2. the ring delta against a fresh seed, bit for bit --------------
    for _ in range(5):
        cursor += 1
        tape.feed(eng, cursor, T_TICK)
        inc = eng.step()
    fresh = make()
    tape.feed(fresh, cursor, T_TICK)
    seeded = fresh.step()
    if eng.last_stats["full_seed"] or not fresh.last_stats["full_seed"]:
        fail("the ring-delta check did not compare a delta with a seed")
    if not same_table(inc, seeded):
        fail("the ring delta's tick table differs from a fresh seed's on the card")

    # --- 3. pipelined against serial, shifted by one tick -----------------
    serial, pipe = make(), make(pipelined=True)
    serial_outs, pipe_outs = [], []
    for i in range(5):
        c = cursor + 1 + i
        tape.feed(serial, c, T_TICK)
        tape.feed(pipe, c, T_TICK)
        serial_outs.append(serial.step())
        got = pipe.step()
        if (got is None) != (i == 0):
            fail("the pipelined engine's first step returned a table, or a later one none")
        if got is not None:
            pipe_outs.append(got)
    pipe_outs.append(pipe.flush())
    if not all(same_table(a, b) for a, b in zip(pipe_outs, serial_outs)):
        fail("the pipelined tables differ from the serial ones shifted by one tick")

    # --- 4. flips ---------------------------------------------------------
    flips = tick_flips(tape, cursor)

    # --- 5. timed polls: ingest + step, and the step's split --------------
    marks = {}
    real_program = tick_engine._tick_program

    def timed_program(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks["t_prog"] = time.perf_counter()
        ev[0].record()
        out = real_program(*args)
        ev[1].record()
        marks["t_prog_end"], marks["events"] = time.perf_counter(), ev
        return out

    def timed_read(readback):
        marks["t_read"] = time.perf_counter()
        out = real_read(readback)
        marks["t_read_end"] = time.perf_counter()
        return out

    # the two modes in turns within one loop, each first every other poll,
    # so host noise falls on both alike
    polls, engines, rows, events = {}, {}, {}, {}
    c0 = cursor + 6
    for mode in ("serial", "pipelined"):
        e = engines[mode] = make(pipelined=mode == "pipelined")
        tape.feed(e, c0, T_TICK)
        e.step()
        if mode == "pipelined":
            tape.feed(e, c0 + 1, T_TICK)
            e.step()
        rows[mode], events[mode] = [], []
    tick_engine._tick_program, tick_engine.host_read = timed_program, timed_read
    try:
        for k in range(TICK_POLLS):
            c = c0 + 2 + k
            for mode in (("serial", "pipelined") if k % 2 == 0 else ("pipelined", "serial")):
                e = engines[mode]
                marks.clear()
                t0 = time.perf_counter()
                tape.feed(e, c, T_TICK)
                t1 = time.perf_counter()
                e.step()
                t2 = time.perf_counter()
                rows[mode].append({"ingest_s": t1 - t0, "step_s": t2 - t1, "poll_s": t2 - t0,
                                   "scatter_build_s": marks["t_prog"] - t1,
                                   "dispatch_s": marks["t_prog_end"] - marks["t_prog"],
                                   "host_read_s": marks["t_read_end"] - marks["t_read"]})
                events[mode].append(marks["events"])
    finally:
        tick_engine._tick_program, tick_engine.host_read = real_program, real_read
    torch.cuda.synchronize()
    for mode, rs in rows.items():
        for r, (a, b) in zip(rs, events[mode]):
            # the program's span on the card, from its first op to its last
            r["program_device_ms"] = a.elapsed_time(b)
        polls[mode] = {k: {"p50": percentile([r[k] for r in rs], 50),
                           "p99": percentile([r[k] for r in rs], 99)} for k in rs[0]}
        polls[mode]["polls"] = len(rs)
    polls["interleaved"] = True
    polls["pipelined_minus_serial_poll_ms_per_poll"] = [
        1e3 * (p["poll_s"] - s["poll_s"]) for s, p in zip(rows["serial"], rows["pipelined"])]
    e = make()
    tape.feed(e, c0, T_TICK)
    e.step()
    tape.feed(e, c0 + 1, T_TICK)
    try:
        profile = device_profile(e.step)
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        profile = {"measured": False, "reason": repr(ex)[:300]}
    report = {"phase": "tick", "card": info["nvidia_smi"], "symbols": S_TICK,
              "frames": list(TICK_FRAMES), "window": T_TICK, "lanes": eng.last_stats["lanes"],
              "ring_delta_bit_equal_fresh_seed": True, "pipelined_bit_equal_serial_shifted": True,
              "k2_launches_per_step": n_launch, "host_reads_per_step": len(reads),
              "polls": polls, "profile_one_step": profile,
              "flips": {k: flips[k]["count"] for k in ("signal", "trend")}}
    emit(report)
    return {**k2_entry, "poll_ms_p50": 1e3 * polls["serial"]["poll_s"]["p50"],
            "poll_ms_p99": 1e3 * polls["serial"]["poll_s"]["p99"]}


def phase_portfolio(info):
    """The portfolio backtest on the card: S = 8 symbols, one of them
    shorter (left-padded), `max_positions = 5` (config.json's
    trading_params).  `stack_symbol_inputs` with exactly 2 K2 launches;
    capital silos in param-SL/TP mode at T = 8,192 with one K1 launch per
    symbol, bit for bit against the plain loop over all S symbols at once
    (replayed from CUDA graphs); the sizer-ladder silos and the shared pool
    (both equity cadences), plain loops on the card at T = 512, against
    the port's CPU run of the same inputs."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import (
        BacktestStats, default_params, portfolio_backtest, shared_capital_backtest,
        stack_symbol_inputs)
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    def candles(T):
        per = {}
        for i in range(S_PORT):
            d = generate_ohlcv(n=T - (T // 8 if i == 3 else 0), seed=40 + i)
            per[f"P{i}USDC"] = {k: d[k] for k in ("open", "high", "low", "close", "volume")}
        return per

    def stack(T):
        fused_ewma.launches = 0
        inp, syms = stack_symbol_inputs(candles(T), device="cuda")
        if fused_ewma.launches != 2:
            fail(f"stack_symbol_inputs made {fused_ewma.launches} K2 launches, not 2")
        return inp

    params = default_params(device="cuda")
    big = stack(T_PORT_K1)
    # --- silos, param SL/TP: one K1 launch per symbol ---------------------
    sweep_kernel.launches = 0
    (stats, metrics, pf), k1_call_ms = timed(lambda: portfolio_backtest(
        big, params, use_param_sl_tp=True, device="cuda"))
    k1_launches = sweep_kernel.launches
    if k1_launches != S_PORT:
        fail(f"the param-SL/TP portfolio made {k1_launches} K1 launches, not one per symbol")
    rows_params = params._replace(**{f: getattr(params, f).expand(S_PORT).contiguous()
                                     for f in params._fields})
    plain, plain_ms = timed(lambda: sweep_plain_graphed(big, rows_params))
    k1_check = {**compare_stats(stats, plain, f"portfolio_k1_S{S_PORT}_T{T_PORT_K1}"),
                "T": T_PORT_K1}
    # the path's K1 work, all S launches (each symbol's [T] streams, B = 1),
    # timed together as the plain loop is, against the sum of their bounds
    one = params._replace(stop_loss=params.stop_loss.reshape(1),
                          take_profit=params.take_profit.reshape(1))
    per_symbol = [type(big)(*(x[s] for x in big)) for s in range(S_PORT)]
    k1_ms = cuda_ms(lambda: [sweep_kernel(r, one, device="cuda") for r in per_symbol], 10)
    bound = [replay_bound_ms(BacktestStats(*(v[s:s + 1] for v in stats)), 1, T_PORT_K1)
             for s in range(S_PORT)]
    k1_entry = {"launches": k1_launches, "ms": k1_ms, "ms_per_launch": k1_ms / S_PORT,
                "call_ms": k1_call_ms, "plain_ms": plain_ms,
                "bound_ms": sum(b[0] for b in bound),
                "bound_by": max(bound)[1], "max_abs_err": k1_check["max_abs_err"],
                "trades": k1_check["trades"],
                "shape": f"{S_PORT} launches of B=1 x T={T_PORT_K1}; ms, plain_ms and "
                         "bound_ms each cover all of them",
                "plain": "the engine's loop over all symbols' rows, 32 candles a CUDA graph"}

    # --- plain-loop modes on the card against the CPU run -----------------
    small = stack(T_PORT_PLAIN)
    cpu = type(small)(*(x.cpu() for x in small))
    runs = {"silos_sizer_ladder": lambda inp, dev: portfolio_backtest(inp, device=dev)[0],
            "shared_per_update": lambda inp, dev: portfolio_backtest(
                inp, shared_capital=True, max_positions=5, device=dev)[0],
            "shared_per_candle_param_sl_tp": lambda inp, dev: shared_capital_backtest(
                inp, params, initial_balance=10_000.0 * S_PORT, max_positions=5,
                use_param_sl_tp=True, equity_cadence="per_candle", device=dev)[0]}
    plain_checks = []
    for name, fn in runs.items():
        fused_ewma.launches = sweep_kernel.launches = 0
        got, card_ms = timed(lambda: fn(small, "cuda"))
        if fused_ewma.launches or sweep_kernel.launches:
            fail(f"portfolio {name}: a plain-loop mode launched a kernel")
        t0 = time.perf_counter()
        ref = fn(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        worst = 0.0
        for f in ref._fields:
            g, r = getattr(got, f).cpu(), getattr(ref, f)
            if r.dtype == torch.int32:
                if not torch.equal(g, r):
                    fail(f"portfolio {name}: {f} differs from the CPU run")
            else:
                worst = max(worst, float(torch.abs(g - r).max()))
                # the engine tolerance of tests/test_torch_slice.py
                if not torch.allclose(g, r, rtol=1e-5, atol=1e-6):
                    fail(f"portfolio {name}: {f} outside rtol 1e-5, atol 1e-6 of the CPU run")
        trades = int(ref.total_trades.sum())
        if trades <= 0:
            fail(f"portfolio {name}: no trades — the comparison would be vacuous")
        plain_checks.append({"case": name, "T": T_PORT_PLAIN, "trades": trades,
                             "max_abs_err_vs_cpu": worst, "card_ms": card_ms,
                             "cpu_s": cpu_s})
    emit({"phase": "portfolio", "card": info["nvidia_smi"], "symbols": S_PORT,
          "max_positions": 5, "k1": {**k1_entry, "check": k1_check},
          "plain_loop_modes": plain_checks,
          "portfolio_k1": {k: float(v) for k, v in pf.items()}})
    return k1_entry


def tenant_grid(eng, symbols):
    """Heterogeneous tenants: a grid of confidence threshold, strength
    floor, position cap and minimum trade; some open and some pending
    symbols; balances from 1,000 up."""
    for i in range(eng.n_tenants):
        eng.set_tenant(
            i, balance=1_000.0 + 37.0 * i,
            open_symbols=[symbols[(3 * i) % len(symbols)]] if i % 5 == 0 else (),
            pending_symbols=[symbols[(7 * i + 1) % len(symbols)]] if i % 7 == 0 else (),
            conf_threshold=(0.0, 0.3, 0.5, 0.7)[i % 4],
            min_strength=(0.0, 20.0, 50.0, 70.0)[(i // 4) % 4],
            max_positions=(1, 2, 5, 64)[(i // 16) % 4],
            min_trade=(1.0, 40.0, 400.0)[(i // 64) % 3])


def decide_flips(card, cpu, feats, params):
    """Gate and exec differences between the card's and the CPU's decide,
    each required to sit within 1e-6 relative of the threshold of the
    value that decides it (strength, confidence, a sizer-ladder step, the
    minimum trade); float outputs compared bit for bit."""
    import numpy as np

    diff = (card["gate"] != cpu["gate"]) | (card["exec"] != cpu["exec"])
    n = int(diff.sum())
    far = 0
    if n:
        s = feats["strength"][None, :]
        rel = lambda a, b: np.abs(a - b) <= 1e-6 * np.maximum(np.abs(b), 1e-30)  # noqa: E731
        near = (rel(s, params["min_strength"][:card["gate"].shape[0], None])
                | rel(cpu["confidence"], params["conf_threshold"][:card["gate"].shape[0], None])
                | rel(feats["volatility"][None, :], 0.01) | rel(feats["volatility"][None, :], 0.02)
                | rel(cpu["size"], params["min_trade"][:card["gate"].shape[0], None]))
        far = int((diff & ~near).sum())
    floats = [k for k in ("confidence", "size", "qty", "sl_pct", "tp_pct", "equity")
              if not np.array_equal(card[k], cpu[k], equal_nan=True)]
    return n, far, floats


def phase_tenant(info):
    """The live decision path at full width: the tick phase's tape (64
    symbols × frames 1m/3m/5m/15m × a 256-candle window) through a port
    `TickEngine` into `TenantEngine(symbols=those 64, n_tenants=256)`, the
    fleet observatory on (top 8) and containment on; heterogeneous tenants
    (`tenant_grid`), a live SL/TP override on for half the run, a venue
    sync of a few lanes and a NaN balance poisoning one lane mid-run.  A
    warm poll, then 20 polls of ingest → step → `feats_from_tick` →
    `decide`.  Every decide: exactly one host read and no other
    synchronizing call of torch's; gates, decisions and exec against a
    `TenantEngine(device="cpu")` fed the same features and calls (flips
    only within 1e-6 of a threshold, counted), floats bit for bit; the
    poisoned lane `lane_quarantined` from the next decide on, its
    neighbours bit-identical to a card run without the poison; the fleet
    aggregates equal `host_aggregates` of the decide's own read-back
    table.  Then the decide's times, torch.profiler over one decide, and
    the same decide at the capacity row's width (256 tenants × 4
    symbols)."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.obs import fleetscope
    from ai_crypto_trader_tpu_torch.ops import tenant_engine, tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    tape = TickTape(S_TICK, T_TICK)
    cursor = tape.n - 64
    tick = tick_engine.TickEngine(tape.symbols, TICK_FRAMES, window=T_TICK, device="cuda")
    make = lambda dev: tenant_engine.TenantEngine(tape.symbols, N_TENANT, device=dev)  # noqa: E731
    card, twin, cpu = make("cuda"), make("cuda"), make("cpu")
    scopes = {id(e): fleetscope.FleetScope(top_k=8) for e in (card, twin, cpu)}
    for e in (card, twin, cpu):
        tenant_grid(e, tape.symbols)
    poison_lane, poll_sync, poll_poison = 77, 9, 10
    synced = {3: [tape.symbols[9]], 40: [], 130: [tape.symbols[0], tape.symbols[5]]}
    q_gate = tenant_engine.GATE_ID["lane_quarantined"]

    real_read, real_program = tenant_engine.host_read, tenant_engine._decide_program
    marks, reads = {}, []

    def quiet_read(readback):                  # the one sanctioned sync
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_read(readback)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def timed_program(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_program(*args, **kw)
        ev[1].record()
        marks["events"] = ev
        return out

    quiet = set(_debug_mode_messages(lambda: None))
    probe = set(_debug_mode_messages(lambda: torch.ones(1, device="cuda").item())) - quiet
    if not probe:
        fail("torch's sync debug mode flagged no .item(): it cannot check for syncs")

    def decide_all(feats, k):
        out = {}
        for name, e in (("card", card), ("twin", twin), ("cpu", cpu)):
            with fleetscope.use(scopes[id(e)]):
                if name != "card":
                    out[name] = e.decide(feats)
                    continue
                reads.clear()
                tenant_engine.host_read = quiet_read
                tenant_engine._decide_program = timed_program
                t0 = time.perf_counter()
                try:
                    msgs = _debug_mode_messages(lambda: out.__setitem__("card", e.decide(feats)))
                finally:
                    tenant_engine.host_read, tenant_engine._decide_program = real_read, real_program
                marks["decide_s"] = time.perf_counter() - t0
                syncs = [m for m in msgs if m in probe]
                if len(reads) != 1 or syncs:
                    fail(f"decide {k}: {len(reads)} host reads and {len(syncs)} other "
                         f"synchronizing calls, not 1 and 0: {syncs[:3]}")
        return out

    def poll(k):
        nonlocal cursor
        cursor += 1
        t0 = time.perf_counter()
        tape.feed(tick, cursor, T_TICK)
        t1 = time.perf_counter()
        tick.step()
        t2 = time.perf_counter()
        feats = card.feats_from_tick(tick.last_out, tick.last_valid, frame=0)
        outs = decide_all(feats, k)
        return feats, outs, {"ingest_s": t1 - t0, "step_s": t2 - t1,
                             "decide_s": marks["decide_s"],
                             "poll_s": t2 - t0 + marks["decide_s"]}

    poll("warm")
    rows, events, flips, floats_differ, quarantined_from = [], [], 0, set(), None
    exec_total = 0
    fused_ewma.launches = 0
    for k in range(TENANT_POLLS):
        if k == TENANT_POLLS // 4:
            for e in (card, twin, cpu):
                e.set_live_overrides(stop_loss=1.5, take_profit=3.0)
        if k == TENANT_POLLS // 4 + TENANT_POLLS // 2:
            for e in (card, twin, cpu):
                e.set_live_overrides(None, None)
        if k == poll_sync:
            for e in (card, twin, cpu):
                for lane, held in synced.items():
                    e.sync_positions(lane, held)
                    e.sync_balance(lane, 2_500.0 + lane)
        if k == poll_poison:
            for e in (card, cpu):
                e.sync_balance(poison_lane, float("nan"))
        feats, outs, row = poll(k)
        rows.append(row)
        events.append(marks["events"])
        c, r = outs["card"], outs["cpu"]
        exec_total += int(np.count_nonzero(c["exec"]))
        n, far, fl = decide_flips(c, r, feats, cpu._params_np)
        floats_differ |= set(fl)
        flips += n
        if far:
            fail(f"decide {k}: {far} gate/exec differences from the CPU farther than 1e-6 "
                 "from a threshold")
        if not np.array_equal(c["decision"], r["decision"]):
            fail(f"decide {k}: decisions differ from the CPU run")
        for key, v in card._state_np.items():
            if not np.array_equal(v, cpu._state_np[key], equal_nan=True):
                floats_differ.add("state." + key)
        # the poisoned lane, and its neighbours against the twin
        healthy = np.ones(N_TENANT, bool)
        healthy[poison_lane] = False
        if k >= poll_poison:
            decided = c["gate"][poison_lane] != tenant_engine.NO_DECISION
            if not decided.any() or (c["gate"][poison_lane][decided] != q_gate).any():
                fail(f"decide {k}: the poisoned lane is not lane_quarantined")
            quarantined_from = quarantined_from if quarantined_from is not None else k
        for key in c:
            if not np.array_equal(c[key][healthy], outs["twin"][key][healthy]):
                fail(f"decide {k}: a neighbour of the poisoned lane differs in {key}")
        for key, v in card._state_np.items():
            if not np.array_equal(v[healthy], twin._state_np[key][healthy]):
                fail(f"decide {k}: a neighbour's state {key} differs from the unpoisoned run")
        # the fleet aggregates against the host recompute of this table
        st = card._state_np
        host = fleetscope.host_aggregates(
            gate=c["gate"][:, :S_TICK], pnl=card.rolling_pnl(), balance=st["balance"],
            max_drawdown=st["max_drawdown"], active=card._params_np["active"],
            quarantined=st["quarantined"], k=8)
        for key, v in host.items():
            if not np.array_equal(np.asarray(card.last_fleet[key], np.float64),
                                  np.asarray(v, np.float64), equal_nan=True):
                fail(f"decide {k}: fleet {key} differs from host_aggregates")
    k2_launches = fused_ewma.launches
    if k2_launches != 3 * TENANT_POLLS:
        fail(f"{TENANT_POLLS} tick steps feeding the decides made {k2_launches} K2 launches, "
             f"not {3 * TENANT_POLLS}")
    if floats_differ:
        fail(f"the card's decide differs from the CPU's in {sorted(floats_differ)}")
    if not exec_total:
        fail("no decide cleared an entry: the comparison would be vacuous")
    if card.quarantine_trips != 1 or cpu.quarantine_trips != 1 or twin.quarantine_trips:
        fail("the poison tripped no quarantine, or more than one")
    execs = int(np.count_nonzero(outs["card"]["exec"]))
    vetoes = card.veto_counts()
    torch.cuda.synchronize()
    spans = [a.elapsed_time(b) for a, b in events]
    pct = lambda key: {q: 1e3 * percentile([r[key] for r in rows], q)  # noqa: E731
                       for q in (50, 99)}
    feats = card.feats_from_tick(tick.last_out, tick.last_valid, frame=0)
    try:
        with fleetscope.use(scopes[id(card)]):
            profile = device_profile(lambda: card.decide(feats))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        profile = {"measured": False, "reason": repr(ex)[:300]}

    # the capacity row's width: 256 tenants × the first 4 symbols
    cap = tenant_engine.TenantEngine(tape.symbols[:S_CAP], N_TENANT, device="cuda")
    tenant_grid(cap, tape.symbols[:S_CAP])
    cap_feats = cap.feats_from_tick(tick.last_out, tick.last_valid, frame=0)
    cap_feats["valid"][S_CAP:] = False
    cap_ms = []
    with fleetscope.use(fleetscope.FleetScope(top_k=8)):
        cap.decide(cap_feats)
        for _ in range(TENANT_POLLS):
            t0 = time.perf_counter()
            cap.decide(cap_feats)
            cap_ms.append(1e3 * (time.perf_counter() - t0))
    report = {
        "phase": "tenant", "card": info["nvidia_smi"], "tenants": N_TENANT,
        "symbols": S_TICK, "frames": list(TICK_FRAMES), "window": T_TICK,
        "polls": TENANT_POLLS, "host_reads_per_decide": 1, "other_syncs_per_decide": 0,
        "k2_launches_in_the_polls": k2_launches,
        "gate_or_exec_flips_vs_cpu": flips, "floats_vs_cpu": "bit-identical",
        "poisoned_lane": poison_lane, "quarantined_from_decide": quarantined_from,
        "neighbours_bit_identical_to_unpoisoned_run": True,
        "fleet_equals_host_aggregates": True,
        "veto_counts_last": vetoes, "exec_last": execs, "exec_total": exec_total,
        "fleet_last": {k: np.asarray(v).tolist() for k, v in card.last_fleet.items()},
        "decide_ms": pct("decide_s"),
        "decide_program_device_span_ms": {q: percentile(spans, q) for q in (50, 99)},
        "poll_ms": pct("poll_s"), "ingest_ms": pct("ingest_s"), "step_ms": pct("step_s"),
        "profile_one_decide": profile,
        "capacity_width": {"tenants": N_TENANT, "symbols": S_CAP,
                           "decide_ms": {q: percentile(cap_ms, q) for q in (50, 99)}},
    }
    emit(report)
    return {"tick_steps": TENANT_POLLS, "launches": k2_launches,
            "decide_ms_p50": report["decide_ms"][50], "poll_ms_p50": report["poll_ms"][50]}


def phase_mc(info):
    """The Monte-Carlo service at the bench's width (bench.py:837-866):
    2,048 daily returns from `default_rng(0).normal(0.0002, 0.01)`, price
    40,000, 30 days, 10,000 paths.  `run_simulation` (GBM and bootstrap),
    `stress_var_cvar` (flash_crash, 4,096 paths), the correlated
    portfolio (8 assets × 10,000 × 30) and `trailing_stop_update` over a
    [256, 64] position grid for 20 prices in all four strategies.  Each
    result against the port's CPU run on the same draws (drawn on the card
    from a seeded generator, drawn again from the same seed and moved to
    the CPU): VaR, CVaR and percentiles within rtol 1e-5, the trailing
    stops exactly.  Each call's p50 over 20 calls, a fresh generator seed
    each."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.mc import run_simulation, simulate_portfolio_correlated
    from ai_crypto_trader_tpu_torch.risk import (
        STRATEGIES, stress_var_cvar, trailing_stop_init, trailing_stop_update)

    returns = np.random.default_rng(0).normal(0.0002, 0.01, 2048).astype(np.float32)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    shape = (MC_SIMS, MC_DAYS - 1)

    def close(name, got, ref, rtol=MC_RTOL):
        g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        err = float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-12)))
        if not np.allclose(g, r, rtol=rtol, atol=0.0):
            fail(f"mc {name}: card and CPU differ by {err:.3g} relative, over {rtol}")
        return err

    a = np.random.default_rng(8).normal(size=(8, 8)).astype(np.float32)
    cov = (a @ a.T * 0.05 + np.eye(8, dtype=np.float32) * 0.02).astype(np.float32)
    prices = np.linspace(1.0, 40_000.0, 8).astype(np.float32)
    mus = np.linspace(-0.1, 0.3, 8).astype(np.float32)
    w = np.full(8, 1.0 / 8, np.float32)
    calls = {
        "run_simulation_gbm": (
            lambda g, **kw: run_simulation(g, MC_PRICE, returns, days=MC_DAYS,
                                           num_sims=MC_SIMS, **kw),
            lambda g: {"z": torch.randn(shape, generator=g, device="cuda")}),
        "run_simulation_bootstrap": (
            lambda g, **kw: run_simulation(g, MC_PRICE, returns, days=MC_DAYS,
                                           num_sims=MC_SIMS, method="bootstrap", **kw),
            lambda g: {"idx": torch.randint(0, returns.size, shape, generator=g,
                                            device="cuda")}),
        "stress_var_cvar_flash_crash": (
            lambda g, **kw: stress_var_cvar(g, MC_PRICE, returns, stress="flash_crash",
                                            num_sims=4096, **kw),
            lambda g: {"z": torch.randn((4096, MC_DAYS - 1), generator=g, device="cuda")}),
        "portfolio_correlated_8": (
            lambda g, **kw: simulate_portfolio_correlated(g, prices, mus, cov, w, MC_DAYS,
                                                          MC_SIMS, **kw),
            lambda g: {"z": torch.randn((MC_SIMS, MC_DAYS - 1, 8), generator=g,
                                        device="cuda")}),
    }
    report = {"phase": "mc", "card": info["nvidia_smi"], "sims": MC_SIMS, "days": MC_DAYS,
              "rtol": MC_RTOL, "calls": {}}
    for name, (fn, draw) in calls.items():
        got = fn(gen(1), device="cuda")
        again = fn(gen(1), **draw(gen(1)), device="cuda")     # the same draws, injected
        draws = {k: v.cpu() for k, v in draw(gen(1)).items()}
        ref = fn(None, **draws, device="cpu")
        errs = {}
        if name == "portfolio_correlated_8":
            if not torch.equal(got, again):
                fail(f"mc {name}: the injected draws are not the generator's")
            errs["paths"] = close(name, got.cpu(), ref)
        elif name.startswith("stress"):
            if got != again:
                fail(f"mc {name}: the injected draws are not the generator's")
            for k in ("var_pct", "cvar_pct", "stress_var_pct", "stress_cvar_pct",
                      "var_signed_pct", "stress_var_signed_pct"):
                errs[k] = close(f"{name}.{k}", got[k], ref[k])
            if not got["stress_var_pct"] > got["var_pct"]:
                fail("mc: the flash crash did not deepen the VaR")
        else:
            if not torch.equal(got["paths"], again["paths"]):
                fail(f"mc {name}: the injected draws are not the generator's")
            for k in ("var", "cvar", "percentile_prices", "expected_price",
                      "max_drawdown_median", "mu", "sigma"):
                errs[k] = close(f"{name}.{k}", got[k].cpu(), ref[k])
            if not np.isfinite(got["paths"].cpu().numpy()).all():
                fail(f"mc {name}: non-finite paths")
        ms = []
        for i in range(MC_CALLS):
            t0 = time.perf_counter()
            out = fn(gen(100 + i), device="cuda")
            if isinstance(out, dict) and "var" in out:
                float(out["var"])                              # what a caller reads
            elif torch.is_tensor(out):
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        report["calls"][name] = {"ms_p50": percentile(ms, 50), "ms_p99": percentile(ms, 99),
                                 "max_rel_err_vs_cpu": errs,
                                 "var": (float(got["var"]) if isinstance(got, dict)
                                         and "var" in got else None)}

    # trailing stops over a [256, 64] grid, 20 prices, every strategy
    rng = np.random.default_rng(12)
    entry = rng.uniform(50.0, 500.0, STOP_GRID).astype(np.float32)
    path = (entry * np.cumprod(1.0 + rng.normal(0.004, 0.02, (STOP_PRICES, *STOP_GRID)),
                               axis=0)).astype(np.float32)
    stop_report = {}
    for strategy in STRATEGIES:
        kw = dict(strategy=strategy, atr=entry * np.float32(0.01),
                  volatility=entry * np.float32(0.02))

        def run(dev):
            st = trailing_stop_init(entry, entry * np.float32(0.97), device=dev)
            fired = 0
            for p in path:
                st, trig = trailing_stop_update(st, p, device=dev, **kw)
                fired = fired + trig.to(torch.int32)
            return st, fired

        (st, fired), card_ms = timed(lambda: run("cuda"))
        ref, ref_fired = run("cpu")
        for f in st._fields:
            if not torch.equal(getattr(st, f).cpu(), getattr(ref, f)):
                fail(f"trailing stop {strategy}: {f} differs from the CPU run")
        if not torch.equal(fired.cpu(), ref_fired) or int(ref.n_adjustments.sum()) == 0:
            fail(f"trailing stop {strategy}: triggers differ, or nothing adjusted")
        ms = [timed(lambda: run("cuda"))[1] for _ in range(5)]
        stop_report[strategy] = {"ms_20_updates_p50": percentile(ms, 50),
                                 "adjustments": int(ref.n_adjustments.sum()),
                                 "triggered": int(ref_fired.sum()), "exact": True}
    report["trailing_stops"] = {"grid": list(STOP_GRID), "prices": STOP_PRICES,
                                **stop_report}
    emit(report)
    return report


def lane_features(tape, cursor, frames, limit):
    """Each (symbol, frame) lane's OHLCV features [limit, 5] as the
    prediction service builds them from its klines (`_features_from_klines`,
    models/service.py:49-56), symbol-major."""
    import numpy as np

    return [np.asarray([row[1:6] for row in tape.klines(i, iv, cursor, limit)], np.float32)
            for i in range(len(tape.symbols)) for iv in frames]


def lane_results(model_type, feats, seed):
    """One `TrainResult` per lane: the port's initialisers drawing from one
    seeded CPU generator, lane after lane; each lane's scaler fitted on its
    own features; the close (column 3) as target, as the service predicts."""
    import torch

    from ai_crypto_trader_tpu_torch.models import TrainResult, build_model, fit_scaler

    horizons = (1, 3, 5) if model_type == "multitask" else (1,)
    kwargs = dict(units=NN_UNITS, dropout=0.2, horizons=horizons)
    g = torch.Generator().manual_seed(seed)
    out = []
    for lane, f in enumerate(feats):
        model = build_model(model_type, **kwargs, features=f.shape[1], generator=g,
                            device="cpu")
        out.append(TrainResult({k: v.detach() for k, v in model.named_parameters()},
                               model_type, fit_scaler(f, device="cpu"), kwargs,
                               best_val_loss=0.001 * (1 + lane % 7), target_col=3))
    return out


def batched_check(results, feats, label):
    """`predict_prices_batched` on the card against the port's CPU run of the
    same results and windows: the scaled outputs (read through the
    `host_read` seam) within NN_ATOL, the prices within NN_RTOL.  One warm
    call, then one call with its host reads counted and torch's sync debug
    mode on: exactly one read and no other synchronizing call."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import train as mtrain

    real_read, seen, reads = mtrain.host_read, [], []

    def capture(rb):
        seen.append(real_read(rb))
        return seen[-1]

    def quiet_read(rb):                        # the one sanctioned sync
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return capture(rb)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    run = lambda dev: mtrain.predict_prices_batched(results, feats, seq_len=NN_SEQ,  # noqa: E731
                                                    device=dev)
    mtrain.host_read = capture
    try:
        ref = run("cpu")
        run("cuda")                            # warm: the stack goes up once
        mtrain.host_read = quiet_read
        got = []
        syncs = sync_calls(lambda: got.append(run("cuda")))
    finally:
        mtrain.host_read = real_read
    if len(reads) != 1 or syncs:
        fail(f"nn {label}: a batched predict made {len(reads)} host reads and "
             f"{len(syncs)} other synchronizing calls ({syncs[:2]}), not 1 and 0")
    cpu_out, card_out = seen[0], seen[-1]
    errs = {}
    for k in ("mean", "log_sigma"):
        if k in cpu_out:
            errs[k] = float(np.max(np.abs(card_out[k] - cpu_out[k])))
            if not np.isfinite(card_out[k]).all() or errs[k] > NN_ATOL:
                fail(f"nn {label}: card {k} off the CPU run's by {errs[k]:.3g} (atol {NN_ATOL})")
    price = lambda preds: np.array([float(np.ravel(p["predicted_price"])[0])  # noqa: E731
                                    for p in preds], np.float64)
    g, r = price(got[0]), price(ref)
    errs["price_rel"] = float(np.max(np.abs(g - r) / np.abs(r)))
    if not np.allclose(g, r, rtol=NN_RTOL, atol=0.0):
        fail(f"nn {label}: card prices off the CPU run's by {errs['price_rel']:.3g} relative")
    return got[0], errs


def cli_train_k2(stacked, ind, recorded, label="nn: cli train's", case="cli_train"):
    """K2 where `cli train` reads it, at 64 × 43,200.  Each of the two
    launches that `compute_indicators` made (``recorded``: its jobs'
    inputs) is run again through the kernel and held against the plain
    EWMA of the same inputs at K2's tolerance (`ewma_check`), and timed
    beside the plain version and its bound.  Then the seven columns are
    built again with every EWMA entry plain (no launch): the four that no
    EWMA feeds (close, volume, bb_position, stoch_k) must be equal bit for
    bit, and the three that K2 feeds must stay within the bounds its
    tolerance e = 1e-3 + 2e-5·S carries into them — ATR (an EWMA of the true
    range) within e; the MACD line (EMA-12 − EMA-26 of the close) within
    2e-3 + 4e-5·max(close); RSI = 100·g/(g + l) within the widest move of
    that ratio with its gain g and loss l each off by its e, plus 1e-4 for
    the two float32 evaluations (each within 3 ulps of 100).  Phase `rl`
    holds the RL markets' tables ([S, 1024]) the same way; ``label`` and
    ``case`` name the caller in messages and checks."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import indicators as ind_mod
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma_jobs, fused_ewma_plain

    checks = []
    for i, jobs in enumerate(recorded):
        named = [(f"job{j}_K{len(a)}_start{st}", x.reshape(-1, x.shape[-1]), a, st)
                 for j, (x, a, st) in enumerate(jobs)]
        check = ewma_check(named, f"{case}_launch{i}")
        args = [(x, a, st) for _, x, a, st in named]
        checks.append({**check, "ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 20),
                       "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, st), 3)
                                       for x, a, st in args)})
    all_jobs = [(x.reshape(-1, x.shape[-1]), a, st) for jobs in recorded for x, a, st in jobs]
    b_ms, o_ms = ewma_jobs_bound(all_jobs)

    plain = plain_table(stacked, f"{label} plain columns")
    for k in ("close", "volume", "bb_position", "stoch_k"):
        if not same_bits(ind[k], plain[k]):
            fail(f"{label} {k}, which no EWMA feeds, differs with the plain EWMA")
    # RSI's gain and loss: the plain Wilder EWMA of the first launch's stacked moves
    x, alphas, start = recorded[0][1]
    g, l = fused_ewma_plain(x.reshape(-1, x.shape[-1]), alphas, start)[0].reshape(
        x.shape).double()[:2]
    eg, el = 1e-3 + 2e-5 * g, 1e-3 + 2e-5 * l
    ratio = lambda a, b: 100.0 * a / (a + b)  # noqa: E731
    r = ratio(g, l)
    spread = torch.maximum(ratio(g + eg, torch.clamp_min(l - el, 0.0)) - r,
                           r - ratio(torch.clamp_min(g - eg, 0.0), l + el))
    # masked and filled as the column is, so each candle meets its own bound
    rsi_tol = ind_mod.nanfill(ind_mod._mask_warmup(spread.float(), 15)) + 1e-4
    bounds = {"atr": 1e-3 + 2e-5 * plain["atr"],
              "macd": 2e-3 + 4e-5 * plain["close"].amax(-1, keepdim=True),
              "rsi": rsi_tol}
    columns = {}
    for k in CLI_TRAIN_COLUMNS:
        diff = torch.abs(ind[k] - plain[k])
        columns[k] = {"max_abs_diff": float(diff.max())}
        if k in bounds:
            worst = float((diff / bounds[k]).max())
            columns[k]["max_diff_over_bound"] = worst
            if not worst <= 1.0:
                fail(f"{label} {k} is {float(diff.max()):.3g} off its plain-EWMA "
                     f"column, beyond the bound K2's tolerance gives ({worst:.3g} of it)")
    return {"ms": sum(c["ms"] for c in checks), "ms_per_launch": [c["ms"] for c in checks],
            "plain_ms": sum(c["plain_ms"] for c in checks),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "max_abs_err": max(j["max_abs_err"] for c in checks for j in c["jobs"]),
            "max_rel_err": max(j["max_rel_err"] for c in checks for j in c["jobs"]),
            "plans": [c["plan"] for c in checks], "columns_vs_plain_ewma": columns,
            "launch_checks": checks}


def phase_nn(info):
    """The model zoo through the prediction service's batched path at its
    width: 256 lanes (the tick tape's 64 symbols × frames 1m/3m/5m/15m),
    each lane its own model (the port's initialisers, a seeded generator)
    and its own 60-candle OHLCV window (F = 5).  For each of the nine
    architectures at `build_model`'s defaults: `predict_prices_batched` on
    the card against the port's CPU run (scaled outputs within NN_ATOL,
    prices within NN_RTOL), one host read and no other sync a call, three
    lanes through `predict_prices` equal to their lanes of the batch (rtol
    NN_RTOL, the JAX package's own test's), p50/p99 over 10 calls after a
    warm one.  torch.profiler over one `lstm` call, and cuDNN's
    `nn.LSTM` (2 layers × 64, one weight set) over the same 256 windows as
    the library's time for that layer.  Then `cli train`'s feature set:
    64 symbols of `generate_ohlcv(n=43,200, seed=60 + i)` stacked through
    `compute_indicators` on the card (exactly 2 K2 launches, each held
    against the plain EWMA on its recorded inputs: `cli_train_k2`), the
    seven columns of cli.py:182-184, and the `lstm` group over those 64
    lanes (F = 7) held to the CPU run the same way."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.models import MODEL_REGISTRY, predict_prices
    from ai_crypto_trader_tpu_torch.models import train as mtrain
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    t_phase = time.perf_counter()
    tape = TickTape(S_TICK, T_TICK)
    feats = lane_features(tape, tape.n - 64, TICK_FRAMES, T_TICK)
    report = {"phase": "nn", "card": info["nvidia_smi"], "lanes": len(feats),
              "seq_len": NN_SEQ, "features": feats[0].shape[1], "units": NN_UNITS,
              "atol": NN_ATOL, "rtol": NN_RTOL, "architectures": {}}
    build_s = 0.0
    for a, mt in enumerate(MODEL_REGISTRY):
        t0 = time.perf_counter()
        results = lane_results(mt, feats, 100 + a)
        build_s += time.perf_counter() - t0
        batch, errs = batched_check(results, feats, mt)
        single_rel = 0.0
        for lane in (0, 127, 255):
            s = float(np.ravel(predict_prices(results[lane], feats[lane], seq_len=NN_SEQ,
                                              device="cuda")["predicted_price"])[0])
            b = float(np.ravel(batch[lane]["predicted_price"])[0])
            single_rel = max(single_rel, abs(s - b) / abs(b))
        if single_rel > NN_RTOL:
            fail(f"nn {mt}: predict_prices off its lane of the batch by {single_rel:.3g}")
        ms = []
        for _ in range(NN_CALLS):
            t0 = time.perf_counter()
            mtrain.predict_prices_batched(results, feats, seq_len=NN_SEQ, device="cuda")
            ms.append(1e3 * (time.perf_counter() - t0))
        entry = {"ms_p50": percentile(ms, 50), "ms_p99": percentile(ms, 99),
                 "max_err_vs_cpu": errs, "single_vs_batch_max_rel": single_rel,
                 "parameters_per_lane": sum(v.numel() for v in results[0].params.values())}
        if mt == "lstm":
            try:
                entry["profile_one_call"] = device_profile(
                    lambda: mtrain.predict_prices_batched(results, feats, seq_len=NN_SEQ,
                                                          device="cuda"))
            except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
                entry["profile_one_call"] = {"measured": False, "reason": repr(ex)[:300]}
            lib = torch.nn.LSTM(feats[0].shape[1], NN_UNITS, num_layers=2,
                                batch_first=True).cuda()
            x = torch.from_numpy(np.stack([f[-NN_SEQ:] for f in feats])).cuda()
            with torch.no_grad():
                entry["cudnn_lstm_ms"] = cuda_ms(lambda: lib(x), 20)
        report["architectures"][mt] = entry

    # cli train's feature set: 64 symbols × 43,200 candles, 7 columns
    per = [generate_ohlcv(n=T_GA, seed=60 + i) for i in range(S_TICK)]
    stacked = {k: np.stack([np.asarray(d[k], np.float32) for d in per])
               for k in ("open", "high", "low", "close", "volume")}
    fused_ewma.launches = 0
    with recording_ewma([]) as recorded:
        ind = compute_indicators(stacked, device="cuda")
    k2_launches = fused_ewma.launches
    if k2_launches != 2 or len(recorded) != 2:
        fail(f"nn: cli train's indicators made {k2_launches} K2 launches "
             f"({len(recorded)} calls), not 2")
    k2 = cli_train_k2(stacked, ind, recorded)
    cols = torch.stack([ind[k] for k in CLI_TRAIN_COLUMNS], dim=-1).cpu().numpy()
    if not np.isfinite(cols).all():
        fail("nn: cli train's feature columns are not finite")
    cli_feats = list(cols)
    results = lane_results("lstm", cli_feats, 300)
    _, errs = batched_check(results, cli_feats, "cli_train_lstm")
    ms = []
    for _ in range(NN_CALLS):
        t0 = time.perf_counter()
        mtrain.predict_prices_batched(results, cli_feats, seq_len=NN_SEQ, device="cuda")
        ms.append(1e3 * (time.perf_counter() - t0))
    report["cli_train"] = {"symbols": S_TICK, "candles": T_GA, "columns": list(CLI_TRAIN_COLUMNS),
                           "k2_launches": k2_launches, "k2": k2, "max_err_vs_cpu": errs,
                           "lstm_ms_p50": percentile(ms, 50), "lstm_ms_p99": percentile(ms, 99)}
    report["model_build_s"] = build_s
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return {"launches": k2_launches, **{k: v for k, v in k2.items() if k != "launch_checks"},
            "lanes": S_TICK, "T": T_GA,
            "shape": f"compute_indicators over {S_TICK} x {T_GA} (cli train's feature set)"}


def detected_branch(mt, card, cpu, windows):
    """`detect_patterns`' detected branch (primary pattern, confidence,
    completion, implications) on the card against the CPU, at threshold 0
    and with the classifier's no_pattern output bias lowered by 10 (on both
    sides), so that a pattern leads the average on every symbol.  The
    verdicts must be equal and every symbol detected; the primary pattern
    equal but where the CPU's top two lie within NN_ATOL; the confidence
    within NN_ATOL; the completion (the window where the primary's
    probability peaks) equal but where the CPU's probabilities of the two
    windows lie within NN_ATOL.  Returns (detected, near ties)."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.patterns import PatternRecognizer, detect_patterns
    from ai_crypto_trader_tpu_torch.patterns.model import (
        N_CLASSES, PATTERN_CLASSES, PATTERN_IMPLICATIONS, _window_probs)

    none = PATTERN_CLASSES.index("no_pattern")
    head = [k for k, v in cpu.params.items() if k.endswith("bias") and v.shape == (N_CLASSES,)]
    if len(head) != 1:
        fail(f"patterns {mt}: no single output bias among {sorted(cpu.params)}")

    def lowered(rec):
        params = dict(rec.params)
        params[head[0]] = params[head[0]].clone()
        params[head[0]][none] -= 10.0
        return PatternRecognizer(mt, params)

    card0, cpu0 = lowered(card), lowered(cpu)
    detected, ties = 0, 0
    for w in windows:
        got = detect_patterns(card0, w, confidence_threshold=0.0, device="cuda")
        ref = detect_patterns(cpu0, w, confidence_threshold=0.0, device="cpu")
        if got["detected"] != ref["detected"] or not ref["detected"]:
            fail(f"patterns {mt} at threshold 0: detected {got['detected']} on the card, "
                 f"{ref['detected']} on the CPU")
        detected += 1
        avg = np.array(list(ref["all_probabilities"].values()))
        if got["primary_pattern"] != ref["primary_pattern"]:
            if np.diff(np.sort(avg)[::-1][:2]).item() < -NN_ATOL:
                fail(f"patterns {mt}: primary {got['primary_pattern']} on the card, "
                     f"{ref['primary_pattern']} on the CPU")
            ties += 1
            continue
        if abs(got["confidence"] - ref["confidence"]) > NN_ATOL:
            fail(f"patterns {mt}: confidence {got['confidence']} on the card, "
                 f"{ref['confidence']} on the CPU")
        if got["implications"] != PATTERN_IMPLICATIONS[ref["primary_pattern"]]:
            fail(f"patterns {mt}: the card's implications are not its pattern's")
        if got["completion"] != ref["completion"]:
            per = _window_probs(cpu0.params, mt, torch.as_tensor(w), NN_SEQ, 5)[
                :, PATTERN_CLASSES.index(ref["primary_pattern"])].numpy()
            at = [round(c * per.size) - 1 for c in (got["completion"], ref["completion"])]
            if abs(per[at[0]] - per[at[1]]) > NN_ATOL:
                fail(f"patterns {mt}: completion {got['completion']} on the card, "
                     f"{ref['completion']} on the CPU")
            ties += 1
    return detected, ties


def phase_patterns(info):
    """The chart-pattern classifier at the pattern service's width
    (patterns/service.py:79-112): the tick tape's 64 symbols, each one's
    256-candle `5m` window (seq_len 60, stride 5: 40 windows), through
    `detect_patterns` for each of the three classifiers (seeded parameters
    on the card).  Each symbol against the port's CPU run of the same
    parameters: the averaged probabilities within NN_ATOL, the same
    verdict and the same top 3 except where two neighbouring probabilities
    lie within NN_ATOL of each other (counted).  Seeded weights detect
    nothing at the default threshold, so each classifier runs the detected
    branch too (`detected_branch`).  The p50 and p99 over 10 rounds of the
    64 symbols."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.patterns import PatternRecognizer, detect_patterns
    from ai_crypto_trader_tpu_torch.patterns.model import _build

    t_phase = time.perf_counter()
    tape = TickTape(S_TICK, T_TICK)
    windows = lane_features(tape, tape.n - 64, ("5m",), T_TICK)
    report = {"phase": "patterns", "card": info["nvidia_smi"], "symbols": len(windows),
              "candles": T_TICK, "seq_len": NN_SEQ, "stride": 5, "atol": NN_ATOL,
              "classifiers": {}}
    for j, mt in enumerate(("cnn", "lstm", "cnn_lstm")):
        model = _build(mt, generator=torch.Generator().manual_seed(200 + j), device="cuda")
        card = PatternRecognizer(mt, {k: v.detach() for k, v in model.named_parameters()})
        cpu = PatternRecognizer(mt, {k: v.cpu() for k, v in card.params.items()})
        err, ties = 0.0, 0
        for w in windows:
            got = detect_patterns(card, w, device="cuda")
            ref = detect_patterns(cpu, w, device="cpu")
            g = np.array(list(got["all_probabilities"].values()))
            r = np.array(list(ref["all_probabilities"].values()))
            err = max(err, float(np.max(np.abs(g - r))))
            if err > NN_ATOL or got["detected"] != ref["detected"]:
                fail(f"patterns {mt}: the card's probabilities are {err:.3g} off the CPU's, "
                     f"or the verdict differs")
            top_g = [t["pattern"] for t in got["top_patterns"]]
            top_r = [t["pattern"] for t in ref["top_patterns"]]
            if top_g != top_r:
                srt = np.sort(r)[::-1][:4]
                if np.min(np.abs(np.diff(srt))) > NN_ATOL:
                    fail(f"patterns {mt}: top 3 {top_g} on the card, {top_r} on the CPU")
                ties += 1
        detected_0, ties_0 = detected_branch(mt, card, cpu, windows)
        rounds = []
        for _ in range(NN_CALLS):
            t0 = time.perf_counter()
            for w in windows:
                detect_patterns(card, w, device="cuda")
            rounds.append(1e3 * (time.perf_counter() - t0))
        report["classifiers"][mt] = {
            "max_abs_err_vs_cpu": err, "top3_near_tie_differences": ties,
            "threshold_0_detected": detected_0, "threshold_0_near_tie_differences": ties_0,
            "round_ms_p50": percentile(rounds, 50), "round_ms_p99": percentile(rounds, 99),
            "detected_last_round": int(sum(detect_patterns(card, w, device="cuda")["detected"]
                                           for w in windows))}
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return report


def recording_bus():
    """The port's EventBus and a "*" subscriber that records every event
    published on it (its queue holds more than any phase publishes)."""
    from ai_crypto_trader_tpu_torch.shell import EventBus

    bus = EventBus(max_queue=1 << 20)
    return bus, bus.subscribe("*")


@contextlib.contextmanager
def counted(module, name):
    """``module.name`` wrapped to record the time of each call; yields the
    list of those times."""
    real, times = getattr(module, name), []

    def call(*args, **kw):
        out = real(*args, **kw)
        times.append(time.perf_counter())
        return out

    setattr(module, name, call)
    try:
        yield times
    finally:
        setattr(module, name, real)


def train_row(info):
    """The bench's `nn` row (bench.py:1154-1262) through `EpochTrainer`:
    the zoo `lstm` (2 × LSTM-64 and its head, `build_model`'s initialisers
    from a generator seeded 0), B 32 × T 60 × F 8, 32 batches an epoch,
    seeded normal inputs and targets, Adam at 1e-3, eval-mode loss as the
    bench's.  A warm epoch, 3 timed epochs (host wall, each ending in its
    one read: ms per step amortised, the bench's `nn_train_step_ms`), then
    one epoch with its reads counted and torch's sync debug mode on (one
    read, no other sync).  The 5 epoch losses and the final parameters
    against the port's CPU run from the same parameters and handed-over
    permutations (TRAIN_RTOL / TRAIN_ATOL).  The Function's dzx and dwh on
    the card against autograd through the plain loop on the card at 60 ×
    32 × 64 (each within LSTM_GRAD_RTOL of its largest magnitude);
    torch.profiler over one step; cuDNN's `nn.LSTM` (2 × 64) forward +
    backward at the same shapes as the library's time."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from ai_crypto_trader_tpu_torch.models import build_model, train, train_loop
    from ai_crypto_trader_tpu_torch.models.fused_lstm import LSTMScan, _scan

    B, T, F, NB = TRAIN_B, NN_SEQ, TRAIN_F, TRAIN_BATCHES
    model = build_model("lstm", units=NN_UNITS, features=F,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    tmpl = train._template("lstm", (("units", NN_UNITS),), F)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(NB * B, T, F)).astype(np.float32)
    Y = rng.normal(size=(NB * B, 1)).astype(np.float32)
    perms = [np.random.default_rng(10 + e).permutation(NB * B) for e in range(5)]

    def loss_fn(p, xb, yb, gen):                     # eval mode, as the bench's
        return train._loss_fn(functional_call(tmpl, p, (xb, False)), yb, "lstm")

    def setup(dev):
        params = {k: v.to(dev).clone() for k, v in params0.items()}
        tx = train_loop.Adam(1e-3)
        return (train_loop.EpochTrainer(loss_fn, tx, device=dev), params, tx.init(params),
                torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev),
                [torch.from_numpy(p).to(dev) for p in perms])

    def epoch(state, e):
        trainer, params, opt, Xd, Yd, pd = state
        params, opt, m = trainer.epoch(params, opt, Xd, Yd, pd[e], None, batch_size=B)
        state[2] = opt
        return train_loop.host_read(m)

    cpu = list(setup("cpu"))
    t0 = time.perf_counter()
    cpu_losses = [float(epoch(cpu, e)[0]) for e in range(5)]
    cpu_s = time.perf_counter() - t0
    card = list(setup("cuda"))
    losses = [float(epoch(card, 0)[0])]              # warm
    t0 = time.perf_counter()
    losses += [float(epoch(card, e)[0]) for e in (1, 2, 3)]
    step_ms = 1e3 * (time.perf_counter() - t0) / (3 * NB)
    reads, real_read = [], train_loop.host_read

    def quiet_read(rb):                              # the one sanctioned sync
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_read(rb)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    train_loop.host_read = quiet_read
    try:
        syncs = sync_calls(lambda: losses.append(float(epoch(card, 4)[0])))
    finally:
        train_loop.host_read = real_read
    if len(reads) != 1 or syncs:
        fail(f"train: an epoch made {len(reads)} host reads and {len(syncs)} other "
             f"synchronizing calls ({syncs[:2]}), not 1 and 0")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    param_err = max(float((card[1][k].detach().cpu() - cpu[1][k].detach()).abs().max())
                    for k in params0)
    if not np.isfinite(losses).all() or loss_rel > TRAIN_RTOL or param_err > TRAIN_ATOL:
        fail(f"train: the card's epoch losses are {loss_rel:.3g} (rtol {TRAIN_RTOL}) and its "
             f"parameters {param_err:.3g} (atol {TRAIN_ATOL}) off the CPU run's")

    g = torch.Generator(device="cuda").manual_seed(1)
    zx = torch.randn((T, B, 4 * NN_UNITS), generator=g, device="cuda").requires_grad_()
    wh = (0.3 * torch.randn((NN_UNITS, 4 * NN_UNITS), generator=g, device="cuda")).requires_grad_()
    w = torch.randn((T, B, NN_UNITS), generator=g, device="cuda")
    fn_grads = torch.autograd.grad((LSTMScan.apply(zx, wh) * w).sum(), (zx, wh))
    plain_grads = torch.autograd.grad((_scan(zx, wh, keep=False) * w).sum(), (zx, wh))
    # each gradient's largest error over its largest magnitude: dwh sums T·B rows
    grad_err = {k: float((a - b).abs().max() / b.abs().max())
                for k, a, b in zip(("dzx", "dwh"), fn_grads, plain_grads)}
    if max(grad_err.values()) > LSTM_GRAD_RTOL:
        fail(f"train: LSTMScan's gradients are {grad_err} (of their scale) off autograd of "
             f"the plain loop")
    fn_ms = cuda_ms(lambda: torch.autograd.grad((LSTMScan.apply(zx, wh) * w).sum(), (zx, wh)), 5)

    one = [card[0], card[1], card[2], card[3][:B], card[4][:B],
           [torch.arange(B, device="cuda")]]
    try:
        profile = device_profile(lambda: epoch(one, 0))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}
    lib = torch.nn.LSTM(F, NN_UNITS, num_layers=2, batch_first=True).cuda()
    xb = card[3][:B]
    cudnn_ms = cuda_ms(lambda: torch.autograd.grad(lib(xb)[0].sum(), list(lib.parameters())), 20)
    return {"model": "lstm", "units": NN_UNITS, "batch": B, "seq_len": T, "features": F,
            "batches_per_epoch": NB, "step_ms_amortised": step_ms, "epoch_losses": losses,
            "loss_max_rel_vs_cpu": loss_rel, "param_max_abs_vs_cpu": param_err,
            "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL, "cpu_5_epochs_s": cpu_s,
            "reads_per_epoch": len(reads), "other_syncs": len(syncs),
            "lstm_function_grad_err": grad_err, "lstm_function_fwd_bwd_ms": fn_ms,
            "profile_one_step": profile, "cudnn_lstm_fwd_bwd_ms": cudnn_ms}


def train_cli(info):
    """`cli train` at its defaults (7 days: `generate_ohlcv(n=10,080,
    seed=0)`, lstm, seq 60, batch 32), epochs cut from 5 to 2, through
    `cli.main` on the card: exactly 2 K2 launches (recorded as the
    indicators make them, and held against the plain EWMA by
    `cli_train_k2`), a finite best val loss, a history of 2 and a finite
    price; seconds per epoch between the epochs' reads.  Returns (report,
    K2 entry, the trained result, its features)."""
    import io

    import numpy as np

    from ai_crypto_trader_tpu_torch import cli, models
    from ai_crypto_trader_tpu_torch.models import train_loop
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    real_train, got = models.train_model, []
    models.train_model = lambda *a, **k: got.append((real_train(*a, **k), a[1])) or got[-1][0]
    out = io.StringIO()
    fused_ewma.launches = 0
    try:
        with recording_ewma([]) as recorded, counted(train_loop, "host_read") as reads, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            cli.main(["train", "--days", "7", "--epochs", str(CLI_TRAIN_EPOCHS),
                      "--device", "cuda"])
            wall = time.perf_counter() - t0
    finally:
        models.train_model = real_train
    launches = fused_ewma.launches
    text = out.getvalue()
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    (result, feats), = got
    if launches != 2 or len(recorded) != 2:
        fail(f"train: cli train's indicators made {launches} K2 launches, not 2")
    if not (np.isfinite(summary["best_val_loss"]) and np.isfinite(summary["predicted_price"])
            and len(result.history) == summary["epochs_run"] == CLI_TRAIN_EPOCHS
            and len(reads) == CLI_TRAIN_EPOCHS):
        fail(f"train: cli train gave {summary} with {len(reads)} epoch reads")
    d = cli._load_or_generate("BTCUSDC", 7 * 1440, 0)
    k2 = cli_train_k2(d, compute_indicators(d, device="cuda"), recorded)
    report = {"candles": int(np.shape(d["close"])[0]), "epochs": CLI_TRAIN_EPOCHS,
              "summary": summary, "wall_s": wall, "k2_launches": launches,
              "epoch_s": [b - a for a, b in zip(reads, reads[1:])],
              "windows": int(feats.shape[0]) - NN_SEQ,
              "history": result.history}
    entry = {"launches": launches, **{k: v for k, v in k2.items() if k != "launch_checks"},
             "T": report["candles"],
             "shape": f"compute_indicators over 1 x {report['candles']} (cli train's defaults)"}
    return report, entry, result, feats


def train_service(info):
    """`PredictionService` at its defaults (lstm, units 32, seq 60,
    intervals 1m/5m) but its epochs (20, cut to SVC_EPOCHS) on the card, over 8 symbols of the tick tape, 256
    kline rows a pair, on an in-memory bus: the first `run_once` trains the
    16 pairs and predicts them as one batched group with one read; a second
    within half an interval predicts nothing; then one HPO request with
    `hpo_trials=4`.  Times of each."""
    import asyncio

    import numpy as np

    from ai_crypto_trader_tpu_torch.models import train, train_loop
    from ai_crypto_trader_tpu_torch.models.service import PredictionService

    tape = TickTape(SVC_SYMBOLS, T_TICK)
    (bus, events), clock = recording_bus(), [1_000_000.0]
    for i, sym in enumerate(tape.symbols):
        for iv in ("1m", "5m"):
            bus.set(f"historical_data_{sym}_{iv}", tape.klines(i, iv, tape.n - 64, SVC_ROWS))
    svc = PredictionService(bus, tape.symbols, now_fn=lambda: clock[0], epochs=SVC_EPOCHS,
                            device="cuda")
    report = {"symbols": SVC_SYMBOLS, "pairs": 2 * SVC_SYMBOLS, "rows": SVC_ROWS,
              "model_type": svc.model_type, "units": svc.units, "epochs": svc.epochs}
    with counted(train, "host_read") as preds, counted(train_loop, "host_read") as epochs:
        t0 = time.perf_counter()
        out = asyncio.run(svc.run_once())
        report["first_run_s"] = time.perf_counter() - t0
    if (out["trained"], out["predicted"], len(preds)) != (16, 16, 1):
        fail(f"train: the service's first cycle trained {out['trained']}, predicted "
             f"{out['predicted']} with {len(preds)} predict reads, not 16, 16 and 1")
    prices = [bus.get(f"nn_prediction_{s}_{iv}")["predicted_price"]
              for s in tape.symbols for iv in ("1m", "5m")]
    if not np.isfinite(prices).all():
        fail("train: the service published a price that is not finite")
    report["epochs_trained"] = len(epochs)
    report["epochs_run"] = [r.epochs_run for r in svc.models.values()]
    clock[0] += 10.0
    t0 = time.perf_counter()
    again = asyncio.run(svc.run_once())
    report["second_run_s"] = time.perf_counter() - t0
    if again["predicted"] or again["trained"]:
        fail(f"train: a cycle 10 s later predicted {again['predicted']}, trained "
             f"{again['trained']}")
    bus.set("nn_optimization_request", {"symbol": tape.symbols[0], "interval": "1m"})
    clock[0] += 20.0
    t0 = time.perf_counter()
    hpo = asyncio.run(svc.run_once())
    report["hpo_run_s"] = time.perf_counter() - t0
    rec = bus.get(f"nn_last_optimization_{tape.symbols[0]}_1m")
    if hpo["hpo"] != 1 or rec is None or not np.isfinite(rec["val_loss"]) \
            or bus.get("nn_optimization_request") is not None:
        fail(f"train: the HPO request gave {hpo} and {rec}")
    report["hpo"] = {"trials": svc.hpo_trials, "best": {k: (v if isinstance(v, (int, float))
                                                            else str(v))
                                                        for k, v in rec["best"].items()},
                     "val_loss": rec["val_loss"], "adoption": rec["adoption"]}
    report["events"] = events.qsize()
    return report


def train_patterns(info):
    """`train_pattern_model("cnn")` at its defaults (64 windows a class ×
    15, 10 epochs, batch 64, T 60) on the card: the loss falling below 0.7
    of the first epoch's, one read an epoch, held-out accuracy above 0.5
    (the JAX package's own test's bar), then `detect_patterns` with it over
    the tick tape's 64 `5m` windows; `lstm` and `cnn_lstm` for 2 epochs
    each."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import train_loop
    from ai_crypto_trader_tpu_torch.patterns import (
        detect_patterns, generate_dataset, train_pattern_model)

    report = {}
    for mt, epochs in (("cnn", 10), ("lstm", 2), ("cnn_lstm", 2)):
        g = torch.Generator(device="cuda").manual_seed(7)
        with counted(train_loop, "host_read") as reads:
            t0 = time.perf_counter()
            rec = train_pattern_model(g, mt, epochs=epochs, device="cuda")
            wall = time.perf_counter() - t0
        losses = [h["loss"] for h in rec.history]
        if len(reads) != epochs or not np.isfinite(losses).all():
            fail(f"train: pattern {mt} made {len(reads)} reads in {epochs} epochs: {losses}")
        report[mt] = {"epochs": epochs, "losses": losses, "wall_s": wall}
        if mt != "cnn":
            continue
        if not losses[-1] < 0.7 * losses[0]:
            fail(f"train: the cnn classifier's loss did not fall: {losses}")
        X, y = generate_dataset(torch.Generator(device="cuda").manual_seed(99), 8,
                                device="cuda")
        with torch.no_grad():
            acc = float((rec.logits(X).argmax(-1) == y).float().mean())
        if acc <= 0.5:
            fail(f"train: the trained cnn recognises {acc:.2f} of held-out patterns")
        tape = TickTape(S_TICK, T_TICK)
        windows = lane_features(tape, tape.n - 64, ("5m",), T_TICK)
        t0 = time.perf_counter()
        found = [detect_patterns(rec, w, device="cuda") for w in windows]
        report[mt].update({"held_out_accuracy": acc,
                           "detect_round_ms": 1e3 * (time.perf_counter() - t0),
                           "detected": sum(f["detected"] for f in found)})
    return report


def train_importance(result, feats):
    """`feature_importance` of `cli train`'s model over its last 64 scaled
    windows × 32 steps on the card, against the port's CPU run: weights
    within IMPORTANCE_ATOL, summing to 1."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import feature_importance, make_windows

    scaled = result.scaler.transform(torch.from_numpy(feats).cuda()).cpu().numpy()
    X = make_windows(scaled, NN_SEQ)[0][-IMPORTANCE_WINDOWS:]
    run = lambda dev: feature_importance(  # noqa: E731
        {k: v.to(dev) for k, v in result.params.items()}, result.model_type, X,
        steps=IMPORTANCE_STEPS, feature_names=list(CLI_TRAIN_COLUMNS),
        model_kwargs=result.model_kwargs, device=dev)
    t0 = time.perf_counter()
    got = run("cuda")
    card_s = time.perf_counter() - t0
    ref = run("cpu")
    err = max(abs(got["importances"][k] - ref["importances"][k]) for k in CLI_TRAIN_COLUMNS)
    total = sum(got["importances"].values())
    if not err <= IMPORTANCE_ATOL or abs(total - 1.0) > IMPORTANCE_ATOL:
        fail(f"train: feature importance {err:.3g} off the CPU run's, summing to {total}")
    return {"windows": IMPORTANCE_WINDOWS, "steps": IMPORTANCE_STEPS, "card_s": card_s,
            "max_abs_err_vs_cpu": err, "sum": total, "ranked": got["ranked"]}


def phase_train(info):
    """Training on the card: the bench's `nn` row (`train_row`), `cli
    train` at its defaults (`train_cli`), the prediction service's cadence
    (`train_service`), the pattern classifiers (`train_patterns`) and
    feature importance of the `cli train` model (`train_importance`).
    Returns `cli train`'s K2 entry for the kernels line."""
    t_phase = time.perf_counter()
    report = {"phase": "train", "card": info["nvidia_smi"], "row": train_row(info)}
    report["cli_train"], entry, result, feats = train_cli(info)
    report["service"] = train_service(info)
    report["patterns"] = train_patterns(info)
    report["importance"] = train_importance(result, feats)
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return entry


class FixedDraws:
    """A market provider that hands out the same recorded `FlowDraws` (moved
    to the caller's device) to every caller: the card's and the CPU's runs
    of one market on the same draws."""

    def __init__(self, draws):
        self.draws = draws

    def flow(self, B, T, levels):
        return self.draws


class ReplayDraws:
    """A DQN provider that hands out one iteration's recorded rollout and
    replay draws: the card's and the CPU's `train_iteration` on the same
    draws."""

    def __init__(self, rollout, idx):
        self.rollout_draws, self.idx = rollout, idx

    def rollout(self, R, P, N, n_actions, bounds):
        return self.rollout_draws

    def replay_indices(self, L, batch, size):
        return self.idx


def lob_held(card, cpu):
    """The order-flow candles of the card against the port's CPU run on the
    same draws (tests/test_torch_sim.py's bounds, u = 2^-24): open and close
    within 4·(t + 1)·u relative over the whole run; every grid-roll flip
    reported and within 4 ulps of the ratio (4·2^-23/tick ticks) of a half
    tick; up to each scenario's first flip high and low within that bound
    plus 4u, volume and the touch depth within L·u·D absolute (D the steady
    book's depth), the spread bit for bit."""
    import numpy as np

    g = {k: v.cpu().numpy() for k, v in card.items()}
    r = {k: v.numpy() for k, v in cpu.items()}
    B, T = r["close"].shape
    bound = 4.0 * (np.arange(T) + 1) * ULP
    worst = {}
    for k in ("open", "close"):
        rel = np.abs(g[k].astype(np.float64) - r[k]) / np.abs(r[k])
        worst[k] = float((rel / bound).max())
        if worst[k] > 1.0:
            fail(f"rl: the card's LOB {k} is {worst[k]:.3g} of its bound off the CPU run's")
    tick = np.float32(1e-4)
    rr = (r["close"] / r["open"] - np.float32(1)) / tick
    rg = (g["close"] / g["open"] - np.float32(1)) / tick
    flips = np.argwhere(np.round(rr) != np.round(rg))
    dist = [float(abs(abs(rr[b, t] - np.trunc(rr[b, t])) - 0.5)) for b, t in flips]
    limit = 4 * 2.0 ** -23 / 1e-4
    if any(d > limit for d in dist):
        fail(f"rl: a LOB grid-roll flip sits {max(dist):.3g} ticks from a half tick "
             f"(> {limit:.3g}): {flips.tolist()}")
    atol = LOB_LEVELS * ULP * float((2.0 * np.exp(-0.12 * np.arange(LOB_LEVELS)) / 0.08).sum())
    for b in range(B):
        f = int(flips[flips[:, 0] == b, 1].min()) if (flips[:, 0] == b).any() else T
        for k in ("high", "low"):
            rel = np.abs(g[k][b, :f].astype(np.float64) - r[k][b, :f]) / r[k][b, :f]
            if not (rel <= bound[:f] + 4 * ULP).all():
                fail(f"rl: the card's LOB {k} of scenario {b} is off the CPU run's before "
                     f"its first flip")
        for k in ("volume", "cap"):
            if np.abs(g[k][b, :f] - r[k][b, :f]).max(initial=0.0) > atol:
                fail(f"rl: the card's LOB {k} of scenario {b} is off the CPU run's before "
                     f"its first flip")
        if not np.array_equal(g["spread"][b, :f], r["spread"][b, :f]):
            fail(f"rl: the card's LOB spread of scenario {b} differs from the CPU run's")
    return {"shape": [B, T], "flips": flips.tolist(), "flip_distance_ticks": dist,
            "mid_worst_over_bound": worst}


def quiet_counted_read(module, reads):
    """``module.host_read`` wrapped to count its calls and to run with the
    sync debug mode off (the one sanctioned sync); returns the original."""
    import torch

    real = module.host_read

    def read(*a, **k):
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    module.host_read = read
    return real


def rl_row(d):
    """The bench's `rl` row (bench.py:695-723) on the card: the year's
    indicator table, `make_env_params(episode_len=512)`, `DQNConfig(num_envs
    =256, rollout_len=32)`; a warm `train_iterations(20)`, then a timed one
    ending in its one `host_read` (env steps/s); one more with its reads
    counted and torch's sync debug mode on (one read, no other sync);
    torch.profiler over one iteration; then one `train_iteration` from the
    same state on the same recorded draws on the card and on the port's CPU
    (the same env tables): actions, the replay's writes, ε and learn steps
    equal (a differing action counts as a near-tie only if its Q gap is
    within RL_TIE_RTOL of scale; the comparison stops there), parameters,
    target and moments within RL_ATOL."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.rl import dqn
    from ai_crypto_trader_tpu_torch.rl.draws import RolloutDraws
    from ai_crypto_trader_tpu_torch.rl.env import make_env_params, reset_bounds

    env = make_env_params(compute_indicators(d, device="cuda"), episode_len=RL_EPISODE,
                          device="cuda")
    cfg = dqn.DQNConfig(num_envs=RL_ENVS, rollout_len=RL_ROLLOUT)
    st = dqn.dqn_init(torch.Generator(device="cuda").manual_seed(0), env, cfg)
    st, _ = dqn.train_iterations(env, st, cfg, n_iters=RL_ITERS)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = dqn.train_iterations(env, st, cfg, n_iters=RL_ITERS)
    host = dqn.host_read(m)
    wall = time.perf_counter() - t0
    reads = []
    real = quiet_counted_read(dqn, reads)
    try:
        box = {}

        def run():
            box["st"], mm = dqn.train_iterations(env, st, cfg, n_iters=RL_ITERS)
            box["host"] = dqn.host_read(mm)
        syncs = sync_calls(run)
    finally:
        dqn.host_read = real
    if len(reads) != 1 or syncs:
        fail(f"rl: train_iterations made {len(reads)} host reads and {len(syncs)} other "
             f"synchronizing calls ({syncs[:2]}), not 1 and 0")
    st = box["st"]
    try:
        profile = device_profile(lambda: dqn.train_iterations(env, st, cfg, n_iters=1))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}

    # one iteration on the card and on the CPU, same state, same draws
    gen = torch.Generator(device="cuda").manual_seed(1)
    from ai_crypto_trader_tpu_torch.rl.draws import GeneratorDraws
    rec = GeneratorDraws(gen)
    roll = rec.rollout(cfg.rollout_len, 1, cfg.num_envs, cfg.n_actions, reset_bounds(env))
    size = torch.clamp_max(st.replay.size + cfg.rollout_len * cfg.num_envs,
                           cfg.replay_capacity).reshape(1)
    idx = rec.replay_indices(cfg.learn_steps_per_iter, cfg.batch_size, size)
    card_st = st._replace(draws=ReplayDraws(roll, idx))
    cpu_env = env._replace(close=env.close.cpu(), obs_table=env.obs_table.cpu(),
                           fee_rate=env.fee_rate.cpu())
    cpu_st = dqn.map_state(lambda x: x.cpu(), st)._replace(draws=ReplayDraws(
        RolloutDraws(*(x.cpu() for x in roll)), idx.cpu()))
    card_out, _ = dqn.train_iteration(env, card_st, cfg)
    t0 = time.perf_counter()
    cpu_out, _ = dqn.train_iteration(cpu_env, cpu_st, cfg)
    cpu_s = time.perf_counter() - t0
    got = {k: v.cpu() for k, v in dqn.tensor_leaves(card_out).items()}
    ref = dqn.tensor_leaves(cpu_out)
    n = cfg.rollout_len * cfg.num_envs
    slots = (int(st.replay.ptr) + torch.arange(n)) % cfg.replay_capacity
    ga, ra = got["replay.actions"][slots], ref["replay.actions"][slots]
    tie = None
    if not torch.equal(ga, ra):
        i = int(torch.nonzero(ga != ra)[0])
        q = dqn.q_values({k: v.cpu() for k, v in st.params.items()},
                         ref["replay.obs"][slots[i]][None])[0]
        gap = float((q[ga[i]] - q[ra[i]]).abs() / q.abs().max())
        if gap > RL_TIE_RTOL:
            fail(f"rl: the card's action {int(ga[i])} at transition {i} differs from the "
                 f"CPU's {int(ra[i])}, Q gap {gap:.3g} of scale: not a near-tie")
        tie = {"transition": i, "q_gap_over_scale": gap}
    errs = {}
    if tie is None:
        for k, r in ref.items():
            g = got[k]
            if k.startswith(("params", "target_params", "opt_state.mu", "opt_state.nu")):
                errs[k] = float((g - r).abs().max())
                if errs[k] > RL_ATOL:
                    fail(f"rl: the card's {k} is {errs[k]:.3g} off the CPU's (atol {RL_ATOL})")
            elif not torch.equal(g, r):
                fail(f"rl: the card's {k} differs from the CPU's after one iteration")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in box["host"].values()):
        fail(f"rl: train_iterations' metrics are not finite: {box['host']}")
    return {"episode_len": RL_EPISODE, "num_envs": RL_ENVS, "rollout_len": RL_ROLLOUT,
            "iters": RL_ITERS, "T": int(env.close.shape[-1]), "seconds": wall,
            "env_steps_per_sec": RL_ITERS * RL_ENVS * RL_ROLLOUT / wall,
            "reads_per_call": len(reads), "other_syncs": len(syncs),
            "metrics_last": {k: float(v[-1]) for k, v in host.items()},
            "profile_one_iteration": profile, "cpu_one_iteration_s": cpu_s,
            "near_tie": tie, "param_max_abs_vs_cpu": max(errs.values()) if errs else None,
            "atol": RL_ATOL}


def rl_markets(seed, scenarios, label):
    """The RL fleet's LOB markets at [scenarios, 1024]: the flow draws
    recorded from a CUDA generator; `lob_candles` on the card (timed: the
    LOB market build ms) against the port's CPU run on the same draws
    (`lob_held`); `compute_indicators` of the card's candles with its 2 K2
    launches recorded and held against the plain EWMA (`cli_train_k2`);
    then `pbt_env_params` on the same draws (episode 256), with exactly 2
    K2 launches.  Returns (report, K2 entry, env)."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.rl import pbt_env_params
    from ai_crypto_trader_tpu_torch.sim import lob, mixed_schedules

    sched, _ = mixed_schedules(None, scenarios, PBT_T, seed=0)
    draws = lob.flow_draws(torch.Generator(device="cuda").manual_seed(seed), scenarios, PBT_T,
                           LOB_LEVELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = lob.lob_candles(FixedDraws(draws), sched, device="cuda")
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    cpu = lob.lob_candles(FixedDraws(lob.FlowDraws(*(x.cpu() for x in draws))), sched,
                          device="cpu")
    held = lob_held(card, cpu)
    ohlcv = {k: card[k] for k in ("open", "high", "low", "close", "volume")}
    with recording_ewma([]) as recorded:
        ind = compute_indicators(ohlcv, device="cuda")
    k2 = cli_train_k2(ohlcv, ind, recorded, label=f"rl: the {label} markets'", case=label)
    fused_ewma.launches = 0
    t0 = time.perf_counter()
    env, labels = pbt_env_params(FixedDraws(draws), num_scenarios=scenarios, steps=PBT_T,
                                 episode_len=PBT_EPISODE, dynamics="lob", device="cuda")
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    if fused_ewma.launches != 2 or len(recorded) != 2:
        fail(f"rl: the {label} markets' indicators made {fused_ewma.launches} K2 launches, "
             f"not 2")
    if not (torch.isfinite(env.obs_table).all() and torch.isfinite(env.trade_cost).all()):
        fail(f"rl: the {label} env tables are not finite")
    report = {"shape": [scenarios, PBT_T], "lob_build_ms": build_ms, "env_build_s": env_s,
              "labels": labels, "card_vs_cpu": held, "obs_width": int(env.obs_table.shape[-1])}
    entry = {"launches": 2, **{k: v for k, v in k2.items() if k != "launch_checks"},
             "shape": f"compute_indicators over {scenarios} x {PBT_T} ({label})"}
    return report, entry, env


def pbt_row(env):
    """The bench's `pbt` row (bench.py:726-834) on the card: 16 members
    (state 12, one env, rollout 8, hidden 16, replay 128, batch 8, one learn
    step), 3 generations × 64 iterations, eval 4 steps; a warm 1-generation
    run, then three timed runs interleaved with the single agent's 192
    iterations (medians, as the bench's): fleet env steps/s, the single
    agent's and `speedup_vs_single`; one read a generation and no other sync
    (a run with torch's sync debug mode on)."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.rl import dqn, obs_size, population

    cfg = dqn.DQNConfig(state_size=obs_size(env), num_envs=1, rollout_len=8, hidden=(16,),
                        replay_capacity=128, batch_size=8, learn_steps_per_iter=1)
    pcfg = population.PBTConfig(population=PBT_P, generations=PBT_G,
                                iters_per_generation=PBT_I, eval_steps=PBT_EVAL)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    t0 = time.perf_counter()
    population.train_pbt(gen(0), env, cfg, pcfg._replace(generations=1))
    warm_s = time.perf_counter() - t0
    n_iters = PBT_G * PBT_I
    st = dqn.dqn_init(gen(0), env, cfg)
    st, m = dqn.train_iterations(env, st, cfg, n_iters=n_iters)              # warm
    dqn.host_read(m)
    pop_s, single_s, res = [], [], None
    for i in range(3):
        t0 = time.perf_counter()
        res = population.train_pbt(gen(1 + i), env, cfg, pcfg)
        pop_s.append(time.perf_counter() - t0)
        st = dqn.dqn_init(gen(1 + i), env, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = dqn.train_iterations(env, st, cfg, n_iters=n_iters)
        dqn.host_read(m)
        single_s.append(time.perf_counter() - t0)
    reads = []
    real = quiet_counted_read(population, reads)
    try:
        syncs = sync_calls(lambda: population.train_pbt(gen(9), env, cfg, pcfg))
    finally:
        population.host_read = real
    if len(reads) != PBT_G or syncs:
        fail(f"rl: train_pbt made {len(reads)} host reads in {PBT_G} generations and "
             f"{len(syncs)} other synchronizing calls ({syncs[:2]})")
    if not np.isfinite(res.fitness).all() or len(res.history) != PBT_G:
        fail(f"rl: the pbt row's fleet gave {res.fitness} over {len(res.history)} generations")
    dt, single_dt = float(np.median(pop_s)), float(np.median(single_s))
    steps = PBT_P * n_iters * cfg.num_envs * cfg.rollout_len / dt
    single = n_iters * cfg.num_envs * cfg.rollout_len / single_dt
    return {"population": PBT_P, "generations": PBT_G, "iters_per_generation": PBT_I,
            "warm_1_generation_s": warm_s, "fleet_s": pop_s, "single_s": single_s,
            "fleet_env_steps_per_sec": steps, "single_agent_steps_per_sec": single,
            "speedup_vs_single": steps / single, "reads_per_generation": len(reads) / PBT_G,
            "other_syncs": len(syncs), "best_fitness": float(res.fitness.max()),
            "history_exploited": [h["n_exploited"] for h in res.history]}


def pbt_oracle_and_containment(env):
    """(c) `train_pbt` at P = 1, 2 generations × 3 iterations against the
    single agent's `train_iterations(6)` from the same generator, bit for
    bit in every DQNState leaf; (d) a NaN written into member 3 of an
    8-member fleet: quarantined by the next generation (and never a donor),
    frozen through its cooldown, healed by the forced exploit after it."""
    import torch

    from ai_crypto_trader_tpu_torch.rl import dqn, obs_size, population

    cfg = dqn.DQNConfig(state_size=obs_size(env), num_envs=1, rollout_len=8, hidden=(16,),
                        replay_capacity=128, batch_size=8, learn_steps_per_iter=1)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    one = population.PBTConfig(population=1, generations=2, iters_per_generation=3,
                               eval_steps=PBT_EVAL)
    res = population.train_pbt(gen(11), env, cfg, one)
    single, _ = dqn.train_iterations(env, dqn.dqn_init(gen(11), env, cfg), cfg, n_iters=6)
    got = dqn.tensor_leaves(dqn._drop(res.state.members))
    differ = [k for k, v in dqn.tensor_leaves(single).items() if not torch.equal(got[k], v)]
    if differ:
        fail(f"rl: the P = 1 fleet differs from the single agent in {differ[:4]}")

    pcfg = population.PBTConfig(population=8, generations=1, iters_per_generation=2,
                                eval_steps=PBT_EVAL)
    pop = population.pop_init(gen(12), env, cfg, pcfg)
    params = dict(pop.members.params)
    params["Dense_0.kernel"] = params["Dense_0.kernel"].clone()
    params["Dense_0.kernel"][3, 0, 0] = float("nan")
    pop = pop._replace(members=pop.members._replace(params=params))
    rows = []
    for g in range(3):
        r = population.train_pbt(None, env, cfg, pcfg, init_pop=pop, start_generation=g)
        pop = r.state
        rows.append(r.history[0])
    donors0 = {d for i, d in enumerate(rows[0]["lineage"]) if d != i}
    ok = (rows[0]["quarantined"][3] and rows[0]["n_tripped"] == 1
          and rows[0]["lineage"][3] == 3 and 3 not in donors0
          and rows[1]["lineage"][3] != 3 and not rows[1]["quarantined"][3]
          and rows[1]["n_healed"] == 1 and rows[2]["n_quarantined"] == 0
          and all(bool(torch.isfinite(v).all()) for v in pop.members.params.values()))
    if not ok:
        fail(f"rl: containment on the card: {[{k: r[k] for k in ('lineage', 'quarantined', 'n_tripped', 'n_healed')} for r in rows]}")
    return {"p1_oracle": "bit for bit in every leaf", "leaves": len(got),
            "containment": [{k: r[k] for k in ("lineage", "quarantined", "n_tripped",
                                               "n_healed", "best_fitness")} for r in rows]}


def cli_rl_tables(argv):
    """`python -m ai_crypto_trader_tpu_torch.cli rl` with ``argv`` as a
    subprocess on the card: exit 0, the generation table's rows and the
    final fleet's, with one winner; its seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "rl", *argv],
                          cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"rl: cli rl {argv} exited {proc.returncode}: {proc.stderr[-800:]}")
    lines = proc.stdout.splitlines()
    try:
        head = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["gen", "src"])
        fleet = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["member", "fitness"])
    except StopIteration:
        fail(f"rl: cli rl {argv} printed no tables: {proc.stdout[-800:]}")
    gens = [ln.split() for ln in lines[head + 1:] if ln.strip() and ln.split()[0].isdigit()
            and len(ln.split()) == 7]
    members = [ln for ln in lines[fleet + 1:] if ln.strip()]
    return {"argv": argv, "seconds": wall, "header": lines[0], "generations": len(gens),
            "members": len(members), "winners": sum("*" in ln for ln in members),
            "best": [float(g[2]) for g in gens]}


def phase_rl(info, d):
    """The RL trainer on the card: (a) the bench's `rl` row, (b) the `pbt`
    row with its LOB markets, (c) the P = 1 oracle, (d) containment, (e)
    `cli rl` at its defaults (but CLI_RL_GENS generations) and with
    ``--dynamics gbm``, the two at once.  Returns the K2
    entries of the RL markets for the kernels line."""
    t_phase = time.perf_counter()
    report = {"phase": "rl", "card": info["nvidia_smi"], "rl_row": rl_row(d)}
    report["pbt_markets"], pbt_k2, env = rl_markets(7, PBT_S, "pbt")
    SHARED["pbt_env"] = env
    report["cli_markets"], cli_k2, _ = rl_markets(0, 8, "cli_rl")
    report["pbt_row"] = pbt_row(env)
    report["oracle_and_containment"] = pbt_oracle_and_containment(env)
    # the two `cli rl` runs at once, beside each other (each holds the card
    # a little and its own host process)
    gbm = BesideCall(cli_rl_tables, ["--dynamics", "gbm", "--generations", str(CLI_RL_GENS)])
    report["cli_rl"] = [cli_rl_tables(["--generations", str(CLI_RL_GENS)]), gbm.result()]
    for run in report["cli_rl"]:
        if (run["generations"], run["members"], run["winners"]) != (CLI_RL_GENS, 8, 1):
            fail(f"rl: cli rl {run['argv']} printed {run['generations']} generations, "
                 f"{run['members']} members and {run['winners']} winners, not 4, 8 and 1")
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return {"pbt_16x1024": pbt_k2, "cli_rl_8x1024": cli_k2}


def same_host_bits(g, r):
    """NumPy arrays equal bit for bit (float32 through their bits)."""
    import numpy as np

    g, r = np.asarray(g), np.asarray(r)
    if g.shape != r.shape:
        return False
    if g.dtype == np.float32:
        return bool(np.array_equal(g.view(np.int32), r.view(np.int32)))
    return bool(np.array_equal(g, r))


def sim_sweep_row():
    """The bench's `sim_sweep` row (bench.py:872-909) on the card: 4096 mixed
    scenarios × 512 candles, log capacity 128, schedules built on the host
    first; a warm `sweep`, then 3 timed (the median of `stats["wall_s"]`:
    scenarios/s and candle-steps/s); one more with its reads counted and
    torch's sync debug mode on (one read, no other sync); the first 256
    scenarios of that run rolled out again on the port's CPU on the card's
    candles — summary, fill logs and equity curves bit for bit; dispatches
    counted over one candle (a sweep of T = 1) and torch.profiler over a
    sweep of 32 candles."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.sim import ShockSchedule, engine, mixed_schedules
    from torch.utils._python_dispatch import TorchDispatchMode

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    scheds = [mixed_schedules(None, SIM_B, SIM_T, seed=i)[0] for i in range(4)]
    kw = dict(log_capacity=SIM_LOG, device="cuda")
    t0 = time.perf_counter()
    engine.sweep(gen(0), scenario=scheds[3], **kw)
    warm_s = time.perf_counter() - t0
    reps = [engine.sweep(gen(i + 1), scenario=scheds[i], **kw)["stats"]["wall_s"]
            for i in range(SIM_REPS)]
    dt = float(np.median(reps))
    reads, box = [], {}
    real = quiet_counted_read(engine, reads)
    try:
        syncs = sync_calls(lambda: box.update(out=engine.sweep(gen(9), scenario=scheds[0], **kw)))
    finally:
        engine.host_read = real
    if len(reads) != 1 or syncs:
        fail(f"sim: sweep made {len(reads)} host reads and {len(syncs)} other synchronizing "
             f"calls ({syncs[:2]}), not 1 and 0")
    out = box["out"]
    s = out["summary"]
    if not all(np.isfinite(v).all() for v in s.values()) or (s["n_fills"] > 0).mean() < 0.2:
        fail(f"sim: the sweep's summary is not finite or barely trades "
             f"({float((s['n_fills'] > 0).mean()):.2f} of scenarios traded)")

    n = SIM_CPU_B
    candles = {k: v[:n].cpu() for k, v in out["device"]["candles"].items()}
    sub = ShockSchedule(*(getattr(scheds[0], k)[:n] for k in ShockSchedule._fields))
    t0 = time.perf_counter()
    cpu = engine.rollout_candles(candles, schedule=sub, log_capacity=SIM_LOG, device="cpu")
    cpu_s = time.perf_counter() - t0
    for k, v in cpu["summary"].items():
        if not same_host_bits(s[k][:n], v):
            fail(f"sim: the card's sweep {k} differs from the CPU's rollout on its candles")
    for k, g in (("fills", out["device"]["fills"]), ("equity_curve", out["device"]["equity_curve"])):
        if not same_host_bits(g[:n].cpu().numpy(), cpu[k]):
            fail(f"sim: the card's {k} differs from the CPU's rollout on its candles")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def count(T):
        one = mixed_schedules(None, SIM_B, T, seed=5)[0]
        Count.n = 0
        with Count():
            engine.sweep(gen(5), scenario=one, **kw)
        return Count.n

    ops_per_candle = count(33) - count(1)
    ops_per_candle /= 32
    try:
        short = mixed_schedules(None, SIM_B, 32, seed=6)[0]
        profile = device_profile(lambda: engine.sweep(gen(6), scenario=short, **kw))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}
    return {"scenarios": SIM_B, "steps": SIM_T, "log_capacity": SIM_LOG, "warm_s": warm_s,
            "wall_s": reps, "sweep_ms": 1e3 * dt, "scenarios_per_sec": SIM_B / dt,
            "candle_steps_per_sec": SIM_B * SIM_T / dt, "reads_per_call": len(reads),
            "other_syncs": len(syncs), "traded_share": float((s["n_fills"] > 0).mean()),
            "dropped_share": float((s["dropped_fills"] > 0).mean()),
            "card_vs_cpu": {"scenarios": n, "bits": "equal", "cpu_s": cpu_s},
            "dispatches_per_candle": ops_per_candle, "profile_32_candles": profile}


def lob_sweep_row():
    """The bench's `lob_events_per_sec` row (bench.py:911-950) on the card:
    1024 mixed scenarios × 256 steps × 32 levels; a warm `lob_sweep`, then 3
    timed (events/s = B·T·(4L + 2) over the median wall); one with its reads
    counted and the sync debug mode on; then `rollout_lob` on draws recorded
    from a CUDA generator, on the card and on the port's CPU, bit for bit in
    every output (summary, fill logs, the per-step market and equity:
    `sim.lob` rounds its ``exp`` and its sums from float64, so no grid roll
    or trigger can tip), and `lob_sweep` on the same draws equal to the
    card's `rollout_lob` bit for bit."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.sim import lob, mixed_schedules
    from ai_crypto_trader_tpu_torch.sim.engine import flatten

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    scheds = [mixed_schedules(None, LOB_B, LOB_T, seed=i)[0] for i in range(4)]
    t0 = time.perf_counter()
    lob.lob_sweep(gen(0), scenario=scheds[3], levels=LOB_LEVELS, device="cuda")
    warm_s = time.perf_counter() - t0
    reps, out = [], None
    for i in range(SIM_REPS):
        out = lob.lob_sweep(gen(i + 1), scenario=scheds[i], levels=LOB_LEVELS, device="cuda")
        reps.append(out["stats"]["wall_s"])
    dt = float(np.median(reps))
    events = out["stats"]["events"]
    if events != LOB_B * LOB_T * (4 * LOB_LEVELS + 2):
        fail(f"sim: lob_sweep counts {events} events, not B·T·(4L + 2)")
    reads, box = [], {}
    real = quiet_counted_read(lob, reads)
    try:
        syncs = sync_calls(lambda: box.update(out=lob.lob_sweep(
            gen(9), scenario=scheds[0], levels=LOB_LEVELS, device="cuda")))
    finally:
        lob.host_read = real
    if len(reads) != 1 or syncs:
        fail(f"sim: lob_sweep made {len(reads)} host reads and {len(syncs)} other "
             f"synchronizing calls ({syncs[:2]}), not 1 and 0")
    s = box["out"]["summary"]
    if not all(np.isfinite(v).all() for v in s.values()):
        fail("sim: lob_sweep's summary is not finite")

    draws = lob.flow_draws(gen(7), LOB_B, LOB_T, LOB_LEVELS)
    card = lob.rollout_lob(FixedDraws(draws), scheds[0], device="cuda")
    t0 = time.perf_counter()
    cpu = lob.rollout_lob(FixedDraws(lob.FlowDraws(*(x.cpu() for x in draws))), scheds[0],
                          device="cpu")
    cpu_s = time.perf_counter() - t0
    flat = lambda r: dict(flatten(r))  # noqa: E731
    got, ref = flat(card), flat(cpu)
    differ = [k for k in ref if not same_host_bits(got[k], ref[k])]
    if differ or set(got) != set(ref):
        fail(f"sim: the card's rollout_lob differs from the CPU's on the same draws in {differ[:4]}")
    if (card["summary"]["n_fills"] > 0).mean() < 0.2:
        fail("sim: the LOB agent barely trades: the comparison is vacuous")
    swept = lob.lob_sweep(FixedDraws(draws), scenario=scheds[0], levels=LOB_LEVELS,
                          device="cuda")
    for k, v in card["summary"].items():
        if not same_host_bits(swept["summary"][k], v):
            fail(f"sim: lob_sweep's {k} differs from rollout_lob's on the same draws")
    return {"scenarios": LOB_B, "steps": LOB_T, "levels": LOB_LEVELS, "warm_s": warm_s,
            "wall_s": reps, "sweep_ms": 1e3 * dt, "events": events,
            "events_per_sec": events / dt, "scenarios_per_sec": LOB_B / dt,
            "reads_per_call": len(reads), "other_syncs": len(syncs),
            "traded_share": float((s["n_fills"] > 0).mean()),
            "card_vs_cpu": {"scenarios": LOB_B, "bits": "equal", "outputs": len(ref),
                            "fills": int(cpu["summary"]["n_fills"].sum()), "cpu_s": cpu_s}}


def stress_k1(stats, inputs, params, label):
    """K1 on the stress path, held and timed: the population's [B, P] stats
    from `backtest_under_stress` (B launches of P rows) against the plain
    loop over all B·P rows at once (replayed from CUDA graphs), bit for bit;
    the B launches timed together beside the sum of their bounds (CUDA
    events around the loop that issues them: the wrappers' host work is in
    it), and their device busy time and idle share under torch.profiler."""
    from ai_crypto_trader_tpu_torch.backtest import BacktestStats
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    B, P = stats.final_balance.shape
    rows = type(inputs)(*(x.unsqueeze(1).expand(B, P, x.shape[-1]).reshape(B * P, -1)
                          for x in inputs))
    tiled = params._replace(stop_loss=params.stop_loss.repeat(B),
                            take_profit=params.take_profit.repeat(B))
    plain, plain_ms = timed(lambda: sweep_plain_graphed(rows, tiled))
    check = compare_stats(stats, BacktestStats(*(v.reshape(B, P) for v in plain)), label)
    per = [type(inputs)(*(x[b] for x in inputs)) for b in range(B)]
    launch_all = lambda: [sweep_kernel(r, params, device="cuda") for r in per]  # noqa: E731
    ms = cuda_ms(launch_all, 5)
    try:
        profile = device_profile(launch_all)
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}
    bounds = [replay_bound_ms(BacktestStats(*(v[b] for v in stats)), P, int(inputs.close.shape[-1]))
              for b in range(B)]
    return {"launches": B, "ms": ms, "ms_per_launch": ms / B, "plain_ms": plain_ms,
            "device_busy_ms": profile.get("device_busy_ms"),
            "device_idle_share": profile.get("device_idle_share"),
            "bound_ms": sum(b[0] for b in bounds), "bound_by": max(bounds)[1],
            "library_ms": None, "max_abs_err": check["max_abs_err"], "trades": check["trades"],
            "shape": f"{B} launches of B={P} x T={int(inputs.close.shape[-1])}; ms, plain_ms "
                     "and bound_ms each cover all of them",
            "plain": "the engine's loop over all B·P rows, 32 candles a CUDA graph"}


def stress_row(dynamics, seed, params):
    """`backtest_under_stress` at its defaults (256 scenarios × 1024
    candles) on the card for one market dynamics: with ``params=None`` (the
    sizer ladder: K2's 2 launches, no K1) and with the P = 64 population (2
    K2 and exactly 256 K1 launches), timed; then the same candles again
    (the generator reseeded) for the holds: K2's two launches against the
    plain EWMA (`cli_train_k2`), the signals of both tables (`signal_flips`),
    K1 bit for bit (`stress_k1`), and the plain sizer-ladder loop timed."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.sim import engine, mixed_schedules

    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    kw = dict(num_scenarios=STRESS_B, steps=STRESS_T, dynamics=dynamics, device="cuda")
    runs = {}
    for mode, p in (("ladder", None), ("population", params)):
        fused_ewma.launches = sweep_kernel.launches = 0
        t0 = time.perf_counter()
        stats, summary = engine.backtest_under_stress(gen(), params=p, **kw)
        wall = time.perf_counter() - t0
        k1 = STRESS_B if p is not None else 0
        if fused_ewma.launches != 2 or sweep_kernel.launches != k1:
            fail(f"sim: backtest_under_stress ({dynamics}, {mode}) made {fused_ewma.launches} "
                 f"K2 and {sweep_kernel.launches} K1 launches, not 2 and {k1}")
        shape = (STRESS_B, STRESS_P) if p is not None else (STRESS_B,)
        if tuple(stats.final_balance.shape) != shape or not all(
                np.isfinite(v) for k, v in summary.items() if k != "labels"):
            fail(f"sim: backtest_under_stress ({dynamics}, {mode}) gave stats "
                 f"{tuple(stats.final_balance.shape)} and summary {summary}")
        runs[mode] = {"stats": stats, "wall_s": wall, "k2_launches": fused_ewma.launches,
                      "k1_launches": sweep_kernel.launches,
                      "summary": {k: v for k, v in summary.items() if k != "labels"}}

    sched, _ = mixed_schedules(None, STRESS_B, STRESS_T, seed=0)
    candles = engine._stress_candles(gen(), sched, dynamics, None, device="cuda")
    ohlcv = {k: candles[k] for k in ("open", "high", "low", "close", "volume")}
    with recording_ewma([]) as recorded:
        ind = compute_indicators(ohlcv, device="cuda")
    label = f"sim: the {dynamics} stress markets'"
    k2 = cli_train_k2(ohlcv, ind, recorded, label=label, case=f"stress_{dynamics}")
    flips, _, _ = signal_flips(ind, plain_table(ohlcv, label), f"stress_flips_{dynamics}")
    hold_flips(flips, f"{label} flips")
    inputs = engine.stress_inputs(candles, device="cuda")
    k1 = stress_k1(runs["population"]["stats"], inputs, params, f"stress_{dynamics}_k1")
    plain_ladder, ladder_ms = timed(lambda: engine.stress_backtest(inputs, None, device="cuda"))
    if not all(torch.equal(a, b) for a, b in zip(plain_ladder, runs["ladder"]["stats"])):
        fail(f"sim: the {dynamics} sizer ladder differs between two runs on the same candles")
    report = {"dynamics": dynamics, "shape": [STRESS_B, STRESS_T], "population": STRESS_P,
              "ladder_loop_ms": ladder_ms, "flips": flips,
              **{f"{m}_{k}": v for m, r in runs.items() for k, v in r.items() if k != "stats"}}
    k2_entry = {"launches": 2, **{k: v for k, v in k2.items() if k != "launch_checks"},
                "shape": f"compute_indicators over {STRESS_B} x {STRESS_T} ({dynamics} stress)"}
    return report, k1, k2_entry


def phase_sim(info):
    """The adversarial simulator on the card: the bench's `sim_sweep` and
    `lob_events_per_sec` rows, and `backtest_under_stress` for both market
    dynamics.  Returns the K1 and K2 entries of the stress path."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import sample_params

    t_phase = time.perf_counter()
    report = {"phase": "sim", "card": info["nvidia_smi"], "sweep": sim_sweep_row(),
              "lob_sweep": lob_sweep_row()}
    params = sample_params(torch.Generator(device="cuda").manual_seed(0), STRESS_P,
                           device="cuda")
    k1, k2 = {}, {}
    for dynamics, seed in (("gbm", 21), ("lob", 22)):
        report[f"stress_{dynamics}"], k1[f"stress_{dynamics}"], k2[f"stress_{dynamics}"] = \
            stress_row(dynamics, seed, params)
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return k1, k2


def svc_fleet_config(env, population, iters):
    """The bench's `pbt` row DQNConfig (bench.py:739-767) and a PBTConfig of
    one generation a tick."""
    from ai_crypto_trader_tpu_torch.rl import dqn, obs_size, population as pop_mod

    cfg = dqn.DQNConfig(state_size=obs_size(env), num_envs=1, rollout_len=8, hidden=(16,),
                        replay_capacity=128, batch_size=8, learn_steps_per_iter=1)
    return cfg, pop_mod.PBTConfig(population=population, generations=1,
                                  iters_per_generation=iters, eval_steps=PBT_EVAL)


def same_fleet(a, b):
    """Two fleets (and their draw streams) equal bit for bit: the names of
    the tensors that differ."""
    import torch

    from ai_crypto_trader_tpu_torch.rl.trainer_service import pop_leaves

    la, lb = pop_leaves(a), pop_leaves(b)
    differ = [k for k in la if la[k].dtype != lb[k].dtype or not torch.equal(la[k], lb[k])]
    sa, sb = a.members.draws.get_state(), b.members.draws.get_state()
    return differ + [f"draws.{k}" for k in sa if not torch.equal(sa[k], sb[k])]


def depth_journal(path, flip_crc=False):
    """A depth-capture journal of the order-flow book's own frames: a
    300-step calm `rollout_lob` with its book (a liquid flow: limit rate 3,
    depth decay 0.15, cancel rate 0.1, no drift), through
    `sim.calibrate.records_from_lob_series`, one ``depth`` record a frame;
    with ``flip_crc`` every line's CRC is wrong.  Returns the record count."""
    import json

    import torch

    from ai_crypto_trader_tpu_torch.sim import calibrate, lob, scenarios
    from ai_crypto_trader_tpu_torch.utils.journal import WriteAheadJournal

    out = lob.rollout_lob(torch.Generator(device="cuda").manual_seed(3),
                          scenarios.compile_schedules("calm", 1, 300, seed=2),
                          flow=lob.flow_params(limit_rate=3.0, depth_decay=0.15,
                                               cancel_rate=0.1, vol=0.0, device="cuda"),
                          return_book=True, device="cuda")
    records = calibrate.records_from_lob_series(out["series"], tick=1e-4)
    j = WriteAheadJournal(path, fsync_every=64)
    for rec in records:
        j.append("depth", rec)
    j.close()
    if flip_crc:
        with open(path) as f:
            lines = [json.loads(ln) for ln in f.read().splitlines()]
        with open(path, "w") as f:
            f.writelines(json.dumps(dict(r, crc=r["crc"] ^ 1)) + "\n" for r in lines)
    return len(records)


def service_trainer(tmp):
    """(a) The continuous PBT trainer at the bench's `pbt` row width (16
    members on `pbt_env_params` 16 × 1,024 LOB markets, the row's
    DQNConfig; depth cut to SVC_TICKS generations of SVC_ITERS iterations):
    an unbroken service of SVC_TICKS ticks against one killed after tick 2
    (checkpoint and adoption every generation) and resumed from its journal
    for the rest — history, fitness, hypers, every fleet tensor and the draw
    streams bit for bit on the card; one host read a generation and one a
    checkpoint.  A checkpoint write timed at P = 16; the bench's
    `pbt_recovery_ms` row (bench.py:1087-1150: P = 8, 8 × 512 markets)
    timed: `load_checkpoint` + `restore_checkpoint`, then the first resumed
    generation; one `adopt_winner` verdict into a `ModelRegistry`; one
    recalibration from a depth journal and one from the same journal
    corrupted (the last-good flow kept, the failure counted)."""
    import asyncio
    import os

    import torch

    from ai_crypto_trader_tpu_torch.obs import Scorecard
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.rl import adopt_winner, pbt_env_params
    from ai_crypto_trader_tpu_torch.rl import population
    from ai_crypto_trader_tpu_torch.rl.trainer_service import (
        PBTTrainerService, checkpoint_payload, load_checkpoint, restore_checkpoint)
    from ai_crypto_trader_tpu_torch.strategy import ModelRegistry
    from ai_crypto_trader_tpu_torch.utils.journal import SnapshotJournal

    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731
    env, _ = pbt_env_params(gen(7), num_scenarios=PBT_S, steps=PBT_T, episode_len=PBT_EPISODE,
                            dynamics="lob", device="cuda")
    cfg, pcfg = svc_fleet_config(env, PBT_P, SVC_ITERS)
    path = os.path.join(tmp, "pbt.journal")

    def service(**kw):
        return PBTTrainerService(cfg=cfg, pcfg=pcfg, env_params=env, seed=0,
                                 now_fn=lambda: 1000.0, device="cuda", **kw)

    def tick(svc):
        t0 = time.perf_counter()
        out = asyncio.run(svc.run_once())
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    with counted(population, "host_read") as reads:
        unbroken = service()
        gen_ms = [tick(unbroken)[1] for _ in range(SVC_TICKS)]
        unbroken_reads = len(reads)
        reads.clear()
        killed = service(checkpoint_path=path, registry=ModelRegistry(
            path=os.path.join(tmp, "registry.json")), scorecard=Scorecard())
        for _ in range(2):
            tick(killed)
        killed_reads = len(reads)
        killed.close()
        reads.clear()
        resumed = service(checkpoint_path=path, registry=ModelRegistry(
            path=os.path.join(tmp, "registry.json")), scorecard=Scorecard())
        first, first_ms = tick(resumed)
        rest_ms = [tick(resumed)[1] for _ in range(SVC_TICKS - 3)]
        resumed_reads = len(reads)
        reads.clear()
        t0 = time.perf_counter()
        unbroken.checkpoint_path = os.path.join(tmp, "write.journal")
        unbroken.checkpoint()
        checkpoint_ms = 1e3 * (time.perf_counter() - t0)
        checkpoint_reads = len(reads)
    resumed_ticks = SVC_TICKS - 2
    if (unbroken_reads, killed_reads, resumed_reads, checkpoint_reads) != (
            SVC_TICKS, 4, 2 * resumed_ticks, 1):
        fail(f"service: host reads {unbroken_reads} for {SVC_TICKS} generations, "
             f"{killed_reads} for 2 generations + 2 checkpoints, {resumed_reads} after the "
             f"resume, {checkpoint_reads} for a checkpoint: not one a generation and one a "
             f"checkpoint")
    if first.get("bootstrap") != {"resumed": True, "generation": 2}:
        fail(f"service: the restarted service did not resume at generation 2: {first}")
    differ = same_fleet(resumed._pop, unbroken._pop)
    if differ or resumed.history != unbroken.history:
        fail(f"service: the resumed fleet differs from the unbroken one on the card in "
             f"{differ[:4]} (history equal: {resumed.history == unbroken.history})")
    if len(resumed.adoptions) != SVC_TICKS or not resumed.registry.entries:
        fail(f"service: {len(resumed.adoptions)} adoption verdicts and "
             f"{len(resumed.registry.entries)} registry entries after {SVC_TICKS} generations")

    # the bench's pbt_recovery_ms row
    renv, _ = pbt_env_params(gen(7), num_scenarios=REC_S, steps=REC_T, episode_len=REC_EPISODE,
                             dynamics="lob", device="cuda")
    rcfg, rpcfg = svc_fleet_config(renv, REC_P, REC_ITERS)
    res = population.train_pbt(gen(0), renv, rcfg, rpcfg)
    rpath = os.path.join(tmp, "recovery.journal")
    journal = SnapshotJournal(rpath, kind="pbt_lineage")
    for _ in range(3):
        journal.write(checkpoint_payload(res.state, generation=1, cfg=rcfg, pcfg=rpcfg,
                                         history=res.history))
    journal.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload, stats = load_checkpoint(rpath)
    pop = restore_checkpoint(payload, rcfg, rpcfg, renv)
    torch.cuda.synchronize()
    recovery_ms = 1e3 * (time.perf_counter() - t0)
    if same_fleet(pop, res.state):
        fail("service: the pbt_recovery fleet restored is not the saved one")
    t0 = time.perf_counter()
    res2 = population.train_pbt(None, renv, rcfg, rpcfg, init_pop=pop,
                                start_generation=int(payload["generation"]))
    torch.cuda.synchronize()
    first_resumed_ms = 1e3 * (time.perf_counter() - t0)
    if res2.history[0]["generation"] != 1:
        fail("service: the pbt_recovery fleet did not resume at generation 1")
    verdict = adopt_winner(res2, ModelRegistry(path=os.path.join(tmp, "adopt.json")),
                           Scorecard(), checkpoint_path=os.path.join(tmp, "winner"))
    if not verdict["adopted"] or not os.path.isdir(os.path.join(tmp, "winner")):
        fail(f"service: adopt_winner into an empty registry gave {verdict}")

    # recalibration: from the book's own depth frames, then from the journal corrupted
    depth = os.path.join(tmp, "depth.journal")
    frames = depth_journal(depth)
    resumed.depth_source = depth
    fused_ewma.launches = 0
    t0 = time.perf_counter()
    good = resumed._recalibrate()
    torch.cuda.synchronize()
    recal_ms = 1e3 * (time.perf_counter() - t0)
    recal_k2 = fused_ewma.launches
    flow, env_good = resumed.flow, resumed.env_params
    if not good["ok"] or good["records"] != frames or flow is None \
            or env_good.close.shape != env.close.shape:
        fail(f"service: recalibration from the depth journal gave {good}")
    depth_journal(depth, flip_crc=True)
    bad = resumed._recalibrate()
    if bad["ok"] or resumed.flow is not flow or resumed.env_params is not env_good \
            or resumed.recalibration_failures != 1:
        fail(f"service: a corrupted depth journal gave {bad}; the last-good flow was not kept")
    tick(resumed)                           # a generation on the re-fitted markets
    return {"population": PBT_P, "markets": [PBT_S, PBT_T], "ticks": SVC_TICKS,
            "iters_per_generation": SVC_ITERS, "generation_ms": gen_ms,
            "resume": "history, fitness, hypers, fleet tensors and draw streams bit for bit",
            "reads": {"per_generation": 1, "per_checkpoint": 1},
            "first_resumed_tick_ms": first_ms, "later_resumed_ticks_ms": rest_ms,
            "checkpoint_write_ms_p16": checkpoint_ms,
            "pbt_recovery": {"population": REC_P, "markets": [REC_S, REC_T],
                             "arrays": len(payload["arrays"]),
                             "packed_mb": sum(len(a["data"]) for a in payload["arrays"]) / 1e6,
                             "snapshot_records": stats["replayed"],
                             "load_and_restore_ms": recovery_ms,
                             "first_resumed_generation_ms": first_resumed_ms},
            "adoption": {k: verdict[k] for k in ("adopted", "reason", "fitness")},
            "recalibration": {"frames": frames, "ms": recal_ms, "k2_launches": recal_k2,
                              "corrupt": bad["reason"][:120],
                              "failures": resumed.recalibration_failures},
            "status": {k: v for k, v in resumed.status().items() if k != "adoptions"}}


def cli_rl_service(tmp):
    """`cli rl --checkpoint` and then `cli rl --checkpoint --resume
    --registry` as subprocesses on the card: the resumed run names its
    generation and prints the checkpoint's row as ``ckpt`` beside its own
    ``live`` one, and registers the winner."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    path, reg = os.path.join(tmp, "cli.journal"), os.path.join(tmp, "cli_registry.json")
    argv = ["--population", "4", "--generations", "1", "--iters", "2", "--scenarios", "4",
            "--steps", "256", "--episode-len", "64"]
    runs = []
    for extra in (["--checkpoint", path],
                  ["--checkpoint", path, "--resume", path, "--registry", reg]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "rl",
                               *argv, *extra], cwd=root, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            fail(f"service: cli rl {extra} exited {proc.returncode}: {proc.stderr[-800:]}")
        runs.append((proc.stdout, time.perf_counter() - t0))
    out = runs[1][0]
    rows = [ln.split()[:2] for ln in out.splitlines()
            if len(ln.split()) == 7 and ln.split()[0].isdigit()]
    if f"resumed@gen=1 from {path}" not in out or rows != [["0", "ckpt"], ["1", "live"]] \
            or "registered " not in out:
        fail(f"service: cli rl --resume --registry printed {out[-800:]}")
    return {"seconds": [r[1] for r in runs], "rows": rows,
            "registered": next(ln for ln in out.splitlines() if "registered " in ln).strip()}


def regime_histories():
    """The regime service's 64 symbols' 1-minute klines: REGIME_T candles of
    `generate_ohlcv` with a seed a symbol (rows [open time, o, h, l, c, v])."""
    import numpy as np

    from ai_crypto_trader_tpu_torch.data import generate_ohlcv

    out = {}
    for i in range(REGIME_S):
        d = generate_ohlcv(n=REGIME_T, seed=100 + i)
        ts = np.arange(REGIME_T, dtype=np.int64) * 60_000
        out[f"R{i:02d}USDC"] = np.column_stack(
            [ts] + [d[k] for k in ("open", "high", "low", "close", "volume")]).tolist()
    return out


def regime_arrays(klines):
    import numpy as np

    arr = np.asarray([row[1:6] for row in klines], np.float32)
    return {k: arr[:, i] for i, k in enumerate(("open", "high", "low", "close", "volume"))}


def recorded_k2(recorded, case="regime"):
    """K2 launches that a path made (``recorded``: each launch's jobs, as
    `recording_ewma` keeps them), each held against the plain EWMA of its
    inputs at K2's tolerance (`ewma_check`) and timed beside the plain
    version; the bound of all of them together.  ``case`` names the path in
    messages."""
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma_jobs, fused_ewma_plain

    checks = []
    for i, jobs in enumerate(recorded):
        named = [(f"job{j}_K{len(a)}_start{st}", x.reshape(-1, x.shape[-1]), a, st)
                 for j, (x, a, st) in enumerate(jobs)]
        args = [(x, a, st) for _, x, a, st in named]
        check = ewma_check(named, f"{case}_launch{i}")
        checks.append({**check, "ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 20),
                       "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, st), 5)
                                       for x, a, st in args)})
    b_ms, o_ms = ewma_jobs_bound([(x.reshape(-1, x.shape[-1]), a, st)
                                  for jobs in recorded for x, a, st in jobs])
    return {"ms": sum(c["ms"] for c in checks), "ms_per_launch": [c["ms"] for c in checks],
            "plain_ms": sum(c["plain_ms"] for c in checks),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "max_abs_err": max(j["max_abs_err"] for c in checks for j in c["jobs"]),
            "max_rel_err": max(j["max_rel_err"] for c in checks for j in c["jobs"]),
            "launch_shapes": [[j["shape"] for j in c["jobs"]] for c in checks]}


def regime_flips(method, arrays, key):
    """`label_series` and `detect` of one symbol fitted on the card (the
    fit's and a detect's time taken) and on the CPU from the same
    first-centroid index: every candle whose label
    differs must sit near a tie of the CPU's model — for k-means the two
    clusters' squared distances within REGIME_TIE_RTOL of their mean, for
    the GMM and the HMM the two states' probabilities (posteriors) within
    REGIME_TIE_RTOL, for the rules the volatility or the slope within four
    times the card's feature difference of its threshold."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.mc.engine import quantile
    from ai_crypto_trader_tpu_torch.regime import RegimeDetector, regime_features
    from ai_crypto_trader_tpu_torch.regime import cluster as cl
    from ai_crypto_trader_tpu_torch.regime import hmm as hmm_mod

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = RegimeDetector(method=method, key=key, device="cuda").fit(arrays)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    card.detect(arrays)
    detect_ms = 1e3 * (time.perf_counter() - t0)
    cpu = RegimeDetector(method=method, key=key, device="cpu").fit(arrays)
    got, ref = card.label_series(arrays), cpu.label_series(arrays)
    feats_c = regime_features(arrays, device="cuda").cpu()
    feats = regime_features(arrays, device="cpu")
    flips = np.flatnonzero(got != ref)
    margins = []
    if len(flips) and method != "rules":
        _, z = cpu._project(arrays)
        model, inv = cpu._state["model"], {int(m): c for c, m in
                                           enumerate(cpu._state["mapping"])}
        for t in flips:
            a, b = inv.get(int(got[t])), inv.get(int(ref[t]))
            if a is None:
                fail(f"service: regime {method} label {got[t]} of the card names no CPU cluster")
            if method == "kmeans":
                d = cl._sq_dists(z[t:t + 1], model.centroids)[0]
                margins.append(float((d[a] - d[b]).abs() / d.mean()))
            else:
                p = (cl.gmm_predict_proba(model, z[t:t + 1])[0] if method == "gmm"
                     else hmm_mod.hmm_posteriors(model, z)[0][t])
                margins.append(float((p[a] - p[b]).abs()))
        if max(margins) > REGIME_TIE_RTOL:
            fail(f"service: regime {method} flips {flips.tolist()[:8]} card vs CPU, margins "
                 f"{margins[:8]}: not near a tie")
    elif len(flips):
        tol = 4.0 * float((feats_c - feats).abs().amax(dim=0)[1:3].max())
        q_c, q = float(quantile(feats_c[:, 1], 0.8)), float(quantile(feats[:, 1], 0.8))
        for t in flips:
            vol, slope = float(feats[t, 1]), float(feats[t, 2])
            margin = min(abs(vol - q) - abs(q - q_c), abs(abs(slope) - 5e-5))
            margins.append(margin)
            if margin > tol:
                fail(f"service: the rules flip at candle {t} sits {margin:.3g} from a "
                     f"threshold (tolerance {tol:.3g})")
    a, b = card.detect(arrays), cpu.detect(arrays)
    if a["regime"] != b["regime"] and not (len(flips) and flips[-1] == len(got) - 1):
        fail(f"service: regime {method} detects {a['regime']} on the card, {b['regime']} on "
             f"the CPU, with the last candle's label equal")
    prob = max(abs(a["probabilities"][k] - b["probabilities"][k]) for k in a["probabilities"])
    return {"fit_ms": fit_ms, "detect_ms": detect_ms,
            "flips": len(flips), "candles": len(got), "margins": margins[:16],
            "detect": [a["regime"], b["regime"]], "detect_prob_max_abs_diff": prob,
            "feature_max_abs_diff": [float(x) for x in (feats_c - feats).abs().amax(dim=0)]}


def service_regime(info):
    """(b) `MarketRegimeService` over the 64 symbols' 1,000-candle 1m
    histories on a bus in memory, the default k-means: a first round (each
    symbol fitted, then detected) and REGIME_ROUNDS - 1 steady rounds (the
    detectors kept), update and round times; the K2 launches of that run
    counted and one `regime_features` call's held against the plain EWMA;
    torch.profiler over one steady update; card against CPU label flips
    per method on two symbols (the HMM on one: its fit is the sequential
    recursion, ~T steps × 2 directions × 30 iterations), with each card
    fit's and detect's time."""
    import asyncio

    import numpy as np

    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.regime import MarketRegimeService

    histories = regime_histories()
    bus, events = recording_bus()
    for s, rows in histories.items():
        bus.set(f"historical_data_{s}_1m", rows)
    svc = MarketRegimeService(bus, now_fn=lambda: 5000.0, device="cuda")

    def timed_update(s):
        t0 = time.perf_counter()
        out = asyncio.run(svc.update(s))
        return out, 1e3 * (time.perf_counter() - t0)

    fused_ewma.launches = 0
    with recording_ewma([]) as recorded:
        rounds, first_updates, updates = [], [], []
        for r in range(REGIME_ROUNDS):
            t0 = time.perf_counter()
            for s in histories:
                out, ms = timed_update(s)
                (first_updates if r == 0 else updates).append(ms)
            rounds.append(1e3 * (time.perf_counter() - t0))
    launches = fused_ewma.launches
    want = REGIME_S * 4 * (REGIME_ROUNDS + 1)       # fit + detect, then detects
    if launches != want or len(recorded) != want:
        fail(f"service: the regime rounds made {launches} K2 launches ({len(recorded)} "
             f"recorded), not {want} (4 a regime_features call)")
    regimes = [svc.regimes[s]["regime"] for s in histories]
    if events.qsize() != REGIME_S * REGIME_ROUNDS or len(svc.detectors) != REGIME_S:
        fail(f"service: {events.qsize()} regime updates published, {len(svc.detectors)} "
             f"detectors")
    k2 = recorded_k2(recorded[-4:])
    first = next(iter(histories))
    try:
        profile = device_profile(lambda: asyncio.run(svc.update(first)))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}

    flips = {}
    rng = np.random.default_rng(0)
    for method, n in (("kmeans", 2), ("gmm", 2), ("hmm", 1), ("rules", 2)):
        flips[method] = [regime_flips(method, regime_arrays(histories[s]),
                                      int(rng.integers(0, REGIME_T)))
                         for s in list(histories)[:n]]
    entry = {"launches": launches, **{k: v for k, v in k2.items() if k != "launch_shapes"},
             "shape": f"regime_features over {REGIME_S} symbols x {REGIME_T} candles, "
                      f"{REGIME_ROUNDS} rounds (4 launches a call; ms/plain_ms/bound of one "
                      f"call's 4 launches)"}
    return {"symbols": REGIME_S, "candles": REGIME_T, "method": "kmeans",
            "first_round_ms": rounds[0], "first_update_ms_p50": percentile(first_updates, 50),
            "first_update_ms_p99": percentile(first_updates, 99),
            "round_ms_p50": percentile(rounds[1:], 50), "round_ms_p99": percentile(rounds[1:], 99),
            "update_ms_p50": percentile(updates, 50), "update_ms_p99": percentile(updates, 99),
            "regime_counts": {r: regimes.count(r) for r in sorted(set(regimes))},
            "k2_launches": launches, "k2": k2, "profile_one_update": profile,
            "card_vs_cpu": flips}, entry


def synthetic_books(rng, n, levels, mid=40_000.0, tick=0.5):
    """``n`` books of ``levels`` a side: (price, size) rows, bids
    descending from half a tick under ``mid``, asks ascending, lognormal
    sizes with a few walls."""
    import numpy as np

    sizes = rng.lognormal(0.0, 0.6, (n, 2, levels))
    walls = rng.integers(0, levels, (n, 2, 3))
    np.put_along_axis(sizes, walls, np.take_along_axis(sizes, walls, -1) * 12.0, -1)
    off = tick / 2 + tick * np.arange(levels)
    mids = mid * (1.0 + 1e-3 * rng.standard_normal(n))[:, None]
    bids = np.stack([np.broadcast_to(mids - off, (n, levels)), sizes[:, 0]], -1)
    asks = np.stack([np.broadcast_to(mids + off, (n, levels)), sizes[:, 1]], -1)
    return bids.astype(np.float32), asks.astype(np.float32)


def held(got, want, label, rtol=1e-5, atol=0.0):
    """The card's value against the CPU's within atol + rtol·|CPU|; returns
    the largest difference as a share of that bound."""
    import numpy as np

    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    worst = float((np.abs(g - w) / (atol + rtol * np.abs(w) + 1e-300)).max(initial=0.0))
    if worst > 1.0:
        fail(f"service: the card's {label} is {float(np.abs(g - w).max()):.3g} off the CPU's "
             f"({worst:.3g} of its bound)")
    return worst


def service_orderbook():
    """(c) `orderbook_signal` and `cluster_orders` on 64 books of 100
    levels a side (the venue's default depth), and `price_impact` and
    `pressure_metrics` batched over a 1,024-frame capture window: the card
    against the CPU at float32 tolerance (rtol 1e-5, and for the values
    that cancel — the imbalances, the score and the Gini, differences of
    sums over levels; the microprice tilt and the impact, differences of
    two prices — within 8 ulps of their operands' scale, 16 for the Gini),
    the signal's label and the cluster labels equal; times."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.ops import orderbook as ob

    rng = np.random.default_rng(17)
    bids, asks = synthetic_books(rng, BOOK_N, BOOK_LEVELS)
    u = 2.0 ** -23
    tilt_atol = 8 * u * 1e4
    atol = {"imbalance": 8 * u, "near_pressure": 8 * u, "score": 8 * u,
            "gini_bids": 16 * u, "gini_asks": 16 * u, "microprice_tilt_bps": tilt_atol}
    sig_ms, clu_ms, err, labels = [], [], 0.0, {}
    for i in range(BOOK_N):
        t0 = time.perf_counter()
        got = ob.orderbook_signal(bids[i], asks[i], device="cuda")
        sig_ms.append(1e3 * (time.perf_counter() - t0))
        ref = ob.orderbook_signal(bids[i], asks[i], device="cpu")
        if got["signal"] != ref["signal"] or (got["bid_walls"], got["ask_walls"]) != \
                (ref["bid_walls"], ref["ask_walls"]):
            fail(f"service: book {i}: signal {got['signal']} on the card, {ref['signal']} on "
                 f"the CPU")
        labels[got["signal"]] = labels.get(got["signal"], 0) + 1
        for group in ("imbalance", "pressure"):
            for k, v in ref[group].items():
                err = max(err, held(got[group][k], v, f"{group}.{k}", atol=atol.get(k, 0.0)))
        for k in ("score", "gini_bids", "gini_asks"):
            err = max(err, held(got[k], ref[k], k, atol=atol[k]))
        key = int(rng.integers(0, BOOK_LEVELS))
        t0 = time.perf_counter()
        c = ob.cluster_orders(bids[i], k=3, key=key, device="cuda")
        clu_ms.append(1e3 * (time.perf_counter() - t0))
        if not np.array_equal(c["labels"], ob.cluster_orders(bids[i], k=3, key=key,
                                                             device="cpu")["labels"]):
            fail(f"service: book {i}'s order clusters differ between the card and the CPU")
    fb, fa = synthetic_books(rng, BOOK_FRAMES, BOOK_LEVELS)
    sizes = np.array(ob.DEFAULT_TRADE_SIZES, np.float32)
    b_c, a_c = torch.from_numpy(fb).cuda(), torch.from_numpy(fa).cuda()
    s_c = torch.from_numpy(sizes).cuda()
    impact = ob.price_impact(a_c, s_c, device="cuda").cpu().numpy()
    held(impact, ob.price_impact(fa, sizes, device="cpu").numpy(), "price_impact",
         atol=8 * 2.0 ** -23)
    pres = ob.pressure_metrics(b_c, a_c, device="cuda")
    pres_cpu = ob.pressure_metrics(fb, fa, device="cpu")
    for k, v in pres_cpu.items():
        held(pres[k].cpu().numpy(), v.numpy(), k, atol=atol.get(k, 0.0))
    n_bytes = fa.nbytes + sizes.nbytes + impact.nbytes
    return {"books": BOOK_N, "levels": BOOK_LEVELS, "signals": labels,
            "orderbook_signal_ms_p50": percentile(sig_ms, 50),
            "orderbook_signal_ms_p99": percentile(sig_ms, 99),
            "cluster_orders_ms_p50": percentile(clu_ms, 50), "worst_over_bound": err,
            "window": {"frames": BOOK_FRAMES, "price_impact_ms": cuda_ms(
                lambda: ob.price_impact(a_c, s_c, device="cuda"), 20),
                "price_impact_bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                "pressure_metrics_ms": cuda_ms(
                    lambda: ob.pressure_metrics(b_c, a_c, device="cuda"), 20)}}


def service_patterns():
    """(d) `ChartPatternService`: one round over the tick tape's 64
    symbols' 256-candle `5m` klines with phase `patterns`' cnn classifier
    (seed 200) on the card, and the same round on the CPU, each on its own
    bus in memory; then the same with the no-pattern output bias lowered by
    10 and the threshold at 0, so that the detected branch and the signal
    derivation run.  The analyses (verdict, primary, completion; confidence
    within NN_ATOL) and the signals must equal the CPU's, but where the
    CPU's two leading patterns, or its probabilities at the two windows the
    completions name, lie within NN_ATOL (near ties, counted); a strength,
    rounded to 2 decimals, within one step."""
    import asyncio

    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.patterns import PatternRecognizer
    from ai_crypto_trader_tpu_torch.patterns.model import PATTERN_CLASSES, _build, _window_probs
    from ai_crypto_trader_tpu_torch.patterns.service import ChartPatternService

    tape = TickTape(S_TICK, T_TICK)
    model = _build("cnn", generator=torch.Generator().manual_seed(200), device="cuda")
    params = {k: v.detach() for k, v in model.named_parameters()}
    head = [k for k, v in params.items() if k.endswith("bias")
            and v.shape == (len(PATTERN_CLASSES),)][0]
    lowered = dict(params)
    lowered[head] = params[head].clone()
    lowered[head][PATTERN_CLASSES.index("no_pattern")] -= 10.0
    report = {}
    for label, p, threshold in (("seeded", params, 0.5), ("no_pattern_lowered", lowered, 0.0)):
        runs = {}
        for dev in ("cuda", "cpu"):
            bus, _ = recording_bus()
            for i, s in enumerate(tape.symbols):
                bus.set(f"historical_data_{s}_5m", tape.klines(i, "5m", tape.n - 64, T_TICK))
            rec = PatternRecognizer("cnn", {k: v.to(dev) for k, v in p.items()})
            svc = ChartPatternService(bus, rec, list(tape.symbols), now_fn=lambda: 1e6,
                                      confidence_threshold=threshold, device=dev)
            t0 = time.perf_counter()
            out = asyncio.run(svc.run_once())
            runs[dev] = (svc, bus, out, 1e3 * (time.perf_counter() - t0))
        (card, cbus, cout, ms), (cpu, pbus, pout, cpu_ms) = runs["cuda"], runs["cpu"]
        ties = 0
        for i, s in enumerate(tape.symbols):
            a, b = card.pattern_data[s], cpu.pattern_data[s]
            if a["detected"] != b["detected"]:
                fail(f"service: pattern {label} {s}: detected {a['detected']} on the card, "
                     f"{b['detected']} on the CPU")
            tie = False
            if a.get("primary_pattern") != b.get("primary_pattern"):
                top = np.sort(np.array(list(b["all_probabilities"].values())))[::-1]
                if top[0] - top[1] > NN_ATOL:
                    fail(f"service: pattern {label} {s}: primary {a.get('primary_pattern')} "
                         f"on the card, {b.get('primary_pattern')} on the CPU")
                tie = True
            elif a.get("completion") != b.get("completion"):
                w = np.asarray([row[1:6] for row in pbus.get(f"historical_data_{s}_5m")],
                               np.float32)
                per = _window_probs(cpu.recognizer.params, "cnn", torch.as_tensor(w), NN_SEQ, 5)[
                    :, PATTERN_CLASSES.index(b["primary_pattern"])].numpy()
                at = [round(c * per.size) - 1 for c in (a["completion"], b["completion"])]
                if abs(per[at[0]] - per[at[1]]) > NN_ATOL:
                    fail(f"service: pattern {label} {s}: completion {a['completion']} on the "
                         f"card, {b['completion']} on the CPU")
                tie = True
            if abs(a.get("confidence", 0.0) - b.get("confidence", 0.0)) > NN_ATOL:
                fail(f"service: pattern {label} {s}: confidence {a.get('confidence')} on the "
                     f"card, {b.get('confidence')} on the CPU")
            ties += tie
            x, y = cbus.get(f"pattern_signals_{s}"), pbus.get(f"pattern_signals_{s}")
            if not tie and ((x is None) != (y is None) or (x is not None and (
                    {k: v for k, v in x.items() if k != "strength"} !=
                    {k: v for k, v in y.items() if k != "strength"}
                    or abs(x["strength"] - y["strength"]) > 0.01))):
                fail(f"service: pattern {label} {s}: signal {x} on the card, {y} on the CPU")
        if not ties and cout != pout:
            fail(f"service: pattern round {label}: {cout} on the card, {pout} on the CPU")
        report[label] = {"round_ms": ms, "cpu_round_ms": cpu_ms, **cout, "near_ties": ties,
                         "detected": sum(a["detected"] for a in card.pattern_data.values())}
    if not report["no_pattern_lowered"]["detected"]:
        fail("service: the lowered-bias pattern round detected no pattern")
    return report


def phase_service(info):
    """The services on the card: (a) the continuous PBT trainer (and `cli
    rl --checkpoint / --resume / --registry`), (b) the regime service,
    (c) the order book, (d) the chart-pattern service.  Returns the
    regime path's K2 entry for the kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    report = {"phase": "service", "card": info["nvidia_smi"]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # the two `cli rl` subprocesses run beside the trainer (no kernel is
        # timed in it), and are waited for before the regime's K2 is timed;
        # the trainer's host-wall times share the card and the host with them
        cli_rl = BesideCall(cli_rl_service, tmp)
        try:
            report["trainer"] = service_trainer(tmp)
        finally:
            cli_rl.thread.join(900)
        report["cli_rl"] = cli_rl.result()
        report["trainer"]["contended"] = (
            "generation_ms, first_resumed_tick_ms, later_resumed_ticks_ms, "
            "checkpoint_write_ms_p16 and pbt_recovery.load_and_restore_ms were taken "
            "while the two `cli rl` subprocesses ran on the same card and host")
        report["trainer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["regime"], regime_entry = service_regime(info)
    report["regime_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["orderbook"] = service_orderbook()
    report["orderbook_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["patterns"] = service_patterns()
    report["patterns_s"] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    return regime_entry


@contextlib.contextmanager
def recording_k1(calls):
    """`ops.replay.sweep_kernel` wrapped to record each launch's (inputs,
    params, keywords, stats); `sweep_kernel.launches` keeps counting (the
    kernel adds to the module's `sweep_kernel`, the wrapper while it is
    installed)."""
    from ai_crypto_trader_tpu_torch.ops import replay

    real = replay.sweep_kernel

    def call(inputs, params, **kw):
        out = real(inputs, params, **kw)
        calls.append((inputs, params, kw, out))
        return out

    call.launches = real.launches
    replay.sweep_kernel = call
    try:
        yield calls
    finally:
        real.launches = call.launches
        replay.sweep_kernel = real


def held_k1(calls, label):
    """Each recorded K1 launch's stats against the plain loop on its own
    inputs (graph-replayed), bit for bit; all launches timed together
    beside the plain loops and the sum of their bounds."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import BacktestStats
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    plain_kw = ("initial_balance", "ai_confidence_threshold", "min_signal_strength", "warmup")
    gots, refs, plain_ms, bounds = [], [], 0.0, []
    for inputs, params, kw, out in calls:
        ref, ms = timed(lambda: sweep_plain_graphed(inputs, params,
                                                    **{k: kw[k] for k in plain_kw}))
        plain_ms += ms
        gots.append(out)
        refs.append(ref)
        bounds.append(replay_rows_bound_ms(out, inputs, kw["warmup"]))
    cat = lambda xs: BacktestStats(*(torch.cat([getattr(s, f).reshape(-1) for s in xs])  # noqa: E731
                                     for f in BacktestStats._fields))
    check = compare_stats(cat(gots), cat(refs), label)
    launch_all = lambda: [sweep_kernel(i, p, **kw) for i, p, kw, _ in calls]  # noqa: E731
    return {"launches": len(calls), "ms": cuda_ms(launch_all, 5), "plain_ms": plain_ms,
            "bound_ms": sum(b[0] for b in bounds), "bound_by": max(bounds)[1],
            "library_ms": None, "max_abs_err": check["max_abs_err"], "trades": check["trades"],
            "shapes": [f"B={int(p.stop_loss.numel())} x T={int(i.close.shape[-1])}"
                       for i, p, _, _ in calls]}


def cli_generate(tmp):
    """(a) `python -m ai_crypto_trader_tpu_torch.cli generate` at its
    defaults (BTCUSDC, 7 days, seed 0, 3 folds, pool 16) but its rounds (6,
    cut to GEN_CLI_ROUNDS) as a
    subprocess on the card, its registry in ``tmp``: exit 0, the JSON keys
    of the JAX package's command, at least one round and one registered
    version; its wall time, rounds and holdout Sharpes."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    registry = os.path.join(tmp, "registry.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "generate",
                           "--rounds", str(GEN_CLI_ROUNDS), "--registry", registry], cwd=root,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"strategy: cli generate exited {proc.returncode}: {proc.stderr[-800:]}")
    try:
        out = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"strategy: cli generate printed no JSON: {proc.stdout[-800:]}")
    keys = {"best_structure", "cv_sharpe", "seed_cv_sharpe", "holdout_sharpe_seed",
            "holdout_sharpe_best", "versions", "rounds"}
    with open(registry) as f:
        entries = json.load(f)
    if set(out) != keys or out["rounds"] < 1 or len(out["versions"]) < 1 or \
            not all(v in json.dumps(entries) for v in out["versions"]):
        fail(f"strategy: cli generate gave {out}")
    return {"seconds": wall, "rounds": out["rounds"], "versions": len(out["versions"]),
            "seed_cv_sharpe": out["seed_cv_sharpe"], "cv_sharpe": out["cv_sharpe"],
            "holdout_sharpe_seed": out["holdout_sharpe_seed"],
            "holdout_sharpe_best": out["holdout_sharpe_best"],
            "best_rules": sorted(out["best_structure"]["rules"])}


def generate_folds(device, n_fold=None):
    """`cli generate`'s folds of its default candles (7 days, seed 0, 70 %
    searched, 3 folds of 2,352), or their first ``n_fold`` candles, as
    `fold_features` builds them on ``device``."""
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.strategy.generator import fold_features

    d = {k: v for k, v in generate_ohlcv(n=GEN_DAYS * 1440, seed=GEN_SEED).items()
         if k != "regime"}
    fold_len = int(GEN_DAYS * 1440 * 0.7) // GEN_FOLDS
    n = n_fold or fold_len
    return [fold_features({k: v[i * fold_len:i * fold_len + n] for k, v in d.items()},
                          device=device) for i in range(GEN_FOLDS)]


def generate_pool():
    """The seed and 16 mutants of it (`mutate`, numpy seed 0): a round's pool."""
    import numpy as np

    from ai_crypto_trader_tpu_torch.strategy.generator import default_seed, mutate

    rng = np.random.default_rng(GEN_SEED)
    return [default_seed()] + [mutate(rng, default_seed(), 1) for _ in range(GEN_POOL)]


def strategy_evaluate():
    """(b) `evaluate_structures` at `cli generate`'s fold shape (3 × 2,352,
    the seed and 16 mutants): one host read a call; the card's packed
    Sharpe ratios and trade counts against the port's CPU run on the card's
    fold features copied to the CPU, bit for bit; dispatches a candle, the
    wall of a call, and torch.profiler over one call on 3 × 256-candle
    folds.  Returns the report and the card's folds."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.strategy import generator as gen

    folds, pool = generate_folds("cuda"), generate_pool()
    packed = {}
    real = gen.host_read

    def read(t):
        packed.setdefault(t.device.type, []).append(real(t))
        return packed[t.device.type][-1]

    gen.host_read = read
    try:
        gen.evaluate_structures(folds, pool, device="cuda")          # warm
        torch.cuda.synchronize()
        packed.clear()
        t0 = time.perf_counter()
        scores = gen.evaluate_structures(folds, pool, device="cuda")
        wall = time.perf_counter() - t0
        reads = len(packed["cuda"])
        cpu_folds = [{k: v.cpu() for k, v in f.items()} for f in folds]
        t0 = time.perf_counter()
        cpu_scores = gen.evaluate_structures(cpu_folds, pool, device="cpu")
        cpu_wall = time.perf_counter() - t0
    finally:
        gen.host_read = real
    if reads != 1:
        fail(f"strategy: evaluate_structures read the card {reads} times, not once")
    card, cpu = packed["cuda"][-1], packed["cpu"][-1]
    if not np.array_equal(card[1], cpu[1]):
        fail(f"strategy: trade counts differ card against CPU: {card[1].tolist()} vs "
             f"{cpu[1].tolist()}")
    if not same_host_bits(card[0], cpu[0]) or not same_host_bits(scores, cpu_scores):
        fail(f"strategy: Sharpe ratios not bit for bit card against CPU (max abs diff "
             f"{float(np.abs(card[0] - cpu[0]).max())})")
    if not np.isfinite(scores).any() or card[1].sum() <= 0:
        fail(f"strategy: no candidate trades: scores {scores.tolist()}")
    short = generate_folds("cuda", GEN_SHORT_T)
    try:
        profile = device_profile(lambda: gen.evaluate_structures(short, pool, device="cuda"))
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
        profile = {"measured": False, "reason": repr(ex)[:300]}
    T = int(folds[0]["close"].shape[-1])
    SHARED["structures"] = (folds, pool, scores)
    report = {"folds": GEN_FOLDS, "candles": T, "pool": len(pool), "call_s": wall,
              "cpu_call_s": cpu_wall, "reads_per_call": reads, "card_vs_cpu": "bit for bit",
              "trades": int(card[1].sum()), "scores": [float(s) for s in scores],
              "profile_short": {"candles": GEN_SHORT_T, **profile}}
    if profile.get("measured"):
        report["dispatches_per_candle"] = profile["device_ops"] / GEN_SHORT_T
    return report, folds, pool


def structure_flips(folds_k, folds_p, pool):
    """The pool's signals on K2's fold features against those on the plain
    EWMA's: every flip must sit within FLIP_MARGIN of a threshold on the
    plain blend, and a kind may flip at most once in 1,000 candles."""
    import torch

    from ai_crypto_trader_tpu_torch.strategy.generator import _candidates, blend_signals

    cand = _candidates(pool, torch.device("cuda"))
    buy, sell = cand[2][:, None], cand[3][:, None]
    flips = far = 0
    stack_diff = 0.0
    n = 0
    for fk, fp in zip(folds_k, folds_p):
        _, sig_k, _ = blend_signals(fk["stack"][None], *cand[:4])
        blend_p, sig_p, _ = blend_signals(fp["stack"][None], *cand[:4])
        diff = sig_k[0] != sig_p[0]
        margin = torch.minimum(torch.abs(blend_p[0] - buy), torch.abs(blend_p[0] + sell))
        flips += int(diff.sum())
        far += int((diff & (margin > FLIP_MARGIN)).sum())
        stack_diff = max(stack_diff, float(torch.abs(fk["stack"] - fp["stack"]).max()))
        n += int(diff.numel())
    if far or flips > n // 1000:
        fail(f"strategy: {flips} signal flips with K2's fold features, {far} of them farther "
             f"than {FLIP_MARGIN} from a threshold")
    return {"signals": n, "flips": flips, "far_from_threshold": far,
            "stack_max_abs_diff": stack_diff}


def strategy_k2(d_year):
    """(c) K2 on this path: one `fold_features` call's launches (exactly 3:
    the indicator table's 2 and the combination scores' fast RSI) and a
    `cross_validate(k=5)` call's — its `RegimeDetector` (fit and labels, 4
    each) and each fold's period indicators (`ops.dynamic`) — counted and
    each held against the plain EWMA; the pool's signals on K2 fold
    features against plain fold features (`structure_flips`)."""
    from ai_crypto_trader_tpu_torch.backtest import default_params
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import dynamic
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.strategy import cross_validate
    from ai_crypto_trader_tpu_torch.strategy.generator import fold_features

    d = {k: v[:int(GEN_DAYS * 1440 * 0.7) // GEN_FOLDS]
         for k, v in generate_ohlcv(n=GEN_DAYS * 1440, seed=GEN_SEED).items() if k != "regime"}
    fused_ewma.launches = 0
    with recording_ewma([]) as rec_fold:
        fold_features(d, device="cuda")
    fold_launches = fused_ewma.launches
    if fold_launches != 3 or len(rec_fold) != 3:
        fail(f"strategy: fold_features made {fold_launches} K2 launches, not 3")

    rec_dyn, kernel_entry = [], dynamic.fused_ewma_jobs

    def recording(jobs, device=None):
        rec_dyn.append([(x, a, st) for x, a, st in jobs])
        return kernel_entry(jobs, device=device)

    arrays = {k: v[:T_CV] for k, v in d_year.items()}
    fused_ewma.launches = 0
    dynamic.fused_ewma_jobs = recording
    try:
        with recording_ewma([]) as rec_regime:
            cross_validate(arrays, default_params(device="cuda"), k=CV_K, device="cuda")
    finally:
        dynamic.fused_ewma_jobs = kernel_entry
    cv_launches = fused_ewma.launches
    if len(rec_regime) != 8 or not rec_dyn or len(rec_dyn) % CV_K or \
            cv_launches != len(rec_regime) + len(rec_dyn):
        fail(f"strategy: cross_validate made {cv_launches} K2 launches: {len(rec_regime)} "
             f"in its regime detector (8 expected), {len(rec_dyn)} in its {CV_K} folds")
    fold_k2 = recorded_k2(rec_fold, "fold_features")
    cv_k2 = recorded_k2(rec_regime + rec_dyn, "cross_validate")
    folds_k = generate_folds("cuda")
    with plain_ewma("strategy: the plain fold features"):
        folds_p = generate_folds("cuda")
    flips = structure_flips(folds_k, folds_p, generate_pool())
    return {"fold_features_launches": fold_launches, "cross_validate_launches": cv_launches,
            "cross_validate_regime_launches": len(rec_regime),
            "cross_validate_fold_launches": len(rec_dyn),
            "fold_features": {k: v for k, v in fold_k2.items() if k != "launch_shapes"},
            "cross_validate": {k: v for k, v in cv_k2.items() if k != "launch_shapes"},
            "flips": flips}, fold_k2, cv_k2


def strategy_k1(d_year):
    """(d) K1 on this path: `cross_validate(k=5)` over 43,200 candles at
    `default_params` (exactly 5 launches) and `compare_strategies` over 8
    parameter sets (exactly one rows launch), each launch held bit for bit
    against the plain loop (`held_k1`); one `StrategyEvolver.evolve`
    through the GA path at `EvolutionParams()`'s GA (20 × 10: exactly G + 1
    = 11 K1 launches, 5 K2, one host read), and one `SystematicImprover`
    iteration, timed."""
    import asyncio

    import torch

    from ai_crypto_trader_tpu_torch.backtest import default_params, sample_params
    from ai_crypto_trader_tpu_torch.config import EvolutionParams
    from ai_crypto_trader_tpu_torch.evolve import ga
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.strategy import (
        StrategyEvolver, compare_strategies, cross_validate)
    from ai_crypto_trader_tpu_torch.strategy.improver import SystematicImprover

    arrays = {k: v[:T_CV] for k, v in d_year.items()}
    report = {"candles": T_CV}
    sweep_kernel.launches = 0
    with recording_k1([]) as cv_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = cross_validate(arrays, default_params(device="cuda"), k=CV_K, device="cuda")
        report["cross_validate_ms"] = 1e3 * (time.perf_counter() - t0)
    if sweep_kernel.launches != CV_K or len(cv_calls) != CV_K:
        fail(f"strategy: cross_validate(k={CV_K}) made {sweep_kernel.launches} K1 launches")
    report["cross_validate"] = {"mean_sharpe": cv["mean_sharpe"],
                                "regimes": [f["regime"] for f in cv["folds"]],
                                **held_k1(cv_calls, "strategy_cross_validate")}
    params = sample_params(torch.Generator(device="cuda").manual_seed(1), CMP_S - 1,
                           device="cuda")
    named = {f"sampled_{i}": params._replace(**{f: getattr(params, f)[i]
                                                for f in params._fields})
             for i in range(CMP_S - 1)}
    named["default"] = default_params(device="cuda")
    sweep_kernel.launches = 0
    with recording_k1([]) as cmp_calls:
        t0 = time.perf_counter()
        cmp = compare_strategies(arrays, named, device="cuda")
        report["compare_strategies_ms"] = 1e3 * (time.perf_counter() - t0)
    if sweep_kernel.launches != 1 or int(cmp_calls[0][1].stop_loss.numel()) != CMP_S:
        fail(f"strategy: compare_strategies made {sweep_kernel.launches} K1 launches")
    report["compare_strategies"] = {"best": cmp["best"], "ranked": cmp["ranked"],
                                    **held_k1(cmp_calls, "strategy_compare")}

    cfg = EvolutionParams()
    evolver = StrategyEvolver(recording_bus()[0], cfg=cfg, now_fn=lambda: 0.0, device="cuda")
    sweep_kernel.launches = fused_ewma.launches = 0
    with counted(ga, "host_read") as reads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = asyncio.run(evolver.evolve(arrays, regime="bear"))
        evolve_s = time.perf_counter() - t0
    want = cfg.ga.generations + 1
    if out["method"] != "ga" or sweep_kernel.launches != want or fused_ewma.launches != 5 \
            or len(reads) != 1:
        fail(f"strategy: the evolver's GA ({out['method']}) made {sweep_kernel.launches} K1 "
             f"and {fused_ewma.launches} K2 launches and {len(reads)} reads, not {want}, 5, 1")
    report["evolver_ga"] = {"population": cfg.ga.population_size,
                            "generations": cfg.ga.generations, "seconds": evolve_s,
                            "k1_launches": sweep_kernel.launches,
                            "k2_launches": fused_ewma.launches, "reads": len(reads),
                            "best_fitness": out["detail"]["history"][-1]["best_fitness"]}
    improver = SystematicImprover(StrategyEvolver(recording_bus()[0], cfg=cfg, now_fn=lambda: 0.0,
                                                  device="cuda"),
                                  max_iterations=1, target_sharpe=1e9)
    sweep_kernel.launches = 0
    t0 = time.perf_counter()
    imp = asyncio.run(improver.improve(arrays, regime="bear"))
    report["improver"] = {"seconds": time.perf_counter() - t0, "iterations": imp["iterations"],
                          "k1_launches": sweep_kernel.launches,
                          "mean_sharpe": imp["evaluation"]["mean_sharpe"]}
    if imp["iterations"] != 1:
        fail(f"strategy: the improver ran {imp['iterations']} iterations, not 1")
    return report


def strategy_long_context():
    """(e) `LongContextTransformer` at its defaults (d_model 64, 4 heads, 2
    blocks, ff 128) over T = 16,384 candles × 8 features from a seed: the
    forward and a `long_context_loss` + gradient, each timed (host clock
    around synchronised work, after a warm run) with its peak memory; then
    at T = 2,048 the card against the port's CPU (outputs within LC_ATOL,
    gradients within LC_GRAD_RTOL of each parameter's largest)."""
    import copy

    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import LongContextTransformer, long_context_loss

    rng = np.random.default_rng(5)
    model = LongContextTransformer(LC_F, generator=torch.Generator().manual_seed(5),
                                   device="cuda")
    params = dict(model.named_parameters())

    def data(T):
        x = rng.normal(size=(T, LC_F)).astype(np.float32)
        y = (rng.normal(size=(T, 1)) * 1e-3).astype(np.float32)
        y[:16], y[-1] = np.nan, np.nan
        return torch.from_numpy(x), torch.from_numpy(y)

    def step(m, p, x, y):
        loss = long_context_loss(m, p, x, y)
        return loss, torch.autograd.grad(loss, list(p.values()))

    x, y = (v.cuda() for v in data(LC_T))
    report = {"T": LC_T, "features": LC_F, "d_model": 64, "heads": 4, "blocks": 2}
    for name, fn in (("forward", lambda: model(x)["mean"]),
                     ("loss_and_grad", lambda: step(model, params, x, y))):
        if name == "forward":
            with torch.no_grad():
                fn()
        else:
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "forward":
            with torch.no_grad():
                out = fn()
        else:
            out = fn()
        torch.cuda.synchronize()
        report[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        report[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        vals = [out] if name == "forward" else [out[0], *out[1]]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            fail(f"strategy: the long-context {name} at T={LC_T} is not finite")
    xs, ys = data(LC_T_CPU)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_params = dict(cpu_model.named_parameters())
    with torch.no_grad():
        out_c, out_p = model(xs.cuda())["mean"].cpu(), cpu_model(xs)["mean"]
    err = float(torch.abs(out_c - out_p).max())
    if err > LC_ATOL:
        fail(f"strategy: the long-context forward at T={LC_T_CPU} is {err:.3g} off the CPU's")
    (lc, gc), (lp, gp) = step(model, params, xs.cuda(), ys.cuda()), step(
        cpu_model, cpu_params, xs, ys)
    worst = 0.0
    for name, a, b in zip(params, gc, gp):
        scale = float(torch.abs(b).max())
        rel = float(torch.abs(a.cpu() - b).max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if float(torch.abs(a.cpu() - b).max()) > 1e-6 + LC_GRAD_RTOL * scale:
            fail(f"strategy: the long-context gradient of {name} at T={LC_T_CPU} is off the "
                 f"CPU's by {rel:.3g} of its scale")
    report["card_vs_cpu"] = {"T": LC_T_CPU, "out_max_abs_err": err,
                             "loss": [lc.item(), lp.item()], "grad_worst_of_scale": worst}
    return report


def strategy_social():
    """(f) The social analyzer over 30 days of hourly metrics (720 × 8, a
    seed): `normalize_metrics`, `fit_anomaly_model`, `detect_anomalies`,
    `lead_lag_correlation(max_lag=24)` and `adaptive_source_weights` over 3
    sources on the card against the CPU — normalised metrics equal, anomaly
    scores within SOC_RTOL and flags equal but within SOC_RTOL of the
    threshold, the lead-lag argmax equal, the weights within 1e-6 — and each
    call's time (p50 of 5 after a warm one)."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.social import analyzer as sa

    rng = np.random.default_rng(30)
    x = rng.lognormal(2.0, 0.6, size=(SOC_T, SOC_F)).astype(np.float32)
    x[rng.integers(0, SOC_T, 20), rng.integers(0, SOC_F, 20)] *= 25.0
    close = (40_000.0 * np.cumprod(1.0 + rng.normal(scale=0.004, size=SOC_T))).astype(
        np.float32)
    ret = np.diff(close, prepend=close[0]) / close
    social = (np.roll(ret, 6) * 50.0 + rng.normal(scale=0.2, size=SOC_T)).astype(np.float32)
    fwd = np.roll(close, -12) / close - 1.0
    sources = {"twitter": np.clip(0.5 + 30.0 * fwd, 0, 1).astype(np.float32),
               "reddit": rng.uniform(size=SOC_T).astype(np.float32),
               "news": np.clip(0.5 - 10.0 * fwd, 0, 1).astype(np.float32)}
    xc = torch.from_numpy(x).cuda()
    calls = {
        "normalize_metrics": lambda dev, a: sa.normalize_metrics(a, device=dev),
        "fit_anomaly_model": lambda dev, a: sa.fit_anomaly_model(a, device=dev),
        "lead_lag_correlation": lambda dev, a: sa.lead_lag_correlation(
            social, ret, max_lag=SOC_LAG, device=dev),
        "adaptive_source_weights": lambda dev, a: sa.adaptive_source_weights(
            sources, close, device=dev),
    }
    out, times = {}, {}
    for name, fn in calls.items():
        fn("cuda", xc)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn("cuda", xc)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        times[f"{name}_ms_p50"] = percentile(ms, 50)
        out[name] = (got, fn("cpu", x))
    card, cpu = out["normalize_metrics"]
    if not same_bits(card.cpu(), cpu):
        fail("strategy: normalize_metrics differs card against CPU")
    (mc, mp) = out["fit_anomaly_model"]
    t0 = time.perf_counter()
    flags_c, score_c = sa.detect_anomalies(mc, xc, device="cuda")
    flags_c, score_c = flags_c.cpu().numpy(), score_c.cpu().numpy()
    times["detect_anomalies_ms"] = 1e3 * (time.perf_counter() - t0)
    flags_p, score_p = (v.numpy() for v in sa.detect_anomalies(mp, x, device="cpu"))
    rel = float(np.max(np.abs(score_c - score_p) / np.maximum(np.abs(score_p), 1e-30)))
    differ = np.flatnonzero(flags_c != flags_p)
    if rel > SOC_RTOL or np.any(np.abs(score_p[differ] - 1.0) > SOC_RTOL):
        fail(f"strategy: anomaly scores {rel:.3g} off the CPU's, flags differing at "
             f"{differ.tolist()[:8]}")
    (lags_c, corr_c), (lags_p, corr_p) = out["lead_lag_correlation"]
    lead_c, lead_p = int(lags_c[torch.argmax(corr_c)]), int(lags_p[torch.argmax(corr_p)])
    if lead_c != lead_p:
        fail(f"strategy: the detected lead is {lead_c} on the card, {lead_p} on the CPU")
    wc, wp = out["adaptive_source_weights"]
    if max(abs(wc[k] - wp[k]) for k in wp) > 1e-6:
        fail(f"strategy: source weights {wc} on the card, {wp} on the CPU")
    return {"T": SOC_T, "features": SOC_F, "anomalies": int(flags_c.sum()),
            "anomaly_flags_differing": len(differ), "score_max_rel_err": rel,
            "lead": lead_c, "corr_max_abs_err": float(torch.abs(corr_c.cpu() - corr_p).max()),
            "weights": wc, **times}


def phase_strategy(info, d_year):
    """The strategy layer, the long-context model and the social analyzer on
    the card: (a) `cli generate` at its defaults, (b) `evaluate_structures`
    at its fold shape, (c) K2 on this path, (d) K1 on this path with the
    evolver's GA and the improver, (e) the long-context transformer, (f)
    the social analyzer.  Returns the K1 and K2 entries of this path."""
    import tempfile

    t_phase = time.perf_counter()
    report = {"phase": "strategy", "card": info["nvidia_smi"]}
    with tempfile.TemporaryDirectory() as tmp:
        report["cli_generate"] = cli_generate(tmp)
    report["evaluate"], _, _ = strategy_evaluate()
    report["k2"], fold_k2, cv_k2 = strategy_k2(d_year)
    report["k1"] = strategy_k1(d_year)
    report["long_context"] = strategy_long_context()
    report["social"] = strategy_social()
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    k1 = report["k1"]
    held = (k1["cross_validate"], k1["compare_strategies"])
    k1_entry = {
        "launches": (sum(h["launches"] for h in held) + k1["evolver_ga"]["k1_launches"]
                     + k1["improver"]["k1_launches"]),
        "launches_by_path": {"cross_validate": held[0]["launches"],
                             "compare_strategies": held[1]["launches"],
                             "evolver_ga": k1["evolver_ga"]["k1_launches"],
                             "improver": k1["improver"]["k1_launches"]},
        **{k: sum(h[k] for h in held) for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": max(held, key=lambda h: h["bound_ms"])["bound_by"], "library_ms": None,
        "max_abs_err": max(h["max_abs_err"] for h in held),
        "shape": f"cross_validate's {CV_K} launches (B=1 x T={T_CV // CV_K}) and "
                 f"compare_strategies' one (B={CMP_S} x T={T_CV}); ms, plain_ms and "
                 f"bound_ms cover these 6"}
    k2 = report["k2"]
    k2_entry = {
        "launches": (k2["fold_features_launches"] + k2["cross_validate_launches"]
                     + k1["evolver_ga"]["k2_launches"]),
        "launches_by_path": {"fold_features": k2["fold_features_launches"],
                             "cross_validate": k2["cross_validate_launches"],
                             "evolver_ga_tables": k1["evolver_ga"]["k2_launches"]},
        **{k: fold_k2[k] + cv_k2[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": fold_k2["bound_by"], "library_ms": None,
        "max_abs_err": max(fold_k2["max_abs_err"], cv_k2["max_abs_err"]),
        "shape": "one fold_features call's 3 launches (T=2352) and a cross_validate call's "
                 f"(its regime detector's 8 over T={T_CV}, each fold's period indicators over "
                 f"T={T_CV // CV_K}); ms, plain_ms and bound_ms cover these"}
    return k1_entry, k2_entry


# --- phase live: the live signal path ---------------------------------------

LIVE_TRADING = {"ai_confidence_threshold": 0.0, "min_signal_strength": 0.0,
                "min_trade_amount": 1.0}          # bench_recovery's (bench.py:974-975)
LIVE_LABELS = ("symbol", "signal", "trend", "top_family")
LIVE_FRAME_LABELS = tuple(f"signal_{iv}" for iv in TICK_FRAMES[1:])


def live_tolerance(key, ref):
    """(rtol, atol) of a market_updates field of one device's run against
    another's: 1e-5 relative, and the bounds tests/test_torch_tick.py
    derives for the fields that carry MACD (its 1e-3 + 2e-6·|close|; the
    signal strength's min(|MACD|, 1)·20 term; the 2e-3 of the families and
    the confluence that carry its tanh) or the long SMAs (the trend
    strength's 5e-5).  The frames' MACD is bounded by the 1m close (the
    frames' last bar closes there)."""
    close, macd = abs(ref["current_price"]), abs(ref["macd"])
    if key == "signal_strength":
        return 1e-5, 1e-4 + (20 * (1e-3 + 2e-6 * close) if macd < 1.0 else 0.0)
    if key.startswith("macd"):
        return 2e-5, 1e-3 + 2e-6 * close
    if key in ("confluence", "top_family_score"):
        return 1e-5, 2e-3
    if key == "trend_strength":
        return 1e-5, 5e-5
    return 1e-5, 1e-6


def near_threshold(update, suffix=""):
    """A signal's vote sits on a threshold: its MACD within 1e-4·close of 0,
    or its RSI within 1e-2 of 35 or 45 (phase tick's rule)."""
    macd, rsi = update["macd" + suffix], update["rsi" + suffix]
    return (abs(macd) <= 1e-4 * update["current_price"]
            or min(abs(rsi - 35.0), abs(rsi - 45.0)) <= 1e-2)


def compare_updates(got, ref, label, flips):
    """One symbol's market_updates payload of two runs: labels equal but for
    flips near a threshold (counted into ``flips``, their strength skipped),
    floats within `live_tolerance`, the volume profile at 1e-5."""
    if set(got) != set(ref):
        fail(f"{label}: payload keys differ: {sorted(set(got) ^ set(ref))}")
    skip = set()
    for key in LIVE_LABELS + LIVE_FRAME_LABELS:
        if key in ref and got[key] != ref[key]:
            suffix = key[len("signal"):] if key.startswith("signal_") else ""
            if key == "top_family":
                # the strongest of 15 family scores: a near-tie within the
                # families' bound may change hands
                gs, rs = got["top_family_score"], ref["top_family_score"]
                if abs(gs - rs) > 2e-3 + 1e-5 * abs(rs):
                    fail(f"{label}: top family {got[key]} ({gs}) against {ref[key]} ({rs})")
            elif key not in ("signal", "trend") + LIVE_FRAME_LABELS or \
                    not near_threshold(ref, suffix):
                fail(f"{label}: {key} {got[key]} against {ref[key]}, not near a threshold")
            flips.append({"where": label, "key": key, "got": got[key], "ref": ref[key]})
            skip.add("signal_strength")
    for key, r in ref.items():
        if key in LIVE_LABELS + LIVE_FRAME_LABELS or key in skip or isinstance(r, str):
            continue
        g = got[key]
        if isinstance(r, dict):
            for k2, r2 in r.items():
                if abs(g[k2] - r2) > 1e-6 + 1e-5 * abs(r2):
                    fail(f"{label}: {key}.{k2} {g[k2]} against {r2}")
            continue
        rtol, atol = live_tolerance(key, ref)
        if not abs(g - r) <= atol + rtol * abs(r):
            fail(f"{label}: {key} {g} against {r} (rtol {rtol}, atol {atol})")


class LiveRig:
    """The live path on one device at the bench's `tick_pipeline` width:
    the tape's symbols on `make_exchange("fake", resilient=True)` as `cmd_trade`
    builds it (cli.py:393-406: a virtual clock the adapter's sleeps
    advance), the port's EventBus, MarketMonitor (frames 1m/3m/5m/15m, a
    256-candle window), SignalAnalyzer (the rule backend) and TradeExecutor
    with bench_recovery's trading parameters."""

    def __init__(self, tape, device, cursor, pipelined=False, fused=True, symbols=None,
                 executor=True):
        from ai_crypto_trader_tpu_torch.config import TradingParams
        from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
        from ai_crypto_trader_tpu_torch.shell import (
            EventBus, LLMTrader, MarketMonitor, SignalAnalyzer, TradeExecutor, make_exchange)

        self.clock = [1_000_000.0]
        clock = self.clock
        series = {s: OHLCV(timestamp=tape.ts, open=c[0], high=c[1], low=c[2], close=c[3],
                           volume=c[4], symbol=s) for s, c in zip(tape.symbols, tape.cols)}
        self.ex = make_exchange(
            "fake", resilient=True, series=series,
            resilient_opts={"now_fn": lambda: clock[0],
                            "sleep": lambda s: clock.__setitem__(0, clock[0] + s)})
        self.ex.advance(steps=cursor)
        self.bus = EventBus(now_fn=lambda: clock[0])
        self.updates = self.bus.subscribe("market_updates")
        self.signals = self.bus.subscribe("trading_signals")
        self.monitor = MarketMonitor(self.bus, self.ex, symbols=list(symbols or tape.symbols),
                                     intervals=TICK_FRAMES, kline_limit=T_TICK,
                                     now_fn=lambda: clock[0], pipelined=pipelined, fused=fused,
                                     device=device)
        self.analyzer = SignalAnalyzer(self.bus, trader=LLMTrader(model_version="chip_smoke"),
                                       now_fn=lambda: clock[0])
        self.executor = (TradeExecutor(self.bus, self.ex, trading=TradingParams(**LIVE_TRADING),
                                       now_fn=lambda: clock[0], device=device)
                         if executor else None)
        self.payloads, self.decisions, self.fill_counts, self.poll_clocks = [], [], [], []

    def advance(self):
        self.ex.advance()
        self.clock[0] += 60.0

    def poll(self):
        import asyncio

        self.poll_clocks.append(self.clock[0])
        return asyncio.run(self.monitor.poll())

    def drain_updates(self):
        q = self.updates
        self.payloads.append({e["data"]["symbol"]: e["data"]
                              for e in (q.get_nowait() for _ in range(q.qsize()))})

    def analyze(self):
        import asyncio

        asyncio.run(self.analyzer.run_once())
        q = self.signals
        self.decisions.append([(e["data"]["symbol"], e["data"]["decision"],
                                e["data"]["confidence"])
                               for e in (q.get_nowait() for _ in range(q.qsize()))])

    def execute(self):
        """The executor's drain, then `on_price` for each open trade at the
        close the monitor published (the launcher's stage order)."""
        import asyncio

        async def go():
            await self.executor.run_once()
            for s in list(self.executor.active_trades):
                await self.executor.on_price(
                    s, self.bus.get(f"market_data_{s}")["current_price"])

        asyncio.run(go())
        self.fill_counts.append(len(self.ex.fills))

    def tick(self):
        self.advance()
        self.poll()
        self.drain_updates()
        self.analyze()
        self.execute()

    def books(self):
        """A copy of the trades so far: fills, balances, resting orders,
        closures and open trades."""
        import copy

        ex, exe = self.ex, self.executor
        return copy.deepcopy({"fills": ex.fills, "balances": ex.get_balances(),
                              "open_orders": ex.list_open_orders(),
                              "closed": exe.closed_trades,
                              "active": exe.snapshot_state()["active"]})


def live_run(tape, cursor):
    """Run A: LIVE_TICKS ticks on the card in the launcher's stage order,
    each poll with its K2 launches recorded, its tick-engine host reads
    counted and torch's sync debug mode on (the one read exempt); the
    executor's sizing and stop reads counted apart.  `obs.tickpath` is on
    (the poll's phases; the program's CUDA-event span is read after the
    poll's one read) and each stage is timed on the host clock, the sync
    check's own probes outside the timers; then torch.profiler over one
    more whole tick for the device's idle share."""
    import torch

    from ai_crypto_trader_tpu_torch.obs import tickpath
    from ai_crypto_trader_tpu_torch.ops import tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.shell import executor as executor_mod

    rig = LiveRig(tape, "cuda", cursor)
    scope = tickpath.TickPathScope()
    reads, launches, exe_reads = [], [], []
    real_read, real_exe_read = tick_engine.host_read, executor_mod.host_read

    def quiet_read(readback):                  # the poll's one sanctioned sync
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_read(readback)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def counted_exe_read(values):
        exe_reads.append(1)
        return real_exe_read(values)

    marks, per_poll = {}, []

    def timed_poll():
        marks["t0"] = time.perf_counter()
        rig.poll()
        marks["t1"] = time.perf_counter()

    tick_engine.host_read, executor_mod.host_read = quiet_read, counted_exe_read
    try:
        with tickpath.use(scope):
            for t in range(LIVE_TICKS):
                rig.advance()
                n_reads, n_rec = len(reads), len(launches)
                fused_ewma.launches = 0
                with recording_ewma(launches):
                    syncs = sync_calls(timed_poll)
                p = {"k2": fused_ewma.launches, "recorded": len(launches) - n_rec,
                     "host_reads": len(reads) - n_reads, "syncs": syncs,
                     "poll_ms": 1e3 * (marks["t1"] - marks["t0"])}
                t1 = time.perf_counter()
                rig.drain_updates()
                rig.analyze()
                t2 = time.perf_counter()
                n_exe = len(exe_reads)
                rig.execute()
                t3 = time.perf_counter()
                p.update({"executor_reads": len(exe_reads) - n_exe,
                          "analyzer_ms": 1e3 * (t2 - t1), "executor_ms": 1e3 * (t3 - t2),
                          "tick_ms": p["poll_ms"] + 1e3 * (t3 - t1)})
                per_poll.append(p)
    finally:
        tick_engine.host_read, executor_mod.host_read = real_read, real_exe_read
    for t, p in enumerate(per_poll):
        if (p["k2"], p["recorded"], p["host_reads"]) != (3, 3, 1):
            fail(f"live: poll {t} made {p['k2']} K2 launches ({p['recorded']} recorded) and "
                 f"{p['host_reads']} tick-engine host reads, not 3 and 1")
        if p["syncs"]:
            fail(f"live: poll {t} made {len(p['syncs'])} synchronizing calls besides its "
                 f"read: {p['syncs'][:3]}")
    keys = ("poll_ms", "analyzer_ms", "executor_ms", "tick_ms")
    timing = {k: {"p50": percentile([p[k] for p in per_poll], 50),
                  "p99": percentile([p[k] for p in per_poll], 99)} for k in keys}
    status = scope.status()
    timing["poll_phases_ms"] = {k: {"p50": v["p50_ms"], "p99": v["p99_ms"], "count": v["count"]}
                                for k, v in status["phases"].items() if v["count"]}
    timing["overlap_headroom_ms"] = status["overlap_headroom_ms"]
    timing["cold_start"] = scope.coldstart_status()
    payloads, books = list(rig.payloads), rig.books()
    decisions, fill_counts = list(rig.decisions), list(rig.fill_counts)
    try:
        timing["profile_one_tick"] = device_profile(rig.tick)
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        timing["profile_one_tick"] = {"measured": False, "reason": repr(ex)[:300]}
    run = {"payloads": payloads, "books": books, "decisions": decisions,
           "fill_counts": fill_counts, "poll_clocks": list(rig.poll_clocks)}
    return run, launches, per_poll, timing


def live_k2(launches, label):
    """Every recorded K2 launch held against the plain version job by job
    and launched twice for the same bits (`ewma_check`); the first poll's
    three launches timed beside the plain version, the barrier floor and
    the bound."""
    from ai_crypto_trader_tpu_torch.ops.ewma import (
        barrier_launch, fused_ewma_jobs, fused_ewma_plain, tile_count)

    checks = []
    for i, jobs in enumerate(launches):
        named = [(f"job{j}_K{len(a)}_start{st}", x.reshape(-1, x.shape[-1]), a, st)
                 for j, (x, a, st) in enumerate(jobs)]
        checks.append(ewma_check(named, f"{label}_launch{i}"))
    timed = []
    per_poll = 3 if label in ("live_poll", "trade_poll", "stream_drain", "load_tick",
                              "serve_tick") \
        else len(launches)
    for jobs in launches[:per_poll]:
        args = [(x.reshape(-1, x.shape[-1]), a, st) for x, a, st in jobs]
        n_tiles = tile_count([x.shape for x, _, _ in args])
        kmax = max(len(a) for _, a, _ in args)
        b_ms, o_ms = ewma_jobs_bound(args)
        timed.append({"ms": cuda_ms(lambda: fused_ewma_jobs(args, device="cuda"), 20),
                      "barrier_only_ms": cuda_ms(lambda: barrier_launch(n_tiles, kmax), 20),
                      "plain_ms": sum(cuda_ms(lambda: fused_ewma_plain(x, a, st), 3)
                                      for x, a, st in args),
                      "bytes_bound_ms": b_ms, "operations_bound_ms": o_ms})
    all_jobs = [(x.reshape(-1, x.shape[-1]), a, st)
                for jobs in launches[:per_poll] for x, a, st in jobs]
    b_ms, o_ms = ewma_jobs_bound(all_jobs)
    return {"launches_held": len(checks), "ms": sum(t["ms"] for t in timed),
            "ms_per_launch": [t["ms"] for t in timed],
            "plain_ms": sum(t["plain_ms"] for t in timed),
            "barrier_only_ms": sum(t["barrier_only_ms"] for t in timed),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "max_abs_err": max(j["max_abs_err"] for c in checks for j in c["jobs"]),
            "max_rel_err": max(j["max_rel_err"] for c in checks for j in c["jobs"]),
            "plans": [c["plan"] for c in checks[:per_poll]]}


def live_per_symbol(tape, cursor, fused_payload):
    """The per-symbol path (`fused=False`) for one symbol × 4 frames on the
    card at the cursor of run A's last poll: its K2 launches recorded and
    held, its payload against the fused path's within `live_tolerance`."""
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    sym = tape.symbols[0]
    rig = LiveRig(tape, "cuda", cursor, fused=False, symbols=[sym], executor=False)
    rig.clock[0] = fused_payload["timestamp"]
    launches = []
    fused_ewma.launches = 0
    with recording_ewma(launches):
        t0 = time.perf_counter()
        n = rig.poll()
        ms = 1e3 * (time.perf_counter() - t0)
    n_launch = fused_ewma.launches
    want = 3 * len(TICK_FRAMES)        # compute_indicators' 2 and rsi(close, 7) a frame
    if n != 1 or n_launch != want or len(launches) != want:
        fail(f"live: the per-symbol poll published {n} updates with {n_launch} K2 launches "
             f"({len(launches)} recorded), not 1 and {want}")
    rig.drain_updates()
    flips = []
    compare_updates(rig.payloads[-1][sym], fused_payload, f"live per-symbol {sym}", flips)
    k2 = live_k2(launches, "live_per_symbol")
    return {"symbol": sym, "poll_ms": ms, "k2_launches": n_launch, "flips_vs_fused": flips,
            "k2": k2}


def live_scan():
    """`cli scan` at its defaults (64 pairs × 256 candles): as a subprocess
    on the card (exit 0, its JSON), in this process on the card with its K2
    launches recorded (exactly 2) and held, and on the CPU: the ranking
    equal, in the same order."""
    import contextlib as ctx
    import io
    import os

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "scan"],
                          cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"live: cli scan exited {proc.returncode}: {proc.stderr[-800:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])

    def in_process(argv):
        buf = io.StringIO()
        with ctx.redirect_stdout(buf):
            t = time.perf_counter()
            cli.main(argv)
            ms = 1e3 * (time.perf_counter() - t)
        return json.loads(buf.getvalue().strip().splitlines()[-1]), ms

    launches = []
    fused_ewma.launches = 0
    with recording_ewma(launches):
        card, card_ms = in_process(["scan"])
    n_launch = fused_ewma.launches
    if n_launch != 2 or len(launches) != 2:
        fail(f"live: cli scan made {n_launch} K2 launches ({len(launches)} recorded), not 2")
    cpu, cpu_ms = in_process(["scan", "--device", "cpu"])
    order = [o["symbol"] for o in cpu["ranked"]]
    for name, run in (("subprocess", sub), ("in-process", card)):
        if [o["symbol"] for o in run["ranked"]] != order or run["discovered"] != 64:
            fail(f"live: cli scan's {name} ranking on the card differs from the CPU's: "
                 f"{[o['symbol'] for o in run['ranked']]} against {order}")
    score_diff = max((abs(a["score"] - b["score"]) for a, b in zip(card["ranked"], cpu["ranked"])),
                     default=0.0)
    return {"exit_code": proc.returncode, "subprocess_s": wall, "discovered": sub["discovered"],
            "ranked": order, "k2_launches": n_launch, "card_ms": card_ms, "cpu_ms": cpu_ms,
            "max_score_diff_card_cpu": score_diff, "k2": live_k2(launches, "live_scan")}


def live_recovery():
    """Recovery at bench_recovery's shape (bench.py:953-1018): 1,000
    journaled trades (entry, close) by an executor on the card, then a
    fresh executor on the card recovers from the journal; its books must
    equal the writer's."""
    import asyncio
    import os
    import tempfile

    from ai_crypto_trader_tpu_torch.config import TradingParams
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell import EventBus, FakeExchange, TradeExecutor
    from ai_crypto_trader_tpu_torch.utils.journal import WriteAheadJournal

    n_trades = 1_000
    clock = {"t": 0.0}
    series = from_dict(generate_ohlcv(n=2 * n_trades + 200, seed=11), symbol="BTCUSDC")
    ex = FakeExchange({"BTCUSDC": series}, quote_balance=1e9, fee_rate=0.0)
    ex.advance(steps=64)
    trading = TradingParams(**LIVE_TRADING)

    def executor(journal):
        return TradeExecutor(EventBus(now_fn=lambda: clock["t"]), ex, trading=trading,
                             now_fn=lambda: clock["t"], journal=journal, device="cuda")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trades.journal")
        writer = executor(WriteAheadJournal(path))
        writer.COMPACT_EVERY = 10 ** 9

        async def drive():
            for _ in range(n_trades):
                price = ex.get_ticker("BTCUSDC")["price"]
                trade = await writer.handle_signal({
                    "symbol": "BTCUSDC", "signal": "BUY", "decision": "BUY",
                    "confidence": 1.0, "signal_strength": 100.0, "current_price": price,
                    "volatility": 0.015, "avg_volume": 60_000.0})
                ex.advance()
                clock["t"] += 60.0
                if trade is not None:
                    await writer.close_trade("BTCUSDC", ex.get_ticker("BTCUSDC")["price"],
                                             "Bench")

        t0 = time.perf_counter()
        asyncio.run(drive())
        write_s = time.perf_counter() - t0
        writer.journal.flush()
        n_records = writer.journal.seq
        t0 = time.perf_counter()
        fresh = executor(None)
        journal = WriteAheadJournal(path)
        fresh.journal = journal
        report = asyncio.run(fresh.recover_from_journal(journal))
        ms = 1e3 * (time.perf_counter() - t0)
        journal.close()
    want, got = writer.snapshot_state(), fresh.snapshot_state()
    if len(writer.closed_trades) != n_trades or got != want:
        fail(f"live: recovery rebuilt {got['closed_total_n']} closed trades and "
             f"{len(got['active'])} open, the writer {want['closed_total_n']} and "
             f"{len(want['active'])}; books equal: {got == want}")
    return {"trades": n_trades, "journal_records": n_records,
            "replayed_records": report["replayed_records"], "recovery_ms": ms,
            "write_s": write_s, "books_equal_writer": True}


def phase_live(info):
    """The live signal path on the card at the bench's `tick_pipeline` width
    (64 symbols × frames 1m/3m/5m/15m × a 256-candle window on the
    resilient paper exchange): LIVE_TICKS ticks of ex.advance → monitor.poll
    → analyzer.run_once → executor.run_once → on_price, checked (3 K2
    launches and one host read a poll, no other sync, every launch held
    against the plain EWMA) and timed (tickpath's split of the poll,
    torch.profiler over one more tick); the same ticks on the CPU (payloads
    within `live_tolerance`, label flips only near a threshold, trades
    equal where the decisions agree); the pipelined monitor's payloads over
    LIVE_PIPE_TICKS ticks against the serial ones shifted by one tick; the
    per-symbol path; `cli scan`; journal recovery at bench_recovery's
    shape.  Returns K2's entry for the kernels line."""
    import asyncio

    t_phase = time.perf_counter()
    tape = TickTape(S_TICK, T_TICK)
    # every frame full; the tape's first BUY run starts at its 4th tick (all
    # 64 symbols are one series scaled, so they signal together), and 36
    # candles are left after the LIVE_TICKS ticks and a profiled one
    cursor = tape.n - 48
    run_a, launches, per_poll, timing = live_run(tape, cursor)

    # --- the CPU run of the same ticks ------------------------------------
    rig_c = LiveRig(tape, "cpu", cursor)
    t0 = time.perf_counter()
    for _ in range(LIVE_TICKS):
        rig_c.tick()
    cpu_s = time.perf_counter() - t0
    flips = []
    for t, (card, cpu) in enumerate(zip(run_a["payloads"], rig_c.payloads)):
        if set(card) != set(cpu) or len(card) != S_TICK:
            fail(f"live: tick {t} published {len(card)} updates on the card, {len(cpu)} on "
                 "the CPU")
        for s in cpu:
            compare_updates(card[s], cpu[s], f"live tick {t} {s}", flips)
    n_labels = LIVE_TICKS * S_TICK * len(TICK_FRAMES)
    if len(flips) > n_labels // 1000:
        fail(f"live: {len(flips)} label flips card vs CPU, over one in 1,000 of {n_labels}")
    # trades: equal wherever the decisions agree — all of them when every
    # tick's decisions agree, else the fills made before the first tick
    # whose decisions differ
    card_books, cpu_books = run_a["books"], rig_c.books()
    diverge = next((t for t, (a, b) in enumerate(zip(run_a["decisions"], rig_c.decisions))
                    if a != b), None)
    if diverge is None:
        if card_books != cpu_books:
            fail("live: the decisions agree but the trades on the card differ from the CPU's")
        compared_fills = len(card_books["fills"])
    else:
        compared_fills = run_a["fill_counts"][diverge - 1] if diverge else 0
        if card_books["fills"][:compared_fills] != cpu_books["fills"][:compared_fills] or \
                (diverge and rig_c.fill_counts[diverge - 1] != compared_fills):
            fail(f"live: the trades before tick {diverge}, where the decisions agree, differ")
    entries = sum(f["side"] == "BUY" for f in card_books["fills"][:compared_fills])
    if entries < 1:
        fail("live: no entry where the decisions agree: the trade comparison is vacuous")
    if not all(math.isfinite(u[k]) for p in run_a["payloads"] for u in p.values()
               for k in ("current_price", "rsi", "macd", "confluence")):
        fail("live: a published value is not finite")

    # --- pipelined against serial, shifted by one tick --------------------
    rig_p = LiveRig(tape, "cuda", cursor, pipelined=True, executor=False)
    for t in range(LIVE_PIPE_TICKS):
        rig_p.advance()
        # the serial run's clock at this poll: its executor's venue calls
        # moved the virtual clock (rate-limit sleeps), and a payload is
        # stamped with the clock at its poll
        rig_p.clock[0] = run_a["poll_clocks"][t]
        rig_p.poll()
        rig_p.drain_updates()
    asyncio.run(rig_p.monitor.flush_pipeline())
    rig_p.drain_updates()
    serial = run_a["payloads"][:LIVE_PIPE_TICKS]
    if rig_p.payloads[0] or rig_p.payloads[1:] != serial:
        where = next(((t, sym, k) for t, (p, a) in enumerate(zip(rig_p.payloads[1:], serial))
                      for sym in a for k in a[sym] if p.get(sym, {}).get(k) != a[sym][k]),
                     None)
        fail("live: the pipelined monitor's payloads differ from the serial ones shifted by "
             f"one tick (first at tick, symbol, key {where}; {len(rig_p.payloads)} drains)")

    per_symbol = live_per_symbol(tape, cursor + LIVE_TICKS,
                                 run_a["payloads"][-1][tape.symbols[0]])
    k2 = live_k2(launches, "live_poll")
    scan = live_scan()
    recovery = live_recovery()
    exe_reads = [p["executor_reads"] for p in per_poll]
    report = {"phase": "live", "card": info["nvidia_smi"], "symbols": S_TICK,
              "frames": list(TICK_FRAMES), "window": T_TICK, "ticks": LIVE_TICKS,
              "k2_launches_per_poll": 3, "host_reads_per_poll": 1,
              "host_syncs_per_poll_besides_read": 0,
              "executor_reads_per_tick": exe_reads, "k2": k2,
              "timing": timing, "cpu_run_s": cpu_s,
              "card_vs_cpu": {"label_flips": len(flips), "labels": n_labels,
                              "flips": flips[:5], "decisions_diverge_at_tick": diverge,
                              "fills_compared": compared_fills,
                              "trades_equal": card_books == cpu_books},
              "entries": entries, "closed_trades": len(card_books["closed"]),
              "open_trades": len(card_books["active"]),
              "pipelined_equal_serial_shifted": True, "pipelined_ticks": LIVE_PIPE_TICKS,
              "per_symbol": per_symbol,
              "scan": scan, "recovery": recovery,
              "phase_s": time.perf_counter() - t_phase}
    emit(report)
    return {"launches_per_poll": 3, "polls": LIVE_TICKS,
            "launches": 3 * LIVE_TICKS + per_symbol["k2_launches"] + scan["k2_launches"],
            "launches_by_path": {"monitor_polls": 3 * LIVE_TICKS,
                                 "per_symbol_poll": per_symbol["k2_launches"],
                                 "cli_scan": scan["k2_launches"]},
            **{k: k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "barrier_only_ms",
                                  "bound_ms", "bound_by", "max_abs_err", "max_rel_err")},
            "library_ms": None,
            "per_symbol": {k: per_symbol["k2"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by", "max_abs_err")},
            "scan": {k: scan["k2"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "max_abs_err")},
            "poll_ms_p50": timing["poll_ms"]["p50"], "tick_ms_p50": timing["tick_ms"]["p50"],
            "shape": f"a poll's 3 launches at S={S_TICK} x F={len(TICK_FRAMES)} x T={T_TICK}; "
                     "per_symbol: one symbol's 12 (3 a frame); scan: 2 over [64, 256]"}


# --- phase trade: the trading system ---------------------------------------

TRADE_TICKS = 8           # ticks of the trading system (phase trade; cut from 16)
TRADE_CUT = 4             # its recovery run dies after this tick
TRADE_CLI_TICKS = 6       # `cli trade --paper --ticks`, as a user runs it (cut from 100; 25 until
                          # PR 17, 12 until PR 18)
TRADE_CURSOR = 3_858      # the tape's candle before the first tick
# a tight trailing stop, so that the tape's one BUY run (candle 3,860, the
# window's tick 1) closes within the window (candle 3,866, its last tick):
# activation, trail and floor at 0.05 %
TRADE_TRAILING = {"activation_threshold_pct": 0.05, "trail_percent": 0.05,
                  "min_trail_distance_pct": 0.05}


class TradeRig:
    """`TradingSystem` on one device at the bench's `tick_pipeline` width:
    phase live's tape behind `make_exchange("fake", resilient=True)` on a
    virtual clock, bench_recovery's trading parameters, a journal, a
    flight-recorder JSONL and a dashboard (and, for the timed run, a trace
    JSONL) under ``tmp``.  The wall clock that feeds alerts is pinned (a
    frozen loop-lag probe, a tick budget no tick reaches) and ids are
    counted, so the card's run and the CPU's can be held to each other;
    the model version is fixed."""

    def __init__(self, tape, device, cursor, tmp, tag, trace=False, system_kw=None):
        from ai_crypto_trader_tpu_torch.config import (
            FrameworkConfig, RiskParams, TradingParams, TrailingStopParams)
        from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
        from ai_crypto_trader_tpu_torch.shell import make_exchange
        from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem

        self.clock = [1_000_000.0]
        clock = self.clock
        series = {s: OHLCV(timestamp=tape.ts, open=c[0], high=c[1], low=c[2], close=c[3],
                           volume=c[4], symbol=s) for s, c in zip(tape.symbols, tape.cols)}
        self.ex = make_exchange(
            "fake", resilient=True, series=series,
            resilient_opts={"now_fn": lambda: clock[0],
                            "sleep": lambda s: clock.__setitem__(0, clock[0] + s)})
        self.ex.advance(steps=cursor)
        self.paths = {k: f"{tmp}/{tag}.{k}" for k in ("journal", "decisions", "html", "spans")}
        self.system_kw = dict(system_kw or {})
        self.system = self.build(TradingSystem, tape.symbols, FrameworkConfig(
            trading=TradingParams(**LIVE_TRADING),
            risk=RiskParams(trailing_stop=TrailingStopParams(**TRADE_TRAILING))), device, trace)
        self.returns, self.tick_ms = [], []

    def build(self, cls, symbols, config, device, trace):
        import itertools

        from ai_crypto_trader_tpu_torch.shell import LLMTrader
        from ai_crypto_trader_tpu_torch.utils.health import EventLoopLagProbe

        system = cls(self.ex, list(symbols), config=config,
                     now_fn=lambda: self.clock[0], device=device,
                     journal_path=self.paths["journal"],
                     flightrec_path=self.paths["decisions"],
                     dashboard_path=self.paths["html"],
                     trace_jsonl=self.paths["spans"] if trace else None,
                     tick_budget_s=1e9, **self.system_kw)
        ids = itertools.count(1)
        system.flightrec._id_fn = lambda: f"d{next(ids):06d}"
        if system.tracer is not None:
            spans = itertools.count(1)
            system.tracer._id_fn = lambda: f"{next(spans):016x}"
        system.loop_lag = EventLoopLagProbe(clock=lambda: 0.0)
        system.analyzer.trader = LLMTrader(model_version="chip_smoke")
        return system

    def tick(self):
        import asyncio

        self.ex.advance()
        self.clock[0] += 60.0
        t0 = time.perf_counter()
        out = asyncio.run(self.system.tick())
        self.tick_ms.append(1e3 * (time.perf_counter() - t0))
        self.returns.append(out)
        return out

    def restart(self, device):
        """A new system on this rig's exchange, clock and journal: the
        process that replaces one which died without `shutdown()`."""
        from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem

        old = self.system
        self.system = self.build(TradingSystem, old.symbols, old.config, device, False)
        return self.system

    def books(self):
        import copy

        ex, exe = self.ex, self.system.executor
        return copy.deepcopy({"fills": ex.fills, "balances": ex.get_balances(),
                              "open_orders": ex.list_open_orders(),
                              "closed": exe.closed_trades,
                              "active": exe.snapshot_state()["active"]})

    def snapshot(self):
        import copy

        from ai_crypto_trader_tpu_torch.obs.flightrec import load_decisions

        sys_ = self.system
        sys_.flightrec.journal.flush()
        with open(self.paths["html"]) as f:
            html = f.read()
        return copy.deepcopy({
            "returns": self.returns, "status": sys_.status(), "books": self.books(),
            "pnl_attribution": sys_.bus.get("pnl_attribution"),
            "risk_metrics": sys_.bus.get("risk_metrics"),
            "correlation_matrix": sys_.bus.get("correlation_matrix"),
            "portfolio_value_history": sys_.bus.get("portfolio_value_history"),
            "alerts": sys_.alerts.history, "records": sys_.flightrec.query(limit=0),
            "file_records": load_decisions(self.paths["decisions"])[0],
            "flightrec_status": {k: v for k, v in sys_.flightrec.status().items()
                                 if k != "journal"},
            "html": html,
            "max_price": max(sys_.bus.get(f"market_data_{s}")["current_price"]
                             for s in sys_.symbols)})


_TEXT_NUM = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


def same_text(got, ref, rtol=1e-5, atol=0.0):
    """Two texts equal but for their numbers, each within rtol, atol or one
    unit of its last printed digit (a float32 ulp may round a digit the
    other way).  Returns the first difference, or None."""
    if _TEXT_NUM.split(got) != _TEXT_NUM.split(ref):
        a, b = _TEXT_NUM.split(got), _TEXT_NUM.split(ref)
        return next(((x[:80], y[:80]) for x, y in zip(a, b) if x != y), (len(a), len(b)))

    def close(g, r):
        gv, rv = float(g.replace(",", "")), float(r.replace(",", ""))
        last = 10.0 ** -(len(r.split(".")[1]) if "." in r else 0)
        return abs(gv - rv) <= rtol * abs(rv) + max(last, atol)

    for g, r in zip(_TEXT_NUM.findall(got), _TEXT_NUM.findall(ref)):
        # a comma is a thousands separator or a list's ("rgb(40,190,100)")
        if g != r and not close(g, r) and not (
                g.count(",") == r.count(",")
                and all(close(x, y) for x, y in zip(g.split(","), r.split(",")))):
            return g, r
    return None


def svg_geometry_stripped(html):
    """The dashboard without its charts' geometry: every coordinate and size
    attribute inside an ``<svg>`` emptied.  A chart scales its series to its
    own range, so a float32 ulp in a nearly flat series (the VaR history)
    moves a point by far more than the value's tolerance; the labels, the
    tables and every number outside the charts stay."""
    geometry = re.compile(r"""\b(points|d|x|y|x1|x2|y1|y2|cx|cy|width|height|r|fill)=(["'])[^"']*\2""")
    return re.sub(r"<svg.*?</svg>", lambda m: geometry.sub(r"\1=\2\2", m.group(0)), html,
                  flags=re.S)


def trade_records(got, ref, flips):
    """Flight-recorder records of two runs: equal but for the tick engine's
    floats in a feature slice (within `live_tolerance`) and label flips near
    a threshold (counted into ``flips``; that record's verdict and
    narrative then skipped), the narrative's numbers within `same_text`."""
    if len(got) != len(ref):
        fail(f"trade: {len(got)} decision records on the card, {len(ref)} on the CPU")
    for g, r in zip(got, ref):
        if set(g) != set(r):
            fail(f"trade: record keys differ: {sorted(set(g) ^ set(r))}")
        gf, rf = g["features"], r["features"]
        flipped = False
        for k, rv in rf.items():
            if isinstance(rv, str):
                if gf[k] != rv:
                    if k not in ("signal", "trend", "top_family") or not near_threshold(rf):
                        fail(f"trade: record {r['id']} {k} {gf[k]} against {rv}, "
                             "not near a threshold")
                    flips.append({"record": r["id"], "key": k, "got": gf[k], "ref": rv})
                    flipped = True
            elif isinstance(rv, float):
                rtol, atol = live_tolerance(k, rf)
                if not abs(gf[k] - rv) <= atol + rtol * abs(rv):
                    fail(f"trade: record {r['id']} feature {k} {gf[k]} against {rv}")
            elif gf[k] != rv:
                fail(f"trade: record {r['id']} feature {k} {gf[k]} against {rv}")
        for k, rv in r.items():
            if k == "features" or (flipped and k in ("verdict", "explanation")):
                continue
            if k in ("verdict", "explanation") and rv is not None:
                diff = same_text(json.dumps(g[k], sort_keys=True),
                                 json.dumps(rv, sort_keys=True))
                if diff is not None:
                    fail(f"trade: record {r['id']} {k} differs: {diff}")
            elif g[k] != rv:
                fail(f"trade: record {r['id']} {k} {g[k]} against {rv}")


def trade_run(tape, device, tmp, tag, trace=False):
    """TRADE_TICKS ticks of the trading system on ``device``; on the card
    each tick's K2 launches recorded and counted (the counts set to 0 just
    before the run and read just after) and its host reads counted by
    seam: the tick engine's, the risk block's, the executor's."""
    from ai_crypto_trader_tpu_torch.ops import tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.shell import executor as executor_mod
    from ai_crypto_trader_tpu_torch.shell import launcher as launcher_mod

    rig = TradeRig(tape, device, TRADE_CURSOR, tmp, tag, trace=trace)
    signals = rig.system.bus.subscribe("trading_signals")
    reads = {"engine": [], "risk": [], "executor": []}
    seams = {"engine": (tick_engine, "host_read"), "risk": (launcher_mod, "host_read"),
             "executor": (executor_mod, "host_read")}
    real = {k: getattr(m, n) for k, (m, n) in seams.items()}

    def counted(kind):
        def read(x):
            reads[kind].append(1)
            return real[kind](x)
        return read

    launches, per_tick, decisions, clocks, fill_counts = [], [], [], [], []
    for k, (m, n) in seams.items():
        setattr(m, n, counted(k))
    fused_ewma.launches = 0
    try:
        with recording_ewma(launches):
            for _ in range(TRADE_TICKS):
                before = {k: len(v) for k, v in reads.items()}
                n_k2, n_rec = fused_ewma.launches, len(launches)
                rig.tick()
                per_tick.append({"k2": fused_ewma.launches - n_k2,
                                 "recorded": len(launches) - n_rec,
                                 **{f"{k}_reads": len(v) - before[k] for k, v in reads.items()},
                                 "tick_ms": rig.tick_ms[-1]})
                decisions.append([(e["data"]["symbol"], e["data"]["decision"])
                                  for e in (signals.get_nowait() for _ in range(signals.qsize()))])
                clocks.append(rig.clock[0])
                fill_counts.append(len(rig.ex.fills))
        total_k2 = fused_ewma.launches
    finally:
        for k, (m, n) in seams.items():
            setattr(m, n, real[k])
    return rig, {"launches": launches, "per_tick": per_tick, "decisions": decisions,
                 "clocks": clocks, "fill_counts": fill_counts, "k2_total": total_k2}


def trade_cli(tmp):
    """`cli trade --paper` and `cli why` as a user runs them: subprocesses
    on the card (exit 0), against the same commands in this process on the
    CPU.  Each run logs through LOG_PATH, so the alerts that read the wall
    clock (the loop lag, the stage duty) are counted out of both statuses;
    the rest is held exactly (`--full-stack` runs in phase stack, `--serve`
    and the observatories in phase serve)."""
    import contextlib as ctx
    import io
    import os

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.obs.flightrec import format_why, load_decisions

    root = os.path.dirname(os.path.abspath(__file__))
    wall_alerts = ("EventLoopLagHigh", "StageSaturated")

    def argv(tag):
        return ["trade", "--paper", "--ticks", str(TRADE_CLI_TICKS), "--journal",
                f"{tmp}/cli_{tag}.journal", "--flightrec", f"{tmp}/cli_{tag}.decisions.jsonl"]

    def status_of(out, log):
        start = out.rindex("\n{\n") + 1 if "\n{\n" in out else out.index("{\n")
        status = json.loads(out[start:])
        with open(log) as f:
            fired = [json.loads(line) for line in f]
        wall = sum(1 for r in fired if r.get("msg") == "alert fired"
                   and r.get("name") in wall_alerts)
        status["alerts"] = [a for a in status["alerts"] if a not in wall_alerts]
        status["channels"]["alerts"] = status["channels"].get("alerts", 0) - wall
        return status, wall

    # the card's subprocess runs beside the CPU's run in this process (no
    # kernel is timed meanwhile)
    card_proc = Beside([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", *argv("card")],
                       root, env={"LOG_PATH": f"{tmp}/card.log"})
    buf = io.StringIO()
    os.environ["LOG_PATH"] = f"{tmp}/cpu.log"
    try:
        with ctx.redirect_stdout(buf):
            t0 = time.perf_counter()
            cli.main(argv("cpu") + ["--device", "cpu"])
            cpu_s = time.perf_counter() - t0
        rc, out, err, trade_s = card_proc.finish(timeout=600)
    finally:
        os.environ.pop("LOG_PATH", None)
        card_proc.stop()
    if rc != 0:
        fail(f"trade: cli trade exited {rc}: {err[-800:]}")
    card, card_wall = status_of(out, f"{tmp}/card.log")
    cpu, cpu_wall = status_of(buf.getvalue(), f"{tmp}/cpu.log")
    if card != cpu:
        fail(f"trade: cli trade's status on the card differs from the CPU's: {card} against "
             f"{cpu}")
    if card["channels"].get("market_updates") != TRADE_CLI_TICKS:
        fail(f"trade: cli trade published {card['channels']} over {TRADE_CLI_TICKS} ticks")

    t0 = time.perf_counter()
    why = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "why", "BTCUSDC",
                          "--file", f"{tmp}/cli_card.decisions.jsonl"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    why_s = time.perf_counter() - t0
    if why.returncode != 0:
        fail(f"trade: cli why exited {why.returncode}: {why.stderr[-800:]}")
    records, _ = load_decisions(f"{tmp}/cli_cpu.decisions.jsonl")
    want = format_why(list(reversed([r for r in records if r["symbol"] == "BTCUSDC"][-10:])))
    got = why.stdout.splitlines()
    diff = same_text("\n".join(got), "\n".join(want))
    if not want or diff is not None:
        fail(f"trade: cli why's lines differ from format_why over the CPU's records: {diff}")
    return {"ticks": TRADE_CLI_TICKS, "exit_code": rc, "subprocess_s": trade_s,
            "cpu_in_process_s": cpu_s,
            "contended": "subprocess_s and cpu_in_process_s were taken with both runs going "
                         "at once on the same host",
            "status_equal_cpu": True,
            "wall_clock_alerts_fired": {"card": card_wall, "cpu": cpu_wall},
            "closed_trades": card["closed_trades"], "why_exit_code": why.returncode,
            "why_lines": len(got), "why_s": why_s}


def phase_trade(info):
    """The trading system on the card at the bench's `tick_pipeline` width:
    TRADE_TICKS ticks of `TradingSystem.tick` (the monitor's 3 K2 launches
    a tick, each held against the plain EWMA; the host reads pinned: one of
    the tick engine, two of the risk block a tick) against the same ticks
    on the CPU (returns, status, trades, flight records, attribution,
    dashboard; risk within 1e-5), with a trade opened and closed in the
    window; a run that dies after TRADE_CUT ticks and a new system that
    recovers from its journal, its books against the unbroken run's;
    `cli trade --paper` and `cli why` as subprocesses; `device_liveness`.
    Returns K2's `trade` block for the kernels line."""
    import asyncio
    import tempfile

    import numpy as np

    from ai_crypto_trader_tpu_torch.utils.health import device_liveness

    t_phase = time.perf_counter()
    tape = TickTape(S_TICK, T_TICK)
    with tempfile.TemporaryDirectory() as tmp:
        card_rig, card = trade_run(tape, "cuda", tmp, "card", trace=True)
        a = card_rig.snapshot()
        sys_ = card_rig.system
        timing = {"tick_ms": {"p50": percentile(card_rig.tick_ms, 50),
                              "p99": percentile(card_rig.tick_ms, 99)}}
        tp = sys_.tickpath.status()
        timing["waterfall_ms"] = {k: {"p50": v["p50_ms"], "p99": v["p99_ms"]}
                                  for k, v in tp["phases"].items() if v["count"]}
        timing["bottleneck"] = sys_.tickpath.bottleneck()
        busy = sys_.saturation.status()["stage_busy_seconds_total"]
        timing["stage_busy_ms_per_tick"] = {k: 1e3 * v / TRADE_TICKS for k, v in busy.items()}
        timing["duty_of_a_1s_budget"] = {k: v / TRADE_TICKS for k, v in busy.items()}
        try:
            timing["profile_one_tick"] = device_profile(card_rig.tick)
        except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported
            timing["profile_one_tick"] = {"measured": False, "reason": repr(ex)[:300]}
        with open(card_rig.paths["spans"]) as f:
            spans = sum(1 for _ in f)
        sys_.shutdown()

        t0 = time.perf_counter()
        cpu_rig, cpu = trade_run(tape, "cpu", tmp, "cpu", trace=True)
        cpu_s = time.perf_counter() - t0
        b = cpu_rig.snapshot()
        cpu_rig.system.shutdown()

        for t, p in enumerate(card["per_tick"]):
            if (p["k2"], p["recorded"], p["engine_reads"], p["risk_reads"]) != (3, 3, 1, 2):
                fail(f"trade: tick {t} made {p['k2']} K2 launches ({p['recorded']} recorded), "
                     f"{p['engine_reads']} tick-engine and {p['risk_reads']} risk host reads, "
                     "not 3, 1 and 2")
        if card["k2_total"] != 3 * TRADE_TICKS:
            fail(f"trade: {card['k2_total']} K2 launches in {TRADE_TICKS} ticks")
        flips = []
        diverge = next((t for t, (x, y) in enumerate(zip(card["decisions"], cpu["decisions"]))
                        if x != y), None)
        if diverge is None:
            if a["returns"] != b["returns"] or a["status"] != b["status"]:
                fail("trade: the ticks' returns or status on the card differ from the CPU's")
            if a["books"] != b["books"]:
                where = [k for k in a["books"] if a["books"][k] != b["books"][k]]
                fail(f"trade: the decisions agree but the trades on the card differ ({where}): "
                     f"{str([a['books'][k] for k in where])[:600]} against "
                     f"{str([b['books'][k] for k in where])[:600]}")
            for k in ("pnl_attribution", "portfolio_value_history", "alerts",
                      "flightrec_status"):
                if a[k] != b[k]:
                    fail(f"trade: {k} on the card differs from the CPU's")
            trade_records(a["records"], b["records"], flips)
            trade_records(a["file_records"], b["file_records"], [])
            if not flips:
                # the page prints MACD (the explanations): its numbers are
                # held to MACD's bound, 1e-3 + 2e-6·close (live_tolerance)
                diff = same_text(svg_geometry_stripped(a["html"]),
                                 svg_geometry_stripped(b["html"]),
                                 atol=1e-3 + 2e-6 * b["max_price"])
                if diff is not None:
                    fail(f"trade: the dashboard differs from the CPU's: {diff}")
            compared_fills = len(a["books"]["fills"])
        else:
            # phase live's rule: the first tick whose decisions differ holds
            # a label flip near a threshold, and everything before it agrees
            t_d = card["clocks"][diverge - 1] if diverge else -1.0
            compared_fills = card["fill_counts"][diverge - 1] if diverge else 0
            if (a["books"]["fills"][:compared_fills] != b["books"]["fills"][:compared_fills]
                    or (diverge and cpu["fill_counts"][diverge - 1] != compared_fills)):
                fail(f"trade: the trades before tick {diverge}, where the decisions agree, "
                     "differ")
            t_next = card["clocks"][diverge]
            before = [[r for r in x["records"] if r["t"] <= t_d] for x in (a, b)]
            at = [[r for r in x["records"] if t_d < r["t"] <= t_next] for x in (a, b)]
            trade_records(*before, flips)
            trade_records(*at, flips)
            if not any(f["record"] in {r["id"] for r in at[1]} for f in flips):
                fail(f"trade: the decisions differ from tick {diverge} with no label flip "
                     "near a threshold there")
            if not any(c["closed_at"] <= t_d for c in a["books"]["closed"]):
                fail(f"trade: the decisions differ from tick {diverge}, before any closure")
        ra, rb = a["risk_metrics"], b["risk_metrics"]
        for k, v in rb.items():
            if not abs(ra[k] - v) <= 1e-5 * abs(v):
                fail(f"trade: risk_metrics {k} {ra[k]} against the CPU's {v}")
        ca, cb = (np.asarray(x["matrix"]) for x in (a["correlation_matrix"],
                                                    b["correlation_matrix"]))
        if not np.allclose(ca, cb, rtol=1e-5, atol=1e-6):
            fail(f"trade: the correlation matrix differs by {np.abs(ca - cb).max()}")
        closed = a["books"]["closed"]
        if not closed or not a["pnl_attribution"]:
            fail("trade: no trade closed on the card: the closure path is untested")

        # --- recovery on the card ------------------------------------------
        rig = TradeRig(tape, "cuda", TRADE_CURSOR, tmp, "cut")
        for _ in range(TRADE_CUT):
            rig.tick()
        rig.system.journal.simulate_crash()            # dies without shutdown()
        t0 = time.perf_counter()
        fresh = rig.restart("cuda")
        report = asyncio.run(fresh.recover())
        recover_ms = 1e3 * (time.perf_counter() - t0)
        for _ in range(TRADE_TICKS - TRADE_CUT):
            rig.tick()
        got = rig.books()
        fresh.shutdown()

        def no_ids(trades):
            # the new system numbers its decisions afresh, and its recovery's
            # venue calls advance the virtual clock (rate-limit sleeps), so
            # a later closure is stamped a little later
            items = trades.items() if isinstance(trades, dict) else enumerate(trades)
            return {k: {**t, "closed_at": None,
                        "source": {**(t.get("source") or {}), "decision_id": None}}
                    for k, t in items}

        want = a["books"]
        if (got["fills"] != want["fills"] or got["open_orders"] != want["open_orders"]
                or got["balances"] != want["balances"]
                or no_ids(got["active"]) != no_ids(want["active"])
                or no_ids(got["closed"]) != no_ids(want["closed"])):
            fail("trade: the recovered system's books differ from the unbroken run's")
        recovery = {"cut_after_tick": TRADE_CUT, "recover_ms": recover_ms,
                    **{k: v for k, v in report.items() if k != "journal"},
                    "books_equal_unbroken": True, "closed_after_recovery": len(got["closed"])}

        cli_report = trade_cli(tmp)
    live = device_liveness()
    if live != {"cuda:0": True}:
        fail(f"trade: device_liveness() on the card: {live}")
    k2 = live_k2(card["launches"][:3 * TRADE_TICKS], "trade_poll")
    report = {"phase": "trade", "card": info["nvidia_smi"], "symbols": S_TICK,
              "frames": list(TICK_FRAMES), "window": T_TICK, "ticks": TRADE_TICKS,
              "cursor": TRADE_CURSOR, "k2_launches_per_tick": 3,
              "host_reads_per_tick": {"tick_engine": 1, "risk": 2,
                                      "executor": [p["executor_reads"]
                                                   for p in card["per_tick"]]},
              "k2": k2, "timing": timing, "cpu_run_s": cpu_s, "spans_written": spans,
              "card_vs_cpu": {"decisions_diverge_at_tick": diverge, "label_flips": len(flips),
                              "flips": flips[:5], "fills_compared": compared_fills,
                              "trades_equal": a["books"] == b["books"],
                              "records": len(a["records"])},
              "entries": sum(f["side"] == "BUY" for f in a["books"]["fills"]),
              "closed_trades": len(closed), "close_reasons": sorted({c["reason"] for c in closed}),
              "pnl_attribution": a["pnl_attribution"], "risk_metrics": ra,
              "recovery": recovery, "cli": cli_report, "device_liveness": live,
              "phase_s": time.perf_counter() - t_phase}
    emit(report)
    return {"launches": card["k2_total"], "launches_per_tick": 3, "ticks": TRADE_TICKS,
            **{k: k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "barrier_only_ms",
                                  "bound_ms", "bound_by", "max_abs_err", "max_rel_err")},
            "launches_held": k2["launches_held"], "library_ms": None,
            "tick_ms_p50": timing["tick_ms"]["p50"],
            "shape": f"a tick's 3 launches at S={S_TICK} x F={len(TICK_FRAMES)} x T={T_TICK} "
                     "(the monitor's poll inside TradingSystem.tick)"}


# --- phase stack: the full service roster ----------------------------------

STACK_ROSTER = ["social", "news", "patterns", "regime", "nn", "evolver", "generator", "grid",
                "dca"]
STACK_TICKS = 6           # ticks of the trading system with the roster
STACK_CURSOR = 3_854      # the tape's candle before the first tick: the BUY run's entries
#                           (candle 3,859, phase trade's tick 1) come at tick 5, after four
#                           social polls (a snapshot's quality gate needs four rows)
STACK_SOCIAL_POLLS = 64   # part (b): past the 50-row anomaly gate and the report gates
STACK_ARB_ASSETS = 64     # part (c): 64³ = 262,144 cycles
STACK_SOCIAL_DAYS = 15    # part (d): 15 days of daily social metrics (30 until PR 17)
STACK_SOCIAL_T = 21_600   # over 21,600 1m candles (43,200 until PR 17)
STACK_SOCIAL_B = 16       # genomes of its backtest
STACK_CLI_TICKS = 5       # `cli trade --paper --full-stack --ticks` (cut from 20; 10 until PR 18)


def stack_social_provider(bus, symbol):
    """`social.service.deterministic_provider` at ten times its sensitivity
    to the 15-minute price change: over the tape's quiet candles (|Δ| well
    under 1.5 %) the default provider's sentiment stays inside the risk
    adjuster's neutral band, and the executor's social factors would all be
    exactly 1."""
    from ai_crypto_trader_tpu_torch.social.service import deterministic_provider

    md = bus.get(f"market_data_{symbol}")
    if not md:
        return None
    view = {f"market_data_{symbol}": {
        **md, "price_change_15m": 10.0 * float(md.get("price_change_15m", 0.0))}}
    return deterministic_provider(view, symbol)


def stack_cadences(tmp):
    """Part (a)'s cadences: the defaults but in depth — the prediction
    service's epochs 20 → 1, HPO trials 4 → 0, frames 1m/5m → 1m; the
    social poll 300 → 60 s (the virtual clock's tick) through
    `stack_social_provider`; the evolver's method pinned to the GA (the
    hybrid dispatch would take the rule-regime's LLM or RL path), its GA at
    `EvolutionParams()`'s 20 × 10; the pattern checkpoint under ``tmp``."""
    from ai_crypto_trader_tpu_torch.config import EvolutionParams

    return {"social": {"cache_ttl_s": 60.0, "provider": stack_social_provider},
            "patterns": {"checkpoint": f"{tmp}/models/pattern_cnn"},
            "nn": {"epochs": 1, "hpo_trials": 0, "intervals": ("1m",)},
            "evolution_cfg": EvolutionParams(method="ga")}


def stack_run(tape, device, tmp, tag):
    """STACK_TICKS ticks of `TradingSystem` with `build_full_stack` on
    ``device``, from STACK_CURSOR.  The evolver draws from a CPU
    `torch.Generator` seeded 0 on both devices (the same genomes), the
    pattern classifier is trained at start on the card and loaded from its
    checkpoint on the CPU.  On the card: the K2 launches recorded (the
    monitor's through `ops.indicators`, the regime cadence's too, the GA
    tables' through `ops.dynamic`), the evolver's K1 launches recorded, the
    `regime_features` calls and the host reads counted per tick, the
    executor's social factors kept; the counts set to 0 just before the run
    and read just after."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import dynamic, replay, tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.regime import detector as detector_mod
    from ai_crypto_trader_tpu_torch.shell import executor as executor_mod
    from ai_crypto_trader_tpu_torch.shell import launcher as launcher_mod
    from ai_crypto_trader_tpu_torch.shell.stack import build_full_stack
    from ai_crypto_trader_tpu_torch.social import service as social_mod
    from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry

    rig = TradeRig(tape, device, STACK_CURSOR, tmp, tag)
    sys_ = rig.system
    registry = ModelRegistry(path=f"{tmp}/{tag}.registry.json")
    sys_.registry = registry
    t0 = time.perf_counter()
    services = build_full_stack(sys_, registry=registry, grid_symbol=tape.symbols[0],
                                dca_symbol=tape.symbols[0], cadences=stack_cadences(tmp))
    build_s = time.perf_counter() - t0
    services[STACK_ROSTER.index("evolver")].evolver.draws = \
        lambda method, seed: torch.Generator().manual_seed(seed)
    signals = sys_.bus.subscribe("trading_signals")
    factors, real_factors = [], sys_.executor._social_factors

    def social_factors(symbol):
        out = real_factors(symbol)
        snap = sys_.bus.get(f"social_snapshot_{symbol}")
        factors.append({"symbol": symbol, "snapshot": snap is not None,
                        "rows": 0 if snap is None else int(snap.age_hours.shape[0]), **out})
        return out

    sys_.executor._social_factors = social_factors
    reads = {"engine": [], "risk": [], "executor": [], "social": []}
    seams = {"engine": (tick_engine, "host_read"), "risk": (launcher_mod, "host_read"),
             "executor": (executor_mod, "host_read"), "social": (social_mod, "host_read")}
    real = {k: getattr(m, n) for k, (m, n) in seams.items()}

    def counted_read(kind):
        def read(x):
            reads[kind].append(1)
            return real[kind](x)
        return read

    regime_calls, real_features = [], detector_mod.regime_features

    def features(*a, **k):
        regime_calls.append(1)
        return real_features(*a, **k)

    rec_ind, rec_dyn, dyn_entry = [], [], dynamic.fused_ewma_jobs

    def dyn_recording(jobs, device=None):
        rec_dyn.append([(x, a, st) for x, a, st in jobs])
        return dyn_entry(jobs, device=device)

    per_tick, decisions, clocks, fill_counts = [], [], [], []
    for k, (m, n) in seams.items():
        setattr(m, n, counted_read(k))
    detector_mod.regime_features = features
    dynamic.fused_ewma_jobs = dyn_recording
    fused_ewma.launches = replay.sweep_kernel.launches = 0
    try:
        with recording_ewma(rec_ind), recording_k1([]) as k1_calls:
            for _ in range(STACK_TICKS):
                before = {k: len(v) for k, v in reads.items()}
                # inside recording_k1 the kernel counts on the module's wrapper
                n = (fused_ewma.launches, len(rec_ind), len(rec_dyn), len(regime_calls),
                     replay.sweep_kernel.launches)
                rig.tick()
                per_tick.append({
                    "k2": fused_ewma.launches - n[0], "indicators": len(rec_ind) - n[1],
                    "ga_tables": len(rec_dyn) - n[2], "regime_features": len(regime_calls) - n[3],
                    "k1": replay.sweep_kernel.launches - n[4],
                    **{f"{k}_reads": len(v) - before[k] for k, v in reads.items()},
                    "tick_ms": rig.tick_ms[-1]})
                decisions.append([(e["data"]["symbol"], e["data"]["decision"])
                                  for e in (signals.get_nowait() for _ in range(signals.qsize()))])
                clocks.append(rig.clock[0])
                fill_counts.append(len(rig.ex.fills))
        totals = {"k2": fused_ewma.launches, "k1": replay.sweep_kernel.launches}
    finally:
        for k, (m, n) in seams.items():
            setattr(m, n, real[k])
        detector_mod.regime_features = real_features
        dynamic.fused_ewma_jobs = dyn_entry
    # the monitor's launches come first in a tick (the poll), before the
    # cadence services'
    monitor, regime, at = [], [], 0
    for p in per_tick:
        monitor += rec_ind[at:at + 3]
        regime += rec_ind[at + 3:at + p["indicators"]]
        at += p["indicators"]
    return rig, services, {"build_s": build_s, "per_tick": per_tick, "decisions": decisions,
                           "clocks": clocks, "fill_counts": fill_counts, "totals": totals,
                           "monitor_k2": monitor, "regime_k2": regime, "ga_k2": rec_dyn,
                           "k1_calls": k1_calls, "factors": factors}


def stack_state(rig, services):
    """What part (a) holds of one run: the roster and heartbeats, the
    social, news, grid and DCA state, the books, the status and the flight
    records (the status's alerts and the records' predictions aside: the
    prediction service's models differ between the devices' draws, and the
    scorecard's alerts follow them)."""
    import copy

    import numpy as np

    sys_ = rig.system
    bus, syms = sys_.bus, sys_.symbols
    snaps = {}
    for s in syms:
        snap = bus.get(f"social_snapshot_{s}")
        snaps[s] = None if snap is None else {f: np.asarray(getattr(snap, f).cpu())
                                              for f in snap._fields}
    grid, dca = services[STACK_ROSTER.index("grid")], services[STACK_ROSTER.index("dca")]
    status = sys_.status()
    return copy.deepcopy({
        "names": [s.name for s in services], "heartbeats": sys_.heartbeats.health(),
        "social_metrics": {s: bus.get(f"social_metrics_{s}") for s in syms},
        "social_history": {s: bus.get(f"social_history_{s}") for s in syms},
        "social_snapshot": snaps,
        "news": {s: (bus.get(f"news_analysis_{s}"), bus.get(f"news_recent_{s}")) for s in syms},
        "grid": (bus.get(f"grid_orders_{grid.symbol}"), bus.get(f"grid_profit_{grid.symbol}"),
                 grid.stats()),
        "dca": dca.dca.purchases,
        "regimes": {s: (bus.get(f"market_regime_{s}") or {}).get("regime") for s in syms},
        "strategy_params": bus.get("strategy_params"),
        "books": rig.books(),
        "status": {k: v for k, v in status.items() if k != "alerts"},
        # a record's `predictions` are the prediction service's, whose
        # models come from each device's own draws
        "records": [{k: v for k, v in r.items() if k != "predictions"}
                    for r in sys_.flightrec.query(limit=0)],
        "keys": sorted(bus.keys("*")),
        "pattern_status": sorted({a.get("model_status") for a in
                                  services[STACK_ROSTER.index("patterns")]
                                  .pattern_data.values()}),
        "recognizer_trained": services[STACK_ROSTER.index("patterns")].recognizer.trained})


def stack_close(got, ref, path, rtol=1e-5):
    """Equal, but floats within rtol (the trades' sizes, quantities and
    stops).  Returns the first difference's path, or None."""
    if isinstance(ref, float) and isinstance(got, float):
        return None if abs(got - ref) <= rtol * abs(ref) + 1e-9 else path
    if isinstance(ref, dict):
        if not isinstance(got, dict) or got.keys() != ref.keys():
            return path
        return next((d for k in ref if (d := stack_close(got[k], ref[k], f"{path}.{k}", rtol))),
                    None)
    if isinstance(ref, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(ref):
            return path
        return next((d for i, (g, r) in enumerate(zip(got, ref))
                     if (d := stack_close(g, r, f"{path}[{i}]", rtol))), None)
    return None if got == ref else path


def stack_anomaly_close(got, ref, rtol, flips, label):
    """Two metric payloads equal but for the anomaly score (within ``rtol``)
    and its flag (a flip only where the CPU's score lies within ``rtol`` of
    1, counted into ``flips``)."""
    g, r = dict(got), dict(ref)
    ga, ra = g.pop("anomaly"), r.pop("anomaly")
    if g != r:
        fail(f"stack: {label}: the social metrics differ: {g} against {r}")
    if abs(ga["score"] - ra["score"]) > rtol * abs(ra["score"]) + 1e-7:
        fail(f"stack: {label}: anomaly score {ga['score']} against the CPU's {ra['score']} "
             f"(rtol {rtol})")
    if ga["is_anomaly"] != ra["is_anomaly"]:
        if abs(ra["score"] - 1.0) > rtol:
            fail(f"stack: {label}: anomaly flag flipped at score {ra['score']}")
        flips.append({"case": label, "score": ra["score"]})


def score_rtol(model):
    """An anomaly score's rounding bound: 2·cond·2⁻²⁴ of the fitted
    covariance (its inverse carries the sums' rounding cond times over),
    at least 1e-4 (SOC_RTOL)."""
    import numpy as np

    cond = float(np.linalg.cond(np.asarray(model.prec.cpu(), np.float64)))
    return max(SOC_RTOL, 2.0 * cond * 2.0 ** -24)


def stack_system(tape, tmp, beside_cpu_run):
    """(a) The trading system with the roster, card against CPU;
    ``beside_cpu_run()`` starts work that runs beside the CPU run and
    returns what waits for it (phase stack's `cli trade --full-stack`)."""
    import numpy as np

    t0 = time.perf_counter()
    card_rig, card_svcs, card = stack_run(tape, "cuda", tmp, "stack_card")
    card_s = time.perf_counter() - t0
    a = stack_state(card_rig, card_svcs)
    card_rig.system.shutdown()
    t0 = time.perf_counter()
    beside = beside_cpu_run()
    cpu_rig, cpu_svcs, cpu = stack_run(tape, "cpu", tmp, "stack_cpu")
    cpu_s = time.perf_counter() - t0
    beside.result()                   # ended before any kernel is timed below
    b = stack_state(cpu_rig, cpu_svcs)
    cpu_rig.system.shutdown()

    if a["names"] != STACK_ROSTER or b["names"] != STACK_ROSTER:
        fail(f"stack: the roster is {a['names']} (card), {b['names']} (CPU)")
    hb = a["heartbeats"]
    missing = [n for n in STACK_ROSTER + ["monitor", "analyzer", "executor"] if not hb.get(n)]
    if missing or a["heartbeats"] != b["heartbeats"]:
        fail(f"stack: heartbeats not all healthy ({missing}) or not the CPU's")
    if not a["recognizer_trained"] or not b["recognizer_trained"] \
            or a["pattern_status"] != b["pattern_status"] or "untrained" in a["pattern_status"]:
        fail(f"stack: the pattern recognizer: trained {a['recognizer_trained']} / "
             f"{b['recognizer_trained']}, tags {a['pattern_status']} / {b['pattern_status']}")
    if a["keys"] != b["keys"]:
        fail(f"stack: bus keys differ: {sorted(set(a['keys']) ^ set(b['keys']))[:10]}")
    flips = []
    for s in a["social_metrics"]:
        stack_anomaly_close(a["social_metrics"][s], b["social_metrics"][s], SOC_RTOL, flips,
                            f"social_metrics_{s}")
        if a["social_history"][s] != b["social_history"][s]:
            fail(f"stack: social_history_{s} differs")
        for f, v in b["social_snapshot"][s].items():
            if not np.allclose(a["social_snapshot"][s][f], v, rtol=1e-6, atol=1e-6):
                fail(f"stack: social_snapshot_{s}.{f} differs from the CPU's")
    for k in ("news", "grid", "dca", "regimes"):
        if a[k] != b[k]:
            fail(f"stack: {k} differs from the CPU's")

    # the decisions, phase trade's rule: equal, or a first differing tick
    # whose records hold a label flip near a threshold
    label_flips = []
    diverge = next((t for t, (x, y) in enumerate(zip(card["decisions"], cpu["decisions"]))
                    if x != y), None)
    if diverge is None:
        for k in ("books", "status", "strategy_params"):
            d = stack_close(a[k], b[k], k)
            if d is not None:
                fail(f"stack: the decisions agree but {d} differs from the CPU's")
        trade_records(a["records"], b["records"], label_flips)
        compared_fills = len(a["books"]["fills"])
    else:
        t_d = card["clocks"][diverge - 1] if diverge else -1.0
        compared_fills = card["fill_counts"][diverge - 1] if diverge else 0
        d = stack_close(a["books"]["fills"][:compared_fills],
                        b["books"]["fills"][:compared_fills], "fills")
        if d is not None:
            fail(f"stack: the trades before tick {diverge} differ ({d})")
        at = [[r for r in x["records"] if t_d < r["t"] <= card["clocks"][diverge]]
              for x in (a, b)]
        trade_records(*at, label_flips)
        if not label_flips:
            fail(f"stack: the decisions differ from tick {diverge} with no label flip")

    entries = [f for f in a["books"]["fills"] if f["side"] == "BUY"]
    sized = [f for f in card["factors"] if f["snapshot"]]
    if not entries or not sized or any(f["rows"] < 4 for f in sized):
        fail(f"stack: {len(entries)} entries, {len(sized)} sized with a social snapshot "
             f"(rows {[f['rows'] for f in card['factors']]})")
    if diverge is None:
        d = stack_close(card["factors"], cpu["factors"], "factors")
        if d is not None:
            fail(f"stack: the executor's social factors differ from the CPU's: {d}")
    for t, p in enumerate(card["per_tick"]):
        if p["k2"] != p["indicators"] + p["ga_tables"] or \
                p["indicators"] != 3 + 4 * p["regime_features"] or p["engine_reads"] != 1:
            fail(f"stack: tick {t} made {p['k2']} K2 launches ({p['indicators']} through "
                 f"the indicators, {p['ga_tables']} GA tables, {p['regime_features']} "
                 f"regime_features calls) and {p['engine_reads']} tick-engine reads")
    evolver = card_svcs[STACK_ROSTER.index("evolver")]
    generator = card_svcs[STACK_ROSTER.index("generator")]
    cfg = evolver.evolver.cfg
    if [h["method"] for h in evolver.history] != ["ga"] or \
            card["totals"]["k1"] != cfg.ga.generations + 1 or len(card["ga_k2"]) != 5 or \
            len(card["k1_calls"]) != card["totals"]["k1"]:
        fail(f"stack: the evolver ran {evolver.history} with {card['totals']['k1']} K1 and "
             f"{len(card['ga_k2'])} GA-table K2 launches, not G + 1 = "
             f"{cfg.ga.generations + 1} and 5")
    k1 = held_k1(card["k1_calls"], "stack_evolver")
    monitor_k2 = live_k2(card["monitor_k2"], "trade_poll")
    ga_k2 = recorded_k2(card["ga_k2"], "stack_ga_tables")
    regime_k2 = recorded_k2(card["regime_k2"][:8], "stack_regime")
    ticks = [p["tick_ms"] for p in card["per_tick"]]
    return {
        "symbols": len(tape.symbols), "ticks": STACK_TICKS, "cursor": STACK_CURSOR,
        "roster": a["names"], "build_s": card["build_s"], "card_run_s": card_s,
        "cpu_run_s": cpu_s, "tick_ms": ticks,
        "tick_ms_p50": percentile(ticks, 50), "tick_ms_p99": percentile(ticks, 99),
        "tick_ms_p50_after_first": percentile(ticks[1:], 50),
        "per_tick": card["per_tick"],
        "k2": {"launches": card["totals"]["k2"],
               "monitor": len(card["monitor_k2"]), "regime": len(card["regime_k2"]),
               "ga_tables": len(card["ga_k2"]), "monitor_held": monitor_k2,
               "ga_tables_held": ga_k2, "regime_held_first_two_calls": regime_k2},
        "k1": {"launches": card["totals"]["k1"], **k1},
        "evolver": {"history": evolver.history, "population": cfg.ga.population_size,
                    "generations": cfg.ga.generations,
                    "strategy_params_equal_cpu": stack_close(a["strategy_params"],
                                                             b["strategy_params"], "p") is None},
        "generator_ran": bool(generator.runs),
        "regimes": sorted({r for r in a["regimes"].values() if r}),
        "card_vs_cpu": {"decisions_diverge_at_tick": diverge, "label_flips": len(label_flips),
                        "anomaly_flips": len(flips), "fills_compared": compared_fills},
        "entries": len(entries), "social_factors_at_entry": sized[:5],
        "grid": a["grid"][2], "dca_purchases": len(a["dca"]),
        "pattern_status": a["pattern_status"]}


def stack_social(tape):
    """(b) `SocialMonitorService` over the tape's 64 symbols, STACK_SOCIAL_POLLS
    polls (one a virtual minute; each symbol past the 50-row anomaly gate
    from poll 50), a lead-lag report every 10 and an accuracy report every
    15, on the card and on the CPU over twin buses fed the same market data
    and 1m klines: metrics and histories equal but the anomaly score (within
    `score_rtol`, flag flips only that close to 1, counted), snapshots equal,
    the reports' accuracies and weights equal, correlations within 1e-6;
    one read a poll (from poll 50), one a report; the executor's social
    factors over each device's last snapshot within 1e-6, one read each."""
    import asyncio

    import numpy as np

    from ai_crypto_trader_tpu_torch.shell import EventBus, FakeExchange
    from ai_crypto_trader_tpu_torch.shell import executor as executor_mod
    from ai_crypto_trader_tpu_torch.social import service as social_mod

    clock = [2_000_000.0]
    kw = dict(symbols=list(tape.symbols), cache_ttl_s=60.0, lead_lag_interval_s=600.0,
              accuracy_interval_s=900.0, now_fn=lambda: clock[0])
    devices = {"card": "cuda", "cpu": "cpu"}
    buses = {d: EventBus() for d in devices}
    svcs = {d: social_mod.SocialMonitorService(buses[d], device=devices[d], **kw)
            for d in devices}
    reads, real = [], social_mod.host_read

    def read(x):
        reads.append(1)
        return real(x)

    records = {d: [] for d in buses}
    poll_ms, start = [], STACK_CURSOR - STACK_SOCIAL_POLLS
    social_mod.host_read = read
    try:
        for t in range(STACK_SOCIAL_POLLS):
            clock[0] += 60.0
            cursor = start + t
            feed = {}
            for i, s in enumerate(tape.symbols):
                close = tape.cols[i][3]
                chg = float((close[cursor] / close[cursor - 15] - 1.0) * 100.0)
                feed[f"market_data_{s}"] = {"price_change_15m": 10.0 * chg,
                                            "current_price": float(close[cursor])}
                feed[f"historical_data_{s}_1m"] = tape.klines(i, "1m", cursor, T_TICK)
            for d, svc in svcs.items():
                for k, v in feed.items():
                    buses[d].set(k, v)
                n = len(reads)
                t0 = time.perf_counter()
                out = asyncio.run(svc.run_once())
                ms = 1e3 * (time.perf_counter() - t0)
                if d == "card":
                    poll_ms.append(ms)
                b = buses[d]
                records[d].append({
                    "out": out, "reads": len(reads) - n, "ms": ms,
                    "metrics": {s: b.get(f"social_metrics_{s}") for s in tape.symbols},
                    "history": {s: b.get(f"social_history_{s}") for s in tape.symbols},
                    "snapshot": {s: [np.asarray(x.cpu()) for x in b.get(f"social_snapshot_{s}")]
                                 for s in tape.symbols},
                    "rtol": {s: score_rtol(svc._anomaly_models[s])
                             for s in svc._anomaly_models},
                    "lead_lag": b.get("social_lead_lag_report"),
                    "accuracy": b.get("social_accuracy_report"),
                    "weights": dict(svc.source_weights)})
    finally:
        social_mod.host_read = real
    flips, scored, reports = [], 0, {"lead_lag": 0, "accuracy": 0}
    for t, (g, r) in enumerate(zip(records["card"], records["cpu"])):
        want = int(t + 1 >= 50) + g["out"]["lead_lag"] + g["out"]["accuracy"]
        if g["out"] != r["out"] or g["reads"] != want:
            fail(f"stack: social poll {t}: {g['out']} ({g['reads']} reads) against the CPU's "
                 f"{r['out']}, {want} reads expected")
        reports["lead_lag"] += g["out"]["lead_lag"]
        reports["accuracy"] += g["out"]["accuracy"]
        for s in tape.symbols:
            rtol = max(g["rtol"].get(s, SOC_RTOL), r["rtol"].get(s, SOC_RTOL))
            stack_anomaly_close(g["metrics"][s], r["metrics"][s], rtol, flips,
                                f"poll {t} {s}")
            scored += r["metrics"][s]["anomaly"]["score"] != 0.0
            if g["history"][s] != r["history"][s] or any(
                    not np.array_equal(x, y) for x, y in zip(g["snapshot"][s], r["snapshot"][s])):
                fail(f"stack: social poll {t} {s}: history or snapshot differs")
        if g["accuracy"] != r["accuracy"] or g["weights"] != r["weights"]:
            fail(f"stack: social poll {t}: the accuracy report or weights differ")
        gl, rl = g["lead_lag"], r["lead_lag"]
        if (gl is None) != (rl is None) or (rl is not None and gl["symbols"].keys() !=
                                            rl["symbols"].keys()):
            fail(f"stack: social poll {t}: the lead-lag reports differ")
        for s, x in (rl or {}).get("symbols", {}).items():
            y = gl["symbols"][s]
            if y["optimal_lag"] != x["optimal_lag"] or \
                    abs(y["correlation"] - x["correlation"]) > 1e-6:
                fail(f"stack: social poll {t} {s}: lead-lag {y} against {x}")
    if scored < len(tape.symbols) * (STACK_SOCIAL_POLLS - 50) or \
            reports["lead_lag"] < 3 or reports["accuracy"] < 3:
        fail(f"stack: social: {scored} anomaly scores, {reports} reports")
    # the last snapshots through each device's executor
    ex_reads, ex_real = [], executor_mod.host_read
    executor_mod.host_read = lambda x: ex_reads.append(1) or ex_real(x)
    try:
        worst = 0.0
        for s in tape.symbols:
            f = {d: executor_mod.TradeExecutor(buses[d], FakeExchange({}), device=devices[d])
                 ._social_factors(s) for d in devices}
            worst = max(worst, max(abs(f["card"][k] - f["cpu"][k]) for k in f["cpu"]))
    finally:
        executor_mod.host_read = ex_real
    if worst > 1e-6 or len(ex_reads) != 2 * len(tape.symbols):
        fail(f"stack: the executor's social factors differ by {worst} ({len(ex_reads)} reads)")
    last = records["card"][-1]
    return {"symbols": len(tape.symbols), "polls": STACK_SOCIAL_POLLS,
            "poll_ms_p50": percentile(poll_ms, 50), "poll_ms_p99": percentile(poll_ms, 99),
            "poll_ms_p50_scored": percentile(poll_ms[50:], 50),
            "report_polls_ms": [r["ms"] for r in records["card"]
                                if r["out"]["lead_lag"] or r["out"]["accuracy"]][:6],
            "reads_per_poll": [r["reads"] for r in records["card"]][-3:],
            "reports": reports, "anomaly_scores": scored, "anomaly_flips": len(flips),
            "score_rtol_max": max(max(r["rtol"].values(), default=SOC_RTOL)
                                  for r in records["card"]),
            "anomalies_flagged": sum(m["anomaly"]["is_anomaly"]
                                     for m in last["metrics"].values()),
            "executor_factor_max_diff": worst,
            "average_direction_accuracy": last["accuracy"]["average_direction_accuracy"]}


def stack_market(n, seed, planted):
    """Tickers over n assets (every pair quoted, log-normal values with a
    spread) with ``planted`` (a, b, c, edge) cycles: selling b for c pays
    ``edge`` on top of the fair cross rate."""
    import numpy as np

    rng = np.random.default_rng(seed)
    assets = ["USDC"] + [f"A{i:02d}" for i in range(n - 1)]
    value = np.exp(rng.normal(0.0, 1.5, n))
    value[0] = 1.0
    tickers = {}
    for i in range(1, n):
        for j in range(i):
            mid = value[i] / value[j]
            half = mid * rng.uniform(1e-4, 2e-3)
            tickers[assets[i] + assets[j]] = {"bid": mid - half, "ask": mid + half}
    for _, b, c, edge in planted:
        i, j = max(b, c), min(b, c)
        t = tickers[assets[i] + assets[j]]
        scale = (1.0 + edge) if i == b else 1.0 / (1.0 + edge)
        tickers[assets[i] + assets[j]] = {"bid": t["bid"] * scale, "ask": t["ask"] * scale}
    return tickers, assets


def stack_arbitrage():
    """(c) `find_triangle_arbitrage` over 64 assets (262,144 cycles, three
    planted): the cycle tensor on the card bit for bit against the CPU's,
    the lists equal, one read a call; times."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.strategy import arbitrage

    planted = [(0, 7, 41, 0.012), (3, 19, 60, 0.02), (5, 22, 33, 0.006)]
    tickers, assets = stack_market(STACK_ARB_ASSETS, 64, planted)
    R = arbitrage.build_rate_matrix(tickers, assets)
    card = arbitrage._cycle_profits(R, 0.001, device="cuda")
    cpu = arbitrage._cycle_profits(R, 0.001, device="cpu")
    if not np.array_equal(card.cpu().numpy().view(np.uint32), cpu.numpy().view(np.uint32)):
        fail("stack: the cycle tensor on the card differs from the CPU's")
    reads, real = [], arbitrage.host_read
    arbitrage.host_read = lambda x: reads.append(1) or real(x)
    try:
        got = arbitrage.find_triangle_arbitrage(tickers, assets, device="cuda")
    finally:
        arbitrage.host_read = real
    want = arbitrage.find_triangle_arbitrage(tickers, assets, device="cpu")
    if got != want or len(reads) != 1 or not got:
        fail(f"stack: arbitrage lists differ ({len(got)} / {len(want)}) or {len(reads)} reads")
    best = {frozenset(c["cycle"][:3]) for c in got}
    if not any({assets[b], assets[c]} <= set(x) for x in best for _, b, c, _ in planted):
        fail("stack: no planted cycle among the best")
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arbitrage.find_triangle_arbitrage(tickers, assets, device="cuda")
        walls.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    arbitrage.find_triangle_arbitrage(tickers, assets, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    return {"assets": STACK_ARB_ASSETS, "cycles": STACK_ARB_ASSETS ** 3, "found": len(got),
            "best": got[0], "bitwise_equal_cpu": True, "reads": len(reads),
            "cycle_tensor_ms": cuda_ms(lambda: arbitrage._cycle_profits(R, 0.001,
                                                                          device="cuda"), 20),
            "call_ms_p50": percentile(walls, 50), "cpu_call_ms": cpu_ms}


def stack_provider_k1():
    """(d) 15 days of `SocialDaily` joined onto 21,600 1m candles by
    `SocialDataProvider.social_inputs` on the card (the CPU's arrays bit for
    bit), fed to `evolvable_backtest(social=...)` over STACK_SOCIAL_B
    genomes: its K1 launch bit for bit against the plain loop (`held_k1`),
    its K2 launches (`ops.dynamic`) held against the plain EWMA, and the
    card's stats against the CPU's run of the same call — equal, or (where
    a K2 rounding moved a signal) the card's own inputs replayed on the CPU
    equal to the card's stats."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.backtest import BacktestStats, sample_params
    from ai_crypto_trader_tpu_torch.backtest import engine
    from ai_crypto_trader_tpu_torch.backtest.evolvable import (
        evolvable_backtest, evolvable_inputs)
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.data.ingest import SocialDaily
    from ai_crypto_trader_tpu_torch.ops import dynamic
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.social import SocialDataProvider

    rng = np.random.default_rng(30)
    day = 86_400
    start = 1_700_000_000 - 1_700_000_000 % day
    daily = SocialDaily(start + np.arange(STACK_SOCIAL_DAYS, dtype=np.int64) * day, {
        "social_volume": rng.integers(100, 60_000, STACK_SOCIAL_DAYS).astype(np.float32),
        "social_engagement": rng.integers(10, 25_000, STACK_SOCIAL_DAYS).astype(np.float32),
        "social_sentiment": rng.uniform(0.3, 0.9, STACK_SOCIAL_DAYS).astype(np.float32)})
    ts = start + np.arange(STACK_SOCIAL_T, dtype=np.int64) * 60
    prov = SocialDataProvider(daily)
    t0 = time.perf_counter()
    soc = prov.social_inputs(ts, "1m", device="cuda")
    torch.cuda.synchronize()
    join_ms = 1e3 * (time.perf_counter() - t0)
    soc_cpu = prov.social_inputs(ts, "1m", device="cpu")
    for f in soc._fields:
        if not torch.equal(getattr(soc, f).cpu(), getattr(soc_cpu, f)):
            fail(f"stack: social_inputs.{f} on the card differs from the CPU's")
    d = {k: v for k, v in generate_ohlcv(n=STACK_SOCIAL_T, seed=31).items() if k != "regime"}
    params = sample_params(torch.Generator().manual_seed(5), STACK_SOCIAL_B, device="cpu")
    p_card = params._replace(**{f: getattr(params, f).cuda() for f in params._fields})
    rec_dyn, dyn_entry = [], dynamic.fused_ewma_jobs

    def dyn_recording(jobs, device=None):
        rec_dyn.append([(x, a, st) for x, a, st in jobs])
        return dyn_entry(jobs, device=device)

    sweep_kernel.launches = fused_ewma.launches = 0
    dynamic.fused_ewma_jobs = dyn_recording
    try:
        with recording_ewma([]) as rec_ind, recording_k1([]) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = evolvable_backtest(d, p_card, social=soc, device="cuda")
            torch.cuda.synchronize()
            card_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        dynamic.fused_ewma_jobs = dyn_entry
    k1_launches, k2_launches = sweep_kernel.launches, fused_ewma.launches
    if k1_launches != 1 or len(calls) != 1 or k2_launches != len(rec_dyn) + len(rec_ind) \
            or not k2_launches:
        fail(f"stack: evolvable_backtest(social=...) made {k1_launches} K1 and {k2_launches} "
             f"K2 launches")
    k1 = held_k1(calls, "stack_social_backtest")
    k2 = recorded_k2(rec_dyn + rec_ind, "stack_social_backtest")
    t0 = time.perf_counter()
    cpu = evolvable_backtest(d, params, social=soc_cpu, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)) for f in BacktestStats._fields)
    replayed = None
    if not same:
        inputs = evolvable_inputs(d, p_card, soc, device="cuda")
        host = inputs._replace(**{f: getattr(inputs, f).cpu() for f in inputs._fields})
        again = engine.run_backtest(host, params, initial_balance=10_000.0,
                                    min_signal_strength=50.0, use_param_sl_tp=True, warmup=10,
                                    device="cpu")
        replayed = all(torch.equal(getattr(card, f).cpu(), getattr(again, f))
                       for f in BacktestStats._fields)
        if not replayed:
            fail("stack: evolvable_backtest(social=...) on the card differs from the CPU's "
                 "replay of the card's own inputs")
    plain = evolvable_backtest(d, p_card, device="cuda")
    if torch.equal(plain.total_trades, card.total_trades) and \
            torch.equal(plain.final_balance, card.final_balance):
        fail("stack: the social inputs changed no genome's trades")
    return {"candles": STACK_SOCIAL_T, "days": STACK_SOCIAL_DAYS, "genomes": STACK_SOCIAL_B,
            "join_ms": join_ms, "backtest_ms": card_ms, "cpu_backtest_s": cpu_s,
            "k1_launches": k1_launches, "k2_launches": k2_launches, "k1": k1,
            "k2": {k: v for k, v in k2.items() if k != "launch_shapes"},
            "stats_equal_cpu": same, "card_inputs_replayed_on_cpu_equal": replayed,
            "trades": card.total_trades.tolist()}


def stack_cli(tmp):
    """(e) `cli trade --paper --full-stack --ticks 10 --registry <tmp>` as a
    subprocess on the card in a temporary cwd: exit 0, the roster line, the
    status JSON's channels; its seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cwd = os.path.join(tmp, "cli_full_stack")
    os.makedirs(cwd)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", "trade",
                           "--paper", "--full-stack", "--ticks", str(STACK_CLI_TICKS),
                           "--registry", os.path.join(cwd, "registry.json")],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"stack: cli trade --full-stack exited {proc.returncode}: {proc.stderr[-800:]}")
    line = "full stack: " + ", ".join(STACK_ROSTER)
    if line not in proc.stdout.splitlines():
        fail(f"stack: cli trade --full-stack printed no roster line: {proc.stdout[:400]}")
    out = proc.stdout
    status = json.loads(out[out.rindex("\n{\n") + 1:])
    if status["channels"].get("market_updates") != STACK_CLI_TICKS or \
            not os.path.isdir(os.path.join(cwd, "models", "pattern_cnn")):
        fail(f"stack: cli trade --full-stack's status {status['channels']}")
    return {"ticks": STACK_CLI_TICKS, "exit_code": proc.returncode, "subprocess_s": wall,
            "roster_line": line, "channels": status["channels"],
            "closed_trades": status["closed_trades"]}


def phase_stack(info):
    """The full service roster on the card: (a) `TradingSystem` with
    `build_full_stack` over phase trade's tape (64 symbols × 4 frames ×
    256) for STACK_TICKS ticks, card against CPU; (b) the social monitor
    over the 64 symbols; (c) triangle arbitrage over 64 assets; (d) the
    social provider's inputs into K1; (e) `cli trade --full-stack`, run
    beside (a)'s CPU run.
    Returns the K2 and K1 blocks for the kernels line."""
    import tempfile

    t_phase = time.perf_counter()
    tape = TickTape(S_TICK, T_TICK)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli = {}
        system = stack_system(tape, tmp, lambda: cli.setdefault("run", BesideCall(stack_cli, tmp)))
        times = {"system_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        social = stack_social(tape)
        times["social_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arbitrage = stack_arbitrage()
        times["arbitrage_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        provider = stack_provider_k1()
        times["provider_s"] = time.perf_counter() - t0
        cli_report = cli["run"].result()     # run beside the CPU run of (a)
    report = {"phase": "stack", "card": info["nvidia_smi"], "system": system,
              "social": social, "arbitrage": arbitrage, "provider": provider, "cli": cli_report,
              "part_s": times, "phase_s": time.perf_counter() - t_phase}
    emit(report)
    mk, gk, pk = (system["k2"]["monitor_held"], system["k2"]["ga_tables_held"],
                  provider["k2"])
    k2 = {"launches": system["k2"]["launches"] + provider["k2_launches"],
          "system_launches": system["k2"]["launches"],
          "monitor_launches": system["k2"]["monitor"], "regime_launches": system["k2"]["regime"],
          "ga_tables_launches": system["k2"]["ga_tables"],
          "social_backtest_launches": provider["k2_launches"],
          "ms": mk["ms"], "ms_per_launch": mk["ms_per_launch"], "plain_ms": mk["plain_ms"],
          "barrier_only_ms": mk["barrier_only_ms"], "bound_ms": mk["bound_ms"],
          "bound_by": mk["bound_by"], "library_ms": None,
          "max_abs_err": max(mk["max_abs_err"], gk["max_abs_err"], pk["max_abs_err"],
                             system["k2"]["regime_held_first_two_calls"]["max_abs_err"]),
          "max_rel_err": max(mk["max_rel_err"], gk["max_rel_err"], pk["max_rel_err"]),
          "launches_held": mk["launches_held"] + len(gk["ms_per_launch"])
          + len(pk["ms_per_launch"])
          + len(system["k2"]["regime_held_first_two_calls"]["ms_per_launch"]),
          "ga_tables_ms": gk["ms"], "ga_tables_bound_ms": gk["bound_ms"],
          "ga_tables_plain_ms": gk["plain_ms"],
          "tick_ms_p50": system["tick_ms_p50"],
          "shape": f"a tick's 3 monitor launches at S={S_TICK} x F={len(TICK_FRAMES)} x "
                   f"T={T_TICK} (ms/plain/bound); the evolver's GA tables (5), the regime "
                   f"cadence's regime_features (4 a call) and evolvable_backtest(social=...) "
                   f"over {STACK_SOCIAL_T} candles counted and held"}
    sk, pk1 = system["k1"], provider["k1"]
    k1 = {"launches": sk["launches"] + provider["k1_launches"],
          "evolver_launches": sk["launches"], "social_backtest_launches": provider["k1_launches"],
          "ms": sk["ms"] + pk1["ms"], "plain_ms": sk["plain_ms"] + pk1["plain_ms"],
          "bound_ms": sk["bound_ms"] + pk1["bound_ms"], "bound_by": sk["bound_by"],
          "library_ms": None, "max_abs_err": max(sk["max_abs_err"], pk1["max_abs_err"]),
          "evolver_ms": sk["ms"], "evolver_shapes": sk["shapes"][:2],
          "social_backtest_ms": pk1["ms"], "social_backtest_shape": pk1["shapes"],
          "shape": f"the evolver's GA (G + 1 launches, B=20 x T={T_TICK - 1}) and "
                   f"evolvable_backtest(social=...) B={STACK_SOCIAL_B} x T={STACK_SOCIAL_T}"}
    return k2, k1


# --- phase stream: the streamed market path and the load harness ----------

STREAM_S, STREAM_T = 16, 256       # bench_stream's symbols and window (bench.py:1442-1444)
STREAM_TAPE_TICKS = 40             # its ticks a pass, which size its tape (bench.py:1443)
STREAM_TICKS = 20                  # timed ticks a pass here (cut from 40)
STREAM_CLOCK0 = 1_700_000_000.0    # the virtual clock's start (seconds)
STREAM_TRADE_TICKS = 8             # (b): ticks of the streamed trading system
STREAM_SILENT_TICK = 4             # (b): the tick whose frames a ChaosFrameSource silences
LOAD_TENANTS, LOAD_SYMBOLS = 256, 4    # bench_capacity (bench.py:1733-1737)
LOAD_TICKS = 5                     # its ticks a load point (cut from 10)
LOAD_OBJECT_CAP = 8                # its object-lane ramp's cap (bench.py:1733)
LOAD_SLO_MS = 250.0                # its p99 SLO (bench.py:1737)


class StreamTape:
    """bench_stream's tape (bench.py:1446-1466): `generate_ohlcv(n = T·15 +
    2·ticks + 64, seed=17)`, symbol i's open/high/low/close scaled by 1 +
    0.02·i (its volume not), one candle a minute, the venue advanced to
    n − 2·ticks − 8 so that both timed passes of a rig stay on the tape."""

    def __init__(self, S=STREAM_S, T=STREAM_T, ticks=STREAM_TAPE_TICKS, seed=17):
        import numpy as np

        from ai_crypto_trader_tpu_torch.data import generate_ohlcv
        from ai_crypto_trader_tpu_torch.data.ingest import OHLCV

        self.n = T * 15 + 2 * ticks + 64
        d = generate_ohlcv(n=self.n, seed=seed)
        ts = np.arange(self.n, dtype=np.int64) * 60_000
        self.series = {f"W{i:03d}USDC": OHLCV(
            timestamp=ts, open=d["open"] * (1 + 0.02 * i), high=d["high"] * (1 + 0.02 * i),
            low=d["low"] * (1 + 0.02 * i), close=d["close"] * (1 + 0.02 * i),
            volume=d["volume"], symbol=f"W{i:03d}USDC") for i in range(S)}
        self.symbols = sorted(self.series)
        self.start = self.n - 2 * ticks - 8

    def exchange(self):
        from ai_crypto_trader_tpu_torch.shell import FakeExchange

        ex = FakeExchange(self.series)
        ex.advance(steps=self.start)
        return ex


class StreamRig:
    """bench_stream's path on one device: the tape's venue behind
    `CountingKlines`, a `MarketMonitor` (frames 1m/3m/5m/15m, the 256-candle
    window) fed by `StreamSupervisor(MarketStream(...))`, on a virtual clock
    that moves 60 s a tick (so two runs stamp the same times).  ``twin``
    adds a second monitor that polls the same venue by REST after each
    drain: the polled path on the same venue state."""

    def __init__(self, tape, device, pipelined=False, twin=False):
        from ai_crypto_trader_tpu_torch.shell import EventBus, MarketMonitor
        from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor
        from ai_crypto_trader_tpu_torch.testing.chaos import CountingKlines

        self.clock = [STREAM_CLOCK0]
        now = lambda: self.clock[0]            # noqa: E731
        self.symbols = tape.symbols
        self.ex = tape.exchange()
        self.counting = CountingKlines(self.ex)
        self.bus = EventBus(now_fn=now)
        self.q = self.bus.subscribe("market_updates")
        self.monitor = MarketMonitor(self.bus, self.counting, symbols=self.symbols,
                                     intervals=TICK_FRAMES, kline_limit=STREAM_T, now_fn=now,
                                     pipelined=pipelined, device=device)
        self.sup = StreamSupervisor(MarketStream(self.monitor, now_fn=now), now_fn=now)
        self.twin = self.twin_q = None
        if twin:
            tbus = EventBus(now_fn=now)
            self.twin_q = tbus.subscribe("market_updates")
            self.twin = MarketMonitor(tbus, self.ex, symbols=self.symbols,
                                      intervals=TICK_FRAMES, kline_limit=STREAM_T, now_fn=now,
                                      device=device)

    def frames(self):
        from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for

        return kline_frames_for(self.ex, self.symbols, TICK_FRAMES,
                                event_ms=int(self.clock[0] * 1000))

    def advance(self):
        self.ex.advance()
        self.clock[0] += 60.0

    @staticmethod
    def drained(q):
        return {e["data"]["symbol"]: e["data"] for e in (q.get_nowait() for _ in range(q.qsize()))}


async def stream_pass(rig, ticks, launches=None, reads=None, seed=False, scope=None):
    """``ticks`` drains of ``rig`` (advance, build the tick's frames, then
    the timed region: offer them to the supervisor and step it), each with
    its K2 launches counted from 0 and recorded, its tick-engine reads and
    its REST kline calls counted, its payloads kept (and the twin's, polled
    after the timed region).  ``seed``: first the tape's start, stepped
    until no symbol is pending (the stream's REST backfill seeds at most
    `backfill_batch` symbols a drain; untimed).  ``scope``: a TickPathScope
    active around the drains."""
    from ai_crypto_trader_tpu_torch.obs import tickpath
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma

    async def drain(batch, is_seed):
        rest0, n_rec, n_reads = rig.counting.kline_calls, len(launches), len(reads)
        fused_ewma.launches = 0
        t0 = time.perf_counter()
        for f in batch:
            rig.sup.offer(f)
        n = await rig.sup.step()
        ms = 1e3 * (time.perf_counter() - t0)
        rec = {"published": n, "ms": ms, "k2": fused_ewma.launches,
               "recorded": len(launches) - n_rec, "reads": len(reads) - n_reads,
               "rest": rig.counting.kline_calls - rest0, "seed": is_seed,
               "payloads": rig.drained(rig.q)}
        if rig.twin is not None:
            n_keep = len(launches)
            await rig.twin.poll(force=True)
            del launches[n_keep:]                # the twin's launches are not the stream's
            rec["polled"] = rig.drained(rig.twin_q)
        out.append(rec)

    out = []
    ctx = tickpath.use(scope) if scope is not None else contextlib.nullcontext()
    with ctx:
        if seed:
            await drain(rig.frames(), True)
            while rig.sup.stream._pending:
                await drain([], True)
        for _ in range(ticks):
            rig.advance()
            await drain(rig.frames(), False)
        if rig.monitor.pipelined:
            fused_ewma.launches = 0
            n_reads = len(reads)
            await rig.monitor.flush_pipeline()
            payloads = rig.drained(rig.q)
            out.append({"published": len(payloads), "k2": fused_ewma.launches,
                        "reads": len(reads) - n_reads, "flush": True, "seed": False,
                        "payloads": payloads})
    return out


def stream_latency(tape):
    """(a) bench_stream's three passes on the card, and the serial pass on
    the CPU: zero REST kline calls in every timed window, 3 K2 launches and
    one tick-engine read a drain, every launch recorded; the serial pass's
    payloads bit for bit against a monitor polling the same venue by REST,
    and against the CPU run within `live_tolerance`; the pipelined pass's
    equal to the serial pass's one drain later."""
    import asyncio

    from ai_crypto_trader_tpu_torch.obs.tickpath import TickPathScope
    from ai_crypto_trader_tpu_torch.ops import tick_engine

    launches, reads = [], []
    real_read = tick_engine.host_read

    def counted_read(readback):
        reads.append(1)
        return real_read(readback)

    serial = StreamRig(tape, "cuda", twin=True)
    pipe = StreamRig(tape, "cuda", pipelined=True)
    scope = TickPathScope()
    tick_engine.host_read = counted_read
    try:
        with recording_ewma(launches):
            async def card():
                off = await stream_pass(serial, STREAM_TICKS, launches, reads, seed=True)
                serial.twin = None               # the tickpath pass: the stream alone
                on = await stream_pass(serial, STREAM_TICKS, launches, reads, scope=scope)
                piped = await stream_pass(pipe, STREAM_TICKS, launches, reads, seed=True)
                return off, on, piped

            off, on, piped = asyncio.run(card())
    finally:
        tick_engine.host_read = real_read
    drains = off + on + piped[:-1]
    for name, rs in (("serial", off), ("tickpath", on), ("pipelined", piped[:-1])):
        for i, r in enumerate(rs):
            fill = name == "pipelined" and i == 0      # the pipeline fills: no drain yet
            got = (r["k2"], r["recorded"], r["reads"])
            if got != (3, 3, 0 if fill else 1):
                fail(f"stream: {name} drain {i} made (K2 launches, recorded, tick-engine "
                     f"reads) {got}, not (3, 3, {0 if fill else 1})")
            # a pipelined drain publishes the drain before it (held below)
            want_pub = r["published"] if name == "pipelined" else STREAM_S
            if not r["seed"] and (r["rest"] or r["published"] != want_pub):
                fail(f"stream: {name} timed drain {i} made {r['rest']} REST kline calls and "
                     f"published {r['published']} updates")
    flush = piped[-1]
    if (flush["k2"], flush["reads"], flush["published"]) != (0, 1, STREAM_S):
        fail(f"stream: the pipeline's flush made (K2, reads, published) "
             f"{(flush['k2'], flush['reads'], flush['published'])}")
    seeds = [r for r in off if r["seed"]]
    if sum(r["published"] for r in seeds) != STREAM_S or \
            sum(r["rest"] for r in seeds) != STREAM_S * len(TICK_FRAMES):
        fail(f"stream: the seed drains published {[r['published'] for r in seeds]} updates "
             f"with {[r['rest'] for r in seeds]} REST calls")
    for t, r in enumerate(off):
        polled = {s: r["polled"][s] for s in r["payloads"]}
        if r["payloads"] != polled:
            where = next(((s, k) for s in polled for k in polled[s]
                          if r["payloads"][s].get(k) != polled[s][k]), None)
            fail(f"stream: drain {t}'s streamed payloads differ from the polled path's on the "
                 f"same venue state (first at symbol, key {where})")
    pipe_pay = [r["payloads"] for r in piped]
    if pipe_pay[0] or pipe_pay[1:] != [r["payloads"] for r in off]:
        fail("stream: the pipelined pass's payloads are not the serial pass's one drain later")

    # --- the same serial pass on the CPU -----------------------------------
    cpu = StreamRig(tape, "cpu")
    t0 = time.perf_counter()
    cpu_run = asyncio.run(stream_pass(cpu, STREAM_TICKS, [], [], seed=True))
    cpu_s = time.perf_counter() - t0
    flips = []
    for t, (a, b) in enumerate(zip(off, cpu_run)):
        if set(a["payloads"]) != set(b["payloads"]):
            fail(f"stream: drain {t} published other symbols on the card than on the CPU")
        for s, ref in b["payloads"].items():
            compare_updates(a["payloads"][s], ref, f"stream drain {t} {s}", flips)
        if b["rest"] != a["rest"]:
            fail(f"stream: drain {t} made {a['rest']} REST calls on the card, {b['rest']} on "
                 "the CPU")
    n_labels = len(off) * STREAM_S * len(TICK_FRAMES)
    if len(flips) > n_labels // 1000:
        fail(f"stream: {len(flips)} label flips card vs CPU, over one in 1,000 of {n_labels}")

    # --- one more drain under torch.profiler ------------------------------
    def one_drain():
        serial.advance()
        batch = serial.frames()

        async def go():
            for f in batch:
                serial.sup.offer(f)
            await serial.sup.step()

        asyncio.run(go())

    try:
        profile = device_profile(one_drain)
    except Exception as ex:  # noqa: BLE001 — a profiler that cannot trace is reported, not fatal
        profile = {"measured": False, "reason": repr(ex)[:300]}

    def lat(rs):
        ms = [r["ms"] for r in rs if not r["seed"]]
        return {"p50": percentile(ms, 50), "p99": percentile(ms, 99), "ticks": len(ms)}

    status = scope.status()
    waterfall = {k: {"p50": v["p50_ms"], "p99": v["p99_ms"], "count": v["count"]}
                 for k, v in status["phases"].items() if v["count"]}
    for phase in ("parse", "scatter_build", "dispatch", "device_compute", "host_read",
                  "publish"):
        if phase not in waterfall:
            fail(f"stream: the tickpath pass's waterfall has no {phase} phase: "
                 f"{sorted(waterfall)}")
    st = serial.sup.stream
    return {"symbols": STREAM_S, "frames": list(TICK_FRAMES), "window": STREAM_T,
            "ticks_per_pass": STREAM_TICKS,
            "event_to_publish_ms": {"serial": lat(off), "tickpath": lat(on),
                                    "pipelined": lat(piped[:-1])},
            "seed_drains": len(seeds),
            "rest_kline_calls": {"seed": sum(r["rest"] for r in seeds), "timed": 0},
            "k2_launches_per_drain": 3, "host_reads_per_drain": 1,
            "waterfall_ms": waterfall, "bottleneck": status["bottleneck"],
            "overlap_headroom_ms": status["overlap_headroom_ms"],
            "profile_one_drain": profile,
            "streamed_equal_polled_bit_for_bit_drains": len(off),
            "pipelined_equal_serial_shifted": True,
            "card_vs_cpu": {"label_flips": len(flips), "labels": n_labels, "flips": flips[:5],
                            "cpu_pass_s": cpu_s},
            "stream_counters": {k: getattr(st, k) for k in (
                "frames_in", "streamed_rows", "served_current", "backfills", "gaps",
                "dup_frames", "ooo_frames", "micro_batches")},
            "drains": len(drains)}, launches


class StreamTradeRig:
    """`TradingSystem` on one device over phase live's tape (64 symbols ×
    1m/3m/5m/15m × 256) on the paper exchange without the resilient
    adapter (its rate limiter would sleep the virtual clock forward by the
    REST calls a run makes, and the streamed and polled runs make
    different numbers), bench_recovery's trading parameters, the tick-path
    scope off (its event stamps would differ between the two market
    paths).  ``streamed``: a `StreamSupervisor` attached (backfill_batch =
    the universe, so one drain repairs every lane after a gap), its frames
    built from the venue and passed through a `ChaosFrameSource` that
    silences tick STREAM_SILENT_TICK.  The venue's `get_klines` is counted
    (the frames' own reads are not)."""

    def __init__(self, tape, device, cursor, streamed):
        import itertools

        from ai_crypto_trader_tpu_torch.config import FrameworkConfig, TradingParams
        from ai_crypto_trader_tpu_torch.data.ingest import OHLCV
        from ai_crypto_trader_tpu_torch.shell import FakeExchange, LLMTrader
        from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
        from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor
        from ai_crypto_trader_tpu_torch.testing.chaos import ChaosFrameSource, FaultSchedule
        from ai_crypto_trader_tpu_torch.utils.health import EventLoopLagProbe

        self.clock = [STREAM_CLOCK0]
        now = lambda: self.clock[0]            # noqa: E731
        series = {s: OHLCV(timestamp=tape.ts, open=c[0], high=c[1], low=c[2], close=c[3],
                           volume=c[4], symbol=s) for s, c in zip(tape.symbols, tape.cols)}
        self.ex = FakeExchange(series)
        self.ex.advance(steps=cursor)
        real = self.ex.get_klines
        self.rest = [0]

        def counted(*a, **kw):
            self.rest[0] += 1
            return real(*a, **kw)

        self.ex.get_klines = counted
        self.venue = type("Venue", (), {"get_klines": staticmethod(real)})()
        self.symbols = list(tape.symbols)
        self.system = TradingSystem(self.ex, self.symbols,
                                    config=FrameworkConfig(trading=TradingParams(**LIVE_TRADING)),
                                    now_fn=now, device=device, tick_budget_s=1e9,
                                    enable_tickpath=False)
        ids = itertools.count(1)
        self.system.flightrec._id_fn = lambda: f"d{next(ids):06d}"
        self.system.loop_lag = EventLoopLagProbe(clock=lambda: 0.0)
        self.system.analyzer.trader = LLMTrader(model_version="chip_smoke")
        self.updates = self.system.bus.subscribe("market_updates")
        self.signals = self.system.bus.subscribe("trading_signals")
        self.sup = self.chaos = None
        if streamed:
            per_tick = len(self.symbols) * len(TICK_FRAMES)
            self.sup = StreamSupervisor(
                MarketStream(self.system.monitor, now_fn=now, backfill_batch=len(self.symbols)),
                now_fn=now, stale_after_s=45.0, max_silence_s=90.0)
            self.system.attach_stream(self.sup)
            self.chaos = ChaosFrameSource(
                FaultSchedule(script={STREAM_SILENT_TICK * per_tick: "fs_silence"}),
                silence_frames=per_tick - 1)
        self.ticks = []

    def tick(self):
        import asyncio

        from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
        from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for

        self.ex.advance()
        self.clock[0] += 60.0
        offered = 0
        if self.sup is not None:
            frames, dropped = self.chaos.filter(kline_frames_for(
                self.venue, self.symbols, TICK_FRAMES, event_ms=int(self.clock[0] * 1000)))
            if dropped:
                fail("stream: the trading rig's frame source disconnected")
            for f in frames:
                self.sup.offer(f)
            offered = len(frames)
        rest0 = self.rest[0]
        fused_ewma.launches = 0
        t0 = time.perf_counter()
        out = asyncio.run(self.system.tick())
        ms = 1e3 * (time.perf_counter() - t0)
        sys_ = self.system
        rec = {"out": out, "ms": ms, "k2": fused_ewma.launches, "rest": self.rest[0] - rest0,
               "offered": offered,
               "mode": sys_.metrics.gauges.get("crypto_trader_tpu_stream_mode"),
               "stream_degraded": (sys_._alert_state().get("stream_degraded")
                                   if self.sup is not None else None),
               "degraded_alert": "StreamDegradedToPoll" in sys_.alerts.active,
               "payloads": StreamRig.drained(self.updates),
               "decisions": [(e["data"]["symbol"], e["data"]["decision"],
                              e["data"]["confidence"])
                             for e in (self.signals.get_nowait()
                                       for _ in range(self.signals.qsize()))]}
        self.ticks.append(rec)
        return rec

    def books(self):
        import copy

        ex, exe = self.ex, self.system.executor
        return copy.deepcopy({"fills": ex.fills, "balances": ex.get_balances(),
                              "open_orders": ex.list_open_orders(),
                              "closed": exe.closed_trades,
                              "active": exe.snapshot_state()["active"]})


def stream_trading(trade_tick_ms_p50):
    """(b) The trading system on the stream: STREAM_TRADE_TICKS ticks from
    phase trade's cursor on the card, streamed; the same ticks polled on
    the card and streamed on the CPU.  The first tick seeds the lanes by
    REST backfill; the later ticks make zero REST kline calls at
    stream_mode 1, but the silent tick (stream_mode 0, the
    StreamDegradedToPoll input set, the monitor polling) and the hand-back
    after it (the gap's bounded backfill); 3 K2 launches a tick.  Payloads
    and trades equal the polled system's bit for bit, and the CPU's within
    `live_tolerance` (trades equal where the decisions agree)."""
    tape = TickTape(S_TICK, T_TICK)
    runs = {}
    t_runs = {}
    for tag, device, streamed in (("streamed", "cuda", True), ("polled", "cuda", False),
                                  ("cpu", "cpu", True)):
        rig = StreamTradeRig(tape, device, TRADE_CURSOR, streamed)
        t0 = time.perf_counter()
        try:
            for _ in range(STREAM_TRADE_TICKS):
                rig.tick()
            runs[tag] = {"ticks": rig.ticks, "books": rig.books()}
        finally:
            rig.system.shutdown()
        t_runs[tag] = time.perf_counter() - t0
    s, p, c = runs["streamed"]["ticks"], runs["polled"]["ticks"], runs["cpu"]["ticks"]
    silent, back = STREAM_SILENT_TICK, STREAM_SILENT_TICK + 1
    for t, r in enumerate(s):
        if r["k2"] != 3:
            fail(f"stream trading: tick {t} made {r['k2']} K2 launches, not 3")
        if len(r["payloads"]) != S_TICK or r["out"]["published"] != S_TICK:
            fail(f"stream trading: tick {t} published {len(r['payloads'])} updates")
        want_mode = 0.0 if t == silent else 1.0
        if r["mode"] != want_mode:
            fail(f"stream trading: tick {t}'s stream_mode {r['mode']}, not {want_mode}")
        if t == 0 and r["rest"] < S_TICK * len(TICK_FRAMES):
            fail(f"stream trading: the first tick seeded with {r['rest']} REST calls")
        if t not in (0, silent, back) and r["rest"]:
            fail(f"stream trading: steady tick {t} made {r['rest']} REST kline calls")
    if s[silent]["offered"] or not s[silent]["stream_degraded"] or not s[silent]["degraded_alert"]:
        fail(f"stream trading: the silent tick offered {s[silent]['offered']} frames, "
             f"stream_degraded {s[silent]['stream_degraded']}, alert "
             f"{s[silent]['degraded_alert']}")
    if s[silent]["rest"] != p[silent]["rest"]:
        fail(f"stream trading: the degraded tick made {s[silent]['rest']} REST calls, the "
             f"polled system {p[silent]['rest']}")
    if s[back]["stream_degraded"] or s[back]["degraded_alert"]:
        fail("stream trading: the system did not hand back to the stream after the silence")
    for t, (a, b) in enumerate(zip(s, p)):
        if a["payloads"] != b["payloads"] or a["decisions"] != b["decisions"]:
            fail(f"stream trading: tick {t}'s payloads or decisions differ from the polled "
                 "system's on the same tape")
    if runs["streamed"]["books"] != runs["polled"]["books"]:
        fail("stream trading: the trades differ from the polled system's")
    flips = []
    for t, (a, b) in enumerate(zip(s, c)):
        if (a["mode"], a["rest"]) != (b["mode"], b["rest"]):
            fail(f"stream trading: tick {t} mode/REST on the card {a['mode']}/{a['rest']}, on "
                 f"the CPU {b['mode']}/{b['rest']}")
        for sym, ref in b["payloads"].items():
            compare_updates(a["payloads"][sym], ref, f"stream trading tick {t} {sym}", flips)
    card_books, cpu_books = runs["streamed"]["books"], runs["cpu"]["books"]
    diverge = next((t for t, (a, b) in enumerate(zip(s, c)) if a["decisions"] != b["decisions"]),
                   None)
    if diverge is None and card_books != cpu_books:
        fail("stream trading: the decisions agree but the trades on the card differ from "
             "the CPU's")
    entries = sum(f["side"] == "BUY" for f in card_books["fills"])
    if entries < 1:
        fail("stream trading: no entry: the trade comparison is vacuous")
    steady = [r["ms"] for t, r in enumerate(s) if t not in (0, silent, back)]
    polled = [r["ms"] for t, r in enumerate(p) if t]
    return {"symbols": S_TICK, "ticks": STREAM_TRADE_TICKS, "cursor": TRADE_CURSOR,
            "silent_tick": silent,
            "per_tick": [{k: r[k] for k in ("ms", "k2", "rest", "offered", "mode",
                                            "stream_degraded", "degraded_alert")}
                         for r in s],
            "rest_per_tick_polled": [r["rest"] for r in p],
            "tick_ms": {"streamed_steady": {"p50": percentile(steady, 50),
                                            "p99": percentile(steady, 99)},
                        "polled_this_phase": {"p50": percentile(polled, 50),
                                              "p99": percentile(polled, 99)},
                        "phase_trade_polled_p50": trade_tick_ms_p50},
            "equal_polled_bit_for_bit": True,
            "card_vs_cpu": {"label_flips": len(flips), "flips": flips[:5],
                            "decisions_diverge_at_tick": diverge,
                            "trades_equal": card_books == cpu_books},
            "entries": entries, "closed_trades": len(card_books["closed"]),
            "run_s": t_runs}


def load_point(device):
    """`run_load(LoadConfig(tenants=256, symbols=4, mode="vmapped",
    ticks=10))` on ``device`` through its pieces, so that each decide is
    kept: the report and every decide's output."""
    import asyncio

    import numpy as np

    from ai_crypto_trader_tpu_torch.testing.loadgen import (
        LoadConfig, SyntheticTenantTraffic, _fleet_scope)

    cfg = LoadConfig(tenants=LOAD_TENANTS, symbols=LOAD_SYMBOLS, mode="vmapped",
                     ticks=LOAD_TICKS, slo_p99_ms=LOAD_SLO_MS, device=device)
    traffic = SyntheticTenantTraffic(cfg)
    eng, decides = traffic.tenant_engine, []
    real = eng.decide

    def decide(feats):
        out = real(feats)
        decides.append({k: np.asarray(v).copy() for k, v in out.items()})
        return out

    eng.decide = decide
    with _fleet_scope(traffic):
        try:
            rep = asyncio.run(traffic.run())
        finally:
            traffic.close()
    vetoes = {k: v for k, v in traffic.metrics.counters.items() if "decision_vetoes" in k}
    return {"report": rep, "decides": decides, "vetoes": vetoes,
            "state": {k: np.asarray(v).copy() for k, v in eng._state_np.items()},
            "quarantined": eng.quarantined_lanes(), "warmup": cfg.warmup_ticks}


def stream_load():
    """(c) The capacity row's path: the load point on the card (its K2
    launches recorded: 3 a tick) and on the CPU, decisions, vetoes,
    balances and quarantines equal; then `ramp` in both modes as
    bench_capacity runs it (objects to 8 tenants, vmapped to 256, 4
    symbols, SLO p99 250 ms), its K2 launches counted."""
    import numpy as np

    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.testing.loadgen import LoadConfig, ramp

    launches = []
    fused_ewma.launches = 0
    t0 = time.perf_counter()
    with recording_ewma(launches):
        card = load_point("cuda")
    card_s = time.perf_counter() - t0
    n_ticks = card["warmup"] + LOAD_TICKS
    if (fused_ewma.launches, len(launches)) != (3 * n_ticks, 3 * n_ticks):
        fail(f"stream load: {fused_ewma.launches} K2 launches ({len(launches)} recorded) over "
             f"{n_ticks} ticks, not 3 a tick")
    t0 = time.perf_counter()
    cpu = load_point("cpu")
    cpu_s = time.perf_counter() - t0
    rep, rep_c = card["report"], cpu["report"]
    for k in ("published", "analyzed", "executed", "rest_kline_calls_steady", "ticks", "lanes"):
        if rep[k] != rep_c[k]:
            fail(f"stream load: {k} {rep[k]} on the card, {rep_c[k]} on the CPU")
    if rep["rest_kline_calls_steady"] != 0:
        fail(f"stream load: {rep['rest_kline_calls_steady']} REST kline calls in the steady "
             "state")
    if len(card["decides"]) != len(cpu["decides"]):
        fail("stream load: a different number of decides on the card and the CPU")
    for t, (a, b) in enumerate(zip(card["decides"], cpu["decides"])):
        for k in ("gate", "decision", "exec"):
            if k in b and not np.array_equal(a[k], b[k]):
                fail(f"stream load: decide {t}'s {k} differs between the card and the CPU at "
                     f"{int((a[k] != b[k]).sum())} lanes")
        for k in ("confidence", "size", "qty"):
            if k in b and not np.allclose(a[k], b[k], rtol=1e-5, atol=1e-6, equal_nan=True):
                fail(f"stream load: decide {t}'s {k} differs beyond rtol 1e-5")
    if card["vetoes"] != cpu["vetoes"]:
        fail(f"stream load: vetoes {card['vetoes']} on the card, {cpu['vetoes']} on the CPU")
    if card["quarantined"] != cpu["quarantined"]:
        fail("stream load: the quarantined lanes differ between the card and the CPU")
    for k, v in cpu["state"].items():
        a = card["state"][k]
        same = (np.allclose(a, v, rtol=1e-5, atol=1e-6, equal_nan=True) if v.dtype.kind == "f"
                else np.array_equal(a, v))
        if not same:
            fail(f"stream load: the lanes' {k} differs between the card and the CPU")

    def ramp_mode(mode, cap):
        fused_ewma.launches = 0
        t0 = time.perf_counter()
        out = ramp(LoadConfig(tenants=cap, symbols=LOAD_SYMBOLS, ticks=LOAD_TICKS,
                              slo_p99_ms=LOAD_SLO_MS, mode=mode, device="cuda"))
        wall = time.perf_counter() - t0
        k2 = fused_ewma.launches
        ticks = sum(s["ticks"] for s in out["steps"]) + 2 * len(out["steps"])
        if k2 != 3 * ticks or any(s["rest_kline_calls_steady"] for s in out["steps"]):
            fail(f"stream load: the {mode} ramp made {k2} K2 launches over {ticks} ticks, "
                 f"REST {[s['rest_kline_calls_steady'] for s in out['steps']]}")
        best = out["max_sustainable"] or {}
        return {"steps": [{k: s[k] for k in ("tenants", "lanes", "p50_ms", "p99_ms",
                                             "breached", "bottleneck_stage")}
                          for s in out["steps"]],
                "max_sustainable_lanes": best.get("lanes", 0),
                "max_sustainable_tenants": best.get("tenants", 0),
                "p99_ms_at_max": best.get("p99_ms"), "breach": out["breach"],
                "saturated_stages": out["saturated_stages"],
                "bottleneck_stage": out["bottleneck_stage"], "k2_launches": k2,
                "ramp_s": wall}

    objects = ramp_mode("objects", LOAD_OBJECT_CAP)
    vmapped = ramp_mode("vmapped", LOAD_TENANTS)
    speedup = (vmapped["max_sustainable_lanes"] / objects["max_sustainable_lanes"]
               if objects["max_sustainable_lanes"] else None)
    k2_total = 3 * n_ticks + objects["k2_launches"] + vmapped["k2_launches"]
    return {"load_point": {"tenants": LOAD_TENANTS, "symbols": LOAD_SYMBOLS,
                           "ticks": LOAD_TICKS, "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
                           "cpu_p50_ms": rep_c["p50_ms"], "stage_duty": rep["stage_duty"],
                           "bottleneck_stage": rep["bottleneck_stage"],
                           "published": rep["published"], "analyzed": rep["analyzed"],
                           "executed": rep["executed"], "decides": len(card["decides"]),
                           "vetoes": card["vetoes"], "card_equal_cpu": True,
                           "card_s": card_s, "cpu_s": cpu_s},
            "ramp": {"slo_p99_ms": LOAD_SLO_MS, "objects": objects, "vmapped": vmapped,
                     "speedup": speedup},
            "k2_launches": k2_total}, launches, k2_total


def stream_cli():
    """(d) `cli load --mode vmapped --tenants 256 --symbols 4` and `cli
    fleet` as subprocesses on the card, run at once: exit 0, the load
    report's mode and zero steady REST calls, the fleet view's headline
    (each `subprocess_s` from the start of both)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    out = {}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli",
                                     *argv], cwd=root, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env)
             for name, argv in (("load", ["load", "--mode", "vmapped", "--tenants",
                                          str(LOAD_TENANTS), "--symbols", str(LOAD_SYMBOLS)]),
                                ("fleet", ["fleet"]))}   # both at once
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        proc = subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"stream: cli {name} exited {proc.returncode}: {proc.stderr[-800:]}")
        if name == "load":
            rep = json.loads(proc.stdout[proc.stdout.index("{"):])
            if rep["mode"] != "vmapped" or rep["rest_kline_calls_steady"] != 0 or \
                    rep["lanes"] != LOAD_TENANTS * LOAD_SYMBOLS:
                fail(f"stream: cli load's report {str(rep)[:300]}")
            out[name] = {"subprocess_s": wall, "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
                         "bottleneck_stage": rep["bottleneck_stage"]}
        else:
            head = next((line for line in proc.stdout.splitlines() if line.startswith("fleet: ")),
                        None)
            if head is None:
                fail(f"stream: cli fleet printed no fleet line: {proc.stdout[:400]}")
            out[name] = {"subprocess_s": wall, "headline": head}
    return out


def phase_stream(info, trade_tick_ms_p50=None):
    """The streamed market path and the load harness on the card: (a)
    bench_stream's path at its width (16 symbols × 1m/3m/5m/15m × 256,
    STREAM_TICKS ticks a pass: serial, under TickPathScope, pipelined),
    the CPU's serial pass; (b) `TradingSystem.attach_stream` over phase
    live's tape with a silence and a hand-back, against a polled system
    and the CPU; (c) the capacity row's load point card against CPU and
    both ramps; (d) `cli load` and `cli fleet`.  Every K2 launch of (a) is
    held against the plain EWMA, and (c)'s load point's too.  Returns K2's
    entry for the kernels line."""
    t_phase = time.perf_counter()
    tape = StreamTape()
    t0 = time.perf_counter()
    latency, launches_a = stream_latency(tape)
    times = {"latency_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    trading = stream_trading(trade_tick_ms_p50)
    times["trading_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load, launches_c, load_k2 = stream_load()
    times["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = stream_cli()
    times["cli_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k2 = live_k2(launches_a, "stream_drain")
    k2_load = live_k2(launches_c, "load_tick")
    times["held_s"] = time.perf_counter() - t0
    report = {"phase": "stream", "card": info["nvidia_smi"], "latency": latency,
              "trading": trading, "load": load, "cli": cli, "k2": k2,
              "k2_load_ticks": {k: k2_load[k] for k in ("launches_held", "ms", "plain_ms",
                                                         "bound_ms", "bound_by",
                                                         "max_abs_err")},
              "part_s": times, "phase_s": time.perf_counter() - t_phase}
    emit(report)
    drains = latency["drains"]
    trade_k2 = sum(r["k2"] for r in trading["per_tick"])
    return {"launches": 3 * drains + trade_k2 + load_k2,
            "launches_by_path": {"stream_drains": 3 * drains, "trading_ticks": trade_k2,
                                 "load": load_k2},
            "launches_per_drain": 3, "launches_held": k2["launches_held"]
            + k2_load["launches_held"],
            **{k: k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "barrier_only_ms",
                                  "bound_ms", "bound_by")},
            "max_abs_err": max(k2["max_abs_err"], k2_load["max_abs_err"]),
            "max_rel_err": max(k2["max_rel_err"], k2_load["max_rel_err"]),
            "library_ms": None,
            "load_tick": {k: k2_load[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "event_to_publish_ms_p50": latency["event_to_publish_ms"]["serial"]["p50"],
            "shape": f"a drain's 3 launches at S={STREAM_S} x F={len(TICK_FRAMES)} x "
                     f"T={STREAM_T} (ms/plain/bound); load_tick: a load tick's 3 at "
                     f"S={LOAD_SYMBOLS} x F=1 x T=64"}


# --- phase serve: the operator surface -------------------------------------

SERVE_TICKS = 6           # (a): ticks of the served system and of the plain one, alternating
SERVE_PROFILE_S = 3       # (d): the /profile capture's seconds: a polled tick is ~1.2-1.6 s,
#                           its card work ~0.05 s of it, so a 1 s window can miss every tick's
SERVE_PROFILE_TICKS = 4   # (d): the served system's ticks, back to back, during the capture
SERVE_CLI_PROFILE_TICKS = 4   # (e): `cli profile --ticks`
SERVE_CLI_TRADE_TICKS = 2     # (e): `cli trade --paper --ticks`, twice on one --aot-cache
SERVE_K1_HELD = 2         # (b): K1 launches held against the plain loop: the sweep's and the
                          # GA's first (all 5 until PR 18; the GA's rows form is held at this
                          # shape in phase ga)
SERVE_OVERHEAD_TICKS = 4  # (f): ticks of the served system and of the plain one, alternating,
#                           once (e)'s subprocesses have ended
SERVE_BLOCKS = ("status", "devprof", "mesh", "tickpath", "coldstart", "aot_cache", "build")
SERVE_ROUTES = ("/", "/state.json", "/traces", "/decisions", "/metrics", "/health")


# the alerts the observatories raise from their own readings (each rule
# reads only devprof, meshprof or tickpath state): the served system may
# fire them, the plain one cannot; everything else is held bit for bit
OBSERVATORY_ALERTS = ("LatencySLOBurnRateCritical", "LatencySLOBurnRateWarning",
                      "DonatedBufferNotFreed", "SteadyStateRecompile",
                      "UnintendedHostTransfer", "MeshPaddingWasteHigh",
                      "DeviceMemoryImbalance", "DecisionLatencyBudgetBreach")


def without_observatory_alerts(snap):
    """A `TradeRig.snapshot` with the observatories' own alerts taken out
    of its alert history, active alerts and alert-channel count, and of
    each tick's return (its alert count); the dashboard HTML, which lists
    the active alerts, is left out.  Returns (snapshot, the alerts taken)."""
    import copy

    snap = copy.deepcopy(snap)
    taken = [a for a in snap["alerts"] if a["name"] in OBSERVATORY_ALERTS]
    snap["alerts"] = [a for a in snap["alerts"] if a["name"] not in OBSERVATORY_ALERTS]
    status = snap["status"]
    status["alerts"] = [n for n in status["alerts"] if n not in OBSERVATORY_ALERTS]
    status["channels"]["alerts"] = status["channels"].get("alerts", 0) - len(taken)
    snap["returns"] = [{k: v for k, v in r.items() if k != "alerts"} for r in snap["returns"]]
    del snap["html"]
    return snap, taken


def serve_get(port, route, timeout=120):
    """(code, body) of one GET on the local dashboard server."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as ex:
        return ex.code, ex.read()


def serve_system(tape, tmp):
    """(a) The served system (devprof, meshprof, tickpath, a fresh kernel
    cache, a dashboard server on port 0) and the plain one (every
    observatory off) over phase trade's tape, SERVE_TICKS ticks each,
    alternating; the served ticks' K2 launches recorded and counted, the
    tick engine's first program call captured for the card's byte check.
    Their trades, status, journal and decisions must be the same bits."""
    from ai_crypto_trader_tpu_torch.ops import tick_engine
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.shell.dashboard_server import DashboardServer

    on = TradeRig(tape, "cuda", TRADE_CURSOR, tmp, "served", system_kw={
        "enable_devprof": True, "enable_meshprof": True, "enable_tickpath": True,
        "aot_cache_dir": f"{tmp}/aot"})
    off = TradeRig(tape, "cuda", TRADE_CURSOR, tmp, "plain",
                   system_kw={"enable_tickpath": False})
    server = DashboardServer(on.system, port=0, profile_dir=f"{tmp}/profiles").start()
    launches, per_tick, first_call = [], [], []
    real_program = tick_engine._tick_program

    def program(*args):
        out = real_program(*args)
        if not first_call:
            first_call.append((args, out))
        return out

    tick_engine._tick_program = program
    fused_ewma.launches = 0
    try:
        for _ in range(SERVE_TICKS):
            n0 = fused_ewma.launches
            with recording_ewma(launches):
                on.tick()
            per_tick.append(fused_ewma.launches - n0)
            off.tick()
    finally:
        tick_engine._tick_program = real_program
    k2_launches = sum(per_tick)
    if per_tick != [3] * SERVE_TICKS or len(launches) != 3 * SERVE_TICKS:
        fail(f"serve: the served ticks launched K2 {per_tick} times (recorded {len(launches)})")
    a, taken = without_observatory_alerts(on.snapshot())
    b, none = without_observatory_alerts(off.snapshot())
    differ = sorted(k for k in a if json.dumps(a[k], sort_keys=True, default=str)
                    != json.dumps(b[k], sort_keys=True, default=str))
    with open(on.paths["journal"], "rb") as f1, open(off.paths["journal"], "rb") as f2:
        if f1.read() != f2.read():
            differ.append("journal")
    if none:
        differ.append("the plain system's observatory alerts")
    if differ:
        fail(f"serve: the served system's {differ} differ from the plain system's")
    if not a["books"]["closed"] and not a["books"]["fills"]:
        fail("serve: no fill in the window: the comparison holds no trade")
    return on, off, server, launches, k2_launches, first_call[0], sorted(
        {x["name"] for x in taken})


def serve_devprof(on, first_call, d_year):
    """(b) The served system's devprof on the card: the tick_engine card's
    bytes against its tensors, temp bytes, the ring's donation, the
    allocator watermark, the SLO windows; then `backtest.sweep` at 256 ×
    43,200 and `run_ga(GAParams(256, 3))` over the same candles under the
    observatories, their K1 launches recorded."""
    import torch

    from ai_crypto_trader_tpu_torch import backtest
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.utils.devprof import _tensors

    dp, mp = on.system.devprof, on.system.meshprof

    def nbytes(tree):
        seen = {}
        for t in _tensors(tree):
            seen[(t.data_ptr(), t.nbytes)] = t.nbytes
        return sum(seen.values())

    card = dp.cards["tick_engine"]
    args, out = first_call
    want = {"argument_bytes": nbytes(args), "output_bytes": nbytes(out),
            "alias_bytes": args[0].nbytes}
    got = {k: getattr(card, k) for k in want}
    if got != want or card.error is not None:
        fail(f"serve: tick_engine card {got} != its tensors' bytes {want} ({card.error})")
    if not card.temp_bytes or card.temp_bytes <= 0 or card.donation_ok is not True:
        fail(f"serve: tick_engine card temp_bytes {card.temp_bytes}, "
             f"donation {card.donation_ok}")
    if card.kernels.get("fused_ewma") != 3:
        fail(f"serve: the tick_engine card counted {card.kernels} kernel launches")
    mem = dp.sample_memory()
    peak = dp.watermark.peak_bytes.get("cuda:0", 0)
    if not 0 < peak <= torch.cuda.max_memory_allocated(0):
        fail(f"serve: watermark peak {peak} vs max_memory_allocated "
             f"{torch.cuda.max_memory_allocated(0)}")
    slos = dp.status()["slos"]
    if slos.get("tick", {}).get("count") != SERVE_TICKS or \
            slos.get("host_read", {}).get("count", 0) < SERVE_TICKS:
        fail(f"serve: SLO windows {slos}")

    d = {k: v[:T_GA] for k, v in d_year.items()}
    calls = []
    k2_0, k1_0 = fused_ewma.launches, sweep_kernel.launches
    t0 = time.perf_counter()
    with recording_k1(calls):
        inp = backtest.prepare_inputs(compute_indicators(d, device="cuda"), device="cuda")
        params = backtest.sample_params(torch.Generator().manual_seed(0), POP_GA, device="cuda")
        backtest.sweep(inp, params, device="cuda")
        fitness = backtest_fitness(d, device="cuda")
        run_ga(torch.Generator(device="cuda").manual_seed(0), fitness,
               GAParams(population_size=POP_GA, generations=GENS_GA),
               seed_params=backtest.default_params(device="cuda"), device="cuda")
        torch.cuda.synchronize()
    sweep_ga_s = time.perf_counter() - t0
    k2, k1 = fused_ewma.launches - k2_0, sweep_kernel.launches - k1_0
    if k1 != 1 + GENS_GA + 1 or len(calls) != k1:
        fail(f"serve: sweep + GA launched K1 {k1} times (recorded {len(calls)})")
    cards = {}
    for name in ("backtest_sweep", "ga_scan"):
        c = dp.cards.get(name)
        if c is None or c.error is not None or not c.bytes_accessed or \
                not c.kernels.get("replay_sweep"):
            fail(f"serve: the {name} card is {c and c.to_dict()}")
        cards[name] = {k: v for k, v in c.to_dict().items() if k != "notes"}
    layout = mp.layouts.get("ga_scan")
    if layout is None or (layout.population, layout.pad, layout.devices) != (POP_GA, 0, 1):
        fail(f"serve: ga_scan layout card {layout and layout.to_dict()}")
    return {"tick_engine": {k: v for k, v in card.to_dict().items() if k != "notes"},
            "watermark": {"peak_bytes": peak, "sample": mem,
                          "max_memory_allocated": torch.cuda.max_memory_allocated(0)},
            "slos": slos, "cards": cards, "layout_ga_scan": layout.to_dict(),
            "sweep_ga_s": sweep_ga_s, "k2_table_launches": k2, "k1_launches": k1}, calls


def serve_meshprof(on):
    """(c) The sync sentinel armed on the card: 0 violations over the
    steady ticks, exactly 1 for a deliberate `.item()` in a watch window;
    no kernel built after warm-up."""
    import torch

    from ai_crypto_trader_tpu_torch.utils import meshprof

    mp = on.system.meshprof
    st = mp.status()
    if st["transfers"]["violations"] or st["transfers"]["armed_windows"] < SERVE_TICKS:
        fail(f"serve: steady ticks' transfers {st['transfers']}")
    if st["recompiles"]["steady_recompiles"]:
        fail(f"serve: steady-state rebuilds {st['recompiles']}")
    probe = torch.ones(1, device="cuda")
    try:
        with meshprof.watch("serve_probe"):
            probe.item()
        fail("serve: a .item() inside an armed watch window was not refused")
    except RuntimeError as ex:
        if not meshprof.is_transfer_violation(ex):
            raise
    counted = mp.transfers.violations.get("serve_probe")
    if counted != 1:
        fail(f"serve: the sentinel counted {counted} for one .item()")
    return {"steady_violations": 0, "probe_violations": counted,
            "armed_windows": mp.transfers.armed_windows,
            "unarmed_windows": mp.transfers.unarmed_windows,
            "windows": st["recompiles"]["windows"],
            "steady_recompiles": st["recompiles"]["steady_recompiles"],
            "last_error": mp.transfers.last_error.get("serve_probe")}


def serve_server(on, server):
    """(d) Every route with content; /state.json's blocks and build; a
    SERVE_PROFILE_S /profile capture on a handler thread while the served
    system ticks back to back, its trace naming K2's kernel, and a second
    capture refused meanwhile;
    `cli status/latency/fleet/mesh --url` in this process."""
    import contextlib as ctx
    import io
    import threading

    import torch

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.utils import profiling

    routes, bodies = {}, {}
    for r in SERVE_ROUTES:
        code, bodies[r] = serve_get(server.port, r)
        if code != 200 or not bodies[r]:
            fail(f"serve: {r} answered {code} with {len(bodies[r])} bytes")
        routes[r] = len(bodies[r])
    state = json.loads(bodies["/state.json"])
    missing = [b for b in SERVE_BLOCKS if b not in state]
    build = state.get("build", {})
    if missing or build.get("torch_version") != torch.__version__ or \
            build.get("cuda_version") != torch.version.cuda or \
            build.get("device_kind") != torch.cuda.get_device_name(0):
        fail(f"serve: /state.json lacks {missing} or names {build}")
    box = {}
    th = threading.Thread(target=lambda: box.update(
        first=serve_get(server.port, f"/profile?seconds={SERVE_PROFILE_S}")))
    t0 = time.perf_counter()
    th.start()
    time.sleep(0.2)
    second = serve_get(server.port, "/profile?seconds=1")
    for _ in range(SERVE_PROFILE_TICKS):
        on.tick()
    th.join(timeout=120)
    profile_s = time.perf_counter() - t0
    code, body = box.get("first", (None, b""))
    if code != 200:
        fail(f"serve: /profile answered {code}: {body[:300]!r}")
    if second[0] != 409:
        fail(f"serve: a second capture during the first answered {second[0]}")
    art = json.loads(body)
    kernels = profiling.cuda_events(art["trace"], ("kernel",))
    if not art["cuda_events"]:
        fail(f"serve: the /profile capture recorded no CUDA activity: {art}")
    if not any("ewma_tiles" in k for k in kernels):
        fail(f"serve: the /profile trace names no K2 kernel: {kernels[:20]}")
    url = f"http://127.0.0.1:{server.port}"
    outs = {}
    for name in ("status", "latency", "fleet", "mesh"):
        buf = io.StringIO()
        with ctx.redirect_stdout(buf):
            cli.main([name, "--url", url])
        outs[name] = buf.getvalue()
    status = json.loads(outs["status"])
    if not status["live"] or status["build"]["device_kind"] != torch.cuda.get_device_name(0):
        fail(f"serve: cli status --url printed {outs['status'][:300]}")
    if "tick_engine" not in outs["latency"] or "torch " not in outs["latency"]:
        fail(f"serve: cli latency --url printed {outs['latency'][:300]}")
    if json.loads(outs["mesh"]).get("transfers", {}).get("violations", {}).get(
            "serve_probe") != 1:
        fail(f"serve: cli mesh --url printed {outs['mesh'][:300]}")
    return {"routes_bytes": routes, "blocks": sorted(state), "build": build,
            "profile": {"requested_s": art["requested_s"], "seconds": art["seconds"],
                        "wall_s": profile_s, "kernels": len(kernels),
                        "k2_kernel": next(k for k in kernels if "ewma_tiles" in k),
                        "second_capture_code": second[0]},
            "cli_lines": {k: len(v.splitlines()) for k, v in outs.items()}}


def serve_cli(tmp):
    """(e) `cli profile --ticks 4` once, beside `cli trade --paper --ticks 2
    --aot-cache DIR` twice: the second trade finds both libraries built
    (warm, nothing built, cache_hits ≥ 2)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    cmd = [sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli"]
    t0 = time.perf_counter()
    prof = subprocess.Popen([*cmd, "profile", "--ticks", str(SERVE_CLI_PROFILE_TICKS),
                             "--out", f"{tmp}/cli_profile"], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = []
    for _ in range(2):
        t1 = time.perf_counter()
        proc = subprocess.run([*cmd, "trade", "--paper", "--ticks", str(SERVE_CLI_TRADE_TICKS),
                               "--aot-cache", f"{tmp}/cli_aot"], cwd=root, env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"serve: cli trade --aot-cache exited {proc.returncode}: {proc.stderr[-800:]}")
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith('{"aot_cache"')),
                    None)
        if line is None:
            fail(f"serve: cli trade --aot-cache printed no cache line: {proc.stdout[:300]}")
        runs.append({**json.loads(line)["aot_cache"], "subprocess_s": time.perf_counter() - t1})
    out, err = prof.communicate(timeout=300)
    profile_s = time.perf_counter() - t0
    if prof.returncode != 0:
        fail(f"serve: cli profile exited {prof.returncode}: {err[-800:]}")
    cold, warm = runs
    if cold["warm"] or len(cold["built"]) != 2 or not warm["warm"] or warm["built"] or \
            warm["cache_hits"] < 2 or warm["dir"] != cold["dir"]:
        fail(f"serve: the cache runs: cold {cold}, warm {warm}")
    report = json.loads(out[out.index("{"):])
    from ai_crypto_trader_tpu_torch.utils import profiling

    kernels = profiling.cuda_events(report["trace"], ("kernel",))
    if not any("ewma_tiles" in k for k in kernels):
        fail(f"serve: cli profile's trace names no K2 kernel: {kernels[:20]}")
    return {"aot": [{k: r[k] for k in ("warm", "built", "cache_hits", "build_s", "entries",
                                       "lock", "subprocess_s")} for r in runs],
            "profile": {"subprocess_s": profile_s, "kernels": len(kernels),
                        "cards": sorted(report["devprof"]["cost_cards"])}}


def phase_serve(info, d_year):
    """The operator surface on the card: (a) the served system (devprof,
    meshprof, tickpath, a fresh kernel cache, the dashboard server) against
    the plain one, tick for tick, bit for bit but for the observatories'
    own alerts (`OBSERVATORY_ALERTS`), and its 18 K2 launches held
    against the plain EWMA; (b) devprof's cards, donation, watermark and
    SLOs, with the sweep and the GA under the observatory (their K1
    launches counted, the first SERVE_K1_HELD held bit for bit); (c) the sync sentinel armed on the card;
    (d) the server's routes, /state.json, /profile and the --url commands;
    (e) `cli profile` and a cold and a warm `cli trade --aot-cache`, as
    subprocesses beside (a)-(d); (f) once they have ended, on a quiet
    host, the tick p50 with every observatory on and off, alternating.
    Returns the kernels line's entries: (K2 block, K1 block)."""
    import tempfile
    import threading

    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (e)'s subprocesses run beside (a)-(d): they hold the card little
        # and their own processes' hosts; their result is read at the end
        cli_box = {}

        def run_cli():
            t_cli = time.perf_counter()
            try:
                cli_box["out"] = serve_cli(tmp)
            except BaseException as ex:   # noqa: BLE001 — raised again below
                cli_box["error"] = ex
            times["cli_s"] = time.perf_counter() - t_cli

        cli_thread = threading.Thread(target=run_cli, name="serve-cli")
        cli_thread.start()
        tape = TickTape(S_TICK, T_TICK)
        t0 = time.perf_counter()
        on, off, server, launches, k2_served, first_call, obs_alerts = serve_system(tape, tmp)
        times["system_s"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            dev, k1_calls = serve_devprof(on, first_call, d_year)
            times["devprof_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh = serve_meshprof(on)
            times["meshprof_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            srv = serve_server(on, server)
            times["server_s"] = time.perf_counter() - t0
            aot = on.system.aot_cache.status()
            # (f) alone on the host and the card: (e)'s subprocesses first end
            t0 = time.perf_counter()
            cli_thread.join(timeout=600)
            times["cli_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            n_on, n_off = len(on.tick_ms), len(off.tick_ms)
            for _ in range(SERVE_OVERHEAD_TICKS):
                on.tick()
                off.tick()
            tick_on, tick_off = on.tick_ms[n_on:], off.tick_ms[n_off:]
            times["overhead_s"] = time.perf_counter() - t0
        finally:
            server.stop()
            on.system.shutdown()
            off.system.shutdown()
            cli_thread.join(timeout=600)
        if "error" in cli_box:
            raise cli_box["error"]
        cli_out = cli_box["out"]
    t0 = time.perf_counter()
    k2 = live_k2(launches, "serve_tick")
    k1 = {**held_k1(k1_calls[:SERVE_K1_HELD], "serve_k1"), "launches": len(k1_calls),
          "launches_held": SERVE_K1_HELD}
    times["held_s"] = time.perf_counter() - t0
    overhead = {"tick_ms_p50_on": percentile(tick_on, 50),
                "tick_ms_p50_off": percentile(tick_off, 50),
                "tick_ms_on": tick_on, "tick_ms_off": tick_off,
                # (a)'s ticks, beside (e)'s subprocesses: not the overhead
                "beside_cli": {"tick_ms_on": on.tick_ms[:SERVE_TICKS],
                               "tick_ms_off": off.tick_ms[:SERVE_TICKS]}}
    report = {"phase": "serve", "card": info["nvidia_smi"], "ticks": SERVE_TICKS,
              "equal_bits_on_off": True, "observatory_alerts_fired": obs_alerts,
              "devprof": dev, "meshprof": mesh, "server": srv,
              "aot_cache_in_process": aot, "cli": cli_out, "overhead": overhead,
              "k2": {k: k2[k] for k in ("launches_held", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "max_abs_err")},
              "k1": k1, "part_s": times, "phase_s": time.perf_counter() - t_phase}
    emit(report)
    k2_total = k2_served + dev["k2_table_launches"]
    return ({"launches": k2_total,
             "launches_by_path": {"served_ticks": k2_served,
                                  "ga_tables": dev["k2_table_launches"]},
             "launches_held": k2["launches_held"],
             **{k: k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "barrier_only_ms",
                                   "bound_ms", "bound_by", "max_abs_err", "max_rel_err")},
             "library_ms": None,
             "observatory_overhead_tick_ms_p50": {"on": overhead["tick_ms_p50_on"],
                                                  "off": overhead["tick_ms_p50_off"]},
             "shape": f"a served tick's 3 launches at S={S_TICK} x F={len(TICK_FRAMES)} x "
                      f"T={T_TICK} (ms/plain/bound)"},
            {**k1, "launches_by_path": {"sweep": 1, "ga": dev["k1_launches"] - 1},
             "shape_note": f"B={POP_GA} x T={T_GA}: one sweep, the GA's {GENS_GA + 1} "
                           f"rows-form launches; ms/plain/bound: the first {SERVE_K1_HELD}, "
                           "held"})


# --- phase research: the research shell ------------------------------------

RES_FETCH_DAYS = 7        # (a): `cli fetch --days` (its default)
RES_FETCH_SEED = 5        # (a): the fetched series' seed; `cli backtest` runs at its default 0,
                          # so only a backtest that loads the CSV sees this series
RES_SWEEP = 256           # (a): the second `cli backtest`'s --sweep
RES_SYMBOLS, RES_PARAMS, RES_T = 8, 2, 43_200   # (b): symbols × parameter sets, 30 days of 1m
RES_TRADES, RES_HELD = 2_000, 500               # (c): the forest's trades; held-out rows
RES_TRADE_SEED = 21
RES_DRIVERS = ("bb_position", "rsi")            # (c): the two features the outcome depends on
RES_PROBA_ATOL = 1e-6                           # (c), (d): class probabilities, card against CPU
RES_GATE_TICKS = 2                              # (d): ticks of the gated live path


def research_trades(n, seed):
    """``n`` synthetic trades over the 19 `FEATURE_GROUPS` features, each
    drawn in a range the live path's market updates carry; the outcome
    depends on `rsi` and `bb_position` alone (and noise): a mean-reversion
    entry, which wins when both are low."""
    import numpy as np

    from ai_crypto_trader_tpu_torch.models.trade_importance import FEATURE_GROUPS

    names = sorted({f for fs in FEATURE_GROUPS.values() for f in fs})
    rng = np.random.default_rng(seed)
    ranges = {"rsi": (5.0, 95.0), "stoch_k": (0.0, 100.0), "williams_r": (-100.0, 0.0),
              "bb_position": (-0.2, 1.2), "bb_width": (0.0, 0.1),
              "social_sentiment": (0.0, 1.0), "social_volume": (0.0, 5e4),
              "social_engagement": (0.0, 2e4), "volume": (0.0, 1e3),
              "avg_volume": (0.0, 1e3), "volatility": (0.0, 0.05),
              "atr": (0.0, 500.0), "ema_12": (3e4, 5e4), "sma_20": (3e4, 5e4),
              "trend_strength": (-1.0, 1.0)}
    cols = {f: rng.uniform(*ranges[f], n) if f in ranges else rng.normal(0.0, 0.01, n)
            for f in names}
    z = (50.0 - cols["rsi"]) / 15.0 + (0.5 - cols["bb_position"]) / 0.25 \
        + rng.normal(0.0, 0.5, n)
    pnl = np.where(z > 0.0, 1.0, -1.0) + rng.normal(0.0, 0.01, n)
    return [{"features": {f: float(cols[f][i]) for f in names}, "pnl": float(pnl[i])}
            for i in range(n)]


def forest_digest(rf):
    """A digest of a fitted forest's trees: the same bytes, the same model."""
    import hashlib

    h = hashlib.sha256()
    for t in rf.trees:
        for k in ("feature", "threshold", "left", "right", "value"):
            h.update(t[k].tobytes())
    return h.hexdigest()


def research_forest_fit(device):
    """`TradeOutcomeAnalyzer` at the reference's defaults (100 trees, 30
    repeats) fitted on RES_TRADES trades on ``device``: the analyzer, its
    held-out rows, and the fit's parts (each forest's host fit, the
    permutation importance's ms)."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import trade_importance as ti

    trades, held = research_trades(RES_TRADES, RES_TRADE_SEED), \
        research_trades(RES_HELD, RES_TRADE_SEED + 1)
    parts = {"forest_fit_s": [], "permutation_ms": []}
    real_fit = ti.RandomForestClassifier.fit

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed_fit(self, X, y):
        t0 = time.perf_counter()
        out = real_fit(self, X, y)
        sync()
        parts["forest_fit_s"].append(time.perf_counter() - t0)
        return out

    az = ti.TradeOutcomeAnalyzer(device=device)
    real_perm = az._permutation_importance

    def timed_perm(model, X, y):
        sync()
        t0 = time.perf_counter()
        out = real_perm(model, X, y)
        parts["permutation_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    az._permutation_importance = timed_perm
    ti.RandomForestClassifier.fit = timed_fit
    try:
        t0 = time.perf_counter()
        az.fit(trades)
        parts["fit_s"] = time.perf_counter() - t0
    finally:
        ti.RandomForestClassifier.fit = real_fit
        del az._permutation_importance
    xh = np.asarray([[t["features"][f] for f in az.feature_names] for t in held])
    return az, trades, xh, parts


def research_forest_cpu():
    """The CPU run of phase research (c), printed as one JSON line:
    `python3 -c "import chip_smoke; chip_smoke.research_forest_cpu()"`."""
    import torch

    torch.set_num_threads(4)              # beside the card's host work and two CLIs
    az, _, xh, parts = research_forest_fit("cpu")
    keep = [az.feature_names.index(f) for f in az.kept_features]
    print(json.dumps({"importances": az.importances, "kept": az.kept_features,
                      "digest": forest_digest(az.model),
                      "pruned_digest": forest_digest(az.pruned_model),
                      "proba": az.model.predict_proba(xh).tolist(),
                      "pruned_proba": az.pruned_model.predict_proba(xh[:, keep]).tolist(),
                      "parts": parts}), flush=True)


def research_env():
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    return root, {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}


class Beside:
    """A subprocess started now, to run beside what follows: `finish()`
    waits for it and returns (exit code, stdout, stderr, its own wall s);
    `stop()` kills it if it still runs.  ``env`` adds variables to its
    environment."""

    def __init__(self, argv, cwd, env=None):
        import threading

        _, base = research_env()
        env = {**base, **(env or {})}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.box = {}
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        self.box["out"] = self.proc.communicate()
        self.box["s"] = time.perf_counter() - self.t0

    def finish(self, timeout=600):
        self.thread.join(timeout)
        if self.thread.is_alive():
            self.stop()
            fail(f"a subprocess ran over {timeout} s: {self.proc.args}")
        out, err = self.box["out"]
        return self.proc.returncode, out, err, self.box["s"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.thread.join(60)


class BesideCall:
    """``fn(*args)`` on a thread, beside what follows (``fn`` runs
    subprocesses only, so no launch count of this process moves):
    `result()` waits and returns its value or raises its error."""

    def __init__(self, fn, *args):
        import threading

        self.box = {}
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.box["out"] = fn(*args)
        except BaseException as ex:   # noqa: BLE001 — raised again by result()
            self.box["error"] = ex

    def result(self, timeout=900):
        self.thread.join(timeout)
        if self.thread.is_alive():
            fail(f"a call beside the phase ran over {timeout} s")
        if "error" in self.box:
            raise self.box["error"]
        return self.box["out"]


def research_cli_argv(*args):
    return [sys.executable, "-m", "ai_crypto_trader_tpu_torch.cli", *args]


def research_cli(tmp, fetch):
    """(a) The reference's `run_backtest.py` workflow in a temporary cwd:
    `cli fetch --days 7 --seed 5` (``fetch``, a subprocess started at the
    phase's start), then `cli backtest` (one strategy, then a sweep) in
    this process on the card, `cli list` and `analyze`; `cli report` is
    started as a subprocess and returned.  The single backtest must equal
    a direct run over the fetched series (and differ from one over the
    seed-0 series it would have generated), `list` name both runs,
    `analyze` print the run's JSON.  Returns (report so far, the report's
    subprocess)."""
    import contextlib as ctx
    import io
    import os

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.backtest import (
        compute_metrics, default_params, prepare_inputs, run_backtest)
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import compute_indicators
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    times = {}
    rc, out, err, times["fetch_subprocess_s"] = fetch.finish()
    n = RES_FETCH_DAYS * 1440
    csv_rel = os.path.join("backtesting", "data", "market", "BTCUSDC", "BTCUSDC_1m.csv")
    if rc != 0 or out.strip() != f"saved {n} candles -> {csv_rel}":
        fail(f"research: cli fetch exited {rc}: {out[-300:]} {err[-500:]}")
    res_dir = os.path.join(tmp, "backtesting", "results")
    here = os.getcwd()
    files, texts = {}, {}
    sweep_kernel.launches = fused_ewma.launches = 0
    os.chdir(tmp)
    try:
        for name, argv in (("single", ["backtest", "--days", str(RES_FETCH_DAYS)]),
                           ("sweep", ["backtest", "--days", str(RES_FETCH_DAYS),
                                      "--sweep", str(RES_SWEEP)])):
            before = set(os.listdir(res_dir)) if os.path.isdir(res_dir) else set()
            if before:
                time.sleep(1.0)           # the result file is named to the second
            t0 = time.perf_counter()
            buf = io.StringIO()
            with ctx.redirect_stdout(buf):
                cli.main(argv)
            times[f"backtest_{name}_s"] = time.perf_counter() - t0
            new = sorted(set(os.listdir(res_dir)) - before)
            if len(new) != 1:
                fail(f"research: cli backtest ({name}) wrote {new}")
            files[name] = new[0]
        launches = {"replay_sweep": sweep_kernel.launches, "fused_ewma": fused_ewma.launches}
        t0 = time.perf_counter()
        for name, argv in (("list", ["list"]),
                           ("analyze", ["analyze", "--file",
                                        os.path.join(res_dir, files["single"])])):
            buf = io.StringIO()
            with ctx.redirect_stdout(buf):
                cli.main(argv)
            texts[name] = buf.getvalue()
        times["list_analyze_s"] = time.perf_counter() - t0
    finally:
        os.chdir(here)
    report = Beside(research_cli_argv("report", "--out", "report.html"), tmp)
    results = {}
    for name, f in files.items():
        with open(os.path.join(res_dir, f)) as fh:
            results[name] = json.load(fh)
    if json.loads(texts["analyze"]) != results["single"]:
        fail("research: cli analyze did not print the run's JSON")
    lines = texts["list"].splitlines()
    if len(lines) != 2 or sorted(ln.split(":")[0] for ln in lines) != sorted(files.values()):
        fail(f"research: cli list printed {lines}")

    # the single run loaded the fetched CSV: a direct run over the fetched
    # series gives its numbers, one over the series it would have
    # generated does not
    def direct(seed):
        d = {k: v for k, v in generate_ohlcv(n=n, seed=seed).items() if k != "regime"}
        inp = prepare_inputs(compute_indicators(d, device="cuda"), device="cuda")
        stats, curve = run_backtest(inp, default_params(device="cuda"), use_param_sl_tp=True,
                                    return_curve=True, device="cuda")
        m = {k: float(v) for k, v in compute_metrics(stats, device="cuda").items()}
        c = curve.cpu().numpy()
        m["equity_curve"] = [round(float(v), 2) for v in c[::max(len(c) // 500, 1)]]
        return m

    fetched, generated = direct(RES_FETCH_SEED), direct(0)
    single = results["single"]
    if any(single[k] != v for k, v in fetched.items()):
        fail("research: cli backtest's numbers are not those of the fetched series")
    if all(single[k] == v for k, v in generated.items()):
        fail("research: the fetched and the generated series give the same backtest")
    return {"files": files, "results": results, "candles": n,
            "single_equals_fetched_series": True, "launches": launches, "part_s": times}, report


def research_report(tmp, out, report):
    """(a)'s end: `cli report`'s summary counts two runs with the best
    Sharpe's file as `best_run`, and its HTML is written."""
    import os

    rc, text, err, out["part_s"]["report_subprocess_s"] = report.finish()
    if rc != 0:
        fail(f"research: cli report exited {rc}: {err[-500:]}")
    summary = json.loads(text[:text.rindex("}") + 1])
    files, results = out["files"], out.pop("results")
    best = max(files, key=lambda k: results[k]["sharpe_ratio"])
    html_path = os.path.join(tmp, "report.html")
    html = open(html_path).read() if os.path.exists(html_path) else ""
    if summary["n_runs"] != 2 or summary["best_run"] != files[best] or \
            "wrote report.html" not in text or "<h2>Backtest report</h2>" not in html or \
            ("equity_curve" in results[best]) != ("<svg" in html):
        fail(f"research: cli report printed {summary} (best {files[best]}), "
             f"HTML of {len(html)} bytes")
    out["part_s"]["workflow_s"] = sum(out["part_s"].values())
    out.update({"best_run": summary["best_run"], "n_runs": summary["n_runs"],
                "summary": summary, "html_bytes": len(html)})
    return out


def research_queue():
    """(b) RES_SYMBOLS × RES_PARAMS jobs, each one strategy over a 30-day
    1m series (T = RES_T), through `BacktestQueue` on the card with a port
    `EventBus`: K1 and K2 launches counted (one K1 launch a job); every
    record's metrics equal to a direct `compute_metrics(evolvable_backtest
    (...))` on the card, bit for bit; 16 publications in job order; the
    first job's K1 launch held bit for bit against the plain loop over its
    whole series (graph-replayed) and its K2 launches held against the plain
    EWMA; ms a job and the queue latencies (the store's wall clock)."""
    import asyncio
    import math

    import torch

    from ai_crypto_trader_tpu_torch.backtest import compute_metrics, default_params, sample_params
    from ai_crypto_trader_tpu_torch.backtest.evolvable import evolvable_backtest
    from ai_crypto_trader_tpu_torch.backtest.queue import BacktestQueue
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import dynamic
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.shell import EventBus

    symbols = [f"R{i:02d}USDC" for i in range(RES_SYMBOLS)]
    series = {s: {k: v for k, v in generate_ohlcv(n=RES_T, seed=40 + i).items()
                  if k != "regime"} for i, s in enumerate(symbols)}
    drawn = sample_params(torch.Generator().manual_seed(18), 1, device="cuda")
    param_sets = [default_params(device="cuda"),
                  drawn._replace(**{f: getattr(drawn, f)[0] for f in drawn._fields})]
    jobs = [(f"{s}_p{j}", series[s], p) for s in symbols for j, p in enumerate(param_sets)]
    bus = EventBus()
    sub = bus.subscribe("backtest_results")
    queue = BacktestQueue(bus=bus, device="cuda")
    for name, d, p in jobs:
        queue.add_backtest_task(d, p, name=name)
    rec_dyn, dyn_entry = [], dynamic.fused_ewma_jobs

    def dyn_recording(jobs_, device=None):
        rec_dyn.append([(x, a, st) for x, a, st in jobs_])
        return dyn_entry(jobs_, device=device)

    sweep_kernel.launches = fused_ewma.launches = 0
    dynamic.fused_ewma_jobs = dyn_recording
    try:
        with recording_ewma([]) as rec_ind, recording_k1([]) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ran = asyncio.run(queue.process_task_queue(max_tasks=1))
            first_k2 = rec_dyn + rec_ind
            ran += asyncio.run(queue.process_task_queue())
            torch.cuda.synchronize()
            drain_s = time.perf_counter() - t0
    finally:
        dynamic.fused_ewma_jobs = dyn_entry
    k1_launches, k2_launches = sweep_kernel.launches, fused_ewma.launches
    if ran != len(jobs) or queue.pending or k1_launches != len(jobs) or \
            len(calls) != len(jobs) or k2_launches != len(rec_dyn) + len(rec_ind) or \
            not first_k2:
        fail(f"research: the queue ran {ran} of {len(jobs)} jobs with {k1_launches} K1 and "
             f"{k2_launches} K2 launches ({len(rec_dyn) + len(rec_ind)} recorded)")
    envelopes = [sub.get_nowait() for _ in range(sub.qsize())]
    if [e["data"]["id"] for e in envelopes] != [j[0] for j in jobs]:
        fail(f"research: the bus carried {[e['data']['id'] for e in envelopes]}")
    t0 = time.perf_counter()
    for name, d, p in jobs:
        m = compute_metrics(evolvable_backtest(d, p, device="cuda"), device="cuda")
        vals = torch.stack([v.reshape(()).to(torch.float64) for v in m.values()]).cpu().tolist()
        got = queue.get_result(name)["metrics"]
        if list(got) != list(m) or any(
                not (a == b or (math.isnan(a) and math.isnan(b)))
                for a, b in zip(got.values(), vals)):
            fail(f"research: job {name}'s metrics differ from a direct run on the card")
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k1 = held_k1(calls[:1], "research_queue_job0")
    k2 = recorded_k2(first_k2, "research_queue_job0")
    held_s = time.perf_counter() - t0
    bounds = [replay_rows_bound_ms(out, i, kw["warmup"]) for i, _, kw, out in calls]
    all_ms = cuda_ms(lambda: [sweep_kernel(i, p, **kw) for i, p, kw, _ in calls], 3)
    lat = [queue.get_result(j[0])["queue_latency_s"] for j in jobs]
    trades = [queue.get_result(j[0])["metrics"]["total_trades"] for j in jobs]
    return {"jobs": len(jobs), "symbols": RES_SYMBOLS, "param_sets": RES_PARAMS, "T": RES_T,
            "drain_s": drain_s, "ms_per_job": 1e3 * drain_s / len(jobs),
            "queue_latency_s": {"first": lat[0], "p50": percentile(lat, 50), "last": lat[-1]},
            "k1_launches": k1_launches, "k2_launches": k2_launches,
            "k2_launches_per_job": k2_launches / len(jobs), "trades": trades,
            "metrics_equal_direct": True, "direct_s": direct_s, "held_s": held_s,
            "k1": {**k1, "all_launches_ms": all_ms,
                   "all_bound_ms": sum(b[0] for b in bounds)},
            "k2": {k: v for k, v in k2.items() if k != "launch_shapes"}}


def research_forest(cpu_proc):
    """(c) The analyzer at the reference's defaults on the card: the fit's
    host time and the permutation importance's ms (one batched prediction,
    one read; timed again warm) beside the reference's loop order (571
    `predict` calls on the card, each with its read), the two equal; the
    CPU run of the same model (``cpu_proc``, started at the phase's start)
    equal in every importance, the same trees, probabilities within
    RES_PROBA_ATOL on held-out rows and the same predictions; the two
    drivers ranked first."""
    import numpy as np
    import torch

    az, trades, xh, parts = research_forest_fit("cuda")
    X, y = az._xy(trades)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = az._permutation_importance(az.model, X, y)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    if again != az.importances["permutation"]:
        fail("research: the permutation importance changed between two runs on the card")
    rng = np.random.default_rng(az.seed)
    calls = [0]

    def predict(xp):
        calls[0] += 1
        return az.model.predict(xp)

    t0 = time.perf_counter()
    base = (predict(X) == y).mean()
    loop = {}
    for j, f in enumerate(az.feature_names):
        drops = []
        for _ in range(az.n_permutation_repeats):
            xp = X.copy()
            xp[:, j] = rng.permutation(xp[:, j])
            drops.append(base - (predict(xp) == y).mean())
        loop[f] = float(max(np.mean(drops), 0.0))
    loop_ms = 1e3 * (time.perf_counter() - t0)
    if loop != az.importances["permutation"]:
        fail("research: the batched permutation importance differs from the reference loop")
    keep = [az.feature_names.index(f) for f in az.kept_features]
    proba, pruned = az.model.predict_proba(xh), az.pruned_model.predict_proba(xh[:, keep])
    rc, out, err, cpu_s = cpu_proc.finish()
    if rc != 0:
        fail(f"research: the CPU run exited {rc}: {err[-800:]}")
    cpu = json.loads(out.strip().splitlines()[-1])
    if cpu["digest"] != forest_digest(az.model) or \
            cpu["pruned_digest"] != forest_digest(az.pruned_model):
        fail("research: the CPU run fitted other trees")
    if json.loads(json.dumps(az.importances)) != cpu["importances"] or \
            cpu["kept"] != az.kept_features:
        fail("research: the importances on the card differ from the CPU run's")
    errs = []
    for got, ref in ((proba, cpu["proba"]), (pruned, cpu["pruned_proba"])):
        ref = np.asarray(ref)
        errs.append(float(np.abs(got - ref).max()))
        if errs[-1] > RES_PROBA_ATOL or not np.array_equal(got.argmax(1), ref.argmax(1)):
            fail(f"research: predict_proba on the card differs from the CPU's by {errs[-1]}")
    ranked = sorted(az.importances["combined"], key=az.importances["combined"].get,
                    reverse=True)
    if sorted(ranked[:2]) != sorted(RES_DRIVERS):
        fail(f"research: the forest ranks {ranked[:4]} first, not {RES_DRIVERS}")
    return az, {"trades": RES_TRADES, "features": len(az.feature_names),
                "trees": az.n_trees, "repeats": az.n_permutation_repeats,
                "fit_s": parts["fit_s"], "forest_fit_s": parts["forest_fit_s"],
                "permutation_ms": parts["permutation_ms"][0], "permutation_warm_ms": warm_ms,
                "permutation_rows": X.shape[0] * (X.shape[1] * az.n_permutation_repeats + 1),
                "forest_depth": az.model.depth,
                "reference_loop_ms": loop_ms, "reference_loop_predict_calls": calls[0],
                "kept_features": az.kept_features, "ranked": ranked[:4],
                "groups": az.importances["groups"],
                "recommendations": az.importances["recommendations"],
                "importances_equal_cpu": True, "proba_max_abs_err": max(errs),
                "cpu_parts": cpu["parts"], "cpu_subprocess_s": cpu_s}


def research_gate(az):
    """(d) `SignalAnalyzer.run_once` over phase live's tape (64 × 4 × 256)
    for RES_GATE_TICKS ticks from phase live's first BUY tick, on the card,
    with a `FeatureImportanceIntegrator` over the fitted analyzer as its
    outcome gate; the port's CPU analyzer with the same model on the CPU
    over the same market updates: the same signals (probabilities within
    RES_PROBA_ATOL); the gate's ms a call."""
    import asyncio
    import copy

    from ai_crypto_trader_tpu_torch.shell import EventBus, LLMTrader, SignalAnalyzer
    from ai_crypto_trader_tpu_torch.strategy import FeatureImportanceIntegrator

    def integrator(analyzer):
        integ = FeatureImportanceIntegrator()
        integ.update_from_analyzer(analyzer)
        return integ

    card = integrator(az)
    call_ms = []
    real = card.predict_trade_outcome

    def timed_predict(features):
        t0 = time.perf_counter()
        out = real(features)
        call_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    card.predict_trade_outcome = timed_predict
    tape = TickTape(S_TICK, T_TICK)
    rig = LiveRig(tape, "cuda", tape.n - 48 + 3, executor=False)
    rig.analyzer.outcome_model = card
    rig.analyzer._queue()                     # subscribed before the first poll
    updates, card_signals, clocks = [], [], []
    for _ in range(RES_GATE_TICKS):
        rig.advance()
        rig.poll()
        updates.append([rig.updates.get_nowait()["data"] for _ in range(rig.updates.qsize())])
        clocks.append(rig.clock[0])
        asyncio.run(rig.analyzer.run_once())
        card_signals.append([rig.signals.get_nowait()["data"]
                             for _ in range(rig.signals.qsize())])
    az_cpu = copy.copy(az)
    az_cpu.device, az_cpu.model, az_cpu.pruned_model = \
        "cpu", az.model.to("cpu"), az.pruned_model.to("cpu")
    clock = [0.0]
    bus = EventBus(now_fn=lambda: clock[0])
    sig = bus.subscribe("trading_signals")
    ana = SignalAnalyzer(bus, trader=LLMTrader(model_version="chip_smoke"),
                         now_fn=lambda: clock[0], outcome_model=integrator(az_cpu))
    ana._queue()
    cpu_signals = []
    for t, ups in enumerate(updates):
        clock[0] = clocks[t]

        async def publish(ups=ups):
            for u in ups:
                await bus.publish("market_updates", u)

        asyncio.run(publish())
        asyncio.run(ana.run_once())
        cpu_signals.append([sig.get_nowait()["data"] for _ in range(sig.qsize())])
    worst, vetoed, passed, probs = 0.0, 0, 0, []
    for t, (a, b) in enumerate(zip(card_signals, cpu_signals)):
        if [(s["symbol"], s["decision"]) for s in a] != [(s["symbol"], s["decision"]) for s in b]:
            fail(f"research: the gated decisions of tick {t} differ card vs CPU")
        for sa, sb in zip(a, b):
            pa, pb = sa.pop("success_probability", None), sb.pop("success_probability", None)
            if (pa is None) != (pb is None):
                fail(f"research: the gate was consulted on one side only ({sa['symbol']})")
            if pa is not None:
                probs.append(pa)
                worst = max(worst, abs(pa - pb))
                vetoed += "outcome gate" in sa["reasoning"]
                passed += sa["decision"] == "BUY"
            sa.pop("reasoning"), sb.pop("reasoning")
            if sa != sb:
                fail(f"research: tick {t}'s signal for {sa['symbol']} differs card vs CPU")
    if not call_ms or worst > RES_PROBA_ATOL:
        fail(f"research: {len(call_ms)} gate calls, probabilities apart by {worst}")
    return {"ticks": RES_GATE_TICKS, "updates": sum(len(u) for u in updates),
            "signals": sum(len(s) for s in card_signals), "gate_calls": len(call_ms),
            "vetoed": vetoed, "passed": passed,
            "success_probability": {"min": min(probs), "p50": percentile(probs, 50),
                                    "max": max(probs)},
            "predict_ms": {"p50": percentile(call_ms, 50), "p99": percentile(call_ms, 99)},
            "probability_max_abs_err": worst, "decisions_equal_cpu": True}


def phase_research(info):
    """The research shell on the card: (a) `cli fetch` → `cli backtest` →
    `cli list` / `analyze` / `report` (`research_cli`, `research_report`);
    (b) the backtest queue (`research_queue`); (c) the trade-outcome forest
    at the reference's defaults (`research_forest`); (d) the integrator as
    the live path's outcome gate (`research_gate`).  The CPU run of (c),
    `cli fetch` and `cli report` are subprocesses that run beside the
    card's work: the first two from the phase's start, the report from the
    end of (a)'s in-process commands.  Returns the kernels line's entries:
    (K2 block, K1 block)."""
    import tempfile

    t_phase = time.perf_counter()
    root, _ = research_env()
    times, running = {}, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            running.append(Beside([sys.executable, "-c",
                                   "import chip_smoke; chip_smoke.research_forest_cpu()"], root))
            running.append(Beside(research_cli_argv("fetch", "--days", str(RES_FETCH_DAYS),
                                                    "--seed", str(RES_FETCH_SEED)), tmp))
            cpu_proc, fetch = running
            t0 = time.perf_counter()
            queue = research_queue()
            times["queue_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli_out, report = research_cli(tmp, fetch)
            running.append(report)
            times["cli_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            az, forest = research_forest(cpu_proc)
            times["forest_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gate = research_gate(az)
            times["gate_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli_out = research_report(tmp, cli_out, report)
            times["report_wait_s"] = time.perf_counter() - t0
    finally:
        for b in running:
            b.stop()
    k1, k2 = queue["k1"], queue["k2"]
    emit({"phase": "research", "card": info["nvidia_smi"], "cli": cli_out, "queue": queue,
          "forest": forest, "gate": gate, "part_s": times,
          "phase_s": time.perf_counter() - t_phase})
    cli_launches = cli_out["launches"]
    return ({"launches": queue["k2_launches"] + cli_launches["fused_ewma"],
             "launches_by_path": {"queue": queue["k2_launches"],
                                  "cli_backtest": cli_launches["fused_ewma"]},
             "launches_held": len(k2["ms_per_launch"]),
             **{k: k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "max_rel_err")},
             "library_ms": None,
             "shape": f"one queue job's launches at T={RES_T} (ms/plain/bound)"},
            {"launches": queue["k1_launches"] + cli_launches["replay_sweep"],
             "launches_by_path": {"queue": queue["k1_launches"],
                                  "cli_backtest": cli_launches["replay_sweep"]},
             **{k: k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                   "trades", "shapes", "all_launches_ms", "all_bound_ms")},
             "library_ms": None,
             "shape_note": f"ms/plain/bound: the first job's launch, B=1 x T={RES_T}, "
                           f"against the graph-replayed plain loop; all_launches_ms: the "
                           f"queue's {queue['k1_launches']} launches"})


# --- phase mesh: the population seams on a mesh ----------------------------

MESH_N = 4                   # shards of the virtual mesh: the one card listed 4 times
MESH_RAGGED_B = 4_098        # (a): a ragged population, padded to 4,100
MESH_GA_RAGGED = 250         # (b): a ragged GA population, padded to 252
MESH_TENANTS, MESH_TENANTS_RAGGED = 256, 250   # (c): tenants × S_TICK symbols
MESH_DECIDES = 3             # (c): decides a tenant engine makes
MESH_LOB_T = 32              # (c): lob_sweep steps (its row's 256, cut in depth)
MESH_PBT_I = 4               # (c): iterations of the pbt generation (its row's 64, cut)
MESH_HPO_TRIALS = 4          # (c): HPO trials (rung epochs 1 and 1, one finalist)
MESH_HPO_ROWS = 400          # (c): their feature rows (4 columns of the year's candles)
MESH_EMA_WINDOWS = (12, 26, 200)   # (d): the JAX tests' windows
MESH_MEAN_WINDOWS = (5, 20, 50)
MESH_TS_RTOL, MESH_TS_ATOL = 2e-5, 1e-4      # tests/test_time_shard.py's EMA tolerance
MESH_MEAN_ATOL = 1e-3                         # and its rolling mean's
MESH_LC_TOL = 2e-4           # (e): tests/test_long_context.py's forward rtol and atol
MESH_LC_GRAD_RTOL, MESH_LC_GRAD_ATOL = 5e-3, 5e-4   # and its gradients'
MESH_HPO_KW = dict(n_trials=MESH_HPO_TRIALS, rung_epochs=(1, 1), survivor_fraction=0.25,
                   seq_len=16, n_startup=MESH_HPO_TRIALS, device="cuda")
MESH_RANKS = 2               # (g): rank processes that share the card over gloo
MESH_LOCAL = 2               # (g), (f): local shards a rank drives on the hybrid mesh (the
                             # card twice); (g)'s MESH_RANKS × MESH_LOCAL is (d)'s MESH_N
MESH_RANK_TIMEOUT_S = 300    # (g): each rank's limit (the group's collectives time out too)

# (f): NCCL at world size 1 — an all_reduce on the data group, one
# population_eval and one ring step (forward and gradient) through the
# process-mesh code, held against the plain results at argv's tolerances;
# then the same two on the hybrid mesh of the card argv[4] times a rank
_DIST_PROBE = r"""
import json, socket, sys, torch, torch.distributed as dist
from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, initialize_distributed
from ai_crypto_trader_tpu_torch.parallel.mesh import TRANSPORT, process_group, process_mesh
from ai_crypto_trader_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_self_attention)
tol, grad_rtol, grad_atol = (float(a) for a in sys.argv[1:4])
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
backend = initialize_distributed(f"127.0.0.1:{port}", 1, 0)
x = torch.full((4,), 2.0, device="cuda")
dist.all_reduce(x, group=process_group().group)
part = MeshPartitioner(process_mesh())
pop = torch.arange(40.0, device="cuda").reshape(10, 4)
out = part.population_eval(lambda t: {"sq": t * t, "sum": t.sum(-1)}, name="probe")(pop)
g = torch.Generator(device="cuda").manual_seed(5)
q, k, v = (torch.randn(64, 2, 8, generator=g, device="cuda").requires_grad_(True)
           for _ in range(3))
o = ring_self_attention(q, k, v, part.mesh)
grads = torch.autograd.grad(o.square().sum(), [q, k, v])
ref = reference_attention(q, k, v)
ref_grads = torch.autograd.grad(ref.square().sum(), [q, k, v])
torch.cuda.synchronize()
mesh = {"population_eval": bool(torch.equal(out["sq"], pop * pop)
                                and torch.equal(out["sum"], pop.sum(-1))),
        "ring_forward": bool(((o - ref).abs() <= tol + tol * ref.abs()).all()),
        "ring_grad": all(bool(((a - b).abs() <= grad_atol + grad_rtol * b.abs()).all())
                         for a, b in zip(grads, ref_grads)),
        "ring_max_abs_err": float((o - ref).abs().max()),
        "transport": TRANSPORT.counts(), "describe": part.describe()}
TRANSPORT.reset()
hpart = MeshPartitioner(process_mesh(local_devices=["cuda:0"] * int(sys.argv[4])))
hout = hpart.population_eval(lambda t: {"sq": t * t, "sum": t.sum(-1)}, name="hybrid")(pop)
ho = ring_self_attention(q, k, v, hpart.mesh)
hgrads = torch.autograd.grad(ho.square().sum(), [q, k, v])
torch.cuda.synchronize()
hybrid = {"population_eval": bool(torch.equal(hout["sq"], pop * pop)
                                  and torch.equal(hout["sum"], pop.sum(-1))),
          "ring_forward": bool(((ho - ref).abs() <= tol + tol * ref.abs()).all()),
          "ring_grad": all(bool(((a - b).abs() <= grad_atol + grad_rtol * b.abs()).all())
                           for a, b in zip(hgrads, ref_grads)),
          "ring_max_abs_err": float((ho - ref).abs().max()),
          "transport": TRANSPORT.counts(), "describe": hpart.describe()}
print("DIST_OK", backend, dist.get_world_size(), dist.get_rank(), x.tolist(), flush=True)
print("DIST_MESH", json.dumps(mesh), flush=True)
print("DIST_HYBRID", json.dumps(hybrid), flush=True)
dist.destroy_process_group()
"""


def mesh_partitioners():
    """The virtual mesh (the card MESH_N times) and, with more than one
    card, the mesh of min(MESH_N, n) real cards: {name: MeshPartitioner}."""
    import torch

    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, make_mesh

    out = {"virtual": MeshPartitioner(make_mesh(MESH_N, devices=["cuda:0"] * MESH_N))}
    n = torch.cuda.device_count()
    if n > 1:
        k = min(MESH_N, n)
        out["real"] = MeshPartitioner(make_mesh(k, devices=[f"cuda:{i}" for i in range(k)]))
    return out


def same_tree(a, b, label):
    """Two trees of tensors or arrays equal bit for bit, leaf by leaf
    through `same_host_bits` (a float of any width by its bytes: NaN where
    NaN)."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_flatten

    def host(v):
        v = np.ascontiguousarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        return (v.dtype, v.shape, v.reshape(-1).view(np.uint8) if v.dtype.kind == "f" else v)

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        fail(f"mesh: {label}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(map(host, la), map(host, lb))):
        if x[:2] != y[:2] or not same_host_bits(x[2], y[2]):
            fail(f"mesh: {label}: leaf {i} not bit for bit")


def mesh_sweep(part, inp, params, stats):
    """(a) the bench headline's sweep through the mesh: exactly MESH_N K1
    launches of B / MESH_N strategies, the stats and metrics bit for bit
    against phase main's single launch, no synchronizing call; the ragged
    MESH_RAGGED_B against its single launch; both timed beside one launch.
    ``launches``: the sum of the counts read after each of the three
    counted runs (the checked run, the sync check, the ragged run)."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import compute_metrics, sample_params, sweep
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    def counted_run(label, fn):
        sweep_kernel.launches = 0
        out = fn()
        if sweep_kernel.launches != MESH_N:
            fail(f"mesh: the {label} made {sweep_kernel.launches} K1 launches, not {MESH_N}")
        runs[label] = sweep_kernel.launches
        return out

    def recorded():
        with recording_k1(calls):       # counts on the wrapper, handed back at the end
            return sweep(inp, params, partitioner=part, device="cuda")

    runs, calls = {}, []
    got = counted_run("sweep", recorded)
    shard_b = [int(p.stop_loss.numel()) for _, p, _, _ in calls]
    if shard_b != [B_FULL // MESH_N] * MESH_N:
        fail(f"mesh: the sweep's K1 launches were of {shard_b}, not {MESH_N} of "
             f"{B_FULL // MESH_N}")
    del calls
    err = compare_stats(got, stats, "mesh_sweep")["max_abs_err"]
    same_tree(compute_metrics(got, device="cuda"), compute_metrics(stats, device="cuda"),
              "the sweep's metrics")
    syncs = counted_run("sync check", lambda: sync_calls(
        lambda: sweep(inp, params, partitioner=part, device="cuda")))
    if syncs:
        fail(f"mesh: the sweep made synchronizing calls: {syncs[:2]}")
    ragged = sample_params(torch.Generator().manual_seed(1), MESH_RAGGED_B, device="cuda")
    single = sweep(inp, ragged, device="cuda")
    got_r = counted_run("ragged sweep",
                        lambda: sweep(inp, ragged, partitioner=part, device="cuda"))
    err = max(err, compare_stats(got_r, single, "mesh_sweep_ragged")["max_abs_err"])
    ms = cuda_ms(lambda: sweep(inp, params, partitioner=part, device="cuda"), 5)
    single_ms = cuda_ms(lambda: sweep(inp, params, device="cuda"), 5)
    return {"launches": sum(runs.values()), "launches_by_run": runs, "shard_B": shard_b,
            "ms": ms, "single_launch_ms": single_ms, "max_abs_err": err,
            "ragged": {"B": MESH_RAGGED_B, "padded": MESH_RAGGED_B + part.pad_for(MESH_RAGGED_B)},
            "bit_for_bit": "stats and metrics against phase main's launch", "syncs": 0}


def mesh_ga(part, d_year):
    """(b) `run_ga` at `GAParams(256, 3)` over 43,200 candles and at a
    ragged 250: the mesh run bit for bit against the single device on the
    same generator, K1 launches counted in both mesh runs at each size (G +
    1 evaluations, MESH_N launches each), one host read a run and no other
    sync."""
    import torch

    from ai_crypto_trader_tpu_torch.backtest import default_params
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import ga
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel

    d = {k: v[:T_GA] for k, v in d_year.items()}
    fused_ewma.launches = 0
    fit = ga.backtest_fitness(d, device="cuda")
    k2 = fused_ewma.launches
    gen = lambda: torch.Generator(device="cuda").manual_seed(11)  # noqa: E731
    out, k1 = {}, 0
    for pop in (POP_GA, MESH_GA_RAGGED):
        cfg = GAParams(population_size=pop, generations=GENS_GA)
        seed = default_params(device="cuda")
        one = ga.run_ga(gen(), fit, cfg, seed_params=seed, device="cuda")
        with counted(ga, "host_read") as reads:
            sweep_kernel.launches = 0
            t0 = time.perf_counter()
            got = ga.run_ga(gen(), fit, cfg, seed_params=seed, partitioner=part, device="cuda")
            wall = time.perf_counter() - t0
            launches = [sweep_kernel.launches]
        quiet = []
        real = quiet_counted_read(ga, quiet)
        try:
            sweep_kernel.launches = 0
            syncs = sync_calls(lambda: ga.run_ga(gen(), fit, cfg, seed_params=seed,
                                                 partitioner=part, device="cuda"))
            launches.append(sweep_kernel.launches)
        finally:
            ga.host_read = real
        if launches != [(GENS_GA + 1) * MESH_N] * 2 or len(reads) + len(quiet) != 2 or syncs:
            fail(f"mesh: the GA at {pop} made {launches} K1 launches in 2 runs, "
                 f"{len(reads) + len(quiet)} reads and {len(syncs)} other syncs ({syncs[:2]})")
        if got[1] != one[1]:
            fail(f"mesh: the GA's history at {pop} differs from the single device's")
        same_tree(tuple(got[0]), tuple(one[0]), f"the GA's best genome at {pop}")
        SHARED.setdefault("mesh_single_ga", {})[pop] = one
        k1 += sum(launches)
        out[str(pop)] = {"k1_launches_by_run": launches, "wall_s": wall,
                         "best_fitness": one[1][-1]["best_fitness"]}
    out["k2_launches_tables"] = k2
    return out, k1, k2


def mesh_tenant(part):
    """(c) `TenantEngine` at 256 tenants × 64 symbols (and a ragged 250, no
    power-of-two pad): MESH_DECIDES decides with the fleet observatory on,
    out, state and fleet aggregates bit for bit against the single
    engine's, one host read a decide and no other sync."""
    import numpy as np

    from ai_crypto_trader_tpu_torch.config import TradingParams
    from ai_crypto_trader_tpu_torch.obs import fleetscope
    from ai_crypto_trader_tpu_torch.ops import tenant_engine as te

    symbols = [f"M{i:03d}USDC" for i in range(S_TICK)]
    trading = TradingParams(ai_confidence_threshold=0.0, min_signal_strength=0.0,
                            min_trade_amount=1.0)
    rng = np.random.default_rng(19)
    out = {}
    for n, pow2 in ((MESH_TENANTS, True), (MESH_TENANTS_RAGGED, False)):
        engines = [te.TenantEngine(symbols, n, trading, partitioner=p, pad_pow2=pow2,
                                   device="cuda") for p in (None, part)]
        for e in engines:
            e.set_tenant(7, balance=900.0)
        scopes = [fleetscope.FleetScope(top_k=8) for _ in engines]
        reads, syncs = [], []
        for t in range(MESH_DECIDES):
            S = engines[0].S
            feats = {"price": rng.uniform(50.0, 200.0, S).astype(np.float32),
                     "signal": rng.integers(-1, 2, S).astype(np.int32),
                     "strength": rng.uniform(40.0, 110.0, S).astype(np.float32),
                     "volatility": np.full(S, 0.015, np.float32),
                     "avg_volume": np.full(S, 6e4, np.float32), "valid": np.ones(S, bool)}
            with fleetscope.use(scopes[0]):
                ref = engines[0].decide(feats)
            last = t == MESH_DECIDES - 1
            with fleetscope.use(scopes[1]):
                if last:
                    box, real = {}, quiet_counted_read(te, reads)
                    try:
                        syncs = sync_calls(lambda: box.setdefault("o", engines[1].decide(feats)))
                    finally:
                        te.host_read = real
                    got = box["o"]
                else:
                    with counted(te, "host_read") as counted_reads:
                        got = engines[1].decide(feats)
                    reads += counted_reads
            same_tree(got, ref, f"the decide at {n} tenants, tick {t}")
            same_tree(engines[1]._state_np, engines[0]._state_np, f"the state at {n}, tick {t}")
            same_tree(engines[1].last_fleet, engines[0].last_fleet, f"the fleet at {n}")
        if len(reads) != MESH_DECIDES or syncs:
            fail(f"mesh: the decide at {n} tenants made {len(reads)} reads in {MESH_DECIDES} "
                 f"decides and {len(syncs)} other syncs ({syncs[:2]})")
        out[str(n)] = {"tenant_pad": engines[1].n_pad, "decides": MESH_DECIDES,
                       "devices": engines[1].last_stats["devices"],
                       "executable_last_decide": int(ref["exec"].sum())}
    return out


def mesh_lob(part):
    """(c) `lob_sweep` at 1,024 scenarios × 32 levels (MESH_LOB_T steps):
    the summary and the device series bit for bit against the single
    device on the same generator, one host read."""
    import torch

    from ai_crypto_trader_tpu_torch.sim import lob

    kw = dict(num_scenarios=LOB_B, steps=MESH_LOB_T, levels=LOB_LEVELS, device="cuda")
    gen = lambda: torch.Generator(device="cuda").manual_seed(13)  # noqa: E731
    one = lob.lob_sweep(gen(), **kw)
    with counted(lob, "host_read") as reads:
        got = lob.lob_sweep(gen(), partitioner=part, **kw)
    if len(reads) != 1 or got["stats"]["devices"] != part.device_count:
        fail(f"mesh: lob_sweep made {len(reads)} reads, devices {got['stats']['devices']}")
    same_tree(got["summary"], one["summary"], "lob_sweep's summary")
    same_tree(got["device"], one["device"], "lob_sweep's series")
    return {"scenarios": LOB_B, "steps": MESH_LOB_T, "levels": LOB_LEVELS,
            "wall_s": got["stats"]["wall_s"], "single_wall_s": one["stats"]["wall_s"]}


def mesh_pbt_configs(env):
    """(c), (g): the pbt row's fleet (PBT_P members) for one generation of
    MESH_PBT_I iterations."""
    from ai_crypto_trader_tpu_torch.rl import dqn, obs_size, population

    cfg = dqn.DQNConfig(state_size=obs_size(env), num_envs=1, rollout_len=8, hidden=(16,),
                        replay_capacity=128, batch_size=8, learn_steps_per_iter=1)
    return cfg, population.PBTConfig(population=PBT_P, generations=1,
                                     iters_per_generation=MESH_PBT_I, eval_steps=PBT_EVAL)


def mesh_pbt(part, env):
    """(c) one generation of the `pbt` row's fleet (16 members, MESH_PBT_I
    iterations) on the mesh against the single device on the same
    generator: every member's state, the fitness and the history bit for
    bit; one host read a generation."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.rl import dqn, population

    cfg, pcfg = mesh_pbt_configs(env)
    gen = lambda: torch.Generator(device="cuda").manual_seed(21)  # noqa: E731
    one = population.train_pbt(gen(), env, cfg, pcfg)
    SHARED["mesh_single_pbt"] = one
    with counted(population, "host_read") as reads:
        got = population.train_pbt(gen(), env, cfg, pcfg, partitioner=part)
    if len(reads) != 1:
        fail(f"mesh: the pbt generation made {len(reads)} host reads")
    la = dqn.tensor_leaves(dqn._drop(got.state.members))
    lb = dqn.tensor_leaves(dqn._drop(one.state.members))
    worst = max(float(torch.abs(la[k].double() - lb[k].double()).max()) for k in lb)
    fit = float(np.abs(got.fitness - one.fitness).max())
    if not (all(torch.equal(la[k], lb[k]) for k in lb) and got.history == one.history
            and same_host_bits(got.fitness, one.fitness)):
        fail(f"mesh: the pbt generation on the mesh is not bit for bit the single device's: "
             f"{worst:.3g} (state) and {fit:.3g} (fitness) off")
    return {"population": PBT_P, "iterations": MESH_PBT_I, "bit_for_bit": True,
            "state_max_abs_diff": worst, "fitness_max_abs_diff": fit}


def mesh_structures(part):
    """(c) one `evaluate_structures` call at `cli generate`'s fold shape on
    the mesh: bit for bit against phase strategy's single-device call on the
    same folds and pool (computed here if that phase left none), one read."""
    from ai_crypto_trader_tpu_torch.strategy import generator as gen

    folds, pool, single = SHARED.get("structures") or (None, None, None)
    if folds is None:
        folds, pool = generate_folds("cuda"), generate_pool()
        single = gen.evaluate_structures(folds, pool, device="cuda")
    with counted(gen, "host_read") as reads:
        t0 = time.perf_counter()
        got = gen.evaluate_structures(folds, pool, partitioner=part, device="cuda")
        wall = time.perf_counter() - t0
    if len(reads) != 1 or not same_host_bits(got, single):
        fail(f"mesh: evaluate_structures made {len(reads)} reads; scores {got.tolist()} "
             f"against {single.tolist()}")
    return {"folds": len(folds), "pool": len(pool), "call_s": wall}


def mesh_hpo_features(d_year):
    """(c), (g): the HPO farm's feature rows (4 columns of the year's candles)."""
    import numpy as np

    return np.stack([np.asarray(d_year[k][:MESH_HPO_ROWS], np.float32)
                     for k in ("close", "volume", "high", "low")], 1)


def mesh_hpo(part, d_year):
    """(c) an HPO farm of MESH_HPO_TRIALS trials (rung epochs 1 and 1, one
    finalist) round-robin over the mesh: the same trials and losses as the
    single device's on the same generator, each trial counted by meshprof.
    Then the farm over a mesh of the card and the CPU: the CPU's trials
    take their draws from the card's generator, so every trial on the card
    after one on the CPU has the single device's loss bit for bit."""
    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.models import hpo
    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, make_mesh
    from ai_crypto_trader_tpu_torch.utils import meshprof

    feats, kw = mesh_hpo_features(d_year), MESH_HPO_KW
    gen = lambda: torch.Generator(device="cuda").manual_seed(23)  # noqa: E731
    one = hpo.optimize_hyperparameters(gen(), feats, **kw)
    SHARED["mesh_single_hpo"] = one
    mp = meshprof.MeshProf()
    with meshprof.use(mp):
        t0 = time.perf_counter()
        got = hpo.optimize_hyperparameters(gen(), feats, partitioner=part, **kw)
        wall = time.perf_counter() - t0
    trials = sum(mp.trial_assignments.values())
    if got != one or trials != MESH_HPO_TRIALS + 1:
        fail(f"mesh: the HPO farm gave {got['best_val_loss']} over {trials} farmed trials, "
             f"the single device {one['best_val_loss']}")
    mixed = hpo.optimize_hyperparameters(
        gen(), feats, partitioner=MeshPartitioner(make_mesh(2, devices=["cuda:0", "cpu"])),
        **kw)
    # rung 0: trial i on device i mod 2; rung 1: the finalist on the card
    on_card = [i for i, (a, b) in enumerate(zip(mixed["trials"], one["trials"]))
               if a["rung"] == b["rung"] and (a["rung"] == 1 or i % 2 == 0)]
    if max(on_card, default=0) < 1 or any(
            mixed["trials"][i] != one["trials"][i] for i in on_card):
        fail(f"mesh: the card's trials of the card + CPU farm ({on_card}) differ from the "
             f"single device's: {mixed['trials']} against {one['trials']}")
    cpu_diff = [abs(a["val_loss"] - b["val_loss"]) for i, (a, b) in
                enumerate(zip(mixed["trials"], one["trials"])) if i not in on_card]
    if not all(np.isfinite(r["val_loss"]) for r in mixed["trials"]):
        fail(f"mesh: the card + CPU farm gave a loss that is not finite: {mixed['trials']}")
    return {"trials": trials, "assignments": dict(mp.trial_assignments), "wall_s": wall,
            "best_val_loss": got["best_val_loss"],
            "card_and_cpu": {"card_trials_bit_for_bit": on_card,
                             "other_trials_val_loss_diff": cpu_diff}}


def mesh_time_shard(part, d_year):
    """(d) the year's close (T = 525,600) split over the mesh: `sharded_ema`
    against the port's `ops.indicators.ema` (one K2 launch each, recorded
    and held against the plain EWMA) and `sharded_rolling_mean` against
    `rolling_mean` (the same windows in the same order: bit for bit), at
    the JAX tests' tolerances."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import indicators as ind
    from ai_crypto_trader_tpu_torch.parallel.time_shard import (
        sharded_ema, sharded_rolling_mean)

    x = torch.as_tensor(d_year["close"], dtype=torch.float32).cuda()
    mesh, worst = part.mesh, {}
    ctl = {}                 # the one-controller results (g)'s hybrid mesh is held against
    with recording_ewma([]) as recorded:
        refs = {w: ind.ema(x, w) for w in MESH_EMA_WINDOWS}
    for w, want in refs.items():
        got = ctl[f"ema_{w}"] = sharded_ema(x, w, mesh).gather()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            fail(f"mesh: sharded_ema({w}) has other NaNs than ops.indicators.ema")
        ok = ~torch.isnan(want)
        err = torch.abs(got[ok] - want[ok])
        if bool((err > MESH_TS_ATOL + MESH_TS_RTOL * torch.abs(want[ok])).any()):
            fail(f"mesh: sharded_ema({w}) is {float(err.max()):.3g} off ops.indicators.ema")
        worst[f"ema_{w}"] = {"max_abs_err": float(err.max()), "max_rel_err": float(
            (err / torch.abs(want[ok]).clamp_min(1e-30)).max())}
    for w in MESH_MEAN_WINDOWS:
        got, want = sharded_rolling_mean(x, w, mesh).gather(), ind.rolling_mean(x, w)
        if not same_bits(got.nan_to_num(), want.nan_to_num()) or not torch.equal(
                torch.isnan(got), torch.isnan(want)):
            fail(f"mesh: sharded_rolling_mean({w}) is not bit for bit rolling_mean")
        worst[f"rolling_mean_{w}"] = "bit for bit"
        ctl[f"mean_{w}"] = got
    SHARED["mesh_ema_refs"], SHARED["mesh_ts_ctl"] = refs, ctl
    ms = cuda_ms(lambda: sharded_ema(x, 26, mesh), 5)
    ref_ms = cuda_ms(lambda: ind.ema(x, 26), 5)
    return {"T": int(x.shape[-1]), "shards": MESH_N, "errors": worst,
            "sharded_ema_26_ms": ms, "ema_26_ms": ref_ms}, recorded_k2(recorded, "mesh_ema")


def mesh_lc_inputs():
    """(e), (g): the long-context model's [LC_T, LC_F] inputs and [LC_T, 1]
    targets (NaN where there is none), from numpy seed 29."""
    import numpy as np

    rng = np.random.default_rng(29)
    x = rng.normal(size=(LC_T, LC_F)).astype(np.float32)
    y = (rng.normal(size=(LC_T, 1)) * 1e-3).astype(np.float32)
    y[:16], y[-1] = float("nan"), float("nan")
    return x, y


def mesh_long_context(part):
    """(e) `LongContextTransformer` at its defaults over 16,384 × 8 with the
    ring over the mesh against the same weights dense: the forward and the
    loss gradient within tests/test_long_context.py's tolerances, each
    path's ms and peak memory."""
    import torch

    from ai_crypto_trader_tpu_torch.models import LongContextTransformer, long_context_loss

    x, y = (torch.from_numpy(a).cuda() for a in mesh_lc_inputs())
    models = {name: LongContextTransformer(LC_F, mesh=mesh, device="cuda",
                                           generator=torch.Generator().manual_seed(29))
              for name, mesh in (("dense", None), ("ring", part.mesh))}
    out, report = {}, {"T": LC_T, "features": LC_F, "shards": MESH_N}
    for name, model in models.items():
        params = dict(model.named_parameters())

        def fwd():
            with torch.no_grad():
                return model(x)["mean"]

        def grad():
            loss = long_context_loss(model, params, x, y)
            return loss, torch.autograd.grad(loss, list(params.values()))

        for part_name, fn in (("forward", fwd), ("loss_and_grad", grad)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, ms = timed(fn)
            report[f"{name}_{part_name}_ms"] = ms
            report[f"{name}_{part_name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out[(name, part_name)] = res
    a, b = out[("ring", "forward")], out[("dense", "forward")]
    report["forward_max_abs_err"] = float(torch.abs(a - b).max())
    if not bool(torch.isfinite(a).all()) or bool(
            (torch.abs(a - b) > MESH_LC_TOL + MESH_LC_TOL * torch.abs(b)).any()):
        fail(f"mesh: the ring forward is {report['forward_max_abs_err']:.3g} off the dense one")
    (lr, gr), (ld, gd) = out[("ring", "loss_and_grad")], out[("dense", "loss_and_grad")]
    SHARED["mesh_dense_lc"] = (b, ld, gd)
    flat_r, flat_d = torch.cat([g.reshape(-1) for g in gr]), torch.cat([g.reshape(-1) for g in gd])
    report["loss"] = [lr.item(), ld.item()]
    report["grad_max_abs_err"] = float(torch.abs(flat_r - flat_d).max())
    if bool((torch.abs(flat_r - flat_d)
             > MESH_LC_GRAD_ATOL + MESH_LC_GRAD_RTOL * torch.abs(flat_d)).any()):
        fail(f"mesh: the ring gradient is {report['grad_max_abs_err']:.3g} off the dense one")
    return report


def mesh_dist_finish(probe):
    """(f) the `initialize_distributed` subprocess: NCCL, world size 1, an
    all_reduce on the card, DIST_OK; one `population_eval` and one ring
    step (forward and gradient) through the process mesh over the NCCL
    transport, against the plain results, nothing staged; the same on the
    hybrid mesh of the card MESH_LOCAL times (the one way to put NCCL under
    the hybrid mesh on one card)."""
    rc, out, err, wall = probe.finish(timeout=300)
    line = next((ln for ln in out.splitlines() if ln.startswith("DIST_OK")), None)
    if rc != 0 or line is None or line.split()[1:4] != ["nccl", "1", "0"]:
        fail(f"mesh: initialize_distributed's probe exited {rc}: {out[-500:]} {err[-1500:]}")
    got = {}
    for key, tag, local in (("process_mesh", "DIST_MESH", 1),
                            ("hybrid", "DIST_HYBRID", MESH_LOCAL)):
        mesh = got[key] = json.loads(next(ln for ln in out.splitlines()
                                          if ln.startswith(tag + " ")).split(" ", 1)[1])
        t, d = mesh["transport"], mesh["describe"]
        if not (mesh["population_eval"] and mesh["ring_forward"] and mesh["ring_grad"]) \
                or t["collectives"] < 1 or t["staging_copies"] or d["backend"] != "nccl" \
                or (d["local_shards"], d["devices"]) != (local, local):
            fail(f"mesh: the NCCL {key} probe gave {mesh}")
    return {"line": line, **got, "wall_s": wall}


def mesh_rank(rank, port, workdir):
    """(g), one rank: the group over the card (``initialize_distributed``
    with no device: the two ranks share the card, so gloo), the seams
    through `get_partitioner()` (one shard a rank) and then through the
    hybrid mesh over the same group (`process_mesh` with the card
    MESH_LOCAL times a rank: G = MESH_RANKS × MESH_LOCAL shards) on the
    inputs the parent saved, each part's seconds, K1/K2 launches and
    transport counts read after it, the outputs written to
    ``workdir/rank{rank}.pt``.  The kernels build at first use into one
    empty directory for both ranks, which reach their first launch
    together (the bring-up's exchange has just synchronised them): each
    rank's builds are recorded."""
    import os

    import torch
    import torch.distributed as dist

    from ai_crypto_trader_tpu_torch.backtest import default_params, sweep
    from ai_crypto_trader_tpu_torch.config import GAParams
    from ai_crypto_trader_tpu_torch.evolve import ga
    from ai_crypto_trader_tpu_torch.models import LongContextTransformer, hpo, long_context_loss
    from ai_crypto_trader_tpu_torch.ops import dynamic
    from ai_crypto_trader_tpu_torch.ops.ewma import fused_ewma, fused_ewma_jobs
    from ai_crypto_trader_tpu_torch.ops.replay import sweep_kernel
    from ai_crypto_trader_tpu_torch.parallel import (
        MeshPartitioner, get_partitioner, initialize_distributed)
    from ai_crypto_trader_tpu_torch.parallel.mesh import TRANSPORT, process_mesh
    from ai_crypto_trader_tpu_torch.parallel.time_shard import (
        sharded_ema, sharded_rolling_mean)
    from ai_crypto_trader_tpu_torch.rl import dqn, population
    from ai_crypto_trader_tpu_torch.ops import _cuda
    from ai_crypto_trader_tpu_torch.utils import meshprof

    t_rank = time.perf_counter()
    # both ranks build the same libraries into one empty directory at once
    _cuda.set_build_dir(os.path.join(workdir, "kernels"))
    builds = []
    _cuda.BUILD_LISTENERS.append(lambda name, s, cached: builds.append(
        {"library": name, "s": s, "cached": cached}))
    backend = initialize_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank)
    part = get_partitioner()
    src = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    res = {"rank": rank, "backend": backend, "describe": part.describe(), "parts": {},
           "start_s": time.perf_counter() - t_rank}

    def run(name, fn):
        TRANSPORT.reset()
        sweep_kernel.launches = fused_ewma.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["parts"][name] = {"s": time.perf_counter() - t0, "k1": sweep_kernel.launches,
                              "k2": fused_ewma.launches, "transport": TRANSPORT.counts()}
        return out

    def cuda(tree):
        return type(tree)(*(x.cuda() if torch.is_tensor(x) else x for x in tree))

    inp, params = cuda(src["inputs"]), cuda(src["params"])

    def sweep_part(prefix, p):
        """The main path's sweep through ``p``: the stats, each K1 launch's
        B, and the rank's first launch timed alone after the counted run
        (the other rank times its own at about the same moment: contended)."""
        calls = []

        def swept():
            with recording_k1(calls):
                return sweep(inp, params, partitioner=p, device="cuda")

        stats = run(f"{prefix}sweep", swept)
        shard_in, shard_params, shard_kw, _ = calls[0]
        return {"stats": type(stats)(*(x.cpu() for x in stats)),
                "launch_B": [int(q.stop_loss.numel()) for _, q, _, _ in calls],
                "k1_ms": cuda_ms(lambda: sweep_kernel(shard_in, shard_params, **shard_kw), 3)}

    def seam_parts(prefix, p, fit):
        """The GA (on the rank's tables ``fit``), the pbt generation, the
        HPO farm, `time_shard` and the long-context model's ring through
        ``p``."""
        out = {"ga": {}}
        for pop in (POP_GA, MESH_GA_RAGGED):
            cfg = GAParams(population_size=pop, generations=GENS_GA)
            with counted(ga, "host_read") as reads:
                best, history = run(f"{prefix}ga_{pop}", lambda: ga.run_ga(
                    torch.Generator(device="cuda").manual_seed(11), fit, cfg,
                    seed_params=default_params(device="cuda"), partitioner=p, device="cuda"))
            out["ga"][pop] = {"best": tuple(best), "history": history, "reads": len(reads)}
        env = cuda(src["pbt_env"])
        cfg, pcfg = mesh_pbt_configs(env)
        with counted(population, "host_read") as reads:
            r = run(f"{prefix}pbt", lambda: population.train_pbt(
                torch.Generator(device="cuda").manual_seed(21), env, cfg, pcfg, partitioner=p))
        out["pbt"] = {"fitness": r.fitness, "history": r.history, "reads": len(reads),
                      "members": {k: v.cpu() for k, v in
                                  dqn.tensor_leaves(dqn._drop(r.state.members)).items()}}
        mp = meshprof.MeshProf()
        with meshprof.use(mp):
            out["hpo"] = run(f"{prefix}hpo", lambda: hpo.optimize_hyperparameters(
                torch.Generator(device="cuda").manual_seed(23), src["hpo_features"],
                partitioner=p, **MESH_HPO_KW))
        out["hpo_trials_here"] = sum(mp.trial_assignments.values())
        x = torch.as_tensor(src["close"]).cuda()
        out["time_shard"] = {k: v.cpu() for k, v in run(f"{prefix}time_shard", lambda: {
            **{f"ema_{w}": sharded_ema(x, w, p.mesh).gather() for w in MESH_EMA_WINDOWS},
            **{f"mean_{w}": sharded_rolling_mean(x, w, p.mesh).gather()
               for w in MESH_MEAN_WINDOWS}}).items()}
        lx, ly = (torch.from_numpy(a).cuda() for a in src["lc"])
        model = LongContextTransformer(LC_F, mesh=p.mesh, device="cuda",
                                       generator=torch.Generator().manual_seed(29))
        params_lc = dict(model.named_parameters())
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd = run(f"{prefix}long_context_forward", lambda: model(lx)["mean"])
        peak_fwd = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

        def loss_and_grad():
            loss = long_context_loss(model, params_lc, lx, ly)
            return loss, torch.autograd.grad(loss, list(params_lc.values()))

        loss, grads = run(f"{prefix}long_context_loss_and_grad", loss_and_grad)
        out["long_context"] = {"forward": fwd.cpu(), "loss": float(loss),
                               "grads": [g.cpu() for g in grads],
                               "peak_gb": {"forward": peak_fwd, "loss_and_grad":
                                           torch.cuda.max_memory_allocated() / 1e9}}
        return out

    res["sweep"] = sweep_part("", part)
    tables_jobs, kernel_entry = [], dynamic.fused_ewma_jobs

    def recording(jobs, device=None):
        tables_jobs.append([(x, a, st) for x, a, st in jobs])
        return kernel_entry(jobs, device=device)

    dynamic.fused_ewma_jobs = recording
    try:
        fit = run("ga_tables", lambda: ga.backtest_fitness(src["candles"], device="cuda"))
    finally:
        dynamic.fused_ewma_jobs = kernel_entry
    res["k2_ms"] = [cuda_ms(lambda: fused_ewma_jobs(jobs, device="cuda"), 5)
                    for jobs in tables_jobs]
    del tables_jobs
    res.update(seam_parts("", part, fit))
    # the hybrid mesh over the same group: the card MESH_LOCAL times a rank
    hybrid = MeshPartitioner(process_mesh(local_devices=["cuda:0"] * MESH_LOCAL))
    res["hybrid"] = {"describe": hybrid.describe(), "sweep": sweep_part("hybrid_", hybrid),
                     **seam_parts("hybrid_", hybrid, fit)}
    res["rank_s"] = time.perf_counter() - t_rank
    res["builds"] = builds
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def held_rank(got, parts, r, label, shards, ctl_ts, stats):
    """(g): one rank's outputs on a mesh of ``shards`` shards (``got``: the
    one-shard parts' or the hybrid's; ``parts``: the rank's counts by part)
    held against the single device: the
    sweep's stats bit for bit against phase main's single launch, in
    ``shards`` // MESH_RANKS K1 launches of B / ``shards`` here; the GA at
    256 and 250 (one read a run, G + 1 evaluations of as many launches
    each), the pbt generation and the HPO farm bit for bit against (b)-(c)'s
    single device; `time_shard` bit for bit against ``ctl_ts`` (a
    one-controller mesh of as many shards of the card: {name: series}) and
    its EMA within MESH_TS_* of `ops.indicators.ema`.  Returns the sweep's
    max abs error against phase main."""
    import torch

    from ai_crypto_trader_tpu_torch.rl import dqn

    local = shards // MESH_RANKS
    pre = "hybrid_" if label == "hybrid" else ""
    s = got["sweep"]
    if s["launch_B"] != [B_FULL // shards] * local or parts[f"{pre}sweep"]["k1"] != local:
        fail(f"mesh: rank {r}'s {label} sweep made launches of {s['launch_B']}")
    s["max_abs_err"] = compare_stats(type(stats)(*(x.cuda() for x in s["stats"])), stats,
                                     f"mesh_rank{r}_{label}_sweep")["max_abs_err"]
    for pop, one in SHARED["mesh_single_ga"].items():
        g, k1 = got["ga"][pop], parts[f"{pre}ga_{pop}"]["k1"]
        if g["history"] != one[1] or g["reads"] != 1 or k1 != (GENS_GA + 1) * local:
            fail(f"mesh: rank {r}'s {label} GA at {pop}: {g['reads']} reads, {k1} K1 "
                 f"launches, history {'equal' if g['history'] == one[1] else 'not equal'}")
        same_tree(g["best"], tuple(one[0]), f"rank {r}'s {label} GA best genome at {pop}")
    one = SHARED["mesh_single_pbt"]
    lb = dqn.tensor_leaves(dqn._drop(one.state.members))
    p = got["pbt"]
    if p["reads"] != 1 or p["history"] != one.history \
            or not same_host_bits(p["fitness"], one.fitness):
        fail(f"mesh: rank {r}'s {label} pbt generation is not the single device's")
    same_tree(p["members"], {k: lb[k] for k in p["members"]}, f"rank {r}'s {label} pbt fleet")
    if got["hpo"] != SHARED["mesh_single_hpo"]:
        fail(f"mesh: rank {r}'s {label} HPO farm gave {got['hpo']['trials']}, the single "
             f"device {SHARED['mesh_single_hpo']['trials']}")
    ts = got["time_shard"]
    for w in MESH_EMA_WINDOWS:
        same_tree(ts[f"ema_{w}"], ctl_ts[f"ema_{w}"], f"rank {r}'s {label} sharded_ema({w})")
        want = SHARED["mesh_ema_refs"][w].cpu()
        ok = ~torch.isnan(want)
        if not torch.equal(torch.isnan(ts[f"ema_{w}"]), ~ok) or bool(
                (torch.abs(ts[f"ema_{w}"][ok] - want[ok])
                 > MESH_TS_ATOL + MESH_TS_RTOL * torch.abs(want[ok])).any()):
            fail(f"mesh: rank {r}'s {label} sharded_ema({w}) is off ops.indicators.ema")
    for w in MESH_MEAN_WINDOWS:
        same_tree(ts[f"mean_{w}"], ctl_ts[f"mean_{w}"],
                  f"rank {r}'s {label} sharded_rolling_mean({w})")
    return s["max_abs_err"]


def held_ring(lc, label):
    """(g): the ranks' ring (rank 0's outputs; the others equal it) within
    (e)'s tolerances of the dense model.  Returns the forward's and the
    gradient's max abs errors."""
    import torch

    dense_fwd, _, dense_grads = SHARED["mesh_dense_lc"]
    a, b = lc["forward"].cuda(), dense_fwd
    fwd_err = float(torch.abs(a - b).max())
    flat_r = torch.cat([g.reshape(-1) for g in lc["grads"]]).cuda()
    flat_d = torch.cat([g.reshape(-1) for g in dense_grads])
    grad_err = float(torch.abs(flat_r - flat_d).max())
    if not bool(torch.isfinite(a).all()) or bool(
            (torch.abs(a - b) > MESH_LC_TOL + MESH_LC_TOL * torch.abs(b)).any()) or bool(
            (torch.abs(flat_r - flat_d) > MESH_LC_GRAD_ATOL
             + MESH_LC_GRAD_RTOL * torch.abs(flat_d)).any()):
        fail(f"mesh: the ranks' {label} ring is {fwd_err:.3g} (forward) and {grad_err:.3g} "
             "(gradient) off the dense model")
    return fwd_err, grad_err


def mesh_ranks(d_year, inp, params, stats):
    """(g) MESH_RANKS rank processes that share the card over gloo
    (`mesh_rank`), started after the phase's timed parts: the inputs saved
    once (the main path's inputs and strategies, the GA's candles, the pbt
    markets, the HPO features, the year's close, the long-context inputs),
    and each rank's outputs held here (`held_rank`, `held_ring`): first on
    one shard a rank (the sweep in one K1 launch of B / MESH_RANKS a rank,
    `time_shard` against a one-controller mesh of MESH_RANKS shards), then
    on the hybrid mesh of MESH_LOCAL shards a rank (the sweep in MESH_LOCAL
    launches of B / MESH_N a rank, `time_shard` against (d)'s one-controller
    mesh of MESH_N shards); the ring's forward and gradient within
    MESH_LC_* of (e)'s dense run on both.  Returns (report, K1 launches of
    each rank by path, K2 launches of each rank by path)."""
    import os
    import socket
    import tempfile

    import numpy as np
    import torch

    from ai_crypto_trader_tpu_torch.ops import indicators as ind
    from ai_crypto_trader_tpu_torch.parallel import make_mesh
    from ai_crypto_trader_tpu_torch.parallel.time_shard import (
        sharded_ema, sharded_rolling_mean)

    def cpu(tree):
        return type(tree)(*(x.cpu() if torch.is_tensor(x) else x for x in tree))

    t0 = time.perf_counter()
    root, _ = research_env()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"inputs": cpu(inp), "params": cpu(params),
                    "candles": {k: v[:T_GA] for k, v in d_year.items()},
                    "pbt_env": cpu(SHARED["pbt_env"]), "hpo_features": mesh_hpo_features(d_year),
                    "close": np.asarray(d_year["close"], np.float32),
                    "lc": mesh_lc_inputs()}, os.path.join(tmp, "inputs.pt"))
        for _ in range(3):                           # a port taken meanwhile: another
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            ranks = [Beside([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                             str(port), tmp], root) for r in range(MESH_RANKS)]
            try:
                done = [rk.finish(timeout=MESH_RANK_TIMEOUT_S) for rk in ranks]
            finally:
                for rk in ranks:
                    rk.stop()
            if not any("address already in use" in e.lower() for _, _, e, _ in done):
                break
        for r, (rc, _, err, _) in enumerate(done):
            if rc != 0:
                fail(f"mesh: rank {r} of {MESH_RANKS} exited {rc}: {err[-2500:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(MESH_RANKS)]
        built = sorted(os.listdir(os.path.join(tmp, "kernels")))
    wall = time.perf_counter() - t0
    # the ranks built the libraries at once: each loaded a whole one (its
    # results below are bit for bit), and no half-written file is left
    if len(built) != 2 or not all(f.endswith(".so") for f in built) or any(
            sorted(b["library"] for b in g["builds"]) != ["fused_ewma", "replay_sweep"]
            for g in res):
        fail(f"mesh: the ranks' kernel builds left {built}: "
             f"{[g['builds'] for g in res]}")
    # time_shard's references: one-controller meshes of as many shards of
    # the card (the hybrid's is (d)'s), whose rolling means are rolling_mean's
    x = torch.as_tensor(np.asarray(d_year["close"], np.float32)).cuda()
    ctl = make_mesh(MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
    ctl_ts = {**{f"ema_{w}": sharded_ema(x, w, ctl).gather() for w in MESH_EMA_WINDOWS},
              **{f"mean_{w}": sharded_rolling_mean(x, w, ctl).gather()
                 for w in MESH_MEAN_WINDOWS}}
    for w in MESH_MEAN_WINDOWS:
        same_tree(ctl_ts[f"mean_{w}"], ind.rolling_mean(x, w), f"rolling_mean({w})")
    for r, got in enumerate(res):
        h = got["hybrid"]
        if got["backend"] != "gloo" or got["describe"]["ranks"] != MESH_RANKS or (
                h["describe"]["devices"], h["describe"]["local_shards"]) != (
                MESH_RANKS * MESH_LOCAL, MESH_LOCAL):
            fail(f"mesh: rank {r} brought up {got['backend']} over "
                 f"{got['describe'].get('ranks')} ranks; the hybrid mesh {h['describe']}")
        held_rank(got, got["parts"], r, "one shard a rank", MESH_RANKS, ctl_ts, stats)
        held_rank(h, got["parts"], r, "hybrid", MESH_RANKS * MESH_LOCAL, SHARED["mesh_ts_ctl"],
                  stats)
        for what, a, b in (("", got, res[0]), ("hybrid ", h, res[0]["hybrid"])):
            if r:
                same_tree(a["sweep"]["stats"], b["sweep"]["stats"], f"the ranks' {what}sweeps")
                same_tree(a["time_shard"], b["time_shard"], f"the ranks' {what}time_shard")
                same_tree(a["long_context"]["forward"], b["long_context"]["forward"],
                          f"the ranks' {what}long-context forward")
    rings = {label: held_ring(lc, label) for label, lc in (
        ("one shard a rank", res[0]["long_context"]),
        ("hybrid", res[0]["hybrid"]["long_context"]))}
    _, dense_loss, _ = SHARED["mesh_dense_lc"]

    def launches(g, hybrid, kernel):
        return sum(v[kernel] for k, v in g["parts"].items()
                   if k.startswith("hybrid_") == hybrid)

    report = {"ranks": MESH_RANKS, "backend": "gloo", "wall_s": wall,
              "describe": res[0]["describe"], "hybrid_describe": res[0]["hybrid"]["describe"],
              "builds": [g["builds"] for g in res], "build_dir": built,
              "by_rank": [{"rank": g["rank"], "start_s": g["start_s"], "rank_s": g["rank_s"],
                           "parts": g["parts"], "hpo_trials_here": g["hpo_trials_here"],
                           "hybrid_hpo_trials_here": g["hybrid"]["hpo_trials_here"],
                           "k1_ms_contended": g["sweep"]["k1_ms"],
                           "hybrid_k1_ms_contended": g["hybrid"]["sweep"]["k1_ms"],
                           "k2_ms_contended": g["k2_ms"],
                           "long_context_peak_gb": g["long_context"]["peak_gb"],
                           "hybrid_long_context_peak_gb": g["hybrid"]["long_context"]["peak_gb"],
                           "sweep_max_abs_err": g["sweep"]["max_abs_err"],
                           "hybrid_sweep_max_abs_err": g["hybrid"]["sweep"]["max_abs_err"]}
                          for g in res],
              "sweep": f"{MESH_RANKS} K1 launches of B={B_FULL // MESH_RANKS} x T={T_FULL} "
                       f"(one shard a rank), then {MESH_RANKS * MESH_LOCAL} of "
                       f"B={B_FULL // (MESH_RANKS * MESH_LOCAL)} (hybrid, {MESH_LOCAL} a rank), "
                       "stats bit for bit against phase main's single launch",
              "ga": {str(pop): one[1][-1]["best_fitness"]
                     for pop, one in SHARED["mesh_single_ga"].items()},
              "long_context": {label: {"loss": [lc["loss"], float(dense_loss.detach())],
                                       "forward_max_abs_err": fwd, "grad_max_abs_err": grad}
                               for (label, (fwd, grad)), lc in zip(rings.items(), (
                                   res[0]["long_context"],
                                   res[0]["hybrid"]["long_context"]))},
              "bit_for_bit": "sweep, GA 256 and 250, pbt, HPO farm, time_shard; one shard a "
                             "rank and hybrid"}
    k1 = {path: [launches(g, path == "hybrid", "k1") for g in res] for path in ("ranks", "hybrid")}
    k2 = {path: [launches(g, path == "hybrid", "k2") for g in res] for path in ("ranks", "hybrid")}
    return report, {"launches": k1, "sweep_ms": [g["sweep"]["k1_ms"] for g in res],
                    "hybrid_sweep_ms": [g["hybrid"]["sweep"]["k1_ms"] for g in res]}, \
        {"launches": k2, "ga_tables_ms": [sum(g["k2_ms"]) for g in res]}


def phase_mesh(info, d_year, inp, params, stats, main_plain_ms):
    """The population seams on a mesh (`parallel.MeshPartitioner`): a
    virtual mesh of the card MESH_N times (and, with more than one card, a
    mesh of the real ones for (a)-(b)): (a) the sweep, (b) the GA, (c) the
    tenant engine, the LOB sweep, one PBT generation, the structure pool
    and an HPO farm, (d) `time_shard`, (e) the ring in the long-context
    model, (f) `initialize_distributed` in a subprocess started at the
    phase's start (the process mesh and the hybrid mesh over NCCL at world
    size 1), (g) 2 ranks sharing the card, on one shard a rank and on the
    hybrid mesh of MESH_LOCAL shards a rank.  Returns the kernels line's
    entries (K1, K2)."""
    t_phase = time.perf_counter()
    root, _ = research_env()
    probe = Beside([sys.executable, "-c", _DIST_PROBE, str(MESH_LC_TOL),
                    str(MESH_LC_GRAD_RTOL), str(MESH_LC_GRAD_ATOL), str(MESH_LOCAL)], root)
    try:
        parts = mesh_partitioners()
        part = parts["virtual"]
        report, times = {"phase": "mesh", "card": info["nvidia_smi"],
                         "mesh": part.describe()}, {}
        for name, fn, args in (("sweep", mesh_sweep, (part, inp, params, stats)),
                               ("ga", mesh_ga, (part, d_year)),
                               ("tenant", mesh_tenant, (part,)),
                               ("lob_sweep", mesh_lob, (part,)),
                               ("pbt", mesh_pbt, (part, SHARED.get("pbt_env"))),
                               ("structures", mesh_structures, (part,)),
                               ("hpo", mesh_hpo, (part, d_year)),
                               ("time_shard", mesh_time_shard, (part, d_year)),
                               ("long_context", mesh_long_context, (part,))):
            if name == "pbt" and args[1] is None:
                fail("mesh: phase rl left no pbt markets")
            t0 = time.perf_counter()
            report[name] = fn(*args)
            times[name] = time.perf_counter() - t0
        (report["ga"], ga_k1, ga_k2), (report["time_shard"], ts_k2) = \
            report["ga"], report["time_shard"]
        if "real" in parts:
            real = parts["real"]
            report["real_cards"] = {"mesh": real.describe(),
                                    "sweep": mesh_sweep(real, inp, params, stats),
                                    "ga": mesh_ga(real, d_year)[0]}
        t0 = time.perf_counter()
        report["ranks"], ranks_k1, ranks_k2 = mesh_ranks(d_year, inp, params, stats)
        times["ranks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["distributed"] = mesh_dist_finish(probe)
        times["distributed_wait"] = time.perf_counter() - t0
    finally:
        probe.stop()
    report["part_s"] = times
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    bound_ms, bound_by, _ = replay_bound_ms(stats, B_FULL, T_FULL)
    sweep_r = report["sweep"]
    by_rank_k1, by_rank_k2 = ranks_k1["launches"], ranks_k2["launches"]
    k1 = {"launches": sweep_r["launches"] + ga_k1 + sum(map(sum, by_rank_k1.values())),
          "launches_by_path": {"sweep": sweep_r["launches"], "ga": ga_k1, **by_rank_k1},
          "ranks_sweep_launch_ms_contended": ranks_k1["sweep_ms"],
          "hybrid_sweep_launch_ms_contended": ranks_k1["hybrid_sweep_ms"],
          "ms": sweep_r["ms"], "single_launch_ms": sweep_r["single_launch_ms"],
          "plain_ms": main_plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": None,
          "max_abs_err": sweep_r["max_abs_err"],
          "shape": f"{MESH_N} launches of B={B_FULL // MESH_N} x T={T_FULL} (ms, bound and "
                   f"plain_ms: the {MESH_N} together, the same work as phase main's single "
                   f"launch, which they equal bit for bit and whose plain loop plain_ms is)"}
    k2 = {"launches": len(ts_k2["ms_per_launch"]) + ga_k2 + sum(map(sum, by_rank_k2.values())),
          "launches_by_path": {"time_shard_reference_ema": len(ts_k2["ms_per_launch"]),
                               "ga_tables": ga_k2, **by_rank_k2},
          "hybrid_launches": "none of its own: the hybrid GA runs on the tables each rank "
                             "built for its one-shard parts (the ranks' launches)",
          "ranks_ga_tables_ms_contended": ranks_k2["ga_tables_ms"],
          **{k: ts_k2[k] for k in ("ms", "ms_per_launch", "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err", "max_rel_err")},
          "library_ms": None,
          "shape": f"ops.indicators.ema over T={T_FULL}, windows {list(MESH_EMA_WINDOWS)}: "
                   f"the reference sharded_ema is held against (ms/plain/bound cover these)"}
    return k1, k2


PHASE_S = {}              # every phase's seconds, in order


def timed_phase(name, fn, *args):
    """``fn(*args)``, its seconds printed on a line of their own and kept
    in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    emit({"phase_time": name, "phase_s": PHASE_S[name]})
    return out


def main():
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import ai_crypto_trader_tpu_torch  # noqa: F401 — the checkout's port
    from ai_crypto_trader_tpu_torch.utils.cache import enable_compilation_cache

    info = timed_phase("device", phase_device)
    from ai_crypto_trader_tpu_torch.backtest import prepare_inputs, sample_params
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    # the kernels build where the CLI's card commands look for them (the
    # provenance-keyed directory under .torch_kernels/), so the script's
    # subprocesses load them instead of building their own
    if not enable_compilation_cache():
        fail("the kernel-build cache of the CLI's card commands did not enable")
    libraries = timed_phase("build", phase_build)
    d = {k: v for k, v in generate_ohlcv(n=T_FULL, seed=3).items() if k != "regime"}

    def d_small(n):
        return {k: v for k, v in generate_ohlcv(n=n, seed=3).items() if k != "regime"}

    params = sample_params(torch.Generator().manual_seed(0), B_FULL, device="cuda")
    ewma = timed_phase("ewma", phase_ewma, d, libraries)
    timed_phase("flips", phase_flips, d, params)
    main_inputs = prepare_inputs(compute_indicators(d, device="cuda"), device="cuda")
    checks = timed_phase("replay", phase_replay, main_inputs, params, d_small)
    launches, stats, full, k1 = timed_phase("main", phase_main, d)
    timed_phase("indicator_split", phase_indicator_split, d)
    ga_entries = timed_phase("ga", phase_ga, d, info, libraries)
    tick = timed_phase("tick", phase_tick, info)
    portfolio = timed_phase("portfolio", phase_portfolio, info)
    tenant = timed_phase("tenant", phase_tenant, info)
    timed_phase("mc", phase_mc, info)
    nn = timed_phase("nn", phase_nn, info)
    timed_phase("patterns", phase_patterns, info)
    nn_train = timed_phase("train", phase_train, info)
    rl = timed_phase("rl", phase_rl, info, d)
    sim_k1, sim_k2 = timed_phase("sim", phase_sim, info)
    regime = timed_phase("service", phase_service, info)
    strat_k1, strat_k2 = timed_phase("strategy", phase_strategy, info, d)
    live = timed_phase("live", phase_live, info)
    trade = timed_phase("trade", phase_trade, info)
    stack_k2, stack_k1 = timed_phase("stack", phase_stack, info)
    stream = timed_phase("stream", phase_stream, info, trade["tick_ms_p50"])
    serve_k2, serve_k1 = timed_phase("serve", phase_serve, info, d)
    research_k2, research_k1 = timed_phase("research", phase_research, info)
    mesh_k1, mesh_k2 = timed_phase("mesh", phase_mesh, info, d, main_inputs, params, stats,
                                   k1["plain_ms"])
    emit({"script_s": time.perf_counter() - t_script, "phase_s": PHASE_S})
    bound_ms, bound_by, stepped_bound_ms = replay_bound_ms(stats, B_FULL, T_FULL)
    checks += full
    kernels = [
        {"name": "fused_ewma", "route": "cuda",
         "source": "ai_crypto_trader_tpu_torch/csrc/fused_ewma.cu",
         "replaces": "ai_crypto_trader_tpu/ops/pallas_kernels.py:88",
         "launches": launches["fused_ewma"],
         "max_abs_err": ewma["max_abs_err"], "max_rel_err": ewma["max_rel_err"],
         "ms": ewma["ms"], "plain_ms": ewma["plain_ms"],
         "bound_ms": ewma["bound_ms"], "bound_by": ewma["bound_by"], "library_ms": None,
         "ms_per_launch": {k: v["ms"] for k, v in ewma["launches"].items()},
         "floors_ms_per_launch": {k: {f: v[f] for f in ("barrier_only_ms", "copy_same_bytes_ms")}
                                  for k, v in ewma["launches"].items()},
         "plan": {k: v["plan"] for k, v in ewma["launches"].items()},
         "registers": ewma["registers"], "resources": ewma["shared_memory"],
         "beyond_residency": ewma["beyond_residency"],
         "ga_tables": {**ga_entries["ga_tables"], "registers": ewma["registers"]},
         "tick": tick,
         "tenant": tenant,
         "nn_cli_train": nn,
         "nn_train": nn_train,
         "rl": rl,
         "sim": sim_k2,
         "regime": regime,
         "strategy": strat_k2,
         "live": live,
         "trade": trade,
         "stack": stack_k2,
         "stream": stream,
         "serve": serve_k2,
         "research": research_k2,
         "mesh": mesh_k2,
         "shape": "the two launches of compute_indicators at T=525600, summed "
                  "(A: close K=2 + up/dn/tr K=1; B: MACD line K=1)"},
        {"name": "replay_sweep", "route": "cuda",
         "source": "ai_crypto_trader_tpu_torch/csrc/replay_sweep.cu",
         "replaces": "ai_crypto_trader_tpu/ops/pallas_backtest.py:259",
         "launches": launches["replay_sweep"],
         "max_abs_err": max(max(c["max_abs_err"], c.get("curve_max_abs_err", 0.0))
                            for c in checks),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
         "prepass_ms": k1["prepass_ms"], "walk_ms": k1["walk_ms"],
         "curve_ms": k1["curve_ms"], "curve_shape": f"B={CURVE_B} x T={T_FULL}",
         "walk_ms_heaviest_alone": k1["heaviest"]["walk_ms"],
         "heaviest_trades": k1["heaviest"]["trades"],
         "bound_ms_stepping_every_candle": stepped_bound_ms,
         "registers": {"walk": registers(libraries, "replay_sweep",
                                         "replay_walk_kernelILb0ELb0E"),
                       "walk_curve": registers(libraries, "replay_sweep",
                                               "replay_walk_kernelILb1ELb0E"),
                       "gate": registers(libraries, "replay_sweep", "replay_gate_kernel")},
         "ga_rows": {**ga_entries["ga_rows"],
                     "registers": {
                         "walk_rows": registers(libraries, "replay_sweep",
                                                "replay_walk_kernelILb0ELb1E"),
                         "walk_rows_curve": registers(libraries, "replay_sweep",
                                                      "replay_walk_kernelILb1ELb1E")}},
         "portfolio": portfolio,
         "sim": sim_k1,
         "strategy": strat_k1,
         "stack": stack_k1,
         "serve": serve_k1,
         "research": research_k1,
         "mesh": mesh_k1,
         "shape": f"B={B_FULL} x T={T_FULL}",
         "plain": "the engine's loop, 32 candles a CUDA graph"},
    ]
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:           # one rank of phase mesh (g)
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
