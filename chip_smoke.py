#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Build every kernel of the live tick from ``binquant_tpu_torch/csrc``
   (``nvcc`` for ``sm_90a``) and print the seconds it took.
2. Hold each kernel against its plain torch twin on the card and on the
   CPU, bit for bit, at the shapes the main path gives it
   (ActivityBurstPump's 2048x128 tail with NaN, tie and inf rows — the
   shape of both of its call sites, ``abp_core`` and
   ``abp_init_from_window``), at SpikeHunter's 2048x400 shape, at the
   backtest's ``abp_core_batch`` shapes — the default 16-tick chunk's
   2048x176 (K=52), a 32-tick chunk's 2048x224 (K=100) and the sweep's
   first chunk, which holds the warm tick's 400 bars, 2048x573 (K=449, the
   block kernel) — at a short ``W < L+K-1`` input and at phase 12's
   32-row shapes (the corpus's and the soak's 32x120 tail; the soak's
   ``abp_core_batch`` chunks, 32x168 (K=52) on its 16-tick chunks, 32x159
   (K=43) and 32x207 (K=91) on its two other chunk shapes) and at phase
   13's A/B shapes (64x128, K=4; the spike detector's 64x200).
   Time the kernel on the device (200 wrapper calls captured in one CUDA
   graph, replayed between two events), the host-issued call loop, the
   card's launch floor (the same graph at S=1, K=1, L=1), the twin and a
   ``torch.nanquantile`` yardstick (a short input left-padded with NaN).
3. Drive the port's live paths at full width (S=2048 symbols, W=400 bars
   per ring): warm both rings with 400 bars of seeded history through
   ``IngestBatcher.add_batch`` sub-batches folded by the first
   ``process_tick``, then live ticks of closed klines through ``ingest`` ->
   ``process_tick``. Each drive runs on the card and, on the same stream,
   on the CPU; routing, fired sets and rings must be equal and wires must
   agree. Kernel launch counters are zeroed just before each card drive
   and read just after it.

   * classic (``incremental=False``), 4 live ticks: one qtail launch per
     tick (``abp_core``);
   * incremental (a full-recompute audit every 8 ticks), 16 live ticks: a
     cold start on the warm tick, audits on live ticks 8 and 16, every other
     tick incremental; two qtail launches on each full tick (``abp_core``,
     ``abp_init_from_window``) and none on an incremental one; the carry's
     order-free leaves equal to the CPU's bit for bit; its fired set equal
     to the classic drive's over their common ticks but for flips inside the
     declared gate margins. The supertrend scan and the whole carry init are
     also timed alone.

   Both run the serial loop (depth 0) with copied rings, no digests and no
   outcome tracker.
4. Drive the dormant strategy set (``[slice dormant]``) on the reference's
   two dormant markets (``dormant_market_bars`` and
   ``dormant_extended_market_bars`` of the port's replay module, made at S
   symbols with their crafted setups on the last live tick; the second
   with its rising breadth series and its scripted dominance flags), W
   bars of warm history and 2 live ticks, every strategy on the wire, the
   classic and the incremental drive (an audit on the last tick), each on
   the card and on the CPU: routing equal, fired sets equal but for flips
   inside ``declared_gate_margins()`` (each printed), wires within the
   contract on every tick without a flip, rings bit for bit, every dormant
   strategy that fires on the CPU firing on the card too, and exactly one
   qtail launch at ``detect_spikes`` on every tick. On the first market the
   live set alone also drives the card, for the tick times beside it.
   Then the reference's two 24-symbol markets at their own 130 bars, tiled
   over S rows (one BTC row, the other 23 cycled under distinct names, so
   the cross-sectional shares the breadth gates read stay theirs), classic,
   the last two bars live: there RangeBbRsi, RangeFailedBreakoutFade, RS
   reversal and SupertrendSwingReversal fire, card against CPU, their
   counts printed.
5. Drive the production loop (``[slice pipelined]``): depth 1, rings
   updated in place, both wire digests and the carry-drift meter on, an
   audit every 8 ticks, on a market that trends down through 16 live ticks
   and crashes on a 17th (a green hammer under the lower band on every
   symbol, as ``generate_burst_replay`` makes), so that more pairs fire
   than the wire's 128 slots and the in-place overflow fallback runs. The
   reference is a CPU engine at depth 0 with copied rings and the same
   flags; routing, fired sets, ingest digest blocks (bit for bit), numeric
   digest blocks (counts exact, floats within the wire contract), the drift
   meter's ``compared`` counts and alarm verdicts per audit tick, and the
   rings after the drive must agree. qtail launches per tick and call site:
   3 on each audit tick (``carry_drift`` too), 2 on the cold start, 0 on an
   incremental tick. The outcome tracker is on, as in production: its
   matured tuples and its registered, matured, truncated and eviction
   counts must equal the CPU engine's (the crash tick's pairs pass its cap
   of 1024), horizons 1, 4 and 16 mature within the drive and 96 does not;
   the host ms of each maturation tick (gather, copy, fold) is printed. The
   same drive on five card engines taking each tick in turns, two rounds,
   gives the tick times and peak device memory: depth 1 in place, depth 0
   copying with and without the digests and the meter, depth 2 on
   double-buffered rings (each tick writes a recycled ring slot; held
   against the CPU engine as depth 1 is, in both rounds, with 0 slots
   allocated after the first tick) and depth 2 copying; for each, the
   caching allocator's large-pool allocations per tick and the slots
   pooled.
6. Drive the service around the tick (``[slice service]``): the
   production loop, an audit and a checkpoint every 8 ticks, a binbot
   client over the stub backend with a scripted breadth schedule (one
   stalled bucket) and a seeded symbol list to calibrate. Boot A: a cold
   engine finds no archive, ``backfill`` loads 400 bars per interval and
   symbol from a fake REST source (one symbol's fetches raise, a bar that
   has not closed is served and dropped), then ``consume_loop`` takes 16
   live ticks of the production drive's downtrend from an
   ``asyncio.Queue``, bucket by bucket, and is cancelled; tick 8's state
   is also saved at 4 shards and monolithic, each save timed. Boot B
   restores the 4-shard set, tops the rings up by ``backfill`` (in one
   flush, as A) and consumes ticks 9-16. Fresh card engines restore the
   monolithic archive and the 4-shard set (every leaf bit-equal, and to
   boot B's) and run tick 9 to the same wire bit for bit. A CPU engine (depth
   0, copied rings) takes boot A's stream. Routing, fired tuples, notifier
   digests, leverage PUTs, host carries and rings must equal the CPU's
   (wires within the contract) and B's ticks must equal A's bit for bit
   (but for the ingest counts of B's own backfill); qtail launches per tick
   and site must be 2 on each first tick after a backfill (``cold_start``
   for A, ``backfill`` for B), 3 on the audit, 0 on an incremental tick,
   plus an overflowing tick's fallback. It prints the backfill's seconds
   and bars per second, the save and restore ms, the first tick's ms after
   each backfill and the calibration worker's ms. The fired tuples are
   read from what the autotrade consumer was handed through the delivery
   plane, the digests from what the Telegram consumer sent.
7. Drive the delivery plane and the real sinks (``[slice delivery]``):
   phase 5's market (1 warm + 16 live ticks + the crash tick) through
   ``consume_loop`` at depth 1 with the plane on, its WAL (fsynced per
   put) in a temporary directory; the analytics POST over a stub backend,
   the Telegram consumer over a recording transport that meets flood
   control on sends 3-5 and fails sends 40-51, and autotrade admission
   (autotrade on, KuCoin futures) over a stub backend that answers HTTP 503
   to the first 20 bot creations, with drill-scale backoff and
   breaker cooldown. After live tick 12 the plane is killed undrained and a
   second plane on the same WAL replays the unacked entries. Checks: zero
   autotrade loss (every put reached admission and acked, none unacked in
   the WAL), no duplicate ack, lossy lanes balanced (enqueued = acked +
   shed + abandoned by the kill), Telegram retries, an open breaker and
   counted sheds, and, against a CPU engine (depth 0, copied rings, the
   same sinks without faults), the delivered payloads of every entry both
   delivered (analytics records, Telegram texts, autotrade dumps) and
   admission's REST calls per entry; qtail launches per tick and site as
   phase 5 counts them. The same drive on the inline path (plane off)
   takes the ticks in turns with the plane's engine; it prints both tick
   p50/p99, the finalize and emission host ms per tick and on the crash
   tick, the ms
   per fsynced WAL put, the queue-to-ack lag per sink, the replay ms and
   the WAL's bytes before and after the closing compaction.
8. Drive the tick's default observability (``[slice observability]``):
   phase 5's market under phase 6's breadth schedule (1 warm + 16 live
   ticks + the crash tick) through ``consume_loop`` at production defaults
   (depth 1, rings in place, digests, the meter, outcomes, the plane with
   its fsynced WAL, tracing at sample 1, freshness, host phase, the SLO
   plane, delivery health; the flight recorder's budget 50 ms, the delivery
   SLO 1000 ms, the freshness SLO 5000 ms), a ``MetricsServer`` on
   127.0.0.1:0 scraped after every tick and a ``/debug/profile?seconds=2``
   window opened over the second audit tick; a CPU engine with the same
   knobs is the reference. Checks: one completed trace per tick with the
   CPU's span names, the same traced ``(tick_seq, strategy, symbol)``
   entries per sink, the Telegram texts' trace lines, the payloads equal
   once the trace id and ``freshness_ms`` are masked (``freshness_ms`` at
   least the signal's lag0), ``bqt_freshness_ms`` once per signal and
   ``bqt_delivery_lag_ms`` once per ack, the crash tick among the slow
   ticks, the SLO verdict's zero-loss and zero-duplicate invariants and the
   same SLO names as the CPU's, the ``/metrics`` signal counter equal to
   the engine's after every tick, ``/healthz`` 200 ``ok``, ``/debug/slo``
   and ``/debug/symbols`` answering, the profiler trace naming the qtail
   kernel on the device, and qtail launches by site per tick equal to the
   CPU twin's calls. It prints the close→ack lag per sink from
   ``DeliveryHealth`` beside the queue→ack lag, the ``bqt_host_phase_ms``
   p50 per phase, the traces' busy and wall ms, the build ledger, and the
   slice's host cost: fresh engines with its switchable parts all on and
   all off (:data:`OBS_OFF`), four runs each in pairs whose first arm
   alternates, over the warm tick, 3 live ticks, an audit (every 4 ticks
   there) and 1 more, the lanes running in the loop's gaps
   (incremental-tick p50/p99 and audit-tick p50 of the tick's host path,
   its candles' ingest plus ``process_tick`` plus the finalize, and of the
   loop's ms from queueing a tick's klines to its signals emitted; the
   per-pair on − off of the host path's incremental p50).
9. Drive the subscription fan-out plane (``[slice fanout]``): phase 8's
   engine (phase 5's market under phase 6's breadth schedule, 1 warm + 16
   live ticks + the crash tick through ``consume_loop`` at production
   defaults) with the plane on at its defaults (``compact_frac`` 0.5,
   ``resume_tail`` 1024), its outbox and snapshot sidecar in a temporary
   directory, a checkpoint every 8 ticks; a CPU engine on the same script is
   the reference. 100,000 seeded subscriptions (10% wildcard, 30% one
   strategy, 30% 1-16 symbols, 15% symbols and a strategy, 10% a regime
   subset, 5% a ``min_strength`` from a grid with an unreachable 1e6) are
   bulk-loaded and pushed before the warm tick; live ticks 1-15 bring 400
   subscribes, 300 updates and 300 unsubscribes each, synced before the
   tick (tick 10 adds a flash mob that grows the planes, tick 13 an
   unsubscribe wave that compacts them); the hub serves 127.0.0.1:0 to a WS
   and an SSE watcher and holds a stalled consumer (a 2-frame queue nobody
   drains) that reconnects with its cursor after the crash. Checks: every
   fired signal's recipients on the card equal the oracle's predicate over
   the population the match ran against (``Subscription.matches``, all at
   once) and, for a sample, ``match_oracle`` itself; per (tick, strategy,
   symbol) they equal the CPU's but for subscribers whose floor lies within
   the wire tolerance of ``|score|`` (counted); frames (the trace id masked,
   the score at the wire tolerance) and the outbox; the ``bqt_fanout_*``
   counters; one full push for the load, the growth and the compaction and
   one incremental sync, of exactly its dirty cells, per other churn tick;
   the watchers got exactly what the hub broadcast to them; the stalled
   consumer's sheds and its cursor replay of exactly its outbox frames; the
   ``fanout_recipient_set`` invariant; a second card engine booted from the
   last archive and its snapshot (planes bit for bit, its first match on
   the crash tick's signals equal to the first engine's), and once more
   with the outbox in 4 partitions (the single-file log folded in) and the
   snapshot re-saved as a 4-shard set: the same recipient sets, and the
   same cursor replays for the protected users from three cursors; qtail launches by
   site per tick equal to the CPU twin's calls. Then 1,000,000 subscriptions
   alone: the full push, one match at K = 8, 128 and 2048 (CUDA events,
   warm) with its peak device memory, K=8 against the CPU torch path and
   K=2048 against ``match_oracle`` on 1,000 sampled users.
10. Drive the multi-tick drives. ``[slice scanned]``: phase 3's market
   through ``process_ticks_scanned`` (1 warm + 16 live ticks, audits every
   8: ticks 1-7 and 9-15 form two chunks), every wire, the fired tuples
   and the final rings and carry bit for bit against phase 3's serial
   incremental card drive, the chunk counters and wires (at the wire
   contract) against the CPU's scanned drive, the scan loop run under
   ``torch.cuda.set_sync_debug_mode("warn")`` (no synchronizing operation
   may be issued from the port's code); then phase 5's crash market with
   an audit every 12, so the crash tick lies inside the second chunk: one
   overflow re-drive, the serial drive's fired set and wires. Ms per chunk
   and per tick beside the serial incremental tick, peak device memory.
   ``[slice backtest]``: phase 3's market recipe with 48 live ticks on a
   classic engine, the warm tick through ``process_tick``, then
   ``process_ticks_backtest`` over a 16-tick and a 32-tick chunk: with
   ``ext_invariant`` off the fired set equals the serial classic card
   drive's and, on the first chunk, the CPU backtest's; with it on, equal
   but for flips inside the declared gate margins (printed); two qtail
   launches at ``abp_core_batch`` a chunk (2048x176, K=52 and 2048x224,
   K=100), none at ``abp_core`` on batched ticks, each equal to the twin;
   ms, ticks/s, candles/s and peak device memory a chunk. Then
   ``run_param_sweep`` on the same stream, 8 combos over
   ``abp.score_quantile`` x ``pt.rsi_oversold``, scoring on: two combos'
   counts against ``process_ticks_backtest`` runs at their params, one
   ``abp_core_batch`` pair per score quantile per chunk, every launch (the
   warm chunk's 2048x573 too) equal to the twin, the first chunk's counts
   and rankings against the CPU sweep's; the sweep's launches join the
   backtest drive's in the kernels line.
11. Boot the port as a service (``[slice live]``): ``run_live``, the
   entry point ``python -m binquant_tpu_torch`` runs, as a KuCoin futures
   deployment of S ``…USDTM`` contracts (XBTUSDTM as BTC), W bars, over
   fakes of every network client — the binbot backend (phase 6's breadth
   schedule, phase 7's autotrade backend, the settings and symbol list),
   the Telegram transport, the KuCoin futures REST client (a young
   listing's history, 110 15m bars and 330 5m bars a symbol, in the
   ``/kline/query`` row shape, and
   open interest growing 1.01, 1.02 or 1.05 every 15 minutes, one symbol
   failing from live tick 3) and the websocket (frames of the recorded
   session's shape: unclosed updates, one malformed frame, one connection
   closed before tick 3) — on a market whose BTC stalls on live ticks 2-3,
   where the hot and falling breadth opens LiquidationSweepPump's SHORT
   route. The service clock is driven: a tick closes each bar, and one
   open-interest sweep runs before it. Three cold boots, each backfill in
   one flush: on the card with the feed (4 live ticks, an audit every 2),
   on the card without it (``futures_api`` None, 3 ticks) and on the CPU
   with it (3 ticks).
   Checks: every closed candle frame put exactly one kline on the queue,
   equal to its bar, unclosed ones none; one parse error and one reconnect
   counted; the card's delivered signals equal the CPU's (fired set exact,
   scores at the wire contract); the feed vetoes at least one LSP row that
   fired without it (each growing under 1.02), scales the others by their
   growth, fires none the other did not, on a few dozen rows; no tick
   makes an open-interest request; ``/metrics`` carries every C3 and
   websocket family and the card sets the families the CPU sets; qtail
   launches by site per tick equal to the CPU's twin calls, each launch
   equal to the twin. It prints the time to the first signal after the
   cold boot in parts (backfill seconds, boot to ready, the first tick's
   queue-to-emitted ms), frames parsed per second, the incremental tick's
   p50 through the connector and the open-interest requests per sweep.
12. Drive the scenario engine, the chaos drills and the production-day
   soak (``[slice scenarios]``, ``sim/`` and ``soak/``), on the card only:
   the references are the pinned corpus (the JAX engine's own signal sets,
   ``tests/fixtures/scenario_signals.json``) and the drills' own oracles.
   A: ``rewrite_storm`` at S symbols and W bars (its 112 ticks, seed 29,
   chunks of 32) through ``run_spec``: serial incremental, scanned and
   serial classic, the three fired sets equal, routing exactly
   {cold_start, rewrite} with rewrite >= 6 and equal between the serial
   and the scanned drive, every check of the runner green (zero crash-ring
   entries, dedupe, heartbeat, outcome parity, numeric health) but the
   overflow script, which at this width is counted: the scanned drive
   overflows, and re-drives, on the serial drive's overflowing ticks. It
   prints the seconds to generate and to parse the stream, each drive's
   tick p50/p99 and ms per scanned chunk, and its peak device memory above
   what its engine held once built (the copies each qtail call leaves for
   the twin are kept in host memory, so the peak holds none of them). B: ``run_corpus(include_slow=False,
   chaos=True)``: the 11 scenarios at their own shapes, three drives each
   with every check of the runner, every signal set equal to its pinned
   set but for flips inside ``declared_gate_margins()`` (counted and
   printed; a flip only the pins hold fails: the card has no payload to
   judge it by), then the websocket, delivery and fan-out chaos drills,
   each ok. C: ``soak_drill(full=False)``: the verdict ok, every fault
   window attributed and none vacuous, zero autotrade loss and no
   duplicate ack across the kill, the resumed signals equal to the
   oracle's; it prints the victim's wall time and the close→ack p99 per
   sink. In all three, every serial tick's qtail launches by site are what
   its path makes (:func:`scenario_tick_sites`: 1 at ``abp_core`` a
   classic tick, 2 a full tick of an incremental engine, none an
   incremental tick, doubled plus ``detect_spikes`` on an overflow), the
   launches sum to the part's (the soak's ext-parity backtests aside), and
   each is held against the twin: as many twin checks as launches.
13. Drive the legacy per-symbol backend and the A/B check (``[slice
   oracle]``, ``oracle/`` and ``io/replay.py``'s ``run_replay_ab``): the
   oracle is the reference's control flow on the host (one symbol at a
   time, float64 numpy, no pandas) and shares no code with the batched
   path, so it is the one check on the card by an independent
   implementation. A: ``run_replay_ab(device="cuda")`` on the reference's
   four A/B fixtures at their 64 rows and 200 bars (the seed-7 replay with
   the incremental engine and rings in place, without and with the
   washed-out breadth; the dormant market with ``DORMANT_ORACLE_STRATEGIES``;
   the extended dormant market with ``DORMANT_ORACLE_EXTENDED``, its rising
   breadth and both dominance flags): every ``match`` true with signals
   fired, the breadth run firing all five live strategies and each dormant
   run its whole set, the seed-7 engines taking incremental ticks, and
   every qtail call (``abp_core`` and ``abp_init_from_window``; the spike
   detector's on the extended set) held against the twin. B: phase 3's
   market at S symbols and W bars, the warm tick and 4 live ticks through
   a classic card engine and through the oracle (window W, fed the warm
   history as kline dicts of the values the rings hold): the fired sets
   equal but for flips inside ``declared_gate_margins()``, each printed
   (judged by the card's payload, or by the oracle's own RSI/MFI where only
   the oracle fired), every qtail launch held against the twin. It prints
   the oracle's ingest seconds for the warm history, its ms per tick and
   per symbol-tick, and the card's classic tick p50 beside them. The
   oracle's runs of A and B go to a worker process at the phase's start,
   so they run while the card's engines do. C: every function of the
   batched indicator library (``ops/indicators.py``) on the same market's
   5m ring (S x W), on the card and on the CPU: NaN positions equal, values
   within ``rtol=1e-4, atol=1e-5``, the supertrend's direction exactly; ms
   per call on the card.
14. Profile the tick stage by stage (``[slice stages]``,
   ``binquant_tpu_torch/tools/``): ``profile_stages.run`` on the card at S
   symbols and W bars (the reference profiler's stages, market and seed),
   its table printed (p50 and max wall ms of a synchronized call, device
   ms between CUDA events, host-issue ms, device busy ms and operations per
   call from ``torch.profiler``, qtail launches by site at ``abp``,
   ``detect_spikes`` and the full ``tick_step``: 1, 1 and 3); it fails if
   the profiler lost any stage's device operations. The full and
   the incremental ``tick_step`` on the same market once more on the card
   and on the CPU: wires at the contract (the fired block exact, floats
   ``rtol=1e-4, atol=1e-5``), signals fired. ``sweep_report --demo`` on the
   card and on the CPU over two values of one of its axes (the demo's
   stream; its default 64-combo grid takes minutes on either): fire counts
   per combo and strategy equal. The CPU's side runs in a worker process
   (spawned at the phase's start, killed with this one) beside the card's.
   Every qtail launch of the phase is held against the twin, as many
   checks as launches (the profiled calls write nothing in place, so their
   tensors are held by reference: the timed calls carry no copies). It
   prints the card's name and power limit.
15. Shard the tick over the symbol mesh (``[slice sharded]``,
   ``binquant_tpu_torch/parallel/``): four shards of S/4 rows, all on the
   one card (``make_mesh([cuda:0] * 4)``, the counterpart of the
   reference's virtual CPU mesh; a host with four cards puts shard k on
   ``cuda:k`` with the same code). A phase-3-style market (W bars of warm
   history, then 4 live ticks) through an unsharded and a sharded serial
   engine (the latter placed by the engine's own ``place_on_mesh``), both
   digests on, the engines taking each tick in turns: the incremental
   drive (its cold start, incremental ticks, an audit with the drift meter
   on the last) and the classic drive. Same routing, wires within the
   reference's ``_parity_check`` rule (the fired block exact, floats
   ``atol=rtol=1e-5``, NaN equal; bit-equal ticks counted), every
   replicated leaf equal on the four shards after each tick, the drift
   meter's compared positions and verdicts equal. (On the CPU the sharded
   wire is the unsharded one bit for bit; on the card the library's
   per-row operations may sum a row in another order in a batch of S/4
   rows than in one of S, which the phase prints for the EWM's product, a
   row sum, a cumulative sum and the tick's fixed-order sum.) Then phase
   5's crash market's last 4 ticks (the crash overflows the wire) through
   an unsharded and a sharded
   engine at the production loop's defaults, at depth 1 and at depth 2:
   the same signal tuples. Every qtail launch of the phase is held against
   the twin, as many checks as launches, and the shards' launches are
   equal; no cross-shard collective may reach the reference's limit,
   S·W·F·4/16 bytes. It prints, per tick kind, the host p50 sharded and
   unsharded, the cross-shard bytes a tick and the largest collective; the
   device operations of one copying step of each evaluation, sharded and
   unsharded (one profiler session, the spin-kernel marks of phase 14);
   the launches by shard and by site; the card's name and power limit.
16. Print the kernels line, the card's name and power limit, and the result.

The drives are host-bound (the card is idle most of a tick), so after
phase 2 the phases run in three processes on the one card at once: this
one runs phases 5-8 and 11 and phase 12's part C, a second one (``--second
PATH``) phases 3, 4, 9, 10, 14 and 13, a third one (``--third PATH``) phase
12's parts A and B and phase 15; each is started by this one and killed
with it, writes its results to PATH and its standard
output to ``PATH.log`` (printed here when it ends). Each process zeroes
and reads its own launch counts around each of its drives; the kernels
line sums all three. Host times of any process are taken while the others
run. Phases 14 and 15 run in processes of their own because a profiler
session counts the card's activities in full only in a process that has
opened no profiler before (phase 8 opens one in this process, phase 14
its sessions in the second; after them the counts came short). All run
OpenMP with ``OMP_WAIT_POLICY=PASSIVE`` (unless set): the CPU engines'
threads sleep between parallel regions instead of spinning on the shared
cores.

Phase 5 times five card configurations (depth 1 in place; depth 0
copying; depth 0 copying without the digests and the meter; depth 2 on
double-buffered rings; depth 2 copying) over two rounds of the same
ticks, the engines taking each tick in turns, with the device idle before
every call, as between live ticks.

With ``--profile`` it also drives the incremental path and the production
loop once more each under ``torch.profiler`` and prints, per tick kind
(incremental, full), where the tick's time goes: host wall time, device
busy time and idle share, device activities per tick, the costliest
kernels.

With ``--cold-boot`` it builds the kernel and then only boots phase 11's
service on the card with the backfill at the production flush of every 50
symbols, to its first live tick (:func:`cold_boot`), prints the time to the
first signal in parts, and prints no result.

With ``--fold-ab`` it builds the kernel and then only times the
update-only folds of phase 6's service path (a restart's top-up flush, a
cold backfill's flush, a restore catch-up) through the stacked fold and
through the per-pair loop (:func:`fold_ab`), and prints no result.

It exits nonzero without printing a result when CUDA is unavailable or when
run outside a checkout that holds the ``binquant_tpu_torch`` package.

The smoke runs as CI: it sets ``ENV=CI`` in its own environment (the
processes it starts inherit it), as the test suite does, so the ``Config``
every stub engine builds inside the port skips the production check of the
deployment's environment variables.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S, W = 2048, 400
LIVE_TICKS = 16  # live ticks of the incremental drive (and before the crash)
CLASSIC_TICKS = 4  # live ticks of the classic drive
AUDIT_EVERY = 8  # the full-recompute audit cadence of the incremental drives
DORMANT_TICKS = 2  # live ticks of each dormant-market drive (its audit on the last)
TILED_BARS = 130  # the reference's dormant markets' own length, tiled over S rows
TILED_TICKS = 2  # live ticks of each tiled drive (the setups are on the last two)
# the classic, incremental and dormant-market drives: the serial loop, copied
# rings, no digests, no outcome tracker, the sinks called inline
# the tick's observability off as far as it has switches: the reference's
# five and the port's switch of the ingest watermarks, so phases 3-7 check
# what they checked before it was ported (phase 8 drives it at its
# defaults). What has no switch stays on: the LatencyTracker's records, the
# tick, signal, overflow and full-recompute counters and the queue gauges,
# the per-signal ``signal`` event, the heartbeat file, the sampled-out
# (null) spans and the batchers' arrival stamps.
OBS_OFF = dict(trace_sample=0.0, freshness=False, host_phase=False, slo=False,
               delivery_health=False, ingest_watermarks=False)
# the subscription fan-out plane off, so phases 3-8 check and time what they
# did before it was ported (phase 9 drives it at its defaults)
FANOUT_OFF = dict(fanout=False)
SERIAL = dict(pipeline_depth=0, donate=False, numeric_digest=False, ingest_digest=False,
              drift_meter=False, outcomes=False, delivery=False, **OBS_OFF, **FANOUT_OFF)
# the extended dormant market's scripted breadth: rising twice
RISING_BREADTH = {
    "timestamp": [1, 2, 3, 4],
    "market_breadth": [0.30, 0.34, 0.38, 0.42],
    "market_breadth_ma": [0.30, 0.36],
}
T_LIVE0 = 1_780_272_000 + 900 * 2000  # 15m-aligned start of the live ticks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
SEED = 2026



def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per call of a host loop of ``fn`` between two events: the device
    time when the device is the slower, else the host's issue time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls: int = 200, replays: int = 5) -> float:
    """Device time per call: ``calls`` calls of ``fn`` captured in one CUDA
    graph, replayed between two events; the median of ``replays`` replays.
    The host issues one replay, so its per-call cost drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


# --------------------------------------------------------------------------
# phase 2: kernel vs twin
# --------------------------------------------------------------------------


def quantile_inputs(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    x = rng.random((rows, cols), dtype=np.float32)
    x[3, : cols // 2] = np.nan  # leading NaN (the ring's warm-up pattern)
    x[7, :] = np.nan  # all-NaN row
    x[11, -3:] = np.nan  # NaN inside the evaluated windows
    x[13, 10:40] = x[13, 0]  # ties
    x[17, -20:-10] = np.inf  # +inf inside the windows
    x[19, -30:-25] = -np.inf
    x[23, :] = 0.5  # a constant row: every element ties
    x[29, -40:] = np.where(np.arange(40) % 2 == 0, -0.0, 0.0)  # interleaved ±0.0
    return x


def check_quantile_kernel() -> dict:
    import torch

    from binquant_tpu_torch.ops import quantile_tail as qt

    rng = np.random.default_rng(SEED)
    cases = [
        # (label, rows, cols, L, K, q, min_periods)
        ("abp", S, 128, 80, 4, 0.92, 20),
        ("spike_hunter", S, 400, 60, 1, 0.85, 20),
        ("abp_batch16", S, 176, 80, 52, 0.92, 20),
        ("abp_batch", S, 224, 80, 100, 0.92, 20),
        ("abp_batch_warm", S, BT_WARM_QTAIL[0], 80, BT_WARM_QTAIL[1], 0.92, 20),
        ("short_input", 64, 60, 80, 4, 0.92, 20),
        # phase 12's corpus, drills and soak (32 rows, a 120-bar window):
        # abp_core and abp_init_from_window, then abp_core_batch on the
        # soak's backtest chunks: its 16-tick ones and its two others
        ("scn_abp", 32, 120, 80, 4, 0.92, 20),
        ("scn_batch16", 32, 168, 80, 52, 0.92, 20),
        ("scn_batch43", 32, 159, 80, 43, 0.92, 20),
        ("scn_batch91", 32, 207, 80, 91, 0.92, 20),
        # phase 13's A/B fixtures (64 rows, a 200-bar window): abp_core and
        # abp_init_from_window, and detect_spikes on the extended dormant set
        ("ab_abp", 64, 128, 80, 4, 0.92, 20),
        ("ab_spike", 64, 200, 60, 1, 0.85, 20),
    ]
    # the card's launch floor: the same graph method on the least work
    one = torch.zeros((1, 1), dtype=torch.float32, device="cuda")
    floor_ms = graph_time_ms(lambda: qt.rolling_quantile_tail(one, 1, 0.5))
    floor_call_ms = cuda_time_ms(lambda: qt.rolling_quantile_tail(one, 1, 0.5), iters=200)
    print(f"[qtail floor] S=1 L=1 K=1: device {floor_ms:.5f} ms per launch, "
          f"host-issued call {floor_call_ms:.5f} ms")
    report = {}
    for label, rows, cols, L, K, q, mp in cases:
        x = torch.from_numpy(quantile_inputs(rng, rows, cols)).cuda()
        out = qt.rolling_quantile_tail(x, L, q, num_out=K, min_periods=mp)
        twin = qt.rolling_quantile_tail_reference(x, L, q, num_out=K, min_periods=mp)
        cpu_twin = qt.rolling_quantile_tail_reference(x.cpu(), L, q, num_out=K, min_periods=mp)
        torch.cuda.synchronize()
        out_c, twin_c = out.cpu(), twin.cpu()
        nan_equal = torch.equal(torch.isnan(out_c), torch.isnan(twin_c))

        def bits(t):
            return torch.nan_to_num(t, nan=-9e9).view(torch.int32)

        bits_equal = torch.equal(bits(out_c), bits(twin_c)) and torch.equal(
            bits(out_c), bits(cpu_twin)
        )
        if not (nan_equal and bits_equal):
            diff = (torch.nan_to_num(out_c) - torch.nan_to_num(twin_c)).abs().max()
            fail(f"qtail kernel != twin on {label}: nan_equal={nan_equal}, max diff {diff}")
        finite = torch.isfinite(out_c) & torch.isfinite(twin_c)
        max_abs_err = float((out_c[finite] - twin_c[finite]).abs().max()) if finite.any() else 0.0
        need = min(L + K - 1, cols)

        def kernel():
            return qt.rolling_quantile_tail(x, L, q, num_out=K, min_periods=mp)

        kernel_ms = graph_time_ms(kernel)
        call_ms = cuda_time_ms(kernel, iters=200)
        twin_ms = cuda_time_ms(
            lambda: qt.rolling_quantile_tail_reference(x, L, q, num_out=K, min_periods=mp),
            iters=20,
        )
        # the yardstick: torch.nanquantile over the K trailing windows; a
        # short input is left-padded with NaN to L+K-1 columns first, the
        # positions before the row start
        span = x[:, cols - need:]
        if cols < L + K - 1:
            pad = torch.full((rows, L + K - 1 - cols), float("nan"), device=x.device)
            span = torch.cat([pad, span], dim=1)
        windows = span.unfold(-1, L, 1)  # (rows, K, L)
        library_ms = cuda_time_ms(lambda: torch.nanquantile(windows, q, dim=-1), iters=20)
        # the least work of the function, not of this design's O(L^2) count
        # rank: read each input column once, write each output once, and
        # compare each window element at least once to select its quantile
        bytes_moved = rows * need * 4 + rows * K * 4
        ops = rows * K * L
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        report[label] = {
            "shape": [rows, cols], "L": L, "K": K, "q": q, "min_periods": mp,
            "equal_to_twin": True, "max_abs_err": max_abs_err,
            "kernel_ms": kernel_ms, "call_ms": call_ms,
            "floor_ms": floor_ms, "floor_call_ms": floor_call_ms,
            "twin_ms": twin_ms, "library_ms": library_ms,
            "bytes": bytes_moved, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(
            f"[qtail {label}] {rows}x{cols} L={L} K={K}: equal to twin; "
            f"kernel {kernel_ms:.5f} ms on the device ({kernel_ms / floor_ms:.2f}x floor), "
            f"call {call_ms:.5f} ms, twin {twin_ms:.4f} ms, "
            f"nanquantile {library_ms:.4f} ms, "
            f"bound {report[label]['bound_ms']:.6f} ms ({report[label]['bound_by']})"
        )
    return report


# --------------------------------------------------------------------------
# phase 3: the classic and the incremental live paths at full width
# --------------------------------------------------------------------------


def symbols() -> list[str]:
    return ["BTCUSDT"] + [f"S{i:04d}USDT" for i in range(1, S)]


def make_market(rng: np.random.Generator, live_ticks: int = LIVE_TICKS):
    """Seeded 5m OHLCV for S symbols over the warm history plus
    ``live_ticks`` live ticks, and the 15m bars aggregated from it. Some
    symbols get a volume burst on the last 5m bar of a live tick
    (ActivityBurstPump's setup)."""
    n15 = W + live_ticks
    n5 = 3 * n15
    rets = rng.normal(0.0, 0.004, (S, n5)).astype(np.float64)
    rets[1::29] -= 0.0015  # a drifting-down cohort: oversold setups
    close = (20 + rng.random((S, 1)) * 100) * np.exp(np.cumsum(rets, axis=1))
    open_ = np.concatenate([close[:, :1], close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(1000, 200, (S, n5)))
    high = np.maximum(open_, close) * 1.001
    low = np.minimum(open_, close) * 0.999
    # bursts: per live tick, 12 symbols' last 5m bar jumps +3% on 8x volume
    # after two up bars
    for t in range(live_ticks):
        rows = rng.choice(np.arange(2, S), 12, replace=False)
        j = 3 * (W + t) + 2
        for r in rows:
            close[r, j - 2] = open_[r, j - 2] * 1.003
            open_[r, j - 1] = close[r, j - 2]
            close[r, j - 1] = open_[r, j - 1] * 1.003
            open_[r, j] = close[r, j - 1]
            close[r, j] = open_[r, j] * 1.03
            high[r, j - 2:j + 1] = np.maximum(open_[r, j - 2:j + 1], close[r, j - 2:j + 1]) * 1.001
            low[r, j - 2:j + 1] = np.minimum(open_[r, j - 2:j + 1], close[r, j - 2:j + 1]) * 0.999
            high[r, j] = close[r, j] * 1.002
            vol[r, j] *= 8.0
            if j + 1 < n5:
                open_[r, j + 1] = close[r, j]
    m5 = dict(open=open_, high=high, low=low, close=close, volume=vol)
    g = lambda a: a.reshape(S, n15, 3)
    m15 = dict(
        open=g(open_)[:, :, 0],
        high=g(high).max(axis=2),
        low=g(low).min(axis=2),
        close=g(close)[:, :, 2],
        volume=g(vol).sum(axis=2),
    )
    return m5, m15


def make_crash_market(rng: np.random.Generator):
    """The production drive's market: W bars of warm history as
    :func:`make_market` makes it (a 5m random walk, the 15m bars aggregated
    from it), then LIVE_TICKS + 1 15m bars shaped as ``generate_burst_replay``
    shapes its own (three 5m legs from each bar's open to its close): a
    market-wide downtrend (-0.4% +- 0.2% a bar, which pins RSI low), and on
    the last bar the crash: every symbol gaps 4.5% under its close and
    closes 0.3% green on 3x volume, a hammer under the lower band that fires
    MeanReversionFade on more rows than the wire's 128 slots."""
    n_live = LIVE_TICKS + 1
    rets5 = rng.normal(0.0, 0.004, (S, 3 * W))
    close5 = (20 + rng.random((S, 1)) * 100) * np.exp(np.cumsum(rets5, axis=1))
    open5 = np.concatenate([close5[:, :1], close5[:, :-1]], axis=1)
    vol5 = np.abs(rng.normal(1000, 200, (S, 3 * W)))

    last = close5[:, -1:]
    close = last * np.exp(np.cumsum(rng.normal(-0.004, 0.002, (S, n_live)), axis=1))
    open_ = np.concatenate([last, close[:, :-1]], axis=1)
    vol = np.abs(rng.normal(3000, 600, (S, n_live)))
    open_[:, -1] *= 0.955
    close[:, -1] = open_[:, -1] * 1.003
    vol[:, -1] *= 3.0
    legs = [open_ + (close - open_) * (j + 1) / 3 for j in range(3)]
    lo5 = np.stack([open_, legs[0], legs[1]], axis=2).reshape(S, 3 * n_live)
    lc5 = np.stack(legs, axis=2).reshape(S, 3 * n_live)
    open5 = np.concatenate([open5, lo5], axis=1)
    close5 = np.concatenate([close5, lc5], axis=1)
    vol5 = np.concatenate([vol5, np.repeat(vol / 3, 3, axis=1)], axis=1)
    high5 = np.maximum(open5, close5) * 1.001
    low5 = np.minimum(open5, close5) * 0.999
    m5 = dict(open=open5, high=high5, low=low5, close=close5, volume=vol5)
    g = lambda a: a.reshape(S, W + n_live, 3)
    m15 = dict(
        open=g(open5)[:, :, 0], high=g(high5).max(axis=2), low=g(low5).min(axis=2),
        close=g(close5)[:, :, 2], volume=g(vol5).sum(axis=2),
    )
    # the crash bar's own range: from just under its open to just over its close
    m15["high"][:, -1] = close[:, -1] * 1.001
    m15["low"][:, -1] = open_[:, -1] * 0.997
    return m5, m15


def bar_values(m: dict, cols: slice, interval_s: int) -> np.ndarray:
    """(S, n, 10) value planes in the ring's field order."""
    o, h, lo, c, v = (m[k][:, cols] for k in ("open", "high", "low", "close", "volume"))
    return np.stack(
        [o, h, lo, c, v, v * c, np.full_like(c, 300.0), v / 2, v * c / 2,
         np.full_like(c, float(interval_s))],
        axis=-1,
    ).astype(np.float32)


def kline(symbol, ts_s, interval_s, m, i) -> dict:
    o, h, lo, c, v = (float(m[k][symbol[1], i]) for k in ("open", "high", "low", "close", "volume"))
    return {
        "symbol": symbol[0],
        "open_time": ts_s * 1000,
        "close_time": (ts_s + interval_s) * 1000 - 1,
        "open": o, "high": h, "low": lo, "close": c, "volume": v,
        "quote_asset_volume": v * c,
        "number_of_trades": 300.0,
        "taker_buy_base_volume": v / 2,
        "taker_buy_quote_volume": v * c / 2,
    }


def live_ticks_of(m5: dict, m15: dict, live_ticks: int, warm: int = W):
    """The ticks after ``warm`` 15m bars of history: ``live_ticks`` ticks of
    closed klines (one 15m and three 5m bars per symbol), each as (now_ms,
    klines)."""
    names = symbols()
    ticks: list[tuple[int, list[dict]]] = []
    for t in range(live_ticks):
        ts15 = T_LIVE0 + 900 * t
        klines = []
        for r, name in enumerate(names):
            klines.append(kline((name, r), ts15, 900, m15, warm + t))
            for j in range(3):
                klines.append(kline((name, r), ts15 + 300 * j, 300, m5, 3 * (warm + t) + j))
        ticks.append(((ts15 + 900) * 1000, klines))
    return ticks


def tick_plan(
    engine, m5: dict, m15: dict, live_ticks: int, warm: int = W
) -> list[tuple[int, list[dict]]]:
    """Queue ``warm`` bars of 15m history (and up to W of their 5m bars) as
    ``add_batch`` sub-batches (folded by the first tick) and return the
    ticks: the warm tick, then the live ticks of :func:`live_ticks_of`."""
    queue_warm(engine, m5, m15, warm)
    return [(T_LIVE0 * 1000, [])] + live_ticks_of(m5, m15, live_ticks, warm)


def queue_warm(engine, m5: dict, m15: dict, warm: int = W) -> None:
    """Register the symbols and queue the warm history on ``engine``'s
    batchers (:func:`tick_plan`'s first half)."""
    names = symbols()
    rows = np.array([engine.registry.add(n) for n in names], dtype=np.int32)
    n5 = min(3 * warm, W)
    w15 = bar_values(m15, slice(0, warm), 900)
    w5 = bar_values(m5, slice(3 * warm - n5, 3 * warm), 300)
    t15 = T_LIVE0 - 900 * warm
    t5 = T_LIVE0 - 300 * n5
    for k in range(warm):
        engine.batcher15.add_batch(rows, np.full(S, t15 + 900 * k, np.int32), w15[:, k])
    for k in range(n5):
        engine.batcher5.add_batch(rows, np.full(S, t5 + 300 * k, np.int32), w5[:, k])


def drive(
    device: str, m5: dict, m15: dict, incremental: bool, live_ticks: int, profiler=None,
    enabled: set | None = None, breadth: dict | None = None, host_flags: dict | None = None,
    warm: int = W, audit_every: int = AUDIT_EVERY,
) -> dict:
    """Warm tick plus ``live_ticks`` live ticks through one engine on
    ``device``. Per tick it records the path the engine took, the qtail
    launches (and their call sites) the tick made, the host wall time, the
    wire and the fired signals with their indicator payloads. A
    ``torch.profiler.profile`` passed as ``profiler`` records the live ticks
    only, each inside a ``chip_smoke_tick`` range. ``enabled`` names the
    strategies on the wire (the live set by default), ``breadth`` the
    stub's breadth series, ``host_flags`` the autotrade consumer's scripted
    host flags (the market-dominance flags), ``warm`` the 15m bars of
    history before the live ticks, ``audit_every`` the incremental path's
    audit cadence."""
    import torch

    from binquant_tpu_torch.io.replay import make_stub_engine, signal_tuples
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device,
        incremental=incremental, carry_audit_every=audit_every, enabled_strategies=enabled,
        breadth=breadth, **SERIAL,
    )
    for name, value in (host_flags or {}).items():
        setattr(engine.at_consumer, name, value)
    ticks = tick_plan(engine, m5, m15, live_ticks, warm)
    out = {"paths": [], "launches": [], "sites": [], "tick_ms": [], "wires": [],
           "fired": [], "indicators": {}, "overflowed": []}

    async def tick(now_ms, klines, live):
        for k in klines:
            engine.ingest(k)
        if device == "cuda":
            torch.cuda.synchronize()
        before, sites = qt.launches, dict(qt.launches_by_site)
        overflows = engine.overflow_ticks
        rng = (
            torch.profiler.record_function("chip_smoke_tick")
            if profiler is not None and live else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with rng:
            fired = await engine.process_tick(now_ms=now_ms)
            if device == "cuda":
                torch.cuda.synchronize()
        out["tick_ms"].append((time.perf_counter() - t0) * 1000.0)
        out["launches"].append(qt.launches - before)
        out["sites"].append({
            k: v - sites.get(k, 0) for k, v in qt.launches_by_site.items() if v != sites.get(k, 0)
        })
        out["paths"].append(engine.last_path)
        out["overflowed"].append(engine.overflow_ticks > overflows)
        out["wires"].append(engine.last_wire)
        for sig, tup in zip(fired, signal_tuples(fired)):
            out["fired"].append(tup)
            out["indicators"][tup] = sig.analytics["indicators"]

    async def run():
        await tick(*ticks[0], live=False)
        with profiler if profiler is not None else contextlib.nullcontext():
            for now_ms, klines in ticks[1:]:
                await tick(now_ms, klines, live=True)
        if await engine.flush_pending():
            fail("a depth-0 engine left a tick in flight")

    asyncio.run(run())
    out.update(engine=engine, ticks=len(ticks), tick_times=[t for t, _ in ticks])
    return out


def compare_drives(gpu: dict, cpu: dict, label: str) -> float:
    """The card's drive against the CPU's on the same stream: equal routing
    and fired sets, wires with the fired block exact and floats within
    ``rtol=1e-4, atol=1e-5`` (NaN equal), rings bit for bit. Returns the
    largest finite wire difference."""
    import torch

    from binquant_tpu_torch.engine.step import WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED

    if gpu["paths"] != cpu["paths"]:
        fail(f"{label}: routing differs between the card and the CPU")
    if not gpu["fired"]:
        fail(f"{label}: no signal fired on the card's drive")
    if sorted(gpu["fired"]) != sorted(cpu["fired"]):
        only_gpu = sorted(set(gpu["fired"]) - set(cpu["fired"]))[:5]
        only_cpu = sorted(set(cpu["fired"]) - set(gpu["fired"]))[:5]
        fail(f"{label}: fired sets differ: card-only {only_gpu}, cpu-only {only_cpu}")
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    max_wire_err = 0.0
    for wg, wc in zip(gpu["wires"], cpu["wires"], strict=True):
        if wg.shape != wc.shape:
            fail(f"{label}: wire lengths differ: {wg.shape} vs {wc.shape}")
        if wg[off] != wc[off]:
            fail(f"{label}: fired counts differ: {wg[off]} vs {wc[off]}")
        blk_g = wg[off + 1: off + 1 + 6 * K].reshape(6, K)
        blk_c = wc[off + 1: off + 1 + 6 * K].reshape(6, K)
        if not np.array_equal(blk_g[:4], blk_c[:4]):
            fail(f"{label}: fired (strategy, row, autotrade, direction) blocks differ")
        # cumsum/matmul/libm orders differ between the card and the CPU:
        # float fields agree to a few float32 ulps of their magnitude
        ok = np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True)
        if not ok.all():
            bad = np.flatnonzero(~ok)[:5]
            fail(f"{label}: wire floats differ at {bad.tolist()}: {wg[bad]} vs {wc[bad]}")
        fin = np.isfinite(wg) & np.isfinite(wc)
        max_wire_err = max(max_wire_err, float(np.abs(wg[fin] - wc[fin]).max()))
    st, cst = gpu["engine"].state, cpu["engine"].state
    for name in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a = getattr(getattr(st, name), f).cpu()
            b = getattr(getattr(cst, name), f)
            if not torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                               torch.nan_to_num(b.float(), nan=-1.0)):
                fail(f"{label}: {name}.{f} differs between the card and the CPU")
    return max_wire_err


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], tree


# carry leaves whose values do not depend on a summation order: equal bit for
# bit between the card and the CPU
EXACT_CARRY_LEAVES = {
    "last_ts", "rel", "cnt", "n_seen", "has_qav", "dirty", "bc_dirty", "raw_ring",
    "abp5.vol_med.sorted", "abp5.qvol_med.sorted", "abp5.score_q.sorted", "abp5.score_ring",
}


def compare_exact_carry(gpu: dict, cpu: dict) -> tuple[int, int, int]:
    """The carry's order-free leaves, card against CPU, bit for bit (a
    failure otherwise). Returns (order-free leaves, float sum leaves, those
    of them equal bit for bit too): the inits' fixed-order sums make most
    of the float sums equal as well, which is reported, not required."""
    card = dict(_leaves(gpu["engine"].state.indicator_carry))
    host = dict(_leaves(cpu["engine"].state.indicator_carry))
    n_exact = n_float = n_float_equal = 0
    for path, a in card.items():
        a, b = a.cpu().numpy(), host[path].numpy()
        equal = a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        if path in EXACT_CARRY_LEAVES or path.rsplit(".", 1)[-1] in EXACT_CARRY_LEAVES:
            if not equal:
                fail(f"carry leaf {path} differs between the card and the CPU")
            n_exact += 1
        else:
            n_float += 1
            n_float_equal += int(equal)
    return n_exact, n_float, n_float_equal


def gate_flips(incr: dict, classic: dict) -> tuple[list, list]:
    """Signals on which the incremental and the classic drive disagree, over
    the classic drive's ticks, and those among them that are NOT a flip
    inside a declared gate margin: the row's gated indicator (RSI/MFI
    points, from the payload of the drive that fired) within
    ``declared_gate_margins()`` of its threshold."""
    from binquant_tpu_torch.strategies.params import StrategyParams, declared_gate_margins

    margins = declared_gate_margins()
    p = StrategyParams()
    gates = {
        "coinrule_price_tracker": [("rsi", p.pt.rsi_oversold), ("mfi", p.pt.mfi_oversold)],
        "mean_reversion_fade": [("rsi", p.mrf.rsi_long_max), ("rsi", p.mrf.rsi_short_min)],
    }
    common = set(classic["tick_times"])
    a = {f for f in incr["fired"] if f[0] in common}
    b = set(classic["fired"])
    flips = sorted(a ^ b)
    bad = []
    for f in flips:
        ind = incr["indicators"].get(f) or classic["indicators"].get(f) or {}
        dists = [
            abs(float(ind[k]) - thr) for k, thr in gates.get(f[1], ())
            if ind.get(k) is not None and np.isfinite(float(ind[k]))
        ]
        if f[1] not in margins or not dists or min(dists) > margins[f[1]]:
            bad.append(f)
    return flips, bad


def _launch_report(run: dict) -> dict:
    by_site: dict[str, int] = {}
    for d in run["sites"]:
        for k, v in d.items():
            by_site[k] = by_site.get(k, 0) + v
    return {"launches": sum(run["launches"]), "launches_by_site": by_site}


def check_classic(m5, m15) -> dict:
    """The classic live path (``incremental=False``): one qtail launch per
    tick (``abp_core``), card against CPU."""
    import torch

    from binquant_tpu_torch.ops import quantile_tail as qt

    qt.reset_launches()  # launches made by the comparisons above do not count
    gpu = drive("cuda", m5, m15, incremental=False, live_ticks=CLASSIC_TICKS)
    counts = _launch_report(gpu)  # read just after the drive
    cpu = drive("cpu", m5, m15, incremental=False, live_ticks=CLASSIC_TICKS)
    if set(gpu["paths"]) != {"classic"}:
        fail(f"classic drive took {sorted(set(gpu['paths']))}")
    if gpu["launches"] != [1] * gpu["ticks"]:
        fail(f"classic drive: qtail launches per tick {gpu['launches']}, expected 1 each")
    max_wire_err = compare_drives(gpu, cpu, "classic")
    live = np.asarray(gpu["tick_ms"][1:])
    by_strategy = _by_strategy(gpu["fired"])
    st = gpu["engine"].state
    ring_bytes = sum(
        t.numel() * t.element_size()
        for b in (st.buf5, st.buf15)
        for t in (b.times, b.values, b.filled, b.cursor)
    )
    result = {
        "ticks": gpu["ticks"],
        **counts,
        "signals": len(gpu["fired"]),
        "signals_by_strategy": by_strategy,
        "warm_tick_ms": gpu["tick_ms"][0],
        "tick_p50_ms": float(np.percentile(live, 50)),
        "tick_p99_ms": float(np.percentile(live, 99)),
        "cpu_tick_p50_ms": float(np.percentile(np.asarray(cpu["tick_ms"][1:]), 50)),
        "ring_bytes_on_device": ring_bytes,
        "max_wire_abs_err_vs_cpu": max_wire_err,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print(
        f"[slice classic] S={S} W={W}: {result['ticks']} ticks (1 warm + {CLASSIC_TICKS} live), "
        f"qtail launches {result['launches']} (1 per tick), signals {result['signals']} "
        f"{by_strategy}, tick p50 {result['tick_p50_ms']:.2f} ms p99 "
        f"{result['tick_p99_ms']:.2f} ms (warm tick {result['warm_tick_ms']:.1f} ms; cpu p50 "
        f"{result['cpu_tick_p50_ms']:.1f} ms), rings on device {ring_bytes / 2**20:.1f} MiB, "
        f"fired sets equal to the cpu engine"
    )
    return {**result, "fired": gpu["fired"], "indicators": gpu["indicators"],
            "tick_times": gpu["tick_times"]}


def _by_strategy(fired) -> dict[str, int]:
    out: dict[str, int] = {}
    for _, strat, *_rest in fired:
        out[strat] = out.get(strat, 0) + 1
    return out


def check_incremental(m5, m15, classic: dict, keep: dict | None = None) -> dict:
    """The incremental live path (the production default), card against
    CPU: the routing schedule, two qtail launches on every full tick and
    none on an incremental one, the carry's order-free leaves bit for bit,
    and the fired set against the classic drive's. ``keep`` receives the
    card's drive (phase 10 holds the scanned drive against it)."""
    import torch

    from binquant_tpu_torch.engine.buffer import Field, materialize
    from binquant_tpu_torch.engine.step import init_indicator_carry
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.ops.incremental import supertrend_init

    qt.reset_launches()
    gpu = drive("cuda", m5, m15, incremental=True, live_ticks=LIVE_TICKS)
    counts = _launch_report(gpu)  # read just after the drive
    cpu = drive("cpu", m5, m15, incremental=True, live_ticks=LIVE_TICKS)

    expect = ["cold_start"] + [
        "audit" if t % AUDIT_EVERY == 0 else "incremental" for t in range(1, LIVE_TICKS + 1)
    ]
    if gpu["paths"] != expect:
        fail(f"incremental drive routing {gpu['paths']}, expected {expect}")
    full = [p != "incremental" for p in gpu["paths"]]
    if gpu["launches"] != [2 if f else 0 for f in full]:
        fail(f"qtail launches per tick {gpu['launches']}: 2 on a full tick, 0 else")
    for f, sites in zip(full, gpu["sites"]):
        want = {"abp_core": 1, "abp_init_from_window": 1} if f else {}
        if sites != want:
            fail(f"qtail call sites per tick {gpu['sites']}")
    max_wire_err = compare_drives(gpu, cpu, "incremental")
    if keep is not None:
        keep.update(gpu)
    exact_leaves, float_leaves, float_equal = compare_exact_carry(gpu, cpu)
    flips, bad = gate_flips(gpu, classic)
    if bad:
        fail(f"incremental vs classic on the card: flips outside the gate margins {bad[:5]}")

    # the supertrend scan inside every full recompute, and the whole carry
    # init, timed alone at the engine's shapes (the scan feeds only a
    # dormant strategy); launches made here are not the main path's
    buf5 = materialize(gpu["engine"].state.buf5)
    buf15 = materialize(gpu["engine"].state.buf15)
    start = (W - buf5.filled + 99).to(torch.int32)
    v = buf5.values

    def scan():
        return supertrend_init(v[:, :, Field.HIGH], v[:, :, Field.LOW], v[:, :, Field.CLOSE],
                               10, 3.0, start=start)

    st_scan_ms = cuda_time_ms(scan, iters=3, warmup=1)
    init_ms = cuda_time_ms(
        lambda: init_indicator_carry(buf5, buf15, torch.tensor(0, dtype=torch.int32,
                                                              device=buf5.times.device)),
        iters=3, warmup=1,
    )
    live = np.asarray(gpu["tick_ms"][1:])
    live_full = np.asarray([t for t, f in zip(gpu["tick_ms"][1:], full[1:]) if f])
    live_incr = np.asarray([t for t, f in zip(gpu["tick_ms"][1:], full[1:]) if not f])
    by_strategy = _by_strategy(gpu["fired"])
    routing = dict(gpu["engine"].full_recompute_reasons)
    routing["incremental"] = gpu["engine"].incremental_ticks
    result = {
        "ticks": gpu["ticks"],
        **counts,
        "launches_per_tick": gpu["launches"],
        "paths": gpu["paths"],
        "routing": routing,
        "signals": len(gpu["fired"]),
        "signals_by_strategy": by_strategy,
        "warm_tick_ms": gpu["tick_ms"][0],
        "incremental_tick_p50_ms": float(np.percentile(live_incr, 50)),
        "incremental_tick_p99_ms": float(np.percentile(live_incr, 99)),
        "full_tick_p50_ms": float(np.percentile(live_full, 50)),
        "full_tick_p99_ms": float(np.percentile(live_full, 99)),
        "full_tick_ms": live_full.tolist(),
        "tick_p50_ms": float(np.percentile(live, 50)),
        "cpu_incremental_tick_p50_ms": float(np.percentile(
            [t for t, f in zip(cpu["tick_ms"][1:], full[1:]) if not f], 50)),
        "max_wire_abs_err_vs_cpu": max_wire_err,
        "exact_carry_leaves_equal": exact_leaves,
        "float_carry_leaves_bit_equal": [float_equal, float_leaves],
        "flips_vs_classic": len(flips),
        "supertrend_scan_ms": st_scan_ms,
        "init_indicator_carry_ms": init_ms,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print(
        f"[slice incremental] S={S} W={W}: {result['ticks']} ticks (1 warm + {LIVE_TICKS} "
        f"live, audit every {AUDIT_EVERY}), routing {routing}, qtail launches "
        f"{result['launches']} {counts['launches_by_site']} (per tick {gpu['launches']}), "
        f"signals {result['signals']} {by_strategy}; incremental tick p50 "
        f"{result['incremental_tick_p50_ms']:.2f} ms p99 {result['incremental_tick_p99_ms']:.2f} ms, "
        f"full tick p50 {result['full_tick_p50_ms']:.2f} ms p99 {result['full_tick_p99_ms']:.2f} ms "
        f"(warm {result['warm_tick_ms']:.1f} ms; cpu incremental p50 "
        f"{result['cpu_incremental_tick_p50_ms']:.1f} ms); supertrend scan {st_scan_ms:.2f} ms, "
        f"carry init {init_ms:.2f} ms alone; fired sets, routing, rings and "
        f"{exact_leaves} order-free carry leaves equal to the cpu engine (and "
        f"{float_equal} of {float_leaves} float sums bit for bit); "
        f"{len(flips)} flips vs the classic drive, all inside the gate margins"
    )
    return result


# --------------------------------------------------------------------------
# phase 4: the dormant strategy set with the spike detector
# --------------------------------------------------------------------------


def market_from_bars(bars: dict) -> tuple[dict, dict]:
    """The replay generators' (n_ticks, S) 15m bars and (n_ticks, S, 3) 5m
    sub-bars as the (S, n) and (S, 3n) market planes :func:`tick_plan`
    reads."""
    m15 = {k: v.T.copy() for k, v in bars["15m"].items()}
    m5 = {k: v.transpose(1, 0, 2).reshape(S, -1).copy() for k, v in bars["5m"].items()}
    return m5, m15


def tiled_bars(bars: dict, n_rows: int) -> dict:
    """A market's bars over ``n_rows`` symbols: its BTC row once, then its
    other rows cycled (each copy a symbol of its own), so the
    cross-sectional shares the breadth gates read stay the source's."""
    src = bars["15m"]["close"].shape[1]
    cols = np.concatenate([[0], 1 + np.arange(n_rows - 1) % (src - 1)])
    return {iv: {k: v[:, cols] for k, v in planes.items()} for iv, planes in bars.items()}


def _gated_flip_ok(flip: tuple, ind: dict, margins: dict) -> bool:
    """Whether a fired/not-fired flip sits inside its strategy's declared
    gate margin: the row's gated RSI/MFI within the margin of a threshold."""
    from binquant_tpu_torch.strategies.params import StrategyParams

    p = StrategyParams()
    gates = {
        "coinrule_price_tracker": [("rsi", p.pt.rsi_oversold), ("mfi", p.pt.mfi_oversold)],
        "mean_reversion_fade": [("rsi", p.mrf.rsi_long_max), ("rsi", p.mrf.rsi_short_min)],
        "inverse_price_tracker": [("rsi", 30.0), ("mfi", 20.0)],
    }
    dists = [
        abs(float(ind[k]) - thr) for k, thr in gates.get(flip[1], ())
        if ind.get(k) is not None and np.isfinite(float(ind[k]))
    ]
    return flip[1] in margins and bool(dists) and min(dists) <= margins[flip[1]]


def compare_dormant(gpu: dict, cpu: dict, label: str) -> tuple[list, float]:
    """A dormant-market drive on the card against the CPU's: routing equal,
    fired sets equal but for flips inside the declared gate margins (each
    printed), on every tick without a flip the wire's fired block exact and
    its floats within ``rtol=1e-4, atol=1e-5``, rings bit for bit. Returns
    the flips and the largest finite wire difference."""
    import torch

    from binquant_tpu_torch.engine.step import WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    from binquant_tpu_torch.strategies.params import declared_gate_margins

    if gpu["paths"] != cpu["paths"]:
        fail(f"{label}: routing differs between the card and the CPU")
    margins = declared_gate_margins()
    flips = sorted(set(gpu["fired"]) ^ set(cpu["fired"]))
    for f in flips:
        ind = gpu["indicators"].get(f) or cpu["indicators"].get(f) or {}
        side = "card" if f in gpu["indicators"] else "cpu"
        print(f"[slice dormant] {label}: flip {f} fired on the {side} only, "
              f"gated indicators {{rsi: {ind.get('rsi')}, mfi: {ind.get('mfi')}}}")
        if not _gated_flip_ok(f, ind, margins):
            fail(f"{label}: fired sets differ outside the declared gate margins: {f}")
    flip_ticks = {f[0] for f in flips}
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    max_wire_err = 0.0
    problems = []  # every tick's, so one run shows them all
    for t, wg, wc in zip(gpu["tick_times"], gpu["wires"], cpu["wires"], strict=True):
        if wg.shape != wc.shape:
            fail(f"{label}: wire lengths differ: {wg.shape} vs {wc.shape}")
        if t in flip_ticks:
            continue
        blk_g = wg[off: off + 1 + 6 * K]
        blk_c = wc[off: off + 1 + 6 * K]
        if not np.array_equal(blk_g[: 1 + 4 * K], blk_c[: 1 + 4 * K]):
            problems.append(f"fired blocks differ at tick {t}")
        ok = np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True)
        if not ok.all():
            bad = np.flatnonzero(~ok)[:5]
            problems.append(f"tick {t}: wire floats differ at {bad.tolist()}: {wg[bad]} vs "
                            f"{wc[bad]}")
        fin = np.isfinite(wg) & np.isfinite(wc)
        max_wire_err = max(max_wire_err, float(np.abs(wg[fin] - wc[fin]).max()))
    if problems:
        fail(f"{label}: " + "; ".join(problems))
    st, cst = gpu["engine"].state, cpu["engine"].state
    for name in ("buf5", "buf15"):
        for f in ("times", "values", "filled", "cursor"):
            a = getattr(getattr(st, name), f).cpu()
            b = getattr(getattr(cst, name), f)
            if not torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                               torch.nan_to_num(b.float(), nan=-1.0)):
                fail(f"{label}: {name}.{f} differs between the card and the CPU")
    return flips, max_wire_err


def _expected_sites(path: str, dormant: bool, overflowed: bool = False) -> dict:
    """qtail launches by call site on one tick of a serial drive: the wire
    step's, and on a tick whose fired pairs overflowed the wire the
    fallback's too, which re-runs the tick's path evaluating every strategy
    (the reference's full-outputs step), the spike detector included."""
    full = path != "incremental"
    want = {"abp_core": 1} if full else {}
    if path in ("cold_start", "audit", "backfill"):
        want["abp_init_from_window"] = 1
    if dormant:
        want["detect_spikes"] = 1
    if overflowed:
        for k, v in _expected_sites(path, dormant=True).items():
            want[k] = want.get(k, 0) + v
    return want


def check_dormant() -> dict:
    """The dormant strategy set with the spike detector at full width: the
    reference's two dormant markets, made at S symbols with W + DORMANT_TICKS
    15m bars (the crafted setups on the last live tick), W bars of warm
    history, DORMANT_TICKS live ticks. Every strategy is on the wire. On each
    market the classic and the incremental drive (an audit on the last live
    tick), card against CPU; on the first market the live set alone on the
    card as well, for the tick times beside it."""
    from binquant_tpu_torch.engine.step import LIVE_STRATEGIES, STRATEGY_ORDER, WIRE_MAX_FIRED
    from binquant_tpu_torch.io.replay import (
        dormant_extended_market_bars,
        dormant_market_bars,
    )
    from binquant_tpu_torch.ops import quantile_tail as qt

    n = W + DORMANT_TICKS
    markets = {
        "dormant": (market_from_bars(dormant_market_bars(S, n)), None, {}),
        "extended": (
            market_from_bars(dormant_extended_market_bars(S, n)), RISING_BREADTH,
            {"current_market_dominance_is_losers": True, "market_domination_reversal": True},
        ),
    }
    every = set(STRATEGY_ORDER)
    dormant_set = [s for s in STRATEGY_ORDER if s not in LIVE_STRATEGIES]
    launches = {"launches": 0, "launches_by_site": {}}
    detect_spikes_per_tick: list[int] = []

    def count(run: dict, dormant: bool) -> None:
        rep = _launch_report(run)
        launches["launches"] += rep["launches"]
        for k, v in rep["launches_by_site"].items():
            launches["launches_by_site"][k] = launches["launches_by_site"].get(k, 0) + v
        want = [_expected_sites(p, dormant, ov) for p, ov in zip(run["paths"], run["overflowed"])]
        if run["sites"] != want:
            fail(f"dormant phase: qtail launches by site per tick {run['sites']}, expected {want}")
        if dormant:
            # the wire step's own launch: what the tick launched at the site
            # less the overflow fallback's
            detect_spikes_per_tick.extend(
                d.get("detect_spikes", 0) - int(ov) for d, ov in zip(run["sites"], run["overflowed"])
            )

    result: dict = {"markets": {}}
    any_dormant = 0
    for name, ((m5, m15), breadth, flags) in markets.items():
        per_market: dict = {}
        for incremental in (False, True):
            path = "incremental" if incremental else "classic"
            label = f"{name} {path}"
            kw = dict(enabled=every, breadth=breadth, host_flags=flags,
                      audit_every=DORMANT_TICKS)
            qt.reset_launches()  # launches made elsewhere do not count
            gpu = drive("cuda", m5, m15, incremental, DORMANT_TICKS, **kw)
            count(gpu, dormant=True)  # read just after the drive
            live_only = None
            if name == "dormant":
                qt.reset_launches()
                live_only = drive("cuda", m5, m15, incremental, DORMANT_TICKS,
                                  breadth=breadth, host_flags=flags,
                                  audit_every=DORMANT_TICKS)
                count(live_only, dormant=False)
            cpu = drive("cpu", m5, m15, incremental, DORMANT_TICKS, **kw)
            expect = ["classic"] * (DORMANT_TICKS + 1) if not incremental else (
                ["cold_start"] + ["audit" if t % DORMANT_TICKS == 0 else "incremental"
                                  for t in range(1, DORMANT_TICKS + 1)]
            )
            if gpu["paths"] != expect:
                fail(f"{label}: routing {gpu['paths']}, expected {expect}")
            flips, err = compare_dormant(gpu, cpu, label)
            card_by, cpu_by = _by_strategy(gpu["fired"]), _by_strategy(cpu["fired"])
            missing = {s for s in dormant_set if cpu_by.get(s)} - set(card_by)
            if missing:
                fail(f"{label}: dormant strategies fired on the cpu but not on the card: {missing}")
            any_dormant += sum(card_by.get(s, 0) for s in dormant_set)
            kinds = {"incremental": [], "full": []}
            for t, p in zip(gpu["tick_ms"][1:], gpu["paths"][1:]):
                kinds["incremental" if p == "incremental" else "full"].append(t)
            entry = {
                "overflow_ticks": gpu["engine"].overflow_ticks,
                "signals_by_strategy": card_by,
                "cpu_signals_by_strategy": cpu_by,
                "flips": [list(f) for f in flips],
                "max_wire_abs_err_vs_cpu": err,
                "tick_ms": gpu["tick_ms"],
                "tick_p50_ms": {k: _p(v, 50) for k, v in kinds.items() if v},
                "cpu_tick_p50_ms": _p(cpu["tick_ms"][1:], 50),
            }
            if live_only is not None:
                lk = {"incremental": [], "full": []}
                for t, p in zip(live_only["tick_ms"][1:], live_only["paths"][1:]):
                    lk["incremental" if p == "incremental" else "full"].append(t)
                entry["live_set_tick_p50_ms"] = {k: _p(v, 50) for k, v in lk.items() if v}
                entry["live_set_signals_by_strategy"] = _by_strategy(live_only["fired"])
                entry["live_set_overflow_ticks"] = live_only["engine"].overflow_ticks
            per_market[path] = entry
            print(
                f"[slice dormant] {label}: S={S} W={W}, 1 warm + {DORMANT_TICKS} live ticks, "
                f"all {len(every)} strategies; routing {gpu['paths'][1:]}; signals on the card "
                f"{card_by} (cpu {cpu_by}); {len(flips)} flips inside the gate margins; "
                f"tick p50 ms {entry['tick_p50_ms']}"
                + (f" vs the live set alone {entry['live_set_tick_p50_ms']} "
                   f"({entry['live_set_overflow_ticks']} of whose ticks overflowed)"
                   if live_only is not None else "")
                + f"; {entry['overflow_ticks']} of its ticks overflowed the wire's "
                f"{WIRE_MAX_FIRED} slots; wire max abs err vs cpu {err:.3g}"
            )
        result["markets"][name] = per_market
    # the reference's 24-symbol markets tiled across S rows at their own
    # length: the four strategies that fire nowhere above fire here
    for name, (bars, breadth, flags, want) in {
        "dormant_tiled": (dormant_market_bars(24, TILED_BARS), None, {},
                          ("range_bb_rsi_mean_reversion",)),
        "extended_tiled": (
            dormant_extended_market_bars(24, TILED_BARS), RISING_BREADTH,
            {"current_market_dominance_is_losers": True, "market_domination_reversal": True},
            ("range_failed_breakout_fade", "relative_strength_reversal_range",
             "coinrule_supertrend_swing_reversal"),
        ),
    }.items():
        m5, m15 = market_from_bars(tiled_bars(bars, S))
        kw = dict(enabled=every, breadth=breadth, host_flags=flags, warm=TILED_BARS - TILED_TICKS)
        qt.reset_launches()
        gpu = drive("cuda", m5, m15, False, TILED_TICKS, **kw)
        count(gpu, dormant=True)
        cpu = drive("cpu", m5, m15, False, TILED_TICKS, **kw)
        if gpu["paths"] != ["classic"] * (TILED_TICKS + 1):
            fail(f"{name}: routing {gpu['paths']}")
        flips, err = compare_dormant(gpu, cpu, f"{name} classic")
        card_by, cpu_by = _by_strategy(gpu["fired"]), _by_strategy(cpu["fired"])
        fired_want = {s: card_by.get(s, 0) for s in want}
        if not all(fired_want.values()) or any(cpu_by.get(s, 0) != n for s, n in fired_want.items()):
            fail(f"{name}: {fired_want} fired on the card, {cpu_by} on the cpu; each of "
                 f"{want} must fire, alike on both")
        any_dormant += sum(card_by.get(s, 0) for s in dormant_set)
        result["markets"][name] = {
            "classic": {"signals_by_strategy": card_by, "cpu_signals_by_strategy": cpu_by,
                        "flips": [list(f) for f in flips], "max_wire_abs_err_vs_cpu": err,
                        "overflow_ticks": gpu["engine"].overflow_ticks,
                        "tick_ms": gpu["tick_ms"]},
        }
        print(
            f"[slice dormant] {name} classic: the reference's 24-symbol market ({TILED_BARS} "
            f"bars) tiled over S={S} rows, {TILED_BARS - TILED_TICKS} bars of history + "
            f"{TILED_TICKS} live ticks; fired on the card {fired_want} (cpu "
            f"{ {s: cpu_by.get(s, 0) for s in want} }); all signals {card_by}; "
            f"{len(flips)} flips inside the gate margins; wire max abs err vs cpu {err:.3g}"
        )
    if not any_dormant:
        fail("no dormant strategy fired on the dormant markets")
    if set(detect_spikes_per_tick) != {1}:
        fail(f"qtail launches at detect_spikes per tick {detect_spikes_per_tick}, expected 1 each")
    result.update(launches, detect_spikes_per_tick=detect_spikes_per_tick,
                  dormant_signals=any_dormant)
    print(
        f"[slice dormant] qtail launches {launches['launches']} {launches['launches_by_site']}: "
        f"exactly 1 at detect_spikes in the wire step of each of {len(detect_spikes_per_tick)} "
        f"ticks with the dormant set on, plus 1 in the fallback of each tick that overflowed "
        f"the wire; {any_dormant} dormant signals on the card, routing, fired sets and rings "
        f"equal to the cpu engine's"
    )
    return result


# --------------------------------------------------------------------------
# phase 5: the production loop (depth 1, rings in place, digests, meter)
# --------------------------------------------------------------------------


def _pipelined_engine(device: str, m5: dict, m15: dict, depth: int, donate: bool, digests: bool):
    """A production engine (both digests, the drift meter and the outcome
    tracker on, unless ``digests`` is False) at ``depth``, its monitors
    recording every tick, with the warm history queued; returns it and its
    ticks."""
    from binquant_tpu_torch.io.replay import make_stub_engine
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device,
        incremental=True, carry_audit_every=AUDIT_EVERY, pipeline_depth=depth, donate=donate,
        numeric_digest=digests, ingest_digest=digests, drift_meter=digests, outcomes=digests,
        **OBS_OFF, **FANOUT_OFF,
    )
    for monitor in (engine.numeric, engine.ingest_monitor, engine.drift):
        monitor.record_history = True
    return engine, tick_plan(engine, m5, m15, LIVE_TICKS + 1)


def _engine_summary(engine) -> dict:
    """What the comparisons read of an engine after its drive; the engine
    itself (and its device memory) can then go."""
    import torch

    state = engine.state
    leaves = torch.utils._pytree.tree_leaves(state)
    routing = dict(engine.full_recompute_reasons)
    routing["incremental"] = engine.incremental_ticks
    board = engine.outcomes.scoreboard()
    return {
        "outcomes": {
            "matured_set": sorted(engine.outcomes.matured_set()),
            **{k: board[k] for k in ("registered", "matured", "truncated", "evictions", "open")},
            "timings": list(engine.outcomes.timings),
        },
        "outcome_cap": engine.outcomes.cap,
        "overflow_ticks": engine.overflow_ticks,
        "inplace_ticks": engine.inplace_ticks,
        "state_resets": engine.state_resets,
        "spare_slots": len(engine._spare_slots),
        "spare_bytes": sum(p.numel() * p.element_size()
                           for slot in engine._spare_slots for p in slot),
        "wire_bufs_pinned": None if engine._wire_bufs is None
        else [b.is_pinned() for b in engine._wire_bufs],
        "drift_audits": engine.drift.audits,
        "drift_skipped": engine.drift.skipped,
        "drift_history": engine.drift.history,
        "numeric_history": engine.numeric.history,
        "ingest_digests": engine.ingest_monitor.digests,
        "routing": routing,
        "resident_bytes": sum(t.numel() * t.element_size() for t in leaves),
        "rings": {
            f"{name}.{f}": getattr(getattr(state, name), f).cpu()
            for name in ("buf5", "buf15") for f in ("times", "values", "filled", "cursor")
        },
    }


def drive_pipelined(configs: dict, m5: dict, m15: dict, profiler=None) -> dict:
    """The warm tick, LIVE_TICKS live ticks and the crash tick, then the
    flush, through one production engine per entry of ``configs``
    (label -> (device, depth, donate, digests)). The engines take each tick
    in turns, in an order that rotates from tick to tick, so that a drift of
    the host's speed during the drive falls on all of them alike. Per call:
    the path of the tick it dispatched, the qtail launches by site, the
    call's wall time and, on the card, the time until the device is idle
    again (the wire of a depth-1 tick has landed by then), the device
    memory allocated before the call and the peak during it. A
    ``torch.profiler.profile`` passed as ``profiler`` records the live
    ticks, each call and the wait for the idle device inside one
    ``chip_smoke_tick`` range."""
    import torch

    from binquant_tpu_torch.io.replay import signal_tuples
    from binquant_tpu_torch.ops import quantile_tail as qt

    engines, ticks = {}, None
    for label, (device, depth, donate, digests) in configs.items():
        engines[label], ticks = _pipelined_engine(device, m5, m15, depth, donate, digests)
    outs = {
        label: {"paths": [], "launches": [], "sites": [], "call_ms": [], "landed_ms": [],
                "base_bytes": [], "peak_bytes": [], "fired": [], "fresh_slots": [],
                "large_allocs": []}
        for label in configs
    }

    def launches_since(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in qt.launches_by_site.items()
                if v != before.get(k, 0)}

    async def call(label: str, n: int, now_ms: int, klines: list) -> None:
        engine, out = engines[label], outs[label]
        cuda = engine.device.type == "cuda"
        for k in klines:
            engine.ingest(k)
        if cuda:
            # the idle gap between ticks: the previous tick is done
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else None
        allocs = torch.cuda.memory_stats().get("allocation.large_pool.allocated", 0) if cuda else 0
        before = dict(qt.launches_by_site)
        rng = (
            torch.profiler.record_function("chip_smoke_tick")
            if profiler is not None and 0 < n <= LIVE_TICKS else contextlib.nullcontext()
        )
        with rng:
            t0 = time.perf_counter()
            fired = await engine.process_tick(now_ms=now_ms)
            t1 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize()
        out["call_ms"].append((t1 - t0) * 1000.0)
        out["landed_ms"].append((time.perf_counter() - t0) * 1000.0)
        out["base_bytes"].append(base)
        out["peak_bytes"].append(torch.cuda.max_memory_allocated() if cuda else None)
        # the caching allocator's large-pool (> 1 MiB) allocations this call
        # made, and the ring slots the engine allocated so far
        out["large_allocs"].append(
            torch.cuda.memory_stats().get("allocation.large_pool.allocated", 0) - allocs
            if cuda else None)
        out["fresh_slots"].append(engine.fresh_slots)
        out["sites"].append(launches_since(before))
        out["launches"].append(sum(out["sites"][-1].values()))
        out["paths"].append(engine.last_path)
        out["fired"].extend(signal_tuples(fired))

    async def run():
        labels = list(configs)
        for n, (now_ms, klines) in enumerate(ticks):
            for label in labels[n % len(labels):] + labels[: n % len(labels)]:
                await call(label, n, now_ms, klines)
        for label, engine in engines.items():
            before = dict(qt.launches_by_site)
            outs[label]["fired"].extend(signal_tuples(await engine.flush_pending()))
            outs[label]["flush_sites"] = launches_since(before)
        # the delivery plane (production default) takes each signal at its
        # finalize; this phase reads the ticks, so the planes stop undrained
        for engine in engines.values():
            await engine.aclose_delivery(drain_s=0.0)

    with profiler if profiler is not None else contextlib.nullcontext():
        asyncio.run(run())
    for label, out in outs.items():
        out.update(_engine_summary(engines[label]), tick_times=[t for t, _ in ticks])
    return outs


def _p(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


EXPECT_SITES = {
    "cold_start": {"abp_core": 1, "abp_init_from_window": 1},
    "audit": {"abp_core": 1, "abp_init_from_window": 1, "carry_drift": 1},
    "incremental": {},
}


def check_pipelined(m5, m15) -> dict:
    """The production loop on the card against the serial loop on the CPU,
    then the tick times and device memory of five card configurations
    taking the same ticks in turns: depth 1 with rings in place, depth 0
    with copied rings, depth 0 with copied rings and neither digest nor the
    meter, depth 2 on double-buffered rings (held against the CPU too, in
    each round) and depth 2 with copied rings."""
    import torch

    from binquant_tpu_torch.engine.step import (
        NUMERIC_STAGES,
        STRATEGY_ORDER,
        WIRE_MAX_FIRED,
        numeric_digest_layout,
    )
    from binquant_tpu_torch.ops import quantile_tail as qt

    qt.reset_launches()
    gpu = drive_pipelined({"main": ("cuda", 1, True, True)}, m5, m15)["main"]
    counts = _launch_report(gpu)  # read just after the drive
    for k, v in gpu["flush_sites"].items():
        counts["launches_by_site"][k] = counts["launches_by_site"].get(k, 0) + v
    counts["launches"] += sum(gpu["flush_sites"].values())
    if counts["launches"] != qt.launches or counts["launches_by_site"] != qt.launches_by_site:
        fail(f"per-tick launch accounting {counts} != the wrapper's count {qt.launches}")
    cpu = drive_pipelined({"cpu": ("cpu", 0, False, True)}, m5, m15)["cpu"]
    configs = {
        "depth1_inplace": ("cuda", 1, True, True),
        "depth0_copying": ("cuda", 0, False, True),
        "depth0_copying_no_digests": ("cuda", 0, False, False),
        "depth2_double": ("cuda", 2, True, True),
        "depth2_copying": ("cuda", 2, False, True),
    }
    rounds = [drive_pipelined(configs, m5, m15) for _ in range(2)]

    expect = ["cold_start"] + [
        "audit" if t % AUDIT_EVERY == 0 else "incremental" for t in range(1, LIVE_TICKS + 2)
    ]
    with_digests = [(gpu, "depth 1")] + [
        (r[k], k) for r in rounds
        for k in ("depth1_inplace", "depth0_copying", "depth2_double", "depth2_copying")
    ]
    for run, label in (*with_digests, (cpu, "cpu"),
                       *((r["depth0_copying_no_digests"], "no digests") for r in rounds)):
        if run["paths"] != expect:
            fail(f"pipelined drive ({label}) routing {run['paths']}, expected {expect}")
        if sorted(run["fired"]) != sorted(cpu["fired"]):
            fail(f"pipelined drive ({label}): fired set differs from the cpu engine's")
    # the crash tick's overflow fallback evaluates every strategy, as the
    # reference's full-outputs step does: one more launch at detect_spikes,
    # in the flush at depth 1 (which finalizes the crash tick), in the crash
    # tick's own call at depth 0
    fallback_sites = {"detect_spikes": 1}
    for run, label in with_digests:
        want = [dict(EXPECT_SITES[p]) for p in run["paths"]]
        want_flush = {}
        if label == "depth0_copying":
            want[-1].update(fallback_sites)
        else:
            want_flush = fallback_sites
        if run["sites"] != want or run["flush_sites"] != want_flush:
            fail(f"pipelined drive ({label}): qtail launches by site per tick {run['sites']}, "
                 f"flush {run['flush_sites']}")
    if not (gpu["inplace_ticks"] == len(expect) and gpu["state_resets"] == 0
            and gpu["wire_bufs_pinned"] == [True, True]):
        fail(f"depth 1: in-place ticks {gpu['inplace_ticks']}, resets {gpu['state_resets']}, "
             f"pinned wire buffers {gpu['wire_bufs_pinned']}")
    # depth 2 on double-buffered rings: every tick writes a ring slot, one
    # allocated on the first tick and none after
    for r in rounds:
        d2 = r["depth2_double"]
        fresh_after = d2["fresh_slots"][-1] - d2["fresh_slots"][0]
        if not (d2["inplace_ticks"] == len(expect) and d2["state_resets"] == 0
                and d2["fresh_slots"][0] == 1 and fresh_after == 0
                and d2["wire_bufs_pinned"] == [True] * 3):
            fail(f"depth 2 double: in-place ticks {d2['inplace_ticks']}, resets "
                 f"{d2['state_resets']}, fresh slots per call {d2['fresh_slots']}, pinned "
                 f"wire buffers {d2['wire_bufs_pinned']}")
        if r["depth2_copying"]["inplace_ticks"] or r["depth2_copying"]["fresh_slots"][-1]:
            fail("depth 2 copying wrote rings in place")
    crash_ms = gpu["tick_times"][-1]
    crash_fired = sum(1 for f in gpu["fired"] if f[0] == crash_ms)
    n_counts = 2 * len(NUMERIC_STAGES) + 2 * len(STRATEGY_ORDER)
    # a gate margin is an RSI/MFI (0-100 points) minus its threshold: the
    # wire contract at that indicator's scale; the other floats at their own
    margin = np.array([n.startswith("margin.") for n in numeric_digest_layout()])
    atol = np.where(margin, 1e-4 * 100 + 1e-5, 1e-5)

    def hold(run, label) -> float:
        """A card engine against the cpu engine: the overflow, both digest
        blocks, the drift meter, the rings and the outcome tracker."""
        fired = sum(1 for f in run["fired"] if f[0] == crash_ms)
        if not (run["overflow_ticks"] == cpu["overflow_ticks"] == 1) or fired <= WIRE_MAX_FIRED:
            fail(f"{label}: overflow ticks {run['overflow_ticks']}/{cpu['overflow_ticks']}, "
                 f"{fired} signals on the crash tick (need > {WIRE_MAX_FIRED})")
        if len(run["ingest_digests"]) != len(expect):
            fail(f"{label}: {len(run['ingest_digests'])} ingest digests for {len(expect)} ticks")
        for a, b in zip(run["ingest_digests"], cpu["ingest_digests"], strict=True):
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                fail(f"{label}: ingest digest differs from the cpu engine's: {a} vs {b}")
        err = 0.0
        for (_, a), (_, b) in zip(run["numeric_history"], cpu["numeric_history"], strict=True):
            if not np.array_equal(a[:n_counts], b[:n_counts]):
                fail(f"{label}: numeric digest counts differ from the cpu engine's: "
                     f"{a[:n_counts]} vs {b[:n_counts]}")
            close = np.isclose(a, b, rtol=1e-4, atol=atol, equal_nan=True)
            if not close.all():
                bad = np.flatnonzero(~close)
                fail(f"{label}: numeric digest floats differ at {bad.tolist()}: "
                     f"{a[bad]} vs {b[bad]}")
            fin = np.isfinite(a) & np.isfinite(b)
            err = max(err, float(np.abs(a[fin] - b[fin]).max(initial=0.0)))
        if run["drift_audits"] != 2 or run["drift_skipped"] or cpu["drift_audits"] != 2:
            fail(f"{label}: drift meter: {run['drift_audits']} audits, "
                 f"{run['drift_skipped']} skipped")
        for (_, dg, bg), (_, dc, bc) in zip(run["drift_history"], cpu["drift_history"],
                                            strict=True):
            if bg != bc or any(dg[f]["compared"] != dc[f]["compared"] for f in dg):
                fail(f"{label}: drift meter differs from the cpu engine's: "
                     f"{dg} {bg} vs {dc} {bc}")
        for key, a in run["rings"].items():
            b = cpu["rings"][key]
            if not torch.equal(torch.nan_to_num(a.float(), nan=-1.0),
                               torch.nan_to_num(b.float(), nan=-1.0)):
                fail(f"{label}: {key} differs between the card and the cpu")
        # the outcome tracker: the matured tuples and counters exactly the cpu's
        go, co = run["outcomes"], cpu["outcomes"]
        for k in ("matured_set", "registered", "matured", "truncated", "evictions", "open"):
            if go[k] != co[k]:
                fail(f"{label}: outcome {k} differs from the cpu engine's: "
                     f"{str(go[k])[:200]} vs {str(co[k])[:200]}")
        return err

    numeric_err = hold(gpu, "pipelined drive")
    for r in rounds:
        numeric_err = max(numeric_err, hold(r["depth2_double"], "depth 2 double"))
    go = gpu["outcomes"]
    horizons = sorted({t[3] for t in go["matured_set"]})
    if horizons != [1, 4, 16] or not go["evictions"] or go["truncated"]:
        fail(f"pipelined drive: matured horizons {horizons} (expected 1, 4, 16: 96 bars need "
             f"32 ticks), evictions {go['evictions']}, truncated {go['truncated']}")
    maturation = {
        k: _p([t[k] for t in go["timings"]], 50) for k in ("gather_ms", "copy_ms", "fold_ms")
    }
    maturation.update(ticks=len(go["timings"]), pairs_max=max(t["pairs"] for t in go["timings"]))

    # live ticks 1..LIVE_TICKS by kind, both rounds pooled; the warm tick and
    # the crash tick (whose serial call also runs the overflow fallback) are
    # left out
    live = range(1, LIVE_TICKS + 1)

    def by_kind(runs, key, kind):
        return [run[key][i] for run in runs for i in live
                if (run["paths"][i] == "incremental") == (kind == "incremental")]

    timing = {}
    for label in configs:
        runs = [r[label] for r in rounds]
        t = {"resident_bytes": runs[0]["resident_bytes"]}
        for kind in ("incremental", "full"):
            calls = by_kind(runs, "call_ms", kind)
            above = [p - b for p, b in zip(by_kind(runs, "peak_bytes", kind),
                                           by_kind(runs, "base_bytes", kind))]
            t[kind] = {
                "ticks": len(calls),
                "tick_p50_ms": _p(calls, 50), "tick_p99_ms": _p(calls, 99),
                "tick_p50_ms_per_round": [_p(by_kind((r,), "call_ms", kind), 50) for r in runs],
                "landed_p50_ms": _p(by_kind(runs, "landed_ms", kind), 50),
                "peak_above_resident_bytes": max(above),
            }
        t["crash_tick_ms"] = [r["call_ms"][-1] for r in runs]
        t["fresh_slots_after_first_tick"] = [r["fresh_slots"][-1] - r["fresh_slots"][0]
                                             for r in runs]
        t["large_allocs_per_live_tick_p50"] = _p(
            [r["large_allocs"][i] for r in runs for i in live], 50)
        t["slots_pooled"] = [r["spare_slots"] for r in runs]
        t["pool_bytes"] = [r["spare_bytes"] for r in runs]
        timing[label] = t
    # the main run, alone on the card: its own peak device memory
    peak_alone = {
        kind: max(by_kind((gpu,), "peak_bytes", kind)) for kind in ("incremental", "full")
    }
    result = {
        "ticks": len(expect), **counts, "launches_per_tick": gpu["launches"],
        "routing": gpu["routing"], "signals": len(gpu["fired"]), "crash_tick_signals": crash_fired,
        "signals_by_strategy": _by_strategy(gpu["fired"]), "timing": timing,
        "peak_device_bytes_depth1_alone": peak_alone,
        "drift": [{"tick_ms": t, "breached": b, **d} for t, d, b in gpu["drift_history"]],
        "numeric_max_abs_err_vs_cpu": numeric_err,
        "outcomes": {k: go[k] for k in ("registered", "matured", "truncated", "evictions", "open")}
        | {"matured_horizons": horizons, "maturation_host_ms_p50": maturation},
    }
    d1, d0, dn, dd, dc = (timing[k] for k in configs)
    mib = 2 ** 20

    def kinds(d, key, scale=1.0):
        return "/".join(f"{d[k][key] / scale:.2f}" for k in ("incremental", "full"))

    print(
        f"[slice pipelined] S={S} W={W}: {len(expect)} ticks (1 warm + {LIVE_TICKS} live + 1 "
        f"crash), depth 1, rings in place, both digests and the drift meter on, audit every "
        f"{AUDIT_EVERY}; routing {gpu['routing']}; qtail launches {counts['launches']} "
        f"{counts['launches_by_site']} (per tick {gpu['launches']}: 3 per audit, 2 on the cold "
        f"start, 0 per incremental tick; 1 at detect_spikes in the crash tick's fallback, "
        f"finalized by the flush); signals {len(gpu['fired'])}, {crash_fired} on the crash "
        f"tick (overflow fallback in place); routing, fired sets, {len(expect)} ingest digest "
        f"blocks (bit for bit), numeric digest counts (floats within {numeric_err:.2e}), "
        f"drift-meter compared counts and verdicts on {gpu['drift_audits']} audits and the rings "
        f"(bit for bit) equal to the cpu engine's. Taking the ticks in turns, two rounds, "
        f"incremental/full tick p50 ms: depth 1 in place {kinds(d1, 'tick_p50_ms')} (p99 "
        f"{kinds(d1, 'tick_p99_ms')}, landed p50 {kinds(d1, 'landed_p50_ms')}); depth 0 copying "
        f"{kinds(d0, 'tick_p50_ms')} (p99 {kinds(d0, 'tick_p99_ms')}); depth 0 copying without "
        f"digests or meter {kinds(dn, 'tick_p50_ms')} (p99 {kinds(dn, 'tick_p99_ms')}). Peak device "
        f"memory above the engine's resident {d1['resident_bytes'] / mib:.1f} MiB, "
        f"incremental/full: depth 1 in place {kinds(d1, 'peak_above_resident_bytes', mib)} MiB, "
        f"depth 0 copying {kinds(d0, 'peak_above_resident_bytes', mib)} MiB, without digests "
        f"{kinds(dn, 'peak_above_resident_bytes', mib)} MiB; depth 1 alone on the card: "
        f"{peak_alone['incremental'] / mib:.1f}/{peak_alone['full'] / mib:.1f} MiB"
    )
    print(
        f"[slice pipelined] depth 2 (the same ticks, in the same turns): double-buffered rings "
        f"(each tick writes a recycled slot) routing, fired sets, both digest blocks, drift "
        f"verdicts, outcomes and rings equal to the cpu engine's in both rounds, the crash "
        f"tick's fallback from its own post rings; incremental/full tick p50 ms double "
        f"{kinds(dd, 'tick_p50_ms')} (p99 {kinds(dd, 'tick_p99_ms')}), copying "
        f"{kinds(dc, 'tick_p50_ms')} (p99 {kinds(dc, 'tick_p99_ms')}), depth 1 in place "
        f"{kinds(d1, 'tick_p50_ms')}; peak device memory above the resident state (the pool "
        f"included in it), incremental/full: double {kinds(dd, 'peak_above_resident_bytes', mib)}"
        f" MiB, copying {kinds(dc, 'peak_above_resident_bytes', mib)} MiB, depth 1 in place "
        f"{kinds(d1, 'peak_above_resident_bytes', mib)} MiB; fresh slot allocations after the "
        f"first tick, per round: double {dd['fresh_slots_after_first_tick']}; large-pool "
        f"allocations per live tick p50 (the caching allocator's requests over 1 MiB): double "
        f"{dd['large_allocs_per_live_tick_p50']:.0f}, copying "
        f"{dc['large_allocs_per_live_tick_p50']:.0f}, depth 1 in place "
        f"{d1['large_allocs_per_live_tick_p50']:.0f}, depth 0 copying "
        f"{d0['large_allocs_per_live_tick_p50']:.0f}; slots pooled at the end, per round: "
        f"double {dd['slots_pooled']} ({dd['pool_bytes'][0] / mib:.1f} MiB)"
    )
    print(
        f"[slice pipelined] outcomes: registered {go['registered']}, matured {go['matured']} "
        f"pairs at horizons {horizons} (1, 4 and 16 bars mature within the {LIVE_TICKS} live "
        f"ticks, 96 does not: it needs 32), evictions {go['evictions']} (the crash tick's pairs "
        f"pass the cap of {gpu['outcome_cap']}), truncated {go['truncated']}, open "
        f"{go['open']}; matured set and counters equal to the cpu engine's; host ms per "
        f"maturation tick p50 over {maturation['ticks']} ticks: gather "
        f"{maturation['gather_ms']:.3f}, copy {maturation['copy_ms']:.3f}, fold "
        f"{maturation['fold_ms']:.3f} (up to {maturation['pairs_max']} pairs)"
    )
    return result


# --------------------------------------------------------------------------
# phase 6: the service around the tick (restore, backfill, the consume loop,
# leverage calibration, the regime notifier, checkpoints)
# --------------------------------------------------------------------------

SERVICE_TICKS = 16  # live ticks of the service drive
SERVICE_EVERY = 8  # its checkpoint and audit cadence
BACKFILL_FAILING = "S0007USDT"  # the symbol whose history fetch raises
KLINE_KEYS = ("open_time", "close_time", "open", "high", "low", "close", "volume",
              "quote_asset_volume", "number_of_trades", "taker_buy_base_volume",
              "taker_buy_quote_volume")


def service_breadth() -> list:
    """One breadth payload per 15m bucket of the service drive (its first
    tick's bucket first), a stalled upstream (HTTP 500) on the fifth."""
    out: list = []
    for t in range(SERVICE_TICKS + 1):
        vals = [0.55 - 0.02 * (t + k) for k in range(4)]
        out.append("error" if t == 4 else {
            "timestamp": [t + k for k in range(4)],
            "market_breadth": vals,
            "market_breadth_ma": [v + 0.01 for v in vals],
        })
    return out


def make_fetch(m5: dict, m15: dict, upto15: int):
    """A fake REST history source: ``fetch(symbol, interval)`` returns the
    symbol's 400 bars that closed before 15m bar ``upto15`` opens, and the
    next bar, which has not closed yet (the backfill drops it), as kline
    dicts; :data:`BACKFILL_FAILING`'s fetches raise."""
    row_of = {name: r for r, name in enumerate(symbols())}
    planes = {}
    for interval, m, step, hi in (("15m", m15, 900, upto15), ("5m", m5, 300, 3 * upto15)):
        ts = (T_LIVE0 - 900 * W + step * np.arange(hi - 400, hi + 1))[None, :].repeat(S, 0)
        o, h, lo, c, v = (m[k][:, hi - 400: hi + 1] for k in ("open", "high", "low", "close",
                                                               "volume"))
        planes[interval] = np.stack(
            [ts * 1000, (ts + step) * 1000 - 1, o, h, lo, c, v, v * c,
             np.full_like(c, 300.0), v / 2, v * c / 2], axis=-1,
        )

    def fetch(symbol: str, interval: str) -> list[dict]:
        if symbol == BACKFILL_FAILING:
            raise ConnectionError(f"{symbol}: history unavailable")
        rows = planes[interval][row_of[symbol]].tolist()
        return [dict(zip(KLINE_KEYS, row), symbol=symbol) for row in rows]

    return fetch


def service_symbols(rng: np.random.Generator) -> list:
    """The autotrade consumer's symbol list: every symbol, its current
    futures leverage seeded from 1x-3x (most rows will need a PUT)."""
    from binquant_tpu_torch.schemas import SymbolModel

    levels = rng.choice([1.0, 2.0, 3.0], size=S)
    return [SymbolModel(id=name, futures_leverage=float(lv)) for name, lv in zip(symbols(), levels)]


async def settle(engine, timeout_s: float = 120.0) -> None:
    """Wait until what the engine handed its sinks has landed: the Telegram
    consumer's fire-and-forget sends and the delivery plane's queues."""
    await asyncio.gather(*engine.telegram_consumer._background_tasks)
    if engine.delivery is not None and not await engine.delivery.drain(timeout_s=timeout_s):
        fail(f"the delivery plane did not drain in {timeout_s} s: "
             f"{engine.delivery.snapshot()['sinks']}")


def digests(sent: list[str]) -> list[str]:
    """The regime notifier's digests among the Telegram consumer's sends (a
    signal's message names its algorithm)."""
    return [m for m in sent if "algorithm</strong>" not in m]


def service_drive(device: str, m5: dict, m15: dict, first: int, ckpt_path, symbols_list,
                  production: bool, restore: bool, keep_at: int | None = None,
                  chunk: int = S) -> dict:
    """One boot of the service: a cold engine, ``try_restore`` from
    ``ckpt_path`` (``restore``), ``backfill`` from the fake REST source as
    of the first tick's bucket, then ``consume_loop`` over live ticks
    ``first``..SERVICE_TICKS-1 fed bucket by bucket through an
    ``asyncio.Queue``, a checkpoint every SERVICE_EVERY ticks, cancelled
    at the end. ``production``: depth 1, rings in place (else depth 0,
    copied rings); both digests, the drift meter and outcomes either way.
    Per tick: path, qtail launches by site, the ms from queueing its klines
    until its wire landed, the wire, the fired tuples, digests and PUTs
    it brought; the fired tuples are what the autotrade consumer was handed
    through the delivery plane, the digests what the Telegram consumer
    sent, each read once the plane has drained after the tick. ``keep_at``: after that many ticks, the archive is copied
    aside and the symbol list snapshotted (the restart's starting point).
    ``chunk``: the backfill's flush cadence in symbols (one flush by
    default: at the production default of 50 the CPU engine's ~16,000 ring
    folds would take minutes)."""
    import torch

    from binquant_tpu_torch.io.checkpoint import CheckpointManager, save_state_sharded
    from binquant_tpu_torch.io.replay import StubSession, delivered_tuples, make_stub_engine
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.regime.context import ContextConfig

    session = StubSession({"schedule": service_breadth()[first:]})
    flags = {} if production else dict(pipeline_depth=0, donate=False)
    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device, incremental=True,
        carry_audit_every=SERVICE_EVERY, session=session, all_symbols=symbols_list, **flags,
        **OBS_OFF, **FANOUT_OFF,
    )
    engine.checkpoint = CheckpointManager(ckpt_path, every_ticks=SERVICE_EVERY)
    # every regime digest shares one dedupe key: with the 900 s cooldown the
    # Telegram consumer would send only the first of the drive's digests
    engine.telegram_consumer._signal_dedupe_seconds = 0.0
    out = {"restored": engine.checkpoint.try_restore(engine),
           "paths": [], "sites": [], "tick_ms": [], "wires": [], "fired": [], "digests": [],
           "puts": [], "saves_ms": [], "overflowed": [], "kept": None}
    if out["restored"] != restore:
        fail(f"service drive on {device}: try_restore gave {out['restored']}, expected {restore}")
    out["restore_ms"] = engine.checkpoint.last_restore_ms
    out["restored_leaves"] = _archive_leaves_cpu(engine.state) if restore else None
    now_ms = (T_LIVE0 + 900 * first) * 1000
    loaded = engine.backfill(symbols(), make_fetch(m5, m15, W + first), now_ms=now_ms,
                             chunk=chunk)
    if device == "cuda":
        torch.cuda.synchronize()
    out["backfill"] = dict(engine.backfill_stats, loaded=loaded,
                           failing_registered=BACKFILL_FAILING in engine.registry)
    ticks = live_ticks_of(m5, m15, SERVICE_TICKS)[first:]

    def puts() -> list:
        return [(u.rsplit("/", 1)[-1], body["futures_leverage"])
                for m, u, body in session.requests if m == "PUT"]

    async def run() -> None:
        queue: asyncio.Queue = asyncio.Queue()
        clock = {"now": 0}
        task = asyncio.create_task(
            engine.consume_loop(queue, tick_interval_s=0.0, clock=lambda: clock["now"]))
        for n, (tick_now, klines) in enumerate(ticks, start=first + 1):
            clock["now"] = tick_now
            before, ticks0 = dict(qt.launches_by_site), engine.ticks_processed
            d0, p0 = len(engine._telegram_sent), len(puts())
            f0, o0 = len(engine._autotrade_received), engine.overflow_ticks
            t0 = time.perf_counter()
            for k in klines:
                queue.put_nowait(k)
            while engine.ticks_processed == ticks0 or engine._pending:
                await asyncio.sleep(0.0002)
            out["tick_ms"].append((time.perf_counter() - t0) * 1000.0)
            await settle(engine)  # the tick's deliveries land first
            if engine._calibration_task is not None:
                await engine._calibration_task  # this bucket's PUTs land first
            if engine.checkpoint.should_save(engine):
                while engine.checkpoint.last_saved_tick != engine.ticks_processed:
                    await asyncio.sleep(0.0002)
                out["saves_ms"].append(engine.checkpoint.last_save_ms)
            out["sites"].append({k: v - before.get(k, 0) for k, v in qt.launches_by_site.items()
                                 if v != before.get(k, 0)})
            out["paths"].append(engine.last_path)
            out["overflowed"].append(engine.overflow_ticks > o0)
            out["wires"].append(engine.last_wire)
            out["fired"].append(delivered_tuples(engine._autotrade_received[f0:]))
            out["digests"].append(digests(engine._telegram_sent[d0:]))
            out["puts"].append(puts()[p0:])
            if n == keep_at:
                kept = Path(str(ckpt_path) + f".tick{n}")
                shutil.copy(ckpt_path, kept)
                # the same state once more, at 4 shards and monolithic, each
                # save timed alone
                kept4 = Path(str(ckpt_path) + f".tick{n}.x4")
                save_ms = {}
                with engine.hold_state("the sharded save"):
                    for shards, target in ((4, kept4), (1, Path(str(kept) + ".x1"))):
                        t_save = time.perf_counter()
                        save_state_sharded(target, engine.state, engine.registry, shards,
                                           host_carries=engine.host_carries())
                        save_ms[shards] = (time.perf_counter() - t_save) * 1000.0
                out["kept"] = (kept, kept4, copy.deepcopy(engine.at_consumer.all_symbols),
                               save_ms)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        else:
            fail("the consume loop returned instead of being cancelled")

    asyncio.run(run())
    carries = engine.host_carries()
    carries.pop("saved_at_s")
    out.update(
        carries=carries, registry=engine.registry.to_mapping(), calibration_ms=list(engine.calibration_ms),
        overflow_ticks=engine.overflow_ticks, state_bytes=sum(
            t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(engine.state)),
        rings={f"{name}.{f}": getattr(getattr(engine.state, name), f).cpu()
               for name in ("buf5", "buf15") for f in ("times", "values", "filled")},
        canonical=_canonical_rings(engine.state),
    )
    return out


def _archive_leaves_cpu(state) -> list:
    """A state's checkpoint leaves (rings canonical), on the host."""
    from binquant_tpu_torch.engine.step import canonicalize_state
    from binquant_tpu_torch.io.checkpoint import _archive_leaves

    return [t.cpu() for t in _archive_leaves(canonicalize_state(state))]


def _leaves_equal(a: list, b: list) -> bool:
    """Two lists of host leaves, bit for bit (float32 compared as int32)."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(a, b))


def restore_next_tick(archive, m5: dict, m15: dict, symbols_list) -> dict:
    """A fresh production card engine restores ``archive`` (a monolithic
    archive or a sharded set's manifest) and runs the next live tick
    without a top-up and without an audit (the restored carry advances):
    restore ms, the restored leaves, the tick's path, wire and fired
    tuples."""
    from binquant_tpu_torch.io.checkpoint import CheckpointManager
    from binquant_tpu_torch.io.replay import StubSession, make_stub_engine, signal_tuples
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device="cuda", incremental=True,
        carry_audit_every=0, all_symbols=symbols_list,
        session=StubSession({"schedule": service_breadth()[SERVICE_EVERY:]}),
        **OBS_OFF, **FANOUT_OFF,
    )
    mgr = CheckpointManager(archive)
    out = {"restored": mgr.try_restore(engine)}
    out["restore_ms"], out["leaves"] = mgr.last_restore_ms, _archive_leaves_cpu(engine.state)
    now_ms, klines = live_ticks_of(m5, m15, SERVICE_TICKS)[SERVICE_EVERY]

    async def run() -> list:
        for k in klines:
            engine.ingest(k)
        fired = await engine.process_tick(now_ms=now_ms)
        fired += await engine.flush_pending()
        await engine.aclose_delivery(drain_s=0.0)
        return signal_tuples(fired)

    out["fired"] = asyncio.run(run())
    out.update(path=engine.last_path, wire=engine.last_wire.copy())
    return out


def _canonical_rings(state) -> dict:
    from binquant_tpu_torch.engine.step import canonicalize_state

    canon = canonicalize_state(state)
    return {f"{name}.{f}": getattr(getattr(canon, name), f).cpu()
            for name in ("buf5", "buf15") for f in ("times", "values", "filled")}


def _compare_service(a: dict, b: dict, label: str, exact: bool, skip_first_ingest=False) -> float:
    """Two service drives tick for tick: routing, fired tuples, digests,
    PUTs; wires bit for bit (``exact``) or within the wire contract (fired
    block exact, floats ``rtol=1e-4, atol=1e-5``). ``skip_first_ingest``
    leaves out the first tick's ingest digest block (it counts the folds of
    a backfill only one drive made). Returns the largest finite wire
    difference."""
    from binquant_tpu_torch.engine.step import (
        INGEST_DIGEST_WIDTH,
        WIRE_FIRED_COUNT_OFF,
        WIRE_MAX_FIRED,
    )

    for key in ("paths", "fired", "digests", "puts"):
        if a[key] != b[key]:
            bad = next(i for i, (x, y) in enumerate(zip(a[key], b[key])) if x != y)
            fail(f"{label}: {key} differ at tick {bad}: {a[key][bad]!r} vs {b[key][bad]!r}")
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    err = 0.0
    for i, (wa, wb) in enumerate(zip(a["wires"], b["wires"], strict=True)):
        if skip_first_ingest and i == 0:
            wa, wb = wa[:-INGEST_DIGEST_WIDTH], wb[:-INGEST_DIGEST_WIDTH]
        if exact:
            if not np.array_equal(wa, wb, equal_nan=True):
                fail(f"{label}: wires differ at tick {i}")
            continue
        if not np.array_equal(wa[off: off + 1 + 4 * K], wb[off: off + 1 + 4 * K]):
            fail(f"{label}: fired blocks differ at tick {i}")
        if not np.isclose(wa, wb, rtol=1e-4, atol=1e-5, equal_nan=True).all():
            fail(f"{label}: wire floats differ beyond the contract at tick {i}")
        fin = np.isfinite(wa) & np.isfinite(wb)
        err = max(err, float(np.abs(wa[fin] - wb[fin]).max()))
    return err


def _carries_match(a: dict, b: dict) -> bool:
    """Host carries equal; the transition strength (a wire float) to the
    wire contract."""
    a, b = dict(a), dict(b)
    x, y = a.pop("last_transition_strength"), b.pop("last_transition_strength")
    return a == b and bool(np.isclose(x, y, rtol=1e-4, atol=1e-5))


def check_service(m5, m15) -> dict:
    """Boot A on the card: no archive, backfill, SERVICE_TICKS live ticks
    through the consume loop (checkpoints at ticks 8 and 16; tick 8's
    archive kept, and its state saved again at 4 shards and monolithic).
    Boot B on the card: restore tick 8's 4-shard set, backfill again (the
    top-up: bars the archive holds are written again), live ticks 9..16.
    Fresh card engines restore the monolithic archive and the 4-shard set
    and run the next tick. The CPU engine runs boot A's stream at depth 0
    with copied rings."""
    import torch

    from binquant_tpu_torch.ops import quantile_tail as qt

    sym_a = service_symbols(np.random.default_rng(SEED + 3))
    sym_cpu = copy.deepcopy(sym_a)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        qt.reset_launches()  # launches made elsewhere do not count
        a = service_drive("cuda", m5, m15, 0, tmp / "a.npz", sym_a, production=True,
                          restore=False, keep_at=SERVICE_EVERY)
        kept, kept4, sym_b, shard_save_ms = a["kept"]
        # the restart from the 4-shard set of tick 8's state; its top-up in
        # one flush, as A's backfill (the rings it leaves are the same at any
        # cadence; the production flush of every 50 symbols is timed by
        # --cold-boot and its folds by --fold-ab)
        b_path = tmp / "b.npz"  # boot B saves into its own path: kept4 stays as saved
        for f in tmp.glob(kept4.name + "*"):
            shutil.copy(f, tmp / f.name.replace(kept4.name, b_path.name))
        b = service_drive("cuda", m5, m15, SERVICE_EVERY, b_path, copy.deepcopy(sym_b),
                          production=True, restore=True)
        launches = dict(qt.launches_by_site)  # read just after the card drives
        n_launches = qt.launches
        # the monolithic archive and the 4-shard set of one state, each
        # restored into a fresh card engine that runs the next tick
        restores = {n: restore_next_tick(path, m5, m15, copy.deepcopy(sym_b))
                    for n, path in ((1, kept), (4, kept4))}
        cpu = service_drive("cpu", m5, m15, 0, tmp / "cpu.npz", sym_cpu, production=False,
                            restore=False)
    want_a = ["cold_start"] + ["audit" if t == SERVICE_EVERY else "incremental"
                               for t in range(1, SERVICE_TICKS)]
    if a["paths"] != want_a:
        fail(f"service boot A routing {a['paths']}, expected {want_a}")
    if b["paths"] != ["backfill"] + ["incremental"] * (SERVICE_TICKS - SERVICE_EVERY - 1):
        fail(f"service boot B routing {b['paths']}")
    sites = dict(EXPECT_SITES, backfill=EXPECT_SITES["cold_start"])
    for run, label in ((a, "A"), (b, "B")):
        # an overflowing tick's fallback (the full-outputs step, every
        # strategy) launches its path's sites again, detect_spikes too
        want = []
        for p, ov in zip(run["paths"], run["overflowed"]):
            w = dict(sites[p])
            for k, v in (_expected_sites(p, dormant=True) if ov else {}).items():
                w[k] = w.get(k, 0) + v
            want.append(w)
        if run["sites"] != want:
            fail(f"service boot {label}: qtail launches by site per tick {run['sites']}, "
                 f"expected {want}")
    err = _compare_service(a, cpu, "service boot A card vs cpu", exact=False)
    tail = {k: a[k][SERVICE_EVERY:] for k in ("paths", "fired", "digests", "puts", "wires")}
    tail["paths"] = ["backfill"] + tail["paths"][1:]  # A audits where B resyncs its top-up
    _compare_service(tail, b, "service boot B vs boot A, ticks 9-16", exact=True,
                     skip_first_ingest=True)
    if not _carries_match(a["carries"], cpu["carries"]):
        fail("service: host carries differ between the card and the cpu")
    if b["carries"] != a["carries"]:
        fail("service: boot B's host carries differ from boot A's")
    if not (a["registry"] == b["registry"] == cpu["registry"]):
        fail("service: the registries differ")
    for k, v in a["canonical"].items():
        for other, label in ((cpu["canonical"][k], "cpu"), (b["canonical"][k], "boot B")):
            if not torch.equal(torch.nan_to_num(v.float(), nan=-1.0),
                               torch.nan_to_num(other.float(), nan=-1.0)):
                fail(f"service: ring {k} differs between boot A and {label}")
    one, four = restores[1], restores[4]
    if not (one["restored"] and four["restored"]):
        fail(f"service: fresh restores gave {one['restored']} (monolithic), "
             f"{four['restored']} (4 shards)")
    if not (_leaves_equal(one["leaves"], four["leaves"])
            and _leaves_equal(four["leaves"], b["restored_leaves"])):
        fail("service: the leaves restored from the 4-shard set differ from the monolithic "
             "archive's (or from boot B's)")
    if not (one["path"] == four["path"] == "incremental" and one["fired"] == four["fired"]
            and np.array_equal(one["wire"], four["wire"], equal_nan=True)):
        fail(f"service: the next tick after a 4-shard restore ({four['path']}, "
             f"{len(four['fired'])} signals) differs from the monolithic restore's "
             f"({one['path']}, {len(one['fired'])})")
    n_digests = sum(len(d) for d in a["digests"])
    n_puts = sum(len(p) for p in a["puts"])
    if n_digests < 2 or n_puts == 0:
        fail(f"service: the drive made {n_digests} notifier digests and {n_puts} PUTs; "
             "the market must cross a regime transition and change leverage")
    if (a["backfill"]["fetches_failed"] != 2 or a["backfill"]["bars"] != (S - 1) * 800
            or a["backfill"]["failing_registered"]):
        fail(f"service: backfill counts {a['backfill']}")
    fired = [t for f in a["fired"] for t in f]
    result = {
        "routing": {"A": a["paths"], "B": b["paths"]},
        "overflowed": {"A": a["overflowed"], "B": b["overflowed"]},
        "launches": n_launches,
        "launches_by_site": launches,
        "signals": len(fired),
        "digests": n_digests,
        "digest_events": [d.splitlines()[1].strip() for ds in a["digests"] for d in ds],
        "puts": n_puts,
        "puts_per_tick": [len(p) for p in a["puts"]],
        "max_wire_abs_err_vs_cpu": err,
        "backfill": {"A": a["backfill"], "B": b["backfill"], "cpu": cpu["backfill"]},
        "backfill_bars_per_s": {k: r["backfill"]["bars"] / r["backfill"]["seconds"]
                                for k, r in (("A", a), ("B", b), ("cpu", cpu))},
        "save_ms": {"A": a["saves_ms"], "B": b["saves_ms"]},
        "restore_ms": b["restore_ms"],
        "sharded": {"save_ms": shard_save_ms,
                    "restore_ms": {1: one["restore_ms"], 4: four["restore_ms"],
                                   "B (4)": b["restore_ms"]},
                    "next_tick": {"path": four["path"], "signals": len(four["fired"])}},
        "state_bytes": a["state_bytes"],
        "first_tick_ms": {"A": a["tick_ms"][0], "B": b["tick_ms"][0], "cpu": cpu["tick_ms"][0]},
        "tick_ms": {"A": a["tick_ms"], "B": b["tick_ms"]},
        "incremental_tick_p50_ms": _p([t for t, p in zip(a["tick_ms"], a["paths"])
                                       if p == "incremental"], 50),
        "calibration_ms": {"p50": _p(a["calibration_ms"], 50), "max": max(a["calibration_ms"]),
                           "runs": len(a["calibration_ms"])},
    }
    print(
        f"[slice service] S={S} W={W}: boot A (no archive) backfilled "
        f"{a['backfill']['bars']} bars in {a['backfill']['seconds']:.2f} s "
        f"({result['backfill_bars_per_s']['A']:.0f} bars/s; {a['backfill']['fetches_failed']} "
        f"fetches failed), then {SERVICE_TICKS} ticks through the consume loop, routing "
        f"{a['paths']} ({sum(a['overflowed'])} ticks overflowed the wire); boot B restored tick {SERVICE_EVERY}'s archive in "
        f"{b['restore_ms']:.1f} ms ({a['state_bytes'] / 2**20:.1f} MiB), topped up "
        f"{b['backfill']['bars']} bars in {b['backfill']['seconds']:.2f} s (one flush, as A "
        f"and the cpu engine), ticks 9-16 "
        f"routing {b['paths']}, equal to boot A's bit for bit"
    )
    print(
        f"[slice service] the cpu engine's backfill {cpu['backfill']['seconds']:.2f} s; "
        f"saves ms {a['saves_ms']} (D2H + savez); first post-backfill tick ms "
        f"A {a['tick_ms'][0]:.1f} B {b['tick_ms'][0]:.1f}; incremental tick p50 "
        f"{result['incremental_tick_p50_ms']:.1f} ms (queue to landed); calibration worker ms "
        f"p50 {result['calibration_ms']['p50']:.2f} max {result['calibration_ms']['max']:.2f} "
        f"over {len(a['calibration_ms'])} runs; {n_digests} digests {result['digest_events']}, "
        f"{n_puts} leverage PUTs, {len(fired)} signals, all equal to the cpu engine's; "
        f"qtail launches {n_launches} {launches}; wire max abs err vs cpu {err:.3g}"
    )
    print(
        f"[slice service] sharded archives: tick {SERVICE_EVERY}'s state saved at 4 shards in "
        f"{shard_save_ms[4]:.1f} ms and monolithic in {shard_save_ms[1]:.1f} ms; boot B "
        f"restored the 4-shard set in {b['restore_ms']:.1f} ms (its ticks 9-16 equal to boot "
        f"A's bit for bit, above); fresh card engines restored the monolithic archive in "
        f"{one['restore_ms']:.1f} ms and the 4-shard set in {four['restore_ms']:.1f} ms, every "
        f"leaf bit-equal (and to boot B's), and ran the next tick ({four['path']}, "
        f"{len(four['fired'])} signals) to the same wire bit for bit"
    )
    return result


# --------------------------------------------------------------------------
# phase 7: the delivery plane and the real sinks
# --------------------------------------------------------------------------

KILL_AFTER = 12  # the live tick after which the plane is killed undrained
CREATE_DOWN = range(1, 21)  # bot creations (in order) that the backend answers 503
TELEGRAM_FLOOD = range(3, 6)  # Telegram sends that meet flood control once each
TELEGRAM_DOWN = range(40, 52)  # Telegram sends whose transport raises
# drill-scale retry and breaker knobs (the production 0.25 s backoff and
# 30 s cooldown would outlast the phase); everything else is the default
DRILL = dict(delivery_backoff_s=0.001, delivery_backoff_max_s=0.01,
             delivery_breaker_cooldown_s=0.05)


class TelegramScript:
    """A Telegram transport that records what it sends; with ``faults``,
    the sends numbered in TELEGRAM_FLOOD meet flood control (retry after
    1 ms) and those in TELEGRAM_DOWN raise."""

    def __init__(self, faults: bool) -> None:
        self.faults = faults
        self.calls = 0
        self.sent: list[str] = []

    async def __call__(self, chat_id: str, text: str) -> None:
        from binquant_tpu_torch.io.telegram import RetryAfterError

        self.calls += 1
        if self.faults and self.calls in TELEGRAM_FLOOD:
            raise RetryAfterError(0.001)
        if self.faults and self.calls in TELEGRAM_DOWN:
            raise ConnectionError("telegram unreachable")
        self.sent.append(text)


class _Reply:
    def __init__(self, payload, status_code: int = 200) -> None:
        self._payload, self.status_code = payload, status_code
        self.text = json.dumps(payload)

    def json(self):
        return self._payload

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise ConnectionError(f"HTTP {self.status_code}")


class FuturesBackend:
    """KuCoin futures: every contract one lot of 0.001, a mark price of 50."""

    def get(self, url: str, params=None):
        if "/mark-price/" in url:
            return _Reply({"data": {"value": 50.0}})
        return _Reply({"data": {"multiplier": 0.001, "lotSize": 1, "takerFeeRate": 0.0006}})


FOLD_AB_RUNS = 4  # runs of each fold arm, in pairs whose first arm alternates
FOLD_AB_FLUSH = 50  # the top-up's flush cadence in symbols (the production default)


def fold_ab(m5: dict, m15: dict, card: str = "cuda") -> dict:
    """The update-only folds of phase 6's service path through both fold
    paths of ``_fold_updates`` (``--fold-ab``): the stacked fold
    (``_scan_fold_prefix``, taken by a drain of more than
    ``_SCAN_FOLD_MIN`` sub-batch pairs) and the per-pair loop
    (``_SCAN_FOLD_MIN`` raised past the drain), on one card engine at
    phase 6's settings whose rings phase 5's market warmed. Three drains,
    each through ``_flush_batchers`` as ``backfill`` flushes it: a top-up
    flush (FOLD_AB_FLUSH symbols, W sub-batches of that many rows per
    interval; a restart's top-up at S symbols is S / FOLD_AB_FLUSH of
    them), a cold backfill's one flush (W sub-batches of S rows per
    interval) and a restore catch-up (8 ticks' bars: 24 5m and 8 15m
    sub-batches of S rows). Every drain writes again bars the rings hold,
    as a top-up does, so each run starts from the same rings. Host ms per
    drain from the flush call to the card's idle, FOLD_AB_RUNS runs per
    arm in pairs whose first arm alternates. ``card="cpu"`` rehearses it
    without a card."""
    import torch

    from binquant_tpu_torch.io.replay import make_stub_engine
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=card, incremental=True,
        carry_audit_every=SERVICE_EVERY, **OBS_OFF, **FANOUT_OFF,
    )
    sync = torch.cuda.synchronize if card == "cuda" else (lambda: None)
    queue_warm(engine, m5, m15)
    asyncio.run(engine.process_tick(now_ms=T_LIVE0 * 1000))
    asyncio.run(engine.flush_pending())
    rows = np.array([engine.registry.add(n) for n in symbols()], dtype=np.int32)
    w5 = bar_values(m5, slice(3 * W - W, 3 * W), 300)
    w15 = bar_values(m15, slice(0, W), 900)
    t5 = T_LIVE0 - 300 * W
    t15 = T_LIVE0 - 900 * W
    drains = {
        "topup_flush": (slice(0, FOLD_AB_FLUSH), range(W), range(W)),
        "cold_flush": (slice(0, S), range(W), range(W)),
        "catchup": (slice(0, S), range(W - 24, W), range(W - 8, W)),
    }

    def run(name: str, loop: bool) -> float:
        sel, k5, k15 = drains[name]
        for k in k5:
            engine.batcher5.add_batch(rows[sel], np.full(len(rows[sel]), t5 + 300 * k, np.int32),
                                      w5[sel, k])
        for k in k15:
            engine.batcher15.add_batch(rows[sel],
                                       np.full(len(rows[sel]), t15 + 900 * k, np.int32),
                                       w15[sel, k])
        if loop:
            engine._SCAN_FOLD_MIN = 1 << 30
        sync()
        t0 = time.perf_counter()
        try:
            engine._flush_batchers()
            sync()
        finally:
            engine.__dict__.pop("_SCAN_FOLD_MIN", None)
        return (time.perf_counter() - t0) * 1000.0

    rings0 = _canonical_rings(engine.state)
    result: dict = {}
    for name in drains:
        run(name, False)  # warm both arms once
        run(name, True)
        ms: dict = {"stacked": [], "loop": []}
        for i in range(FOLD_AB_RUNS):
            order = ("stacked", "loop") if i % 2 == 0 else ("loop", "stacked")
            for arm in order:
                ms[arm].append(run(name, arm == "loop"))
        result[name] = {arm: {"ms": v, "p50_ms": float(np.median(v))} for arm, v in ms.items()}
        result[name]["stacked_over_loop"] = (result[name]["stacked"]["p50_ms"]
                                             / result[name]["loop"]["p50_ms"])
    for k, v in _canonical_rings(engine.state).items():
        if not torch.equal(torch.nan_to_num(v.float(), nan=-1.0),
                           torch.nan_to_num(rings0[k].float(), nan=-1.0)):
            fail(f"fold A/B: ring {k} changed by rewriting the bars it holds")
    flushes = -(-S // FOLD_AB_FLUSH)
    result["topup_fold_s"] = {arm: result["topup_flush"][arm]["p50_ms"] * flushes / 1e3
                              for arm in ("stacked", "loop")}
    for name in drains:
        r = result[name]
        print(f"[fold-ab] {name}: stacked p50 {r['stacked']['p50_ms']:.1f} ms "
              f"{[round(x, 1) for x in r['stacked']['ms']]}, loop p50 {r['loop']['p50_ms']:.1f} "
              f"ms {[round(x, 1) for x in r['loop']['ms']]}, stacked/loop "
              f"{r['stacked_over_loop']:.3f}")
    print(f"[fold-ab] a top-up's {flushes} flushes of {FOLD_AB_FLUSH} symbols: folds "
          f"{result['topup_fold_s']['stacked']:.2f} s stacked, "
          f"{result['topup_fold_s']['loop']:.2f} s by the loop")
    return result


def autotrade_backend(faults: bool):
    """The binbot backend admission talks to: the stub's answers, symbols
    with a 5x futures leverage, and (``faults``) HTTP 503 for the bot
    creations numbered in CREATE_DOWN. Each request is filed under the
    admission attempt running in its thread."""
    import threading

    from binquant_tpu_torch.io.replay import StubSession

    class Backend(StubSession):
        def __init__(self) -> None:
            super().__init__()
            self.creates = 0
            self.failed_creates = 0
            self.local = threading.local()

        def request(self, method: str, url: str, **kwargs):
            calls = getattr(self.local, "calls", None)
            if calls is not None:
                calls.append((method, url, kwargs.get("json")))
            if method == "POST" and url.endswith("/bot"):
                self.creates += 1
                if faults and self.creates in CREATE_DOWN:
                    self.failed_creates += 1
                    self.requests.append((method, url, None))
                    return self._Resp({"message": "backend unavailable"}, 503)
            if "/symbol/" in url and method == "GET":
                self.requests.append((method, url, None))
                return self._Resp({"data": {"id": url.rsplit("/", 1)[-1], "quote_asset": "USDT",
                                            "futures_leverage": 5.0}})
            return super().request(method, url, **kwargs)

    return Backend()


def delivery_engine(device: str, wal_path, faults: bool, delivery: bool = True):
    """A production engine (depth 1 on the card, depth 0 with copied rings
    on the CPU) whose sinks are the real ones: the analytics POST over a
    stub backend (serving phase 6's breadth schedule), a Telegram consumer
    over :class:`TelegramScript`, and
    autotrade admission (autotrade on, KuCoin futures) over
    :func:`autotrade_backend`, recording every payload it is handed and the
    REST calls of each attempt."""
    from binquant_tpu_torch.config import Config
    from binquant_tpu_torch.io.autotrade import AutotradeConsumer
    from binquant_tpu_torch.io.binbot import BinbotApi
    from binquant_tpu_torch.io.exchanges import KucoinFutures
    from binquant_tpu_torch.io.pipeline import SignalEngine
    from binquant_tpu_torch.io.replay import StubSession
    from binquant_tpu_torch.io.telegram import TelegramConsumer
    from binquant_tpu_torch.regime.context import ContextConfig
    from binquant_tpu_torch.schemas import (
        AutotradeSettingsSchema,
        MarketType,
        TestAutotradeSettingsSchema,
    )

    backend = autotrade_backend(faults)

    class Admission(AutotradeConsumer):
        async def process_autotrade_restrictions(self, result):
            entry = result.metadata.get("delivery_id")
            self.seen.append(entry)
            backend.local.calls = calls = []
            try:
                await super().process_autotrade_restrictions(result)
            finally:
                backend.local.calls = None
            # an attempt that returned: its REST calls, filed by entry, and
            # the grid-only policy it read (the engine's, as of the last
            # finalize: a late delivery reads a later tick's)
            self.attempts.append((entry, calls, self.grid_only_policy.block_standard_bots))

    consumer = Admission(
        autotrade_settings=AutotradeSettingsSchema(
            autotrade=True, exchange_id="kucoin", market_type=MarketType.FUTURES),
        active_test_bots=[],
        all_symbols=[],
        test_autotrade_settings=TestAutotradeSettingsSchema(autotrade=False),
        active_grid_ladders=[],
        binbot_api=BinbotApi("http://stub-admission", session=backend),
        kucoin_futures_api=KucoinFutures(session=FuturesBackend()),
    )
    consumer.seen, consumer.attempts = [], []
    transport = TelegramScript(faults)
    telegram = TelegramConsumer(token="", chat_id="smoke", transport=transport)
    # drill scale: no one-second pacing, no two-second flood pad
    telegram._min_send_interval_seconds = 0.0
    telegram._retry_after_pad_seconds = 0.0
    config = Config(max_symbols=S, window_bars=W, carry_audit_every_ticks=AUDIT_EVERY, env="CI",
                    delivery_enabled=delivery, delivery_wal_path=str(wal_path), **DRILL,
                    trace_sample=0.0, freshness_enabled=False, host_phase_enabled=False,
                    slo_enabled=False, delivery_health_enabled=False, fanout_enabled=False)
    if device == "cpu":
        config.pipeline_depth, config.donate = 0, False
    # phase 6's breadth schedule: the breadth-gated strategies fire on the
    # live ticks too, not only on the crash
    analytics = BinbotApi("http://stub", session=StubSession({"schedule": service_breadth()}))
    engine = SignalEngine(config, analytics, telegram, consumer, device=device,
                          context_config=ContextConfig())
    return engine, backend, transport


def instrument(plane, rec: dict) -> None:
    """Record what ``plane`` accepts and acks: the autotrade puts, and per
    acked (sink, entry) its payload and its lag from the tick's klines
    being queued (``rec["queued"]``, by tick ms) to the ack."""
    enqueue, ack = plane.enqueue, plane._ack

    def on_enqueue(env):
        if env.sink == "autotrade" and not env.replayed:
            rec["puts"].append(env.entry_id)
        enqueue(env)

    def on_ack(lane, env):
        rec["acked"][(lane.sink.name, env.entry_id)] = env.payload
        if env.replayed:  # decoded from the WAL: a boot replay or a deferral's sweep
            rec["via_wal"].add((lane.sink.name, env.entry_id))
        rec["ack_counts"][lane.sink.name] = rec["ack_counts"].get(lane.sink.name, 0) + 1
        t0 = rec["queued"].get(env.ts_ms)
        if t0 is not None:
            rec["lag_ms"].setdefault(lane.sink.name, []).append(
                (time.perf_counter() - t0) * 1000.0)
        ack(lane, env)

    plane.enqueue, plane._ack = on_enqueue, on_ack


async def kill_and_reboot(engine, rec: dict) -> dict:
    """Kill the plane without a drain (the workers abandoned, the WAL
    handle left open, no compaction), then boot a second plane on the same
    WAL, which replays the unacked entries. Returns what the kill left."""
    from binquant_tpu_torch.io.delivery import DeliveryPlane
    from binquant_tpu_torch.io.emission import make_signal_sinks

    old = engine.delivery
    left = {name: {"enqueued": lane.enqueued, "acked": lane.acked, "shed": dict(lane.shed),
                   "abandoned": lane.queue.qsize() + lane.inflight}
            for name, lane in old._lanes.items()}
    workers = [lane.worker for lane in old._lanes.values()]
    for w in workers:
        w.cancel()
    await asyncio.gather(*workers, return_exceptions=True)
    old.closed = True
    unacked = {rec["id"] for rec in old.wal.unacked() if rec["sink"] == "autotrade"}
    t0 = time.perf_counter()
    plane = DeliveryPlane.from_config(engine.config, make_signal_sinks(
        engine.binbot_api, engine.telegram_consumer, engine.at_consumer),
        freshness=engine.freshness, health=engine.delivery_health)
    instrument(plane, rec)
    plane.start()
    replay_ms = (time.perf_counter() - t0) * 1000.0
    engine.delivery = plane
    return {"lanes": left, "wal": (old.wal.puts, old.wal.acks, old.wal.dup_acks),
            "unacked_at_kill": len(unacked), "unacked_ids": unacked,
            "replayed": plane.wal_replayed, "replay_ms": replay_ms, "old": old}


def drive_delivery(specs: dict, m5: dict, m15: dict) -> dict:
    """The warm tick, LIVE_TICKS live ticks and the crash tick through each
    engine's ``consume_loop`` (label -> spec with its engine), the engines
    taking each tick in turns. Per engine and tick: the ms from queueing the
    klines until the tick landed and emitted, the qtail launches by site,
    the path and whether it overflowed. A spec with ``kill`` kills its plane
    after live tick KILL_AFTER and boots a second one. Last, every plane
    drains and is retired by cancelling the loop; the WAL's bytes before
    and after that compaction are kept."""
    from binquant_tpu_torch.ops import quantile_tail as qt

    for spec in specs.values():
        engine = spec["engine"]
        spec["ticks"] = tick_plan(engine, m5, m15, LIVE_TICKS + 1)
        spec.update(tick_ms=[], sites=[], paths=[], overflowed=[], finalize_ms=[],
                    kill=spec.get("kill"))
        if engine.delivery is not None:
            instrument(engine.delivery, spec["rec"])

        async def timed_finalize(pending, _inner=engine._finalize_tick_inner, _spec=spec):
            t0 = time.perf_counter()
            try:
                return await _inner(pending)
            finally:
                _spec["finalize_ms"].append((time.perf_counter() - t0) * 1000.0)

        # the host ms of each finalize: wire decode, monitors, the overflow
        # fallback where one runs, outcomes and emission
        engine._finalize_tick_inner = timed_finalize

    async def run() -> None:
        labels = list(specs)
        n_ticks = len(next(iter(specs.values()))["ticks"])
        for n in range(n_ticks):
            for label in labels[n % len(labels):] + labels[: n % len(labels)]:
                spec = specs[label]
                engine, (now_ms, klines) = spec["engine"], spec["ticks"][n]
                if n == 0:  # each loop starts at its own warm tick
                    spec["queue"], spec["clock"] = asyncio.Queue(), {"now": now_ms}
                    spec["task"] = asyncio.create_task(engine.consume_loop(
                        spec["queue"], tick_interval_s=0.0,
                        clock=lambda c=spec["clock"]: c["now"]))
                spec["clock"]["now"] = now_ms
                before, ticks0, o0 = dict(qt.launches_by_site), engine.ticks_processed, \
                    engine.overflow_ticks
                t0 = time.perf_counter()
                spec["rec"]["queued"][now_ms] = t0
                for k in klines:
                    spec["queue"].put_nowait(k)
                while engine.ticks_processed == ticks0 or engine._pending:
                    await asyncio.sleep(0.0002)
                spec["tick_ms"].append((time.perf_counter() - t0) * 1000.0)
                spec["sites"].append({k: v - before.get(k, 0) for k, v in
                                      qt.launches_by_site.items() if v != before.get(k, 0)})
                spec["paths"].append(engine.last_path)
                spec["overflowed"].append(engine.overflow_ticks > o0)
                if spec["kill"] and n == KILL_AFTER:
                    spec["killed"] = await kill_and_reboot(engine, spec["rec"])
        for spec in specs.values():
            engine = spec["engine"]
            await settle(engine)
            if engine.delivery is not None:
                spec["wal_bytes_before"] = os.path.getsize(engine.delivery.wal.path)
                spec["final"] = engine.delivery
            spec["task"].cancel()
            try:
                await spec["task"]
            except asyncio.CancelledError:
                pass
            if engine.delivery is not None:
                spec["wal_bytes_after"] = os.path.getsize(engine.delivery.wal.path)
        return None

    asyncio.run(run())
    return specs


def wal_put_ms(wal_dir: Path, payload: dict, n: int = 200) -> dict:
    """ms per WAL put of ``payload`` into a fresh WAL in ``wal_dir``,
    fsynced (the plane's setting) and, for contrast, flushed only."""
    from binquant_tpu_torch.io.delivery import DeliveryWal

    out = {}
    for fsync in (True, False):
        wal = DeliveryWal(wal_dir / f"bench.{int(fsync)}.wal.jsonl", fsync=fsync, compact_every=0)
        t0 = time.perf_counter()
        for i in range(n):
            wal.append_put(f"bench/{i}", "autotrade", payload, ts_ms=i)
        out["fsync" if fsync else "flush"] = (time.perf_counter() - t0) * 1000.0 / n
        wal.close()
    return out


def _comparable(sink: str, payload):
    if sink == "autotrade":
        payload = payload.model_dump(mode="json")
        if payload.get("grid_params"):
            payload["grid_params"].pop("generated_at")
    elif sink == "analytics":
        payload = {k: v for k, v in payload.items() if k != "generated_at"}
    return payload


def envelope_flip(signal_a, signal_b, calls_a: list, calls_b: list):
    """Whether two admissions of one signal differ only by the Bollinger
    envelope gate (exits derived from the bands only when the envelope lies
    strictly between 2% and 20%, autotrade.py ``bollinger_exit_params``),
    with each side's envelope within 1e-4 (relative) of the bound it falls
    on either side of: the bands are wire floats, equal between the card
    and the CPU to the wire contract, so such a gate may flip. Returns the
    two envelopes in % then, else None."""
    from binquant_tpu_torch.io.autotrade import BB_ENVELOPE_MAX_PCT, BB_ENVELOPE_MIN_PCT
    from binquant_tpu_torch.io.replay import payloads_match

    exits = ("stop_loss", "take_profit", "trailing_deviation")
    if [c[:2] for c in calls_a] != [c[:2] for c in calls_b]:
        return None
    for (_, _, ja), (_, _, jb) in zip(calls_a, calls_b):
        if isinstance(ja, dict) and isinstance(jb, dict) and ja.keys() == jb.keys():
            ja = {k: v for k, v in ja.items() if k not in exits}
            jb = {k: v for k, v in jb.items() if k not in exits}
        if not payloads_match(ja, jb):
            return None
    envs = []
    for sig in (signal_a, signal_b):
        bb = sig.bb_spreads
        envs.append(abs(bb.bb_high - bb.bb_low) / bb.bb_high * 100 if bb and bb.bb_high else 0.0)
    for bound in (BB_ENVELOPE_MIN_PCT, BB_ENVELOPE_MAX_PCT):
        if (envs[0] > bound) != (envs[1] > bound) and all(
                abs(e - bound) <= 1e-4 * bound for e in envs):
            return envs
    return None


def check_delivery(m5, m15, card: str = "cuda") -> dict:
    """The production loop through ``consume_loop`` with the delivery plane
    on, its WAL in a temporary directory, phase 5's crash market: on the
    card with scripted faults in all three sinks and a kill of the plane
    after tick KILL_AFTER, beside the same drive on the inline path taken in
    turns; then a CPU engine (depth 0, copied rings) with the same sinks
    and no faults. Zero loss and no duplicate ack of the autotrade class,
    balanced lossy accounting, the card's payloads equal to the CPU's."""
    from unittest import mock

    from binquant_tpu_torch.io import autotrade as at_mod
    from binquant_tpu_torch.io.exchanges import KucoinFutures
    from binquant_tpu_torch.io.replay import payloads_match
    from binquant_tpu_torch.ops import quantile_tail as qt

    def rec() -> dict:
        return {"puts": [], "acked": {}, "ack_counts": {}, "lag_ms": {}, "queued": {},
                "via_wal": set()}

    (ROOT / "build").mkdir(exist_ok=True)
    # a launch builds its own futures client for a short's mark price: the
    # phase's points at the stub contract book
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, mock.patch.object(
        at_mod, "KucoinFutures", lambda: KucoinFutures(session=FuturesBackend())
    ):
        tmp = Path(tmp)
        main, backend, transport = delivery_engine(card, tmp / "main.wal.jsonl", faults=True)
        inline, _, _ = delivery_engine(card, tmp / "inline.wal.jsonl", faults=False,
                                       delivery=False)
        qt.reset_launches()  # launches made elsewhere do not count
        card = drive_delivery({
            "plane": {"engine": main, "backend": backend, "rec": rec(), "kill": True},
            "inline": {"engine": inline, "rec": rec()},
        }, m5, m15)
        launches = dict(qt.launches_by_site)  # read just after the card drives
        n_launches = qt.launches
        cpu_engine, _, _ = delivery_engine("cpu", tmp / "cpu.wal.jsonl", faults=False)
        cpu = drive_delivery({"cpu": {"engine": cpu_engine, "rec": rec()}}, m5, m15)["cpu"]
        sample = next(p for (s, _), p in card["plane"]["rec"]["acked"].items()
                      if s == "autotrade").model_dump(mode="json")
        put_ms = wal_put_ms(tmp, sample)
    plane, inl = card["plane"], card["inline"]
    killed, final, r = plane["killed"], plane["final"], plane["rec"]

    expect = ["cold_start"] + ["audit" if t % AUDIT_EVERY == 0 else "incremental"
                               for t in range(1, LIVE_TICKS + 2)]
    for run, label in ((plane, "plane"), (inl, "inline"), (cpu, "cpu")):
        if run["paths"] != expect:
            fail(f"delivery drive ({label}) routing {run['paths']}, expected {expect}")
    for run, label in ((plane, "plane"), (inl, "inline")):
        want = []
        for p, ov in zip(run["paths"], run["overflowed"]):
            w = dict(EXPECT_SITES[p])
            for k, v in (_expected_sites(p, dormant=True) if ov else {}).items():
                w[k] = w.get(k, 0) + v
            want.append(w)
        if run["sites"] != want or run["overflowed"][-1] is not True:
            fail(f"delivery drive ({label}): qtail launches by site per tick {run['sites']}, "
                 f"expected {want} (overflowed {run['overflowed']})")

    # zero loss and no duplicate ack: every put reached admission and acked
    puts, cpu_puts = set(r["puts"]), set(cpu["rec"]["puts"])
    received = main.at_consumer.seen
    acked_at = {e for (s, e) in r["acked"] if s == "autotrade"}
    n_wal_puts = killed["wal"][0] + final.wal.puts
    if not puts or len(r["puts"]) != len(puts) or n_wal_puts != len(puts):
        fail(f"delivery: {len(r['puts'])} autotrade puts ({len(puts)} ids), WAL puts {n_wal_puts}")
    if puts != cpu_puts:
        fail(f"delivery: the card put {len(puts)} autotrade entries, the cpu {len(cpu_puts)}")
    if set(received) != puts or acked_at != puts or final.wal.unacked_count():
        fail(f"delivery: lost autotrade entries: {len(puts - set(received))} never reached "
             f"admission, {len(puts - acked_at)} never acked, {final.wal.unacked_count()} "
             "unacked in the WAL")
    dup_acks = killed["wal"][2] + final.wal.dup_acks
    if dup_acks or not final.zero_loss_invariant()["ok"]:
        fail(f"delivery: {dup_acks} duplicate acks, invariant {final.zero_loss_invariant()}")
    if not (killed["unacked_at_kill"] > 0 and killed["replayed"] == killed["unacked_at_kill"]):
        fail(f"delivery: the kill left {killed['unacked_at_kill']} unacked entries, the second "
             f"plane replayed {killed['replayed']}")
    if backend.failed_creates != len(CREATE_DOWN) or "open" not in killed["old"].breaker(
            "autotrade").transitions + final.breaker("autotrade").transitions:
        fail(f"delivery: {backend.failed_creates} bot creations failed without opening the "
             "autotrade breaker")

    # lossy accounting: enqueued = acked + shed (+ abandoned by the kill)
    lossy = {}
    for name in ("analytics", "telegram"):
        k, f = killed["lanes"][name], final.lane(name)
        for side, (enq, ack, shed, gone) in {
            "before_kill": (k["enqueued"], k["acked"], k["shed"], k["abandoned"]),
            "after_kill": (f.enqueued, f.acked, dict(f.shed), 0),
        }.items():
            if enq != ack + sum(shed.values()) + gone:
                fail(f"delivery: {name} {side}: enqueued {enq} != acked {ack} + shed {shed} "
                     f"+ abandoned {gone}")
        lossy[name] = {"before_kill": k, "after_kill": {"enqueued": f.enqueued, "acked": f.acked,
                                                        "shed": dict(f.shed)},
                       "retries": f.retries + killed["old"].lane(name).retries,
                       "breaker": killed["old"].breaker(name).transitions
                       + f.breaker.transitions}
    tel = lossy["telegram"]
    sheds = {**tel["before_kill"]["shed"], **tel["after_kill"]["shed"]}
    if not (tel["retries"] and "open" in tel["breaker"] and sheds):
        fail(f"delivery: the Telegram faults made {tel['retries']} retries, breaker "
             f"{tel['breaker']}, sheds {sheds}")

    # card against cpu, by entry id, every entry both delivered
    both_keys = sorted(set(r["acked"]) & set(cpu["rec"]["acked"]))
    compared = {}
    for key in both_keys:
        a = _comparable(key[0], r["acked"][key])
        b = _comparable(key[0], cpu["rec"]["acked"][key])
        if not payloads_match(a, b):
            fail(f"delivery: {key} delivered differently on the card and the cpu: "
                 f"{str(a)[:300]} vs {str(b)[:300]}")
        compared[key[0]] = compared.get(key[0], 0) + 1
    last_ok = lambda attempts: {e: (calls, block) for e, calls, block in attempts}  # noqa: E731
    card_rest, cpu_rest = last_ok(main.at_consumer.attempts), last_ok(cpu_engine.at_consumer.attempts)
    same_rest = lambda a, b: [(m, u) for m, u, _ in a] == [(m, u) for m, u, _ in b] \
        and payloads_match([j for _, _, j in a], [j for _, _, j in b])  # noqa: E731
    rest_compared, policy_differs, replayed_differs, both_via_wal = 0, 0, 0, 0
    envelope_flips: list = []
    for entry in sorted(set(card_rest) & set(cpu_rest)):
        (a, block_a), (b, block_b) = card_rest[entry], cpu_rest[entry]
        if block_a != block_b:  # each side delivered under another tick's policy
            policy_differs += 1
            continue
        via_wal = [("autotrade", entry) in rr["via_wal"] for rr in (r, cpu["rec"])]
        if via_wal[0] != via_wal[1]:
            # a payload decoded from the WAL (the replay after the kill, or
            # the sweep of a burst deferred past the queue bound) comes back
            # with every field marked as set (model_validate of a full
            # dump), so admission reads its dumped defaults as the signal's
            # choices, as the reference does (ROADMAP C): where only one
            # side decoded it, counted, not compared
            replayed_differs += not same_rest(a, b)
            continue
        both_via_wal += via_wal[0]
        rest_compared += 1
        if same_rest(a, b):
            continue
        flip = envelope_flip(r["acked"][("autotrade", entry)],
                             cpu["rec"]["acked"][("autotrade", entry)], a, b)
        if flip is None:
            bad = next((x, y) for x, y in zip(a + [None], b + [None])
                       if x is None or y is None or x[:2] != y[:2]
                       or not payloads_match(x[2], y[2]))
            fail(f"delivery: {entry}: admission's REST sequence differs from the cpu's: "
                 f"{str(bad[0])[:400]} vs {str(bad[1])[:400]}")
        envelope_flips.append((entry, flip))
    if set(card_rest) != puts or not compared.get("autotrade"):
        fail(f"delivery: admission returned for {len(card_rest)} of {len(puts)} entries")
    launched = sum(1 for calls, _ in card_rest.values()
                   if any(m == "POST" and u.endswith("/bot") for m, u, _ in calls))
    if not rest_compared:
        fail("delivery: no entry was admitted under the same grid-only policy on both sides")

    live = slice(1, LIVE_TICKS + 1)
    emits = main.emit_ms
    n_signals = [len([p for p in r["puts"] if p.startswith(f"t{t}/")])
                 for t, _ in plane["ticks"]]
    result = {
        "ticks": len(expect), "launches": n_launches, "launches_by_site": launches,
        "routing": plane["paths"], "signals": len(puts),
        "signals_per_tick": n_signals, "bots_launched": launched,
        "tick_ms": {
            label: {"p50": _p(run["tick_ms"][live], 50), "p99": _p(run["tick_ms"][live], 99),
                    "crash": run["tick_ms"][-1], "per_tick": run["tick_ms"]}
            for label, run in (("plane", plane), ("inline", inl))
        },
        "emit_ms": {"plane_p50": _p(emits[live], 50), "plane_crash": emits[-1],
                    "inline_p50": _p(inline.emit_ms[live], 50),
                    "inline_crash": inline.emit_ms[-1], "plane_per_tick": emits,
                    "inline_per_tick": inline.emit_ms},
        "finalize_ms": {label: {"p50": _p(run["finalize_ms"][live], 50),
                                "crash": run["finalize_ms"][-1], "per_tick": run["finalize_ms"]}
                        for label, run in (("plane", plane), ("inline", inl))},
        "wal_put_ms": put_ms,
        "emit_ms_per_put_crash": emits[-1] / max(n_signals[-1], 1),
        "lag_ms": {s: {"p50": _p(v, 50), "p99": _p(v, 99), "acks": len(v)}
                   for s, v in r["lag_ms"].items()},
        "kill": {"after_tick": KILL_AFTER, "unacked": killed["unacked_at_kill"],
                 "replayed": killed["replayed"], "replay_ms": killed["replay_ms"],
                 "lanes": killed["lanes"]},
        "admission_attempts": len(received),
        "redeliveries": len(main.at_consumer.attempts) - len(card_rest),
        "failed_creates": backend.failed_creates,
        "autotrade_breaker": killed["old"].breaker("autotrade").transitions
        + final.breaker("autotrade").transitions,
        "lossy": lossy,
        "telegram_sent": len(transport.sent), "telegram_calls": transport.calls,
        "wal_bytes": {"before_compaction": plane["wal_bytes_before"],
                      "after_compaction": plane["wal_bytes_after"]},
        "compared_with_cpu": compared, "dup_acks": dup_acks,
        "rest_sequences_compared": rest_compared,
        "rest_sequences_under_another_policy": policy_differs,
        "rest_sequences_compared_both_via_wal": both_via_wal,
        "rest_sequences_one_side_via_wal_differing": replayed_differs,
        "via_wal": {"card": len(r["via_wal"]), "cpu": len(cpu["rec"]["via_wal"])},
        "envelope_gate_flips": envelope_flips,
    }
    print(
        f"[slice delivery] S={S} W={W}: {len(expect)} ticks (1 warm + {LIVE_TICKS} live + 1 crash) "
        f"through consume_loop, depth 1, the delivery plane on (WAL fsynced per put); routing "
        f"{expect.count('audit')} audits; qtail launches {n_launches} {launches} (the plane and "
        f"the inline engine, each tick as phase 5 counts it); {len(puts)} autotrade entries "
        f"({n_signals[-1]} on the crash tick), {launched} bots launched; "
        f"{backend.failed_creates} bot creations failed (HTTP 503), autotrade "
        f"breaker {result['autotrade_breaker']}; killed after tick {KILL_AFTER} with "
        f"{killed['unacked_at_kill']} unacked, the second plane replayed {killed['replayed']} "
        f"in {killed['replay_ms']:.1f} ms; zero loss ({len(puts)} puts = admitted = acked, "
        f"{len(received)} admission attempts, "
        f"{result['redeliveries']} redeliveries), {dup_acks} duplicate acks; Telegram "
        f"{transport.calls} sends ({len(transport.sent)} delivered), retries "
        f"{tel['retries']}, breaker {tel['breaker']}, sheds {sheds}; lossy lanes balanced "
        f"(enqueued = acked + shed + abandoned by the kill); payloads equal to the cpu's on "
        f"{compared} entries, admission's REST sequences on {rest_compared} ({both_via_wal} "
        f"decoded from the WAL on both sides, the rest on neither; {len(r['via_wal'])} card "
        f"and {len(cpu['rec']['via_wal'])} cpu entries were, replayed or deferred); "
        f"{policy_differs} more were admitted under another tick's grid-only policy on one "
        f"side, and of those decoded from the WAL on one side only {replayed_differs} differ, "
        f"their defaults read as set; "
        f"{len(envelope_flips)} differ by the 2%/20% Bollinger envelope gate, both "
        f"envelopes within 1e-4 of the bound: {envelope_flips[:4]})"
    )
    print(
        f"[slice delivery] tick ms (queue to landed) plane on p50 "
        f"{result['tick_ms']['plane']['p50']:.1f} p99 {result['tick_ms']['plane']['p99']:.1f} "
        f"crash {plane['tick_ms'][-1]:.1f}; inline p50 {result['tick_ms']['inline']['p50']:.1f} "
        f"p99 {result['tick_ms']['inline']['p99']:.1f} crash {inl['tick_ms'][-1]:.1f}; emit "
        f"host ms per tick plane p50 {result['emit_ms']['plane_p50']:.2f} crash "
        f"{emits[-1]:.1f} ({result['emit_ms_per_put_crash']:.3f} per signal), inline p50 "
        f"{result['emit_ms']['inline_p50']:.2f} crash {inline.emit_ms[-1]:.1f}; finalize host ms "
        f"(decode, monitors, fallback, outcomes, emission) plane p50 "
        f"{result['finalize_ms']['plane']['p50']:.1f} crash {plane['finalize_ms'][-1]:.1f}, "
        f"inline p50 {result['finalize_ms']['inline']['p50']:.1f} crash "
        f"{inl['finalize_ms'][-1]:.1f}; WAL put ms "
        f"fsynced {put_ms['fsync']:.3f} flushed {put_ms['flush']:.4f}; queue-to-ack lag ms "
        + ", ".join(f"{s} p50 {v['p50']:.1f} p99 {v['p99']:.1f}" for s, v in
                    sorted(result["lag_ms"].items()))
        + f"; WAL bytes {plane['wal_bytes_before']} before the closing compaction, "
        f"{plane['wal_bytes_after']} after"
    )
    return result


# -- phase 8: the tick's default observability -------------------------------------

OBS_SLOW_MS = 50.0  # the flight recorder's busy-time budget
OBS_DELIVERY_SLO_MS = 1000.0  # the delivery SLO's p99 budget per sink
OBS_FRESHNESS_SLO_MS = 5000.0  # the freshness SLO's close→ack budget
OBS_PROFILE_S = 2.0  # the profiler window opened over an audit tick
OBS_COST_RUNS = 4  # runs of each host-cost arm, in pairs whose first arm alternates
OBS_COST_AUDIT = 4  # the cost runs' audit cadence: warm, 3 live, the audit, 1 more


def obs_engine(device: str, wal_path, m5: dict, m15: dict, on: bool = True,
               audit_every: int = AUDIT_EVERY, fanout: dict | None = None):
    """A production engine (depth 1, rings in place, both digests, the
    meter, outcomes, the plane with its WAL at ``wal_path``; phase 6's
    breadth schedule) with the tick's observability at its defaults
    (``on``) or all off, and its ticks. The fan-out plane is off unless
    ``fanout`` gives its ``fanout_overrides`` (phase 9)."""
    from binquant_tpu_torch.io.replay import StubSession, make_stub_engine
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device, incremental=True,
        carry_audit_every=audit_every, session=StubSession({"schedule": service_breadth()}),
        delivery_wal=str(wal_path), freshness_slo_ms=OBS_FRESHNESS_SLO_MS,
        delivery_overrides=dict(trace_slow_ms=OBS_SLOW_MS, delivery_slo_ms=OBS_DELIVERY_SLO_MS),
        **({} if on else OBS_OFF),
        **(FANOUT_OFF if fanout is None else dict(fanout=True, fanout_overrides=fanout)),
    )
    # every regime digest shares one dedupe key (see the service drive)
    engine.telegram_consumer._signal_dedupe_seconds = 0.0
    return engine, tick_plan(engine, m5, m15, LIVE_TICKS + 1)


async def http_get(port: int, target: str, timeout_s: float = 60.0) -> tuple[int, str]:
    """One GET to the engine's metrics server on this loop (served in the
    loop's gaps, between ticks)."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection("127.0.0.1", port), timeout_s)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout_s)
    writer.close()
    head, _, body = raw.decode().partition("\r\n\r\n")
    return int(head.split()[1]), body


def metric_total(text: str, name: str, labels: str = "") -> float:
    """The sum of a family's samples in a /metrics body (those whose label
    set holds ``labels``)."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if labels in line:
                total += float(line.rsplit(" ", 1)[1])
    return total


async def obs_drive(engine, ticks, rec: dict, server=None, profile_at: int | None = None,
                    settle_each: bool = True, start=None, before_tick=None,
                    after_ticks=None) -> dict:
    """The ticks through ``consume_loop``; per tick the ms from queueing its
    klines to its signals emitted, ``process_tick``'s own ms, the path, the
    qtail launches (card) or twin calls (CPU) by site. With ``settle_each``
    the plane drains after every tick (the comparisons need it); without,
    its lanes run in the loop's gaps between back-to-back ticks. With
    ``server`` (a ``MetricsServer`` over the engine) ``/metrics`` is
    scraped after every tick and the debug routes are read at the end;
    with ``profile_at`` a ``/debug/profile`` window opens just before that
    tick. ``start()``, ``before_tick(n)`` and ``after_ticks()`` (coroutines)
    run on the loop before the consume loop starts (it takes the warm tick
    at once), before tick ``n``'s klines are queued, and after the last tick
    settled while the consume loop still runs."""
    from binquant_tpu_torch.obs.instruments import SIGNALS
    from binquant_tpu_torch.ops import quantile_tail as qt

    counts = qt.launches_by_site if engine.device.type == "cuda" else qt.twin_calls_by_site
    out = {"loop_ms": [], "tick_ms": [], "ingest_ms": [], "finalize_ms": [], "host_ms": [],
           "paths": [], "sites": [], "overflowed": [], "scrapes": [], "profile": None,
           "routes": {}}
    # the tick's host path: its candles' ingest, process_tick (the
    # dispatch) and its finalize; none of them yields to the loop, so the
    # lanes' work stays out
    spent = {"ingest_ms": 0.0, "finalize_ms": 0.0}
    ingest, finalize = engine.ingest, engine._finalize_tick

    def timed_ingest(kline):
        t = time.perf_counter()
        try:
            return ingest(kline)
        finally:
            spent["ingest_ms"] += (time.perf_counter() - t) * 1000.0

    async def timed_finalize(pending):
        t = time.perf_counter()
        try:
            return await finalize(pending)
        finally:
            spent["finalize_ms"] += (time.perf_counter() - t) * 1000.0

    engine.ingest, engine._finalize_tick = timed_ingest, timed_finalize
    if start is not None:
        await start()
    port = await server.start() if server is not None else None
    signals0 = sum(c.value for _, c in SIGNALS.children())
    queue: asyncio.Queue = asyncio.Queue()
    clock = {"now": ticks[0][0]}
    task = asyncio.create_task(
        engine.consume_loop(queue, tick_interval_s=0.0, clock=lambda: clock["now"]))
    for n, (now_ms, klines) in enumerate(ticks):
        clock["now"] = now_ms
        if before_tick is not None:
            await before_tick(n)
        if profile_at == n:
            code, body = await http_get(port, f"/debug/profile?seconds={OBS_PROFILE_S}")
            out["profile"] = (code, json.loads(body))
        before, ticks0, over0 = dict(counts), engine.ticks_processed, engine.overflow_ticks
        spent["ingest_ms"] = spent["finalize_ms"] = 0.0
        rec["queued"][now_ms] = t0 = time.perf_counter()
        for k in klines:
            queue.put_nowait(k)
        while engine.ticks_processed == ticks0 or engine._pending:
            await asyncio.sleep(0.0002)
        out["loop_ms"].append((time.perf_counter() - t0) * 1000.0)
        out["tick_ms"].append(engine.tick_wall_ms[-1])
        for key, ms in spent.items():
            out[key].append(ms)
        out["host_ms"].append(spent["ingest_ms"] + engine.tick_wall_ms[-1]
                              + spent["finalize_ms"])
        out["paths"].append(engine.last_path)
        out["overflowed"].append(engine.overflow_ticks > over0)
        out["sites"].append({k: v - before.get(k, 0) for k, v in counts.items()
                             if v != before.get(k, 0)})
        if settle_each:
            await settle(engine)
        if port is not None:
            code, text = await http_get(port, "/metrics")
            out["scrapes"].append((code, metric_total(text, "bqt_signals_total") - signals0,
                                   engine.signals_emitted))
    if after_ticks is not None:
        await after_ticks()
    if server is not None:
        ctl = server.profiler
        for _ in range(600):
            if ctl is None or ctl.closed.is_set():
                break
            await asyncio.sleep(0.1)
        for route in ("/healthz", "/debug/slo", "/debug/symbols?limit=5", "/debug/executables",
                      "/metrics"):
            out["routes"][route] = await http_get(port, route)
        await server.stop()
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    else:
        fail("observability: the consume loop returned instead of being cancelled")
    return out


def _span_names(node: dict) -> list:
    return [node["name"]] + [n for c in node.get("children", ()) for n in _span_names(c)]


def _traced_keys(acked: dict) -> dict:
    """(sink, tick_seq, strategy, symbol) -> payload of every acked entry;
    fails on an untraced entry id."""
    import re

    out = {}
    for (sink, entry_id), payload in acked.items():
        tid, seq, strategy, symbol = entry_id.split("/")
        if not re.fullmatch(r"[0-9a-f]{16}", tid):
            fail(f"observability: entry {entry_id} of {sink} is not traced")
        out[(sink, int(seq), strategy, symbol)] = payload
    return out


def _masked(sink: str, payload):
    """A delivered payload with its trace id and ``freshness_ms`` masked
    (the tick_seq stays); fails when either is missing or not finite."""
    import math
    import re

    if sink == "telegram":
        m = re.search(r"\n- Trace: ([0-9a-f]{16})/(\d+)$", payload)
        if m is None:
            fail(f"observability: a Telegram text lacks its trace line: {payload[-120:]!r}")
        return payload[: m.start()] + f"\n- Trace: <id>/{m.group(2)}"
    payload = _comparable(sink, payload)
    meta = payload["metadata"] if sink == "autotrade" else payload
    if not re.fullmatch(r"[0-9a-f]{16}", str(meta.get("trace_id"))) or not math.isfinite(
            meta.get("freshness_ms", float("nan"))):
        fail(f"observability: {sink} payload without trace_id/freshness_ms: {str(meta)[:300]}")
    meta["trace_id"] = meta["freshness_ms"] = "<masked>"
    if "delivery_id" in meta:
        meta["delivery_id"] = "<id>/" + meta["delivery_id"].split("/", 1)[1]
    return payload


def _profile_names(path) -> dict:
    """What a profiler window's Chrome trace names of the qtail kernel: its
    device kernels and the wrapper's host launch ranges."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    kernels = sorted({e["name"] for e in events
                      if "qtail" in str(e.get("name")) and e.get("cat") == "kernel"})
    ranges = sorted({e["name"] for e in events
                     if str(e.get("name", "")).startswith("qtail_launch")})
    ticks = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("bqt_tick#")})
    return {"events": len(events), "kernels": kernels, "launch_ranges": ranges, "ticks": ticks}


def check_observability(m5, m15, card: str = "cuda") -> dict:
    """Phase 8: the production loop at production defaults (tracing,
    freshness, host phase, SLOs, delivery health) with a ``MetricsServer``
    on 127.0.0.1:0, on the card, against a CPU engine with the same knobs;
    then the slice's host cost, its parts all on against all off, in turns."""
    from binquant_tpu_torch.obs.events import EventLog, set_event_log
    from binquant_tpu_torch.obs.exposition import MetricsServer
    from binquant_tpu_torch.obs.instruments import DELIVERY_LAG, FRESHNESS
    from binquant_tpu_torch.obs.ledger import LEDGER
    from binquant_tpu_torch.obs.tracing import ProfileController
    from binquant_tpu_torch.ops import quantile_tail as qt

    def rec() -> dict:
        return {"puts": [], "acked": {}, "ack_counts": {}, "lag_ms": {}, "queued": {},
                "via_wal": set()}

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # -- the checked run: card, with the server, the event log and a
        # profiler window over the second audit tick
        card_device = card
        card, card_ticks = obs_engine(card_device, tmp / "card.wal.jsonl", m5, m15)
        card_rec = rec()
        instrument(card.delivery, card_rec)
        # every host-phase record of the checked run, for per-phase p50s
        phase_samples: dict[str, list] = {}
        record_phase = card.host_phase.record

        def on_phase(drive, phase, ms, _record=record_phase):
            phase_samples.setdefault(phase, []).append(float(ms))
            _record(drive, phase, ms)

        card.host_phase.record = on_phase
        # every close→ack lag DeliveryHealth takes (its window keeps 512)
        health_samples: dict[str, list] = {}
        on_ack = card.delivery_health.on_ack

        def on_health_ack(sink, lag_ms, *a, _on_ack=on_ack, **k):
            health_samples.setdefault(sink, []).append(float(lag_ms))
            _on_ack(sink, lag_ms, *a, **k)

        card.delivery_health.on_ack = on_health_ack
        server = MetricsServer(
            health_fn=card.health_snapshot, port=0, host="127.0.0.1",
            profiler=ProfileController(log_dir=str(tmp / "profile")),
            ingest=card.ingest_monitor, slo=card.slo,
        )
        events_path = tmp / "events.jsonl"
        log = EventLog(events_path)
        set_event_log(log)
        fresh0 = FRESHNESS.labels(stage="close_to_emit").count
        lag0 = {s: DELIVERY_LAG.labels(sink=s).count for s in ("analytics", "telegram",
                                                                "autotrade")}
        t0 = time.perf_counter()
        qt.reset_launches()  # launches made elsewhere do not count
        main = asyncio.run(obs_drive(card, card_ticks, card_rec, server=server,
                                     profile_at=2 * AUDIT_EVERY))
        launches, launches_by_site = qt.launches, dict(qt.launches_by_site)
        card_s = time.perf_counter() - t0
        set_event_log(None)
        log.close()
        fresh_obs = FRESHNESS.labels(stage="close_to_emit").count - fresh0
        lag_obs = {s: DELIVERY_LAG.labels(sink=s).count - n for s, n in lag0.items()}
        events = [json.loads(x) for x in events_path.read_text().splitlines()]
        verdict = card.slo.verdict()
        health = main["routes"]["/healthz"]
        # -- the reference: a CPU engine with the same knobs
        cpu, cpu_ticks = obs_engine("cpu", tmp / "cpu.wal.jsonl", m5, m15)
        cpu_rec = rec()
        instrument(cpu.delivery, cpu_rec)
        t0 = time.perf_counter()
        ref = asyncio.run(obs_drive(cpu, cpu_ticks, cpu_rec))
        cpu_s = time.perf_counter() - t0

        # -- checks
        n_ticks = len(card_ticks)
        traces = card.tracer.entries()
        if [e["summary"]["tick_seq"] for e in traces] != list(range(1, n_ticks + 1)):
            fail(f"observability: {len(traces)} completed traces for {n_ticks} ticks")
        ref_traces = cpu.tracer.entries()
        for a, b in zip(traces, ref_traces):
            if _span_names(a["spans"]) != _span_names(b["spans"]):
                fail(f"observability: tick {a['summary']['tick_seq']} span names differ: "
                     f"{_span_names(a['spans'])} vs {_span_names(b['spans'])}")
        if main["paths"] != ref["paths"]:
            fail(f"observability: routing {main['paths']} vs the cpu's {ref['paths']}")
        if main["sites"] != ref["sites"]:
            fail(f"observability: qtail launches by site {main['sites']} != the twin's "
                 f"calls on the cpu {ref['sites']}")
        if not main["overflowed"][-1] or main["overflowed"] != ref["overflowed"]:
            fail(f"observability: overflowed ticks {main['overflowed']} vs the cpu's "
                 f"{ref['overflowed']}")
        for path, sites, over in zip(main["paths"], main["sites"], main["overflowed"]):
            want = dict(EXPECT_SITES[path])
            for k, v in (_expected_sites(path, dormant=True) if over else {}).items():
                want[k] = want.get(k, 0) + v
            if sites != want:
                fail(f"observability: a {path} tick launched {sites}, expected {want}")
        kc, kr = _traced_keys(card_rec["acked"]), _traced_keys(cpu_rec["acked"])
        if set(kc) != set(kr):
            fail(f"observability: traced entries differ: card only "
                 f"{sorted(set(kc) - set(kr))[:5]}, cpu only {sorted(set(kr) - set(kc))[:5]}")
        from binquant_tpu_torch.io.replay import payloads_match

        compared = {}
        for key in sorted(kc):
            a, b = _masked(key[0], kc[key]), _masked(key[0], kr[key])
            if not payloads_match(a, b):
                fail(f"observability: {key} delivered differently once masked: "
                     f"{str(a)[:300]} vs {str(b)[:300]}")
            compared[key[0]] = compared.get(key[0], 0) + 1
        sent = [m for m in card._telegram_sent if "algorithm</strong>" in m]
        if len(sent) != compared.get("telegram", 0) or not all(
                "\n- Trace: " in m for m in sent):
            fail(f"observability: {len(sent)} signal texts sent, {compared.get('telegram')} "
                 "acked, or a text without its trace line")
        # freshness_ms: at least the signal's lag0 (tick clock - bar close)
        tick_of = {e["summary"]["trace_id"]: e["spans"]["attrs"]["tick_ms"] for e in traces}
        for key, payload in kc.items():
            if key[0] != "analytics":
                continue
            tick_ms = tick_of[payload["trace_id"]]
            ts_s = tick_ms // 1000
            lag0_ms = tick_ms - card._bar_close_ms(key[2], ts_s // 300 * 300 - 300,
                                                   ts_s // 900 * 900 - 900)
            if not payload["freshness_ms"] >= lag0_ms:
                fail(f"observability: {key} freshness_ms {payload['freshness_ms']} < lag0 "
                     f"{lag0_ms}")
        if fresh_obs != card.signals_emitted or card.signals_emitted == 0:
            fail(f"observability: bqt_freshness_ms close_to_emit observed {fresh_obs} times "
                 f"for {card.signals_emitted} signals")
        if lag_obs != card_rec["ack_counts"]:
            fail(f"observability: bqt_delivery_lag_ms observations {lag_obs} != acks "
                 f"{card_rec['ack_counts']}")
        slow = [e for e in events if e["event"] == "slow_tick"]
        slow_by_stage: dict[str, int] = {}
        for e in slow:
            slow_by_stage[e["stage"]] = slow_by_stage.get(e["stage"], 0) + 1
        if n_ticks not in {e["tick_seq"] for e in slow}:
            fail(f"observability: the crash tick is not among the slow ticks {slow_by_stage}")
        if sum(e["event"] == "trace" for e in events) != n_ticks:
            fail("observability: not one trace event per tick")
        inv = verdict["invariants"]
        if not (inv["delivery_zero_loss"]["ok"] and inv["delivery_zero_duplicate"]["ok"]):
            fail(f"observability: SLO invariants {inv}")
        ref_verdict = cpu.slo.verdict()
        if set(verdict["slos"]) != set(ref_verdict["slos"]) or set(inv) != set(
                ref_verdict["invariants"]):
            fail(f"observability: SLO names {sorted(verdict['slos'])} vs the cpu's "
                 f"{sorted(ref_verdict['slos'])}")
        bad_scrapes = [s for s in main["scrapes"] if s[0] != 200 or s[1] != s[2]]
        if bad_scrapes or len(main["scrapes"]) != n_ticks:
            fail(f"observability: /metrics scrapes (code, counter, engine) {bad_scrapes[:3]}")
        code, body = health
        if code != 200 or json.loads(body)["status"] != "ok":
            fail(f"observability: /healthz answered {code} {body[:300]}")
        for route in ("/debug/slo", "/debug/symbols?limit=5", "/debug/executables"):
            if main["routes"][route][0] != 200:
                fail(f"observability: {route} answered {main['routes'][route][0]}")
        symbols_page = json.loads(main["routes"]["/debug/symbols?limit=5"][1])
        if not symbols_page.get("enabled") or symbols_page["total"] != S:
            fail(f"observability: /debug/symbols {str(symbols_page)[:200]}")
        if main["profile"] is None or main["profile"][0] != 200 or not main["profile"][1].get(
                "started"):
            fail(f"observability: the profiler window did not open: {main['profile']}")
        ctl = server.profiler
        if ctl.last_trace is None:
            fail("observability: the profiler window wrote no trace")
        prof = _profile_names(ctl.last_trace)
        if not prof["kernels"]:
            fail(f"observability: the profiler trace names no qtail kernel on the device: "
                 f"{prof}")
        if not prof["launch_ranges"]:
            fail(f"observability: the profiler trace holds no qtail_launch range: {prof}")
        if main["paths"][2 * AUDIT_EVERY] != "audit":
            fail(f"observability: the profiled tick took {main['paths'][2 * AUDIT_EVERY]}")

        # -- the slice's host cost: on against off, fresh engines, in pairs
        # whose first arm alternates (off-on, on-off, ...) so that neither
        # arm always runs on the other's warmed process
        cost = {"on": [], "off": []}
        for run in range(OBS_COST_RUNS):
            for arm in (("off", "on") if run % 2 == 0 else ("on", "off")):
                eng, eng_ticks = obs_engine(card_device, tmp / f"cost_{arm}{run}.wal.jsonl", m5,
                                            m15, on=arm == "on", audit_every=OBS_COST_AUDIT)
                got = asyncio.run(obs_drive(eng, eng_ticks[:OBS_COST_AUDIT + 2], rec(),
                                            settle_each=False))
                cost[arm].append(got)
                del eng
                torch_empty_cache()

    def pooled(arm: str, path: str, key: str) -> list:
        return [v for got in cost[arm] for p, v in zip(got["paths"], got[key]) if p == path]

    host_cost = {}
    for arm in ("on", "off"):
        host_cost[arm] = {
            key: {"incremental_p50": _p(pooled(arm, "incremental", key), 50),
                  "incremental_p99": _p(pooled(arm, "incremental", key), 99),
                  "audit_p50": _p(pooled(arm, "audit", key), 50),
                  "incremental_n": len(pooled(arm, "incremental", key))}
            for key in ("host_ms", "loop_ms")
        }
    # paired by tick (both arms take the same ticks; burst and quiet ticks
    # differ by seconds): on - off per tick, per part of the host path
    def deltas(key: str, path: str, pair=None) -> list:
        pairs = zip(cost["on"], cost["off"]) if pair is None else [pair]
        return [on[key][k] - off[key][k] for on, off in pairs
                for k, p in enumerate(on["paths"]) if p == path == off["paths"][k]]

    host_cost["paired_ms"] = {
        key: {"incremental_median": _p(deltas(key, "incremental"), 50),
              "incremental_p25": _p(deltas(key, "incremental"), 25),
              "incremental_p75": _p(deltas(key, "incremental"), 75),
              "audit_median": _p(deltas(key, "audit"), 50),
              "incremental_n": len(deltas(key, "incremental"))}
        for key in ("ingest_ms", "tick_ms", "finalize_ms", "host_ms", "loop_ms")
    }
    # per pair (in run order): the median of its incremental ticks' deltas
    host_cost["pair_deltas_ms"] = [_p(deltas("host_ms", "incremental", pair), 50)
                                   for pair in zip(cost["on"], cost["off"])]
    health_lag = {sink: {"p50": _p(v, 50), "p99": _p(v, 99), "acks": len(v)}
                  for sink, v in health_samples.items()}
    queue_lag = {sink: {"p50": _p(v, 50), "p99": _p(v, 99)} for sink, v in
                 card_rec["lag_ms"].items()}
    busy = [e["summary"]["busy_ms"] for e in traces]
    wall = [e["summary"]["wall_ms"] for e in traces]
    builds = LEDGER.snapshot()
    result = {
        "ticks": n_ticks, "paths": main["paths"], "launches": launches,
        "launches_by_site": launches_by_site, "signals": card.signals_emitted,
        "compared": compared, "slow_ticks_by_stage": slow_by_stage,
        "slo_ok": verdict["ok"], "slos": sorted(verdict["slos"]),
        "invariants": sorted(inv), "profile": prof,
        "delivery_health_lag_ms": health_lag, "queue_to_ack_ms": queue_lag,
        "host_phase_p50_ms": {p: _p(v, 50) for p, v in phase_samples.items()},
        "trace_busy_ms": {"p50": _p(busy, 50), "max": max(busy)},
        "trace_wall_ms": {"p50": _p(wall, 50), "max": max(wall)},
        "builds": builds["executables"], "host_cost": host_cost,
        "card_s": card_s, "cpu_s": cpu_s,
    }
    print(
        f"[slice observability] {n_ticks} ticks through consume_loop at production defaults, "
        f"{card.signals_emitted} signals; traces equal to the cpu's span names per tick; "
        f"entries compared once masked {compared}; slow ticks by stage {slow_by_stage}; "
        f"SLO ok {verdict['ok']} ({len(verdict['slos'])} SLOs, invariants {sorted(inv)}); "
        f"/metrics scraped {len(main['scrapes'])} times, /healthz ok; qtail launches "
        f"{launches} {launches_by_site} (equal to the cpu twin's calls per tick); card run "
        f"{card_s:.1f} s, cpu {cpu_s:.1f} s"
    )
    print(f"[slice observability] profiler window over the audit tick: {prof}")
    print("[slice observability] close->ack lag per sink from DeliveryHealth (ms): "
          + ", ".join(f"{s} p50 {v['p50']:.2f} p99 {v['p99']:.2f} ({v['acks']} acks)"
                      for s, v in sorted(health_lag.items()))
          + "; queue->ack (phase 7's measure): "
          + ", ".join(f"{s} p50 {v['p50']:.2f} p99 {v['p99']:.2f}"
                      for s, v in sorted(queue_lag.items())))
    print("[slice observability] bqt_host_phase_ms p50 per phase (serial drive): "
          + ", ".join(f"{p} {v:.3f}" for p, v in result["host_phase_p50_ms"].items()))
    print(f"[slice observability] trace busy ms p50 {result['trace_busy_ms']['p50']:.2f} "
          f"max {result['trace_busy_ms']['max']:.2f}, wall ms p50 "
          f"{result['trace_wall_ms']['p50']:.2f} max {result['trace_wall_ms']['max']:.2f}")
    print("[slice observability] build ledger: "
          + ", ".join(f"{e['executable']} {e['cache']} {e['compile_seconds']:.2f} s"
                      for e in builds["executables"]))
    for key in ("host_ms", "loop_ms"):
        on, off = host_cost["on"][key], host_cost["off"][key]
        print(f"[slice observability] host cost ({key}, {OBS_COST_RUNS} runs per arm, pairs "
              f"alternating): incremental p50 on {on['incremental_p50']:.2f} off "
              f"{off['incremental_p50']:.2f}, p99 on {on['incremental_p99']:.2f} off "
              f"{off['incremental_p99']:.2f}; audit p50 on {on['audit_p50']:.2f} off "
              f"{off['audit_p50']:.2f} ({on['incremental_n']} incremental ticks per arm)")
    print("[slice observability] host cost paired by tick, on - off (ms), incremental median "
          "[p25, p75] / audit median: "
          + ", ".join(f"{k} {v['incremental_median']:+.2f} [{v['incremental_p25']:+.2f}, "
                      f"{v['incremental_p75']:+.2f}] / {v['audit_median']:+.2f}"
                      for k, v in host_cost["paired_ms"].items())
          + f" ({host_cost['paired_ms']['host_ms']['incremental_n']} incremental tick pairs); "
          "per run pair (off-on, on-off, ...), host_ms incremental median: "
          + ", ".join(f"{d:+.2f}" for d in host_cost["pair_deltas_ms"]))
    return result


# -- phase 9: the subscription fan-out plane -----------------------------------------

FAN_USERS = 100_000  # the population bulk-loaded before the warm tick
FAN_CHURN = (400, 300, 300)  # subscribes, updates, unsubscribes before each churn tick
# live ticks 1-15 bring churn; live tick 16 and the crash come after the last
# checkpoint (ticks_processed 16), so its snapshot holds the crash's population
FAN_CHURN_TICKS = range(1, LIVE_TICKS)
FAN_MOB_TICK, FAN_MOB = 10, 32_000  # the flash mob that grows the planes past capacity
FAN_WAVE_TICK, FAN_WAVE = 13, 70_000  # the unsubscribe wave that crosses compact_frac
FAN_EVERY = 8  # the checkpoint (and snapshot sidecar) cadence
FAN_FLOORS = (0.0, 0.25, 0.5, 1.0, 2.0, 5.0, 1e6)  # the min_strength grid (1e6: unreachable)
FAN_RTOL, FAN_ATOL = 1e-4, 1e-5  # the wire contract: a floor this close to |score| may flip
FAN_ORACLE_SAMPLE = 6  # signals per fired tick also held to match_oracle itself
FAN_MILLION = 1_000_000
FAN_MATCH_K = (8, 128, 2048)
FAN_MATCH_REPS = 5  # timed matches per K (after one warm call)


def fan_subscriptions(rng: np.random.Generator, n: int, prefix: str) -> list:
    """``n`` seeded subscriptions of the population's mix: 10% wildcard,
    30% one live strategy, 30% 1-16 of the S symbols (drawn with
    replacement, so a few name fewer), 15% symbols and one strategy, 10% a
    regime subset, 5% a ``min_strength`` from :data:`FAN_FLOORS`."""
    from binquant_tpu_torch.engine.step import STRATEGY_ORDER
    from binquant_tpu_torch.fanout.registry import Subscription

    names, live = symbols(), STRATEGY_ORDER[:5]
    kind = rng.choice(6, size=n, p=[0.10, 0.30, 0.30, 0.15, 0.10, 0.05])
    strat = rng.integers(0, len(live), n)
    nsym = rng.integers(1, 17, n)
    sym = rng.integers(0, S, (n, 16))
    reg = rng.integers(1, 32, n)  # a non-empty subset of the 5 regimes, as bits
    floor = rng.integers(0, len(FAN_FLOORS), n)
    subsets = [frozenset(r for r in range(5) if m >> r & 1) for m in range(32)]
    out = []
    for i, k, st, ns, row, rg, fl in zip(range(n), kind.tolist(), strat.tolist(),
                                         nsym.tolist(), sym.tolist(), reg.tolist(),
                                         floor.tolist()):
        out.append(Subscription(
            f"{prefix}{i}",
            frozenset([names[j] for j in row[:ns]]) if k in (2, 3) else None,
            frozenset((live[st],)) if k in (1, 3) else None,
            subsets[rg] if k == 4 else None,
            FAN_FLOORS[fl] if k == 5 else 0.0,
        ))
    return out


def fan_script(rng: np.random.Generator) -> dict:
    """The drive's subscription script, made once and applied alike to
    every engine: the protected users (a WS and an SSE watcher on 16
    low-row symbols each, the stalled consumer on 12; subscribed first,
    never churned), the population, and per churn tick its shuffled
    subscribes, updates and unsubscribes, the flash mob, the wave."""
    from binquant_tpu_torch.fanout.registry import Subscription

    names = symbols()
    low = [names[j] for j in rng.choice(np.arange(1, 48), 44, replace=False)]
    protected = [Subscription("watch_ws", frozenset(low[:16])),
                 Subscription("watch_sse", frozenset(low[16:32])),
                 Subscription("stalled", frozenset(low[32:44]))]
    population = fan_subscriptions(rng, FAN_USERS, "u")
    live = [s.user_id for s in population]
    ticks: dict[int, dict] = {}
    for t in FAN_CHURN_TICKS:
        n_sub, n_upd, n_uns = FAN_CHURN
        subs = fan_subscriptions(rng, n_sub, f"c{t}_")
        picks = rng.choice(len(live), n_upd + n_uns, replace=False)
        upd = [Subscription(live[j], p.symbols, p.strategies, p.regimes, p.min_strength)
               for j, p in zip(picks[:n_upd], fan_subscriptions(rng, n_upd, "x"))]
        gone = {live[j] for j in picks[n_upd:]}
        ops = ([("subscribe", s) for s in subs] + [("update", s) for s in upd]
               + [("unsubscribe", u) for u in sorted(gone)])
        step = {"ops": [ops[k] for k in rng.permutation(len(ops))]}
        live = [u for u in live if u not in gone] + [s.user_id for s in subs]
        if t == FAN_MOB_TICK:
            step["mob"] = fan_subscriptions(rng, FAN_MOB, f"mob{t}_")
            live += [s.user_id for s in step["mob"]]
        if t == FAN_WAVE_TICK:
            step["wave"] = [live[j] for j in np.sort(rng.choice(len(live), FAN_WAVE,
                                                                replace=False))]
            wave = set(step["wave"])
            live = [u for u in live if u not in wave]
        ticks[t] = step
    return {"protected": protected, "population": population, "ticks": ticks}


def fan_engine(device: str, tmp: Path, m5: dict, m15: dict, tag: str):
    """Phase 8's production engine with the fan-out plane on at its
    defaults (compact_frac 0.5, resume_tail 1024), its outbox and snapshot
    in ``tmp``, a checkpoint every FAN_EVERY ticks; and its ticks."""
    from binquant_tpu_torch.io.checkpoint import CheckpointManager

    engine, ticks = obs_engine(
        device, tmp / f"{tag}.wal.jsonl", m5, m15,
        fanout=dict(fanout_outbox_path=str(tmp / f"{tag}.outbox.jsonl"),
                    fanout_snapshot_path=str(tmp / f"{tag}.fanout.npz")),
    )
    engine.checkpoint = CheckpointManager(tmp / f"{tag}.ckpt.npz", every_ticks=FAN_EVERY)
    return engine, ticks


def _fan_counters() -> dict:
    """Every ``bqt_fanout_*`` counter and histogram child: value, or
    (count, sum) of a histogram."""
    from binquant_tpu_torch.obs import instruments

    out = {}
    for name in dir(instruments):
        fam = getattr(instruments, name)
        if not name.startswith("FANOUT_") or fam.kind == "gauge":
            continue
        for labels, child in fam.children():
            out[(fam.name, labels)] = (child.value if fam.kind == "counter"
                                       else (child.count, round(child.sum, 6)))
    return out


async def _ws_client(port: int, user: str, cursor: str | None = None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    q = f"/ws?user={user}" + (f"&cursor={cursor}" if cursor else "")
    writer.write((f"GET {q} HTTP/1.1\r\nHost: smoke\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZQ==\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    status = (await reader.readline()).decode()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    if "101" not in status:
        fail(f"fanout: the hub answered {user}'s WS upgrade {status!r}")
    return reader, writer


async def _sse_client(port: int, user: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET /sse?user={user} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    status = (await reader.readline()).decode()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    if "200" not in status:
        fail(f"fanout: the hub answered {user}'s SSE request {status!r}")
    return reader, writer


async def _read_ws(reader, got: list) -> None:
    from binquant_tpu_torch.fanout.hub import ws_read_frame

    try:
        while True:
            opcode, payload = await ws_read_frame(reader)
            if opcode == 0x8:
                return
            got.append(json.loads(payload)["seq"])
    except (ConnectionError, asyncio.IncompleteReadError):
        return


async def _read_sse(reader, got: list) -> None:
    while True:
        line = await reader.readline()
        if not line:
            return
        if line.startswith(b"id:"):
            got.append(int(line[3:].strip()))


def fan_drive(engine, ticks, script: dict, rec: dict, keep_pop: bool) -> dict:
    """The ticks through ``consume_loop`` (phase 8's drive) with the
    script applied: the protected users and the population subscribed and
    synced (one full push) before the warm tick, the hub served on
    127.0.0.1:0 with its WS and SSE watchers reading and the stalled
    consumer (a 2-frame queue nobody drains) registered, each churn tick's
    operations applied and synced before its klines are queued, and after
    the crash the stalled consumer reconnected with its cursor. On the card
    the device match is timed with CUDA events. ``keep_pop`` keeps, per
    fired tick, the population the match ran against (the oracle check)."""
    import torch

    from binquant_tpu_torch.fanout import kernel as fk
    from binquant_tpu_torch.fanout.hub import _Connection, ws_read_frame

    plane = engine.fanout
    reg = plane.subscriptions
    timed = engine.device.type == "cuda"
    out = {"syncs": [], "records": [], "on_fired_ms": [], "match_host_ms": [],
           "append_ms": [], "match_device_ms": [], "outbox_bytes": [], "saves": 0,
           "watch": {"watch_ws": [], "watch_sse": []}, "expect": {"watch_ws": [],
                                                               "watch_sse": []}}
    # checkpoint attempts finished (the consume loop saves in a worker
    # thread; churn waits until the tick's save, sidecar included, is done)
    saves = {"done": 0}
    maybe_save = engine.checkpoint.maybe_save

    def counted_save(eng):
        try:
            if maybe_save(eng):
                out["saves"] += 1
        finally:
            saves["done"] += 1

    engine.checkpoint.maybe_save = counted_save
    # the on_fired split: the match (host, and the device part by CUDA
    # events on the card), the outbox appends, the rest (popcounts, frames)
    on_fired, match, append = plane.on_fired, plane.match, plane.outbox.append
    spent = {"match": 0.0, "append": 0.0}

    def timed_match(fired, ctx):
        t = time.perf_counter()
        try:
            return match(fired, ctx)
        finally:
            spent["match"] += (time.perf_counter() - t) * 1000.0

    def timed_append(frame, words):
        t = time.perf_counter()
        try:
            return append(frame, words)
        finally:
            spent["append"] += (time.perf_counter() - t) * 1000.0

    planes_match = fk.match_planes

    def device_timed_match(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        words = planes_match(*args)
        end.record()
        end.synchronize()
        out["match_device_ms"].append((int(args[5].shape[0]), start.elapsed_time(end)))
        return words

    def spy(fired, ctx, tick_ms=None):
        spent["match"] = spent["append"] = 0.0
        size0 = plane.outbox.path.stat().st_size
        t = time.perf_counter()
        stats = on_fired(fired, ctx, tick_ms=tick_ms)
        out["on_fired_ms"].append((tick_ms, len(fired), (time.perf_counter() - t) * 1000.0))
        out["match_host_ms"].append(spent["match"])
        out["append_ms"].append(spent["append"])
        out["outbox_bytes"].append(plane.outbox.path.stat().st_size - size0)
        regime = int(ctx.get("market_regime", -1))
        valid = bool(ctx.get("valid", False))
        out["records"].append({
            "tick_ms": tick_ms,
            "ctx": {"market_regime": regime, "valid": valid},
            "regime": regime if valid and 0 <= regime < 5 else None,
            "pop": [(r.slot, r.sub) for r in reg._records.values()] if keep_pop else None,
            "signals": [(s, s.fanout_frame[0], np.array(s.fanout_frame[1])) for s in fired],
        })
        return stats

    plane.on_fired, plane.match, plane.outbox.append = spy, timed_match, timed_append
    if timed:
        fk.match_planes = device_timed_match
    # what the hub broadcast (the delivery plane's fanout lane delivers it)
    broadcast = plane.hub.broadcast
    slots: dict[str, int] = {}

    def recorded_broadcast(frame, words, t_pub=None):
        for user in ("watch_ws", "watch_sse"):
            s = slots[user]
            if s >> 5 < len(words) and int(words[s >> 5]) >> (s & 31) & 1:
                out["expect"][user].append(int(frame["seq"]))
        return broadcast(frame, words, t_pub=t_pub)

    plane.hub.broadcast = recorded_broadcast

    def sync(t: int, kind_want: str) -> None:
        cells = len(reg.dirty_cells) + len(reg.dirty_floor_words)
        gen = reg.capacity_generation
        t0 = time.perf_counter()
        kind = plane.sync_device()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        words = plane._device.last_delta_words if kind == "incremental" else None
        out["syncs"].append((t, kind, ms, words, cells, gen))

    t0 = time.perf_counter()
    for sub in script["protected"]:
        plane.subscribe(sub)
    plane.bulk_load(script["population"])
    out["bulk_load_ms"] = (time.perf_counter() - t0) * 1000.0
    sync(0, "full")
    for user in ("watch_ws", "watch_sse", "stalled"):
        slots[user] = reg.slot_of(user)
    clients: dict = {}

    async def start() -> None:
        port = await plane.serve(0, host="127.0.0.1")
        r_ws, w_ws = await _ws_client(port, "watch_ws")
        r_sse, w_sse = await _sse_client(port, "watch_sse")
        clients.update(port=port, writers=[w_ws, w_sse], tasks=[
            asyncio.create_task(_read_ws(r_ws, out["watch"]["watch_ws"])),
            asyncio.create_task(_read_sse(r_sse, out["watch"]["watch_sse"]))])
        clients["stalled"] = _Connection("stalled", slots["stalled"], "ws", queue_max=2)
        plane.hub._conns.add(clients["stalled"])

    async def before_tick(n: int) -> None:
        # the previous tick settled and no klines are queued, so the consume
        # loop is idle: wait for its checkpoint save (sidecar included)
        while saves["done"] < engine.ticks_processed // FAN_EVERY:
            await asyncio.sleep(0.005)
        step = script["ticks"].get(n)
        if step is None:
            return
        for op, arg in step["ops"]:
            getattr(plane, op)(arg)
        if "mob" in step:
            plane.bulk_load(step["mob"])
        for uid in step.get("wave", ()):
            plane.unsubscribe(uid)
        sync(n, "incremental")

    async def after_ticks() -> None:
        for user in ("watch_ws", "watch_sse"):
            for _ in range(600):
                if len(out["watch"][user]) >= len(out["expect"][user]):
                    break
                await asyncio.sleep(0.05)
        stalled = clients["stalled"]
        plane.hub._conns.discard(stalled)
        out["stalled"] = {"dropped": stalled.dropped, "queued": stalled.queue.qsize()}
        floor = plane._slot_min_seq.get(slots["stalled"], 0)
        s = slots["stalled"]
        want = [int(f["seq"]) for f, w in plane.outbox.entries()
                if int(f["seq"]) >= floor and s >> 5 < len(w) and int(w[s >> 5]) >> (s & 31) & 1]
        t0 = time.perf_counter()
        reader, writer = await _ws_client(clients["port"], "stalled", cursor="-1")
        got = []
        for _ in want:
            opcode, payload = await asyncio.wait_for(ws_read_frame(reader), 60)
            got.append(json.loads(payload)["seq"])
        out["stalled"]["replay_ms"] = (time.perf_counter() - t0) * 1000.0
        try:
            extra = await asyncio.wait_for(ws_read_frame(reader), 0.5)
            got.append(("extra", extra))
        except (asyncio.TimeoutError, TimeoutError):
            pass
        out["stalled"].update(want=want, got=got)
        writer.close()
        for w in clients["writers"]:
            w.close()
        out["hub"] = plane.hub.snapshot()
        out["verdict"] = engine.slo.verdict()
        out["health"] = engine.health_snapshot()

    counters0 = _fan_counters()
    try:
        run = asyncio.run(obs_drive(engine, ticks, rec, start=start, before_tick=before_tick,
                                    after_ticks=after_ticks))
    finally:
        fk.match_planes = planes_match
    delta = {}
    for key, v in _fan_counters().items():
        v0 = counters0.get(key, 0.0 if not isinstance(v, tuple) else (0, 0.0))
        delta[key] = (v - v0) if not isinstance(v, tuple) else (v[0] - v0[0], v[1] - v0[1])
    out["outbox"] = [(f, np.asarray(w)) for f, w in plane.outbox.entries()]
    out.update(run=run, counters=delta, compactions=plane.compactions,
               recompiles=dict(plane.recompiles), published=plane.published,
               matched=plane.matched_recipients, dispatches=plane.match_dispatches,
               capacity=reg.capacity, slots=slots)
    return out


class PopOracle:
    """``Subscription.matches`` (the oracle's predicate) over a captured
    population at once: per fired signal, the sorted slots it matches."""

    def __init__(self, pop: list) -> None:
        from binquant_tpu_torch.engine.step import STRATEGY_ORDER

        n = len(pop)
        index = {name: i for i, name in enumerate(STRATEGY_ORDER)}
        self.index = index
        self.slots = np.fromiter((slot for slot, _ in pop), np.int64, n)
        self.floors = np.fromiter((sub.min_strength for _, sub in pop), np.float32, n)
        self.strat_ok = np.zeros((n, len(STRATEGY_ORDER)), bool)
        self.reg_ok = np.zeros((n, 5), bool)
        self.reg_any = np.zeros(n, bool)
        self.sym_any = np.zeros(n, bool)
        self.by_sym: dict[str, list[int]] = {}
        for i, (_, sub) in enumerate(pop):
            if sub.strategies is None:
                self.strat_ok[i] = True
            else:
                self.strat_ok[i, [index[x] for x in sub.strategies]] = True
            if sub.regimes is None:
                self.reg_ok[i] = self.reg_any[i] = True
            else:
                self.reg_ok[i, [int(r) for r in sub.regimes]] = True
            if sub.symbols is None:
                self.sym_any[i] = True
            else:
                for name in sub.symbols:
                    self.by_sym.setdefault(name, []).append(i)

    def slots_of(self, strategy: str, symbol: str, score: float, regime) -> np.ndarray:
        m = self.strat_ok[:, self.index[strategy]] & (
            self.reg_any if regime is None else self.reg_ok[:, regime])
        m &= np.abs(np.float32(score)) >= self.floors
        sym = self.sym_any.copy()
        sym[self.by_sym.get(symbol.strip().upper(), [])] = True
        return np.sort(self.slots[m & sym])


def _masked_frame(frame: dict) -> dict:
    return {k: v for k, v in frame.items() if k not in ("trace_id", "score", "recipients")}


def check_fanout(m5, m15, card: str = "cuda") -> dict:
    """Phase 9: the production loop with the fan-out plane on at its
    defaults, 100,000 subscriptions and their churn, the hub served with
    two watchers and a stalled consumer, on the card against a CPU engine
    on the same script; a second card engine booted from the last archive
    and its snapshot; then a 1,000,000-subscription match alone."""
    from binquant_tpu_torch.engine.step import STRATEGY_ORDER
    from binquant_tpu_torch.fanout.kernel import unpack_slots
    from binquant_tpu_torch.fanout.registry import SubscriptionRegistry, _SlotRecord
    from binquant_tpu_torch.fanout.snapshot import load_snapshot, save_snapshot
    from binquant_tpu_torch.io.checkpoint import CheckpointManager
    from binquant_tpu_torch.io.replay import make_stub_engine
    from binquant_tpu_torch.obs.events import EventLog, set_event_log
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.regime.context import ContextConfig

    def rec() -> dict:
        return {"puts": [], "acked": {}, "ack_counts": {}, "lag_ms": {}, "queued": {},
                "via_wal": set()}

    t0 = time.perf_counter()
    script = fan_script(np.random.default_rng(SEED + 9))
    script_s = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # -- the checked run: the card, with the event log
        engine, ticks = fan_engine(card, tmp, m5, m15, "card")
        card_rec = rec()
        instrument(engine.delivery, card_rec)
        events_path = tmp / "events.jsonl"
        log = EventLog(events_path)
        set_event_log(log)
        qt.reset_launches()  # launches made elsewhere do not count
        t0 = time.perf_counter()
        main = fan_drive(engine, ticks, script, card_rec, keep_pop=True)
        launches, launches_by_site = qt.launches, dict(qt.launches_by_site)
        card_s = time.perf_counter() - t0
        print(f"[slice fanout] card drive {card_s:.1f} s (script {script_s:.1f} s)", flush=True)
        crash = main["records"][-1]
        plane = engine.fanout
        # -- a second card engine boots from the last archive and its sidecar
        paths = {k: str(tmp / f"card.{k}") for k in ("outbox.jsonl", "fanout.npz", "ckpt.npz")}
        archive, columns, meta = load_snapshot(paths["fanout.npz"])
        boot = make_stub_engine(
            capacity=S, window=W, context_config=ContextConfig(), device=card, delivery=False,
            fanout=True, fanout_overrides=dict(fanout_outbox_path=paths["outbox.jsonl"],
                                               fanout_snapshot_path=paths["fanout.npz"]),
            **OBS_OFF,
        )
        restored = {name: getattr(boot.fanout.subscriptions, name).copy()
                    for name in archive}
        if not CheckpointManager(paths["ckpt.npz"]).try_restore(boot):
            fail("fanout: the second engine did not restore the last checkpoint")
        boot_kind = boot.fanout.sync_device()
        boot_planes = dict(zip(("sym_plane", "strat_plane", "regime_plane", "any_masks",
                                "floors"), boot.fanout._device.host_planes()))
        boot_words = boot.fanout.match([s for s, _, _ in crash["signals"]], crash["ctx"])
        boot_replays = {key: cursor_replay(boot.fanout, *key)
                        for key in replay_keys(main["records"])}
        # -- once more with the outbox in 4 partitions and the snapshot in 4
        # shards: the archive re-saved as a 4-shard set; the partitions fold
        # the single-file log in, read-only
        snap4 = tmp / "card.fanout4.npz"
        save_snapshot(snap4, archive, columns, meta, n_shards=4)
        boot4 = make_stub_engine(
            capacity=S, window=W, context_config=ContextConfig(), device=card, delivery=False,
            fanout=True, fanout_overrides=dict(
                fanout_outbox_path=paths["outbox.jsonl"], fanout_snapshot_path=str(snap4),
                fanout_outbox_shards=4, fanout_snapshot_shards=4),
            **OBS_OFF,
        )
        restored4 = {name: getattr(boot4.fanout.subscriptions, name).copy() for name in archive}
        if not CheckpointManager(paths["ckpt.npz"]).try_restore(boot4):
            fail("fanout: the sharded engine did not restore the last checkpoint")
        boot4_kind = boot4.fanout.sync_device()
        boot4_words = boot4.fanout.match([s for s, _, _ in crash["signals"]], crash["ctx"])
        boot4_replays = {key: cursor_replay(boot4.fanout, *key) for key in boot_replays}
        boot4_outbox = (type(boot4.fanout.outbox).__name__, boot4.fanout.outbox_shards)
        del boot4
        # the crash tick's match again, warm (in the drive it was the first
        # match of its bucket: the allocator's first blocks of that size)
        sigs = [s for s, _, _ in crash["signals"]]
        _, crash_warm_ms, crash_peak = timed_match(
            boot.fanout._device, [boot.registry.row_of(s.symbol) for s in sigs],
            [STRATEGY_ORDER.index(s.strategy) for s in sigs],
            [float(s.value.score or 0.0) for s in sigs], boot.fanout.regime_row(crash["ctx"]))
        set_event_log(None)
        log.close()
        events = [json.loads(x) for x in events_path.read_text().splitlines()]
        del boot
        # -- the reference: a CPU engine on the same script
        cpu, cpu_ticks = fan_engine("cpu", tmp, m5, m15, "cpu")
        cpu_rec = rec()
        instrument(cpu.delivery, cpu_rec)
        t0 = time.perf_counter()
        ref = fan_drive(cpu, cpu_ticks, script, cpu_rec, keep_pop=False)
        cpu_s = time.perf_counter() - t0
        print(f"[slice fanout] cpu drive {cpu_s:.1f} s", flush=True)

    # -- the tick: routing, qtail per site, as phase 8
    run, ref_run = main["run"], ref["run"]
    if run["paths"] != ref_run["paths"] or run["overflowed"] != ref_run["overflowed"]:
        fail(f"fanout: routing {run['paths']} / overflows {run['overflowed']} vs the cpu's "
             f"{ref_run['paths']} / {ref_run['overflowed']}")
    if run["sites"] != ref_run["sites"]:
        fail(f"fanout: qtail launches by site {run['sites']} != the twin's calls on the cpu "
             f"{ref_run['sites']}")
    for path, sites, over in zip(run["paths"], run["sites"], run["overflowed"]):
        want = dict(EXPECT_SITES[path])
        for k, v in (_expected_sites(path, dormant=True) if over else {}).items():
            want[k] = want.get(k, 0) + v
        if sites != want:
            fail(f"fanout: a {path} tick launched {sites}, expected {want}")
    # -- syncs: one full push for the load, the growth and the compaction,
    # one incremental per other churn tick, O(cells touched) each
    kinds = [(t, k) for t, k, *_ in main["syncs"]]
    want_kinds = [(0, "full")] + [
        (t, "full" if t in (FAN_MOB_TICK, FAN_WAVE_TICK) else "incremental")
        for t in FAN_CHURN_TICKS]
    if kinds != want_kinds or [(t, k) for t, k, *_ in ref["syncs"]] != want_kinds:
        fail(f"fanout: syncs {kinds} (cpu {[(t, k) for t, k, *_ in ref['syncs']]}), "
             f"expected {want_kinds}")
    ops = sum(FAN_CHURN)
    for t, kind, _, words, cells, _ in main["syncs"]:
        if kind == "incremental" and not (words == cells and 0 < words <= 48 * ops):
            fail(f"fanout: tick {t} patched {words} words for {cells} dirty cells")
    if main["recompiles"] != {"full": 3, "incremental": len(FAN_CHURN_TICKS) - 2} or (
            main["compactions"] != 1 or main["recompiles"] != ref["recompiles"]):
        fail(f"fanout: recompiles {main['recompiles']} (cpu {ref['recompiles']}), "
             f"compactions {main['compactions']}")
    # -- the card against the oracle, on the card's own fired signals
    checked = sampled = 0
    oracle_ms = []
    for r in main["records"]:
        oracle = PopOracle(r["pop"])
        uid_of = {slot: sub.user_id for slot, sub in r["pop"]}
        for sig, frame, words in r["signals"]:
            got = unpack_slots(words)
            want = oracle.slots_of(sig.strategy, sig.symbol, float(sig.value.score or 0.0),
                                   r["regime"])
            if not np.array_equal(got, want):
                fail(f"fanout: {sig.strategy}/{sig.symbol} at {r['tick_ms']}: the card "
                     f"matched {len(got)} slots, the oracle {len(want)}")
            checked += 1
        # match_oracle itself on a sample of the tick's signals, over a
        # registry holding the captured records (match_oracle reads only them)
        small = SubscriptionRegistry(S)
        for slot, sub in r["pop"]:
            small._records[sub.user_id] = _SlotRecord(sub=sub, slot=slot)
        for sig, _, words in r["signals"][:: max(len(r["signals"]) // FAN_ORACLE_SAMPLE, 1)]:
            t0 = time.perf_counter()
            want = small.match_oracle(
                [(sig.strategy, sig.symbol, float(sig.value.score or 0.0))], r["regime"])[0]
            oracle_ms.append((time.perf_counter() - t0) * 1000.0)
            if {uid_of[int(s)] for s in unpack_slots(words)} != want:
                fail(f"fanout: {sig.strategy}/{sig.symbol}: match_oracle disagrees")
            sampled += 1
    # -- the card against the CPU engine, per (tick, strategy, symbol)
    def keyed(records):
        return {(r["tick_ms"], s.strategy, s.symbol): (s, f, w) for r in records
                for s, f, w in r["signals"]}

    kc, kr = keyed(main["records"]), keyed(ref["records"])
    if set(kc) != set(kr):
        fail(f"fanout: fired sets differ: card only {sorted(set(kc) - set(kr))[:5]}, "
             f"cpu only {sorted(set(kr) - set(kc))[:5]}")
    floor_of = {}  # per fired tick: each slot's floor (+inf where free)
    for r in main["records"]:
        fl = np.full(main["capacity"], np.inf, np.float32)
        fl[[slot for slot, _ in r["pop"]]] = [sub.min_strength for _, sub in r["pop"]]
        floor_of[r["tick_ms"]] = fl
    margin = 0
    for key, (sig, frame, words) in kc.items():
        _, rframe, rwords = kr[key]
        diff = unpack_slots(words ^ rwords)
        score = abs(float(sig.value.score or 0.0))
        away = np.abs(floor_of[key[0]][diff] - score) > FAN_ATOL + FAN_RTOL * score
        if away.any():
            fail(f"fanout: {key} slots {diff[away][:5]} (floors "
                 f"{floor_of[key[0]][diff[away][:5]]}) differ between the card and the cpu "
                 f"away from |score| {score}")
        margin += len(diff)
        if _masked_frame(frame) != _masked_frame(rframe) or not np.isclose(
                frame["score"], rframe["score"], rtol=FAN_RTOL, atol=FAN_ATOL):
            fail(f"fanout: {key} frames differ: {frame} vs {rframe}")
    # -- the outbox holds exactly the published frames, in order
    for side in (main, ref):
        published = [(f, w) for r in side["records"] for _, f, w in r["signals"]]
        if len(side["outbox"]) != len(published) or any(
                f != pf or not np.array_equal(w, pw)
                for (f, w), (pf, pw) in zip(side["outbox"], published)):
            fail("fanout: the outbox differs from the published frames")
    # -- the counters, card against cpu (recipients but for the margin)
    cc, rc = main["counters"], ref["counters"]
    timing = ("bqt_fanout_write_latency_ms", "bqt_fanout_conn_queue_depth")
    for key in sorted(set(cc) | set(rc)):
        a, b = cc.get(key, 0), rc.get(key, 0)
        if key[0] in timing:
            a, b = a[0] if a else 0, b[0] if b else 0
        if key[0] == "bqt_fanout_matched_recipients_total":
            if abs(a - b) > margin:
                fail(f"fanout: recipients {a} vs the cpu's {b} beyond {margin} margin flips")
        elif a != b:
            fail(f"fanout: {key} {a} vs the cpu's {b}")
    # -- the hub: watchers got exactly what was broadcast to them, the
    # stalled consumer shed and then replayed exactly its outbox frames
    for side in (main, ref):
        for user in ("watch_ws", "watch_sse"):
            if not side["expect"][user] or side["watch"][user] != side["expect"][user]:
                fail(f"fanout: {user} received {len(side['watch'][user])} frames, the hub "
                     f"broadcast {len(side['expect'][user])} to it")
        st = side["stalled"]
        if st["dropped"] < 1 or st["got"] != st["want"] or len(st["want"]) <= 2:
            fail(f"fanout: the stalled consumer dropped {st['dropped']}, replayed "
                 f"{len(st['got'])} of {len(st['want'])}")
    hub = main["hub"]
    watch_conns = [c for c in hub["connections"] if c["user"].startswith("watch_")]
    if len(watch_conns) != 2 or any(c["dropped"] for c in watch_conns):
        fail(f"fanout: watcher connections {watch_conns}")
    if not main["verdict"]["invariants"]["fanout_recipient_set"]["ok"]:
        fail(f"fanout: {main['verdict']['invariants']['fanout_recipient_set']}")
    # -- the second engine's boot
    for name, arr in archive.items():
        if not (np.array_equal(restored[name], arr) and np.array_equal(boot_planes[name], arr)):
            fail(f"fanout: the restored {name} differs from the archive's")
    if boot_kind != "full" or not all(
            np.array_equal(bw, w) for bw, (_, _, w) in zip(boot_words, crash["signals"])):
        fail("fanout: the restored engine's first match differs from the crash tick's")
    # -- the sharded restart: the unsharded restart's recipient sets and replays
    for name, arr in archive.items():
        if not np.array_equal(restored4[name], arr):
            fail(f"fanout: the {name} restored from the 4-shard snapshot differs")
    if boot4_outbox != ("ShardedBroadcastOutbox", 4) or boot4_kind != "full" or not all(
            np.array_equal(a, b) for a, b in zip(boot4_words, boot_words, strict=True)):
        fail(f"fanout: the sharded restart ({boot4_outbox}, {boot4_kind} sync) matched "
             "recipient sets other than the unsharded restart's")
    if boot4_replays != boot_replays or not any(boot_replays.values()):
        bad = [k for k in boot_replays if boot4_replays[k] != boot_replays[k]]
        fail(f"fanout: the sharded restart's cursor replays differ at {bad[:3]}")

    # -- numbers
    def ev(kind):
        return [e["duration_ms"] for e in events if e["event"] == kind]

    saves = len(run["paths"]) // FAN_EVERY
    if main["saves"] != saves or len(ev("fanout_snapshot_save")) != saves:
        fail(f"fanout: {main['saves']} checkpoints and {len(ev('fanout_snapshot_save'))} "
             f"snapshots saved, expected {saves} of each")

    incr = [(t, ms, w) for t, k, ms, w, _, _ in main["syncs"] if k == "incremental"]
    full = [(t, ms) for t, k, ms, *_ in main["syncs"] if k == "full"]
    fired = [(r["tick_ms"], len(r["signals"])) for r in main["records"]]
    lag = card_rec["lag_ms"].get("fanout", [])
    result = {
        "ticks": len(run["paths"]), "paths": run["paths"], "launches": launches,
        "launches_by_site": launches_by_site, "fired": fired,
        "users": FAN_USERS, "capacity": main["capacity"], "syncs": kinds,
        "checked": checked, "oracle_sampled": sampled, "margin_flips": margin,
        "match_device_ms": main["match_device_ms"],
        "crash_match_warm": {"ms": crash_warm_ms, "peak_mib": crash_peak},
        "incremental_sync": incr, "full_push_ms": full,
        "on_fired_ms": main["on_fired_ms"], "match_host_ms": main["match_host_ms"],
        "append_ms": main["append_ms"], "outbox_bytes": main["outbox_bytes"],
        "fanout_lag_ms": {"p50": _p(lag, 50), "p99": _p(lag, 99), "acks": len(lag)}
        if lag else None,
        "hub": {k: hub[k] for k in ("frames_sent", "shed", "resumed", "tail_resumes",
                                    "resume_fallbacks")},
        "stalled": {k: v for k, v in main["stalled"].items() if k not in ("want", "got")}
        | {"replayed": len(main["stalled"]["got"])},
        "sharded_restart": {"replays": len(boot_replays),
                            "frames_replayed": sum(len(v or ()) for v in boot_replays.values()),
                            "restore_ms": ev("fanout_snapshot_restore")[-1:]},
        "snapshot_save_ms": ev("fanout_snapshot_save"),
        "snapshot_restore_ms": ev("fanout_snapshot_restore"),
        "compact_ms": ev("fanout_compact"), "bulk_load_ms": main["bulk_load_ms"],
        "match_oracle_ms": oracle_ms, "script_s": script_s, "card_s": card_s, "cpu_s": cpu_s,
    }
    result["million"] = fan_million(card)
    on_crash = main["on_fired_ms"][-1]
    print(f"[slice fanout] S={S} W={W}: {result['ticks']} ticks through consume_loop at "
          f"production defaults with the plane on: {FAN_USERS} subscriptions bulk-loaded, "
          f"churn {FAN_CHURN} on live ticks {FAN_CHURN_TICKS.start}-{FAN_CHURN_TICKS.stop - 1}, "
          f"flash mob {FAN_MOB} on tick {FAN_MOB_TICK}, wave {FAN_WAVE} on tick "
          f"{FAN_WAVE_TICK}; syncs {kinds}; fired {fired}; {checked} signals equal to the "
          f"oracle ({sampled} to match_oracle itself), equal to the cpu's but for {margin} "
          f"floor-margin flips; qtail launches {launches} {launches_by_site}; card run "
          f"{card_s:.1f} s, cpu {cpu_s:.1f} s")
    print("[slice fanout] match device ms per fired bucket in the drive (fired/bucket ms): "
          + ", ".join(f"{n}/{kb} {ms:.4f}" for (_, n), (kb, ms)
                      in zip(fired, main["match_device_ms"]))
          + (f"; the crash tick's {fired[-1][1]} signals again, warm: {crash_warm_ms:.4f} ms, "
             f"peak {crash_peak:.1f} MiB above the planes" if crash_warm_ms is not None else ""))
    print("[slice fanout] full push ms: " + ", ".join(f"t{t} {ms:.2f}" for t, ms in full)
          + "; incremental sync ms / delta words per churn tick: "
          + ", ".join(f"t{t} {ms:.2f}/{w}" for t, ms, w in incr))
    print("[slice fanout] on_fired host ms per fired tick (signals: total / match / "
          "outbox append / rest): " + ", ".join(
              f"{n}: {tot:.1f} / {m:.1f} / {a:.1f} / {tot - m - a:.1f}" for (_, n, tot), m, a in
              zip(main["on_fired_ms"], main["match_host_ms"], main["append_ms"]))
          + f"; crash tick {on_crash[2]:.1f} ms for {on_crash[1]} signals, its outbox "
          f"{main['outbox_bytes'][-1] / 2**20:.2f} MB")
    if lag:
        print(f"[slice fanout] fanout sink queue->ack lag p50 {_p(lag, 50):.2f} p99 "
              f"{_p(lag, 99):.2f} ms ({len(lag)} acks)")
    print(f"[slice fanout] the restart once more with the outbox in 4 partitions and the "
          f"snapshot in 4 shards: the crash tick's {len(boot_words)} recipient sets and "
          f"{len(boot_replays)} cursor replays ({result['sharded_restart']['frames_replayed']} "
          f"frames) equal to the unsharded restart's")
    print(f"[slice fanout] hub {result['hub']}; stalled consumer {result['stalled']}; "
          f"snapshot save ms {result['snapshot_save_ms']}, restore ms "
          f"{result['snapshot_restore_ms']}, compaction ms {result['compact_ms']}, "
          f"bulk load {main['bulk_load_ms']:.0f} ms, match_oracle ms/signal p50 "
          f"{_p(oracle_ms, 50):.1f}")
    return result


def replay_keys(records: list) -> list:
    """The (user, cursor) pairs a restart's replay is checked on: the
    protected users, from the start of the log, from the middle fired
    tick's first frame and from its trace cursor."""
    frames = [f for r in records for _, f, _ in r["signals"]]
    mid = frames[len(frames) // 2]
    cursors = ["-1", str(int(mid["seq"]) - 1)]
    if mid.get("trace_id"):
        cursors.append(f"{mid['trace_id']}/{mid['tick_seq']}")
    return [(user, c) for user in ("watch_ws", "watch_sse", "stalled") for c in cursors]


def cursor_replay(plane, user: str, cursor: str) -> list | None:
    """The frame seqs a reconnect of ``user`` with ``cursor`` replays from
    the plane's outbox: the hub's outbox path (the slot's min-seq floor,
    the excluded post-snapshot range)."""
    slot = plane.subscriptions.slot_of(user)
    entries = plane.outbox.entries()
    seq = plane.outbox.resolve_cursor(cursor, entries=entries)
    if slot is None or seq is None:
        return None
    seq = max(seq, plane.hub.min_seq_of(slot) - 1)
    excl = plane.hub.replay_excluded
    return [int(f["seq"]) for f in plane.outbox.replay_after(seq, slot, entries=entries)
            if excl is None or not excl[0] <= int(f["seq"]) <= excl[1]]


def timed_match(dev, rows, strats, scores, regime: int):
    """One match of ``len(rows)`` fired slots on ``dev``'s planes (no
    padding): its words, and on the card its warm device ms (CUDA events
    over FAN_MATCH_REPS calls after one warm call) and the peak device MiB
    it allocates above what was resident."""
    import torch

    from binquant_tpu_torch.fanout import kernel as fk

    device = dev.device
    args = (*dev._arrays, torch.from_numpy(np.asarray(rows, np.int64)).to(device),
            torch.from_numpy(np.asarray(strats, np.int64)).to(device),
            torch.from_numpy(np.asarray(scores, np.float32)).to(device),
            torch.ones(len(rows), dtype=torch.bool, device=device), int(regime))
    words = fk.match_planes(*args)
    if device.type != "cuda":
        return fk.to_host_words(words), None, None
    torch.cuda.synchronize()
    del words
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FAN_MATCH_REPS):
        words = fk.match_planes(*args)
    end.record()
    end.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return fk.to_host_words(words), start.elapsed_time(end) / FAN_MATCH_REPS, peak


def fan_million(card: str) -> dict:
    """1,000,000 subscriptions of the population's mix bulk-loaded and
    pushed to the card; one match at each K of FAN_MATCH_K timed by CUDA
    events (warm, FAN_MATCH_REPS calls) with its peak device memory above
    the resident planes; K=8 against the CPU torch path, K=2048 against
    ``match_oracle`` on 1,000 sampled users."""
    import torch

    from binquant_tpu_torch.engine.step import STRATEGY_ORDER
    from binquant_tpu_torch.fanout import kernel as fk
    from binquant_tpu_torch.fanout.registry import SubscriptionRegistry

    rng = np.random.default_rng(SEED + 10)
    names = symbols()
    row_of = {name: r for r, name in enumerate(names)}.get
    t0 = time.perf_counter()
    subs = fan_subscriptions(rng, FAN_MILLION, "m")
    build_s = time.perf_counter() - t0
    reg = SubscriptionRegistry(S, capacity=FAN_MILLION)
    t0 = time.perf_counter()
    reg.bulk_load(subs, row_of=row_of)
    bulk_s = time.perf_counter() - t0
    dev = fk.DevicePlanes(reg, device=card)
    t0 = time.perf_counter()
    if dev.sync() != "full":
        fail("fanout 1M: the first sync was not a full push")
    if card == "cuda":
        torch.cuda.synchronize()
    push_ms = (time.perf_counter() - t0) * 1000.0
    out = {"users": FAN_MILLION, "capacity": reg.capacity, "build_s": build_s,
           "bulk_load_s": bulk_s, "full_push_ms": push_ms, "k": {}}
    kept = {}
    for k in FAN_MATCH_K:
        rows = rng.integers(0, S, k)
        strats = rng.integers(0, 5, k)
        scores = rng.normal(0.0, 2.0, k).astype(np.float32)
        regime = int(rng.integers(0, 6))  # 5: the invalid-context row
        words, ms, peak = timed_match(dev, rows, strats, scores, regime)
        if ms is not None:
            out["k"][k] = {"ms": ms, "peak_mib": peak}
        kept[k] = (rows, strats, scores, regime, words)
    # K=8: the card against the CPU torch path on the same registry
    rows, strats, scores, regime, words = kept[8]
    cpu = fk.DevicePlanes(reg, device="cpu")
    cpu.sync()
    if not np.array_equal(cpu.match(rows, strats, scores, regime), words):
        fail("fanout 1M: the K=8 match differs from the CPU torch path")
    # K=2048: the card against match_oracle on 1,000 sampled users
    rows, strats, scores, regime, words = kept[2048]
    sample = [subs[i] for i in rng.choice(FAN_MILLION, 1000, replace=False)]
    small = SubscriptionRegistry(S, capacity=1024)
    small.bulk_load(sample, row_of=row_of)
    t0 = time.perf_counter()
    oracle = small.match_oracle(
        [(STRATEGY_ORDER[s], names[r], float(x)) for r, s, x in zip(rows, strats, scores)],
        None if regime == 5 else regime)
    oracle_s = time.perf_counter() - t0
    slot_of = {sub.user_id: reg.slot_of(sub.user_id) for sub in sample}
    hits = 0
    for k in range(len(rows)):
        row = words[k]
        got = {u for u, s in slot_of.items() if int(row[s >> 5]) >> (s & 31) & 1}
        if got != oracle[k]:
            fail(f"fanout 1M: K=2048 entry {k} differs from match_oracle")
        hits += len(got)
    out.update(oracle_s=oracle_s, sampled_hits=hits)
    print(f"[slice fanout] 1M: {FAN_MILLION} subscriptions built in {build_s:.1f} s, "
          f"bulk-loaded in {bulk_s:.1f} s, full push {push_ms:.1f} ms; match ms (peak MiB "
          "above the planes) per K: " + ", ".join(
              f"K={k} {v['ms']:.4f} ({v['peak_mib']:.1f})" for k, v in out["k"].items())
          + f"; K=8 equal to the cpu path, K=2048 equal to match_oracle on 1000 sampled users "
          f"({hits} hits, oracle {oracle_s:.1f} s)")
    del dev
    torch_empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 10: the scanned multi-tick drive and the time-batched backtest
# --------------------------------------------------------------------------

SCAN_CRASH_AUDIT = 12  # the crash drive's audit cadence: chunk 1-11, audit, chunk 13-17
BT_CHUNKS = (16, 32)  # the backtest's live ticks: the default chunk, then a 32-tick one
BT_CPU_TICKS = 16  # the CPU backtest and the CPU sweep run the first chunk only
# the sweep's first chunk holds the warm tick, whose 400 history bars join
# the 5m extension with its 15 live ticks' 45: n_ext = 445, so
# abp_core_batch's qtail runs at (S, TAIL + 445) with num_out = 445 +
# cooldown_bars + 1, a span of 528 past the register kernel's 256 (the block
# kernel)
BT_WARM_QTAIL = (128 + 445, 445 + 4)  # (columns, num_out)
SWEEP_AXES = {"abp.score_quantile": [0.9, 0.92], "pt.rsi_oversold": [20.0, 25.0, 30.0, 35.0]}
SWEEP_CHECKED = (0, 7)  # combos also driven through process_ticks_backtest


def _record_wires(engine) -> list:
    """Every finalized tick's wire, in finalize order (a chunk's ticks
    finalize in tick order after its one wire copy)."""
    wires: list = []
    finalize = engine._finalize_tick

    async def recorded(pending):
        out = await finalize(pending)
        wires.append(engine.last_wire.copy())
        return out

    engine._finalize_tick = recorded
    return wires


def _qtail_sites(cuda: bool) -> dict:
    """The qtail calls by site so far: kernel launches on the card, twin
    calls in a CPU rehearsal."""
    from binquant_tpu_torch.ops import quantile_tail as qt

    return dict(qt.launches_by_site if cuda else qt.twin_calls_by_site)


def _sites_since(before: dict, cuda: bool) -> dict:
    return {k: v - before.get(k, 0) for k, v in _qtail_sites(cuda).items()
            if v != before.get(k, 0)}


def _timed_flush(fn, sink: list, cuda: bool, plan_arg: int):
    """Wrap a chunk flush (its plan the ``plan_arg``-th argument): host ms
    (the flush ends in the chunk's wire copy and its finalizes), peak
    device memory above the pre-flush allocation, qtail calls by site,
    ticks."""
    import torch

    async def timed(*args):
        plan = args[plan_arg]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        before = _qtail_sites(cuda)
        t0 = time.perf_counter()
        out = await fn(*args)
        if cuda:
            torch.cuda.synchronize()
        sink.append({
            "ticks": len(plan["ticks"]),
            "ms": (time.perf_counter() - t0) * 1000.0,
            "peak_above_base_bytes": (torch.cuda.max_memory_allocated() - base) if cuda else None,
            "sites": _sites_since(before, cuda),
        })
        return out

    return timed


def _mib(n: int | None) -> float | None:
    return None if n is None else round(n / 2**20, 1)


def _state_bits_equal(a, b) -> tuple[int, list]:
    """Every leaf of two engine states, bit for bit: (leaves, differing)."""
    import torch

    la, lb = dict(_leaves(a)), dict(_leaves(b))
    bad = []
    for path, x in la.items():
        y = lb[path]
        x, y = x.cpu(), y.cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(path)
    return len(la), bad


def _wires_bit_equal(a: list, b: list) -> list[int]:
    """Ticks whose wires differ in any bit (lengths must match)."""
    if len(a) != len(b):
        fail(f"wire counts differ: {len(a)} vs {len(b)}")
    return [i for i, (x, y) in enumerate(zip(a, b))
            if x.shape != y.shape or not np.array_equal(x.view(np.int32), y.view(np.int32))]


def drive_scanned(device: str, m5: dict, m15: dict, live_ticks: int,
                  audit_every: int = AUDIT_EVERY, sync_check: bool = False) -> dict:
    """The warm tick and ``live_ticks`` live ticks through one incremental
    engine's ``process_ticks_scanned`` (the serial drive's settings):
    fired tuples, every tick's wire, the chunks' times, peaks and launches,
    the drive's wall time. ``sync_check`` runs the scan loop under
    ``torch.cuda.set_sync_debug_mode("warn")`` and returns where in the
    port each synchronizing operation it reported was issued."""
    import traceback
    import warnings

    import torch

    from binquant_tpu_torch.io import pipeline as pl
    from binquant_tpu_torch.io.replay import make_stub_engine, signal_tuples
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device,
        incremental=True, carry_audit_every=audit_every, **SERIAL,
    )
    ticks = tick_plan(engine, m5, m15, live_ticks)
    wires = _record_wires(engine)
    chunks: list = []
    engine._flush_scan_plan = _timed_flush(engine._flush_scan_plan, chunks, device == "cuda", 0)
    syncs: list = []
    scan = pl.tick_step_scan
    if sync_check:
        def note(message, category, filename, lineno, file=None, line=None):
            # the frame that issued the synchronizing operation: the deepest
            # one outside torch and the warnings machinery. Counted when it
            # is the port's (the debug switch itself reports one, issued
            # from this script)
            if "synchronizing" in str(message):
                frames = [f for f in traceback.extract_stack()[:-1]
                          if "/torch/" not in f.filename
                          and not f.filename.endswith("warnings.py")]
                where = frames[-1] if frames else None
                if where is not None and "binquant_tpu_torch" in where.filename:
                    syncs.append(f"{Path(where.filename).name}:{where.lineno} {where.line}")

        def checked(*args, **kwargs):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return scan(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        pl.tick_step_scan = checked
    fired: list = []

    async def run():
        fired.extend(await engine.process_ticks_scanned(ticks))
        fired.extend(await engine.flush_pending())

    t0 = time.perf_counter()
    try:
        asyncio.run(run())
    finally:
        pl.tick_step_scan = scan
    return {"engine": engine, "wires": wires, "fired": signal_tuples(fired), "chunks": chunks,
            "wall_ms": (time.perf_counter() - t0) * 1000.0, "syncs": syncs, "paths": [],
            "ticks": len(ticks)}


def check_scanned(m5, m15, serial: dict, cm5, cm15, card: str = "cuda") -> dict:
    """The scanned drive (``[slice scanned]``) on phase 3's market: wires,
    fired tuples, rings and carry bit for bit against phase 3's serial
    incremental card drive (``serial``), the CPU's scanned drive at the wire
    contract, the chunk counters; then phase 5's crash market with the
    crash tick inside a chunk: one overflow re-drive, the serial drive's
    fired set and wires. ``card="cpu"`` rehearses it without a card."""
    from binquant_tpu_torch.ops import quantile_tail as qt

    cuda = card == "cuda"
    qt.reset_launches()  # launches made by the comparisons above do not count
    gpu = drive_scanned(card, m5, m15, LIVE_TICKS, sync_check=cuda)
    counts = {"launches": qt.launches, "launches_by_site": _qtail_sites(cuda)}
    eng = gpu["engine"]
    want = {"scanned_ticks": 2 * (AUDIT_EVERY - 1), "scan_chunks": 2, "scan_overflow_reruns": 0}
    got = {k: getattr(eng, k) for k in want}
    if got != want:
        fail(f"scanned drive counters {got}, expected {want}")
    if sorted(gpu["fired"]) != sorted(serial["fired"]):
        fail("scanned drive: fired tuples differ from the serial incremental card drive")
    if gpu["syncs"]:
        fail(f"scanned drive: synchronizing operations inside the scan loop: "
             f"{sorted(set(gpu['syncs']))[:5]}")
    diff = _wires_bit_equal(gpu["wires"], serial["wires"])
    if diff:
        fail(f"scanned drive: wires differ in bits from the serial card drive on ticks {diff}")
    n_leaves, bad = _state_bits_equal(eng.state, serial["engine"].state)
    if bad:
        fail(f"scanned drive: state leaves differ from the serial card drive: {bad[:5]}")
    cpu = drive_scanned("cpu", m5, m15, LIVE_TICKS)
    if {k: getattr(cpu["engine"], k) for k in want} != got:
        fail("scanned drive: chunk counters differ between the card and the CPU")
    max_wire_err = compare_drives(gpu, cpu, "scanned")

    # the crash market: the crash tick (the 17th live tick) overflows the
    # wire inside the second chunk, which re-drives serially
    crash_ticks = LIVE_TICKS + 1
    before = _qtail_sites(cuda)
    crash = drive_scanned(card, cm5, cm15, crash_ticks, audit_every=SCAN_CRASH_AUDIT)
    crash_sites = _sites_since(before, cuda)
    counts["launches"] = qt.launches
    counts["launches_by_site"] = _qtail_sites(cuda)
    ce = crash["engine"]
    want_c = {"scanned_ticks": SCAN_CRASH_AUDIT - 1, "scan_chunks": 1, "scan_overflow_reruns": 1}
    got_c = {k: getattr(ce, k) for k in want_c}
    if got_c != want_c or ce.overflow_ticks != 1:
        fail(f"crash scanned drive counters {got_c} overflow {ce.overflow_ticks}, "
             f"expected {want_c} and one overflow tick")
    crash_serial = drive(card, cm5, cm15, incremental=True, live_ticks=crash_ticks,
                         audit_every=SCAN_CRASH_AUDIT)
    if sorted(crash["fired"]) != sorted(crash_serial["fired"]):
        fail("crash scanned drive: fired set differs from the serial drive's")
    crash_diff = _wires_bit_equal(crash["wires"], crash_serial["wires"])
    if crash_diff:
        fail(f"crash scanned drive: wires differ in bits on ticks {crash_diff}")

    # phase 3's serial incremental card drive of the same ticks
    serial_incr = [t for t, p in zip(serial["tick_ms"], serial["paths"]) if p == "incremental"]
    chunk_ms = [c["ms"] for c in gpu["chunks"]]
    per_tick = [c["ms"] / c["ticks"] for c in gpu["chunks"]]
    peaks = [c["peak_above_base_bytes"] for c in gpu["chunks"]]
    result = {
        **counts,
        **got,
        "ticks": gpu["ticks"],
        "signals": len(gpu["fired"]),
        "wires_bit_equal_to_serial": len(gpu["wires"]),
        "state_leaves_bit_equal": n_leaves,
        "max_wire_abs_err_vs_cpu": max_wire_err,
        "chunk_ticks": [c["ticks"] for c in gpu["chunks"]],
        "chunk_ms": chunk_ms,
        "chunk_ms_per_tick": per_tick,
        "chunk_peak_above_base_bytes": peaks,
        "serial_incremental_tick_ms": serial_incr,
        "serial_incremental_p50_ms": float(np.percentile(serial_incr, 50)),
        "cpu_chunk_ms": [c["ms"] for c in cpu["chunks"]],
        "syncs_in_scan_loop": len(gpu["syncs"]),
        "sync_sites": sorted(set(gpu["syncs"])),
        "crash": {**got_c, "signals": len(crash["fired"]), "sites": crash_sites,
                  "chunks": [{k: c[k] for k in ("ticks", "ms", "sites")}
                             for c in crash["chunks"]]},
    }
    print(
        f"[slice scanned] S={S} W={W}: 1 warm + {LIVE_TICKS} live ticks, audit every "
        f"{AUDIT_EVERY}: {got['scanned_ticks']} ticks in {got['scan_chunks']} chunks "
        f"{result['chunk_ticks']}, {result['signals']} signals; fired tuples, all "
        f"{len(gpu['wires'])} wires and {n_leaves} state leaves bit-equal to the serial "
        f"incremental card drive; counters equal to the cpu's, wires within the contract "
        f"(max err {max_wire_err:.3g}); chunk ms {[round(x, 2) for x in chunk_ms]} = "
        f"{[round(x, 2) for x in per_tick]} ms a tick vs serial incremental p50 "
        f"{result['serial_incremental_p50_ms']:.2f} ms (phase 3's drive); peak above base "
        f"{[_mib(p) for p in peaks]} MiB; syncs in the scan loop "
        f"{len(gpu['syncs'])} {result['sync_sites']}; qtail {counts['launches_by_site']}"
    )
    print(
        f"[slice scanned] crash market, audit every {SCAN_CRASH_AUDIT}: {got_c}, the crash "
        f"tick's chunk re-driven serially (overflow ticks {ce.overflow_ticks}); "
        f"{len(crash['fired'])} signals and every wire equal to the serial drive's; chunk ms "
        f"{[round(c['ms'], 1) for c in crash['chunks']]} (qtail {crash_sites})"
    )
    return result


@contextlib.contextmanager
def _twin_checked(checks: list, on_host: bool = False, by_reference: bool = False):
    """Hold every qtail call ActivityBurstPump and the spike detector make
    inside the block against the twin on the same input, bit for bit, once
    the block has ended: each call's input and output are cloned as it is
    made (so a timed drive carries two copies a call and no twin), and
    ``checks`` gets one ``(site, shape, num_out, equal)`` entry a call. The
    copies stay on the device, or with ``on_host`` go to pinned host memory
    by an asynchronous copy on the compute stream, so that the device memory
    a drive reports holds none of them. ``by_reference`` keeps each call's
    own tensors instead, for a block that writes nothing in place, so that
    its timed calls carry no copies."""
    import torch

    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.strategies import activity_burst_pump as abp_mod
    from binquant_tpu_torch.strategies import spike_hunter as spike_mod

    real = qt.rolling_quantile_tail
    saved: list = []

    def keep(t):
        if by_reference:
            return t
        if on_host and t.is_cuda:
            return t.to("cpu", non_blocking=True)  # pinned, ordered after the launch
        return t.clone()

    def checked(x, window, q, num_out=1, min_periods=None, site="direct"):
        out = real(x, window, q, num_out=num_out, min_periods=min_periods, site=site)
        saved.append((site, x.device, keep(x), window, q, num_out, min_periods, keep(out)))
        return out

    mods = (abp_mod, spike_mod)
    for mod in mods:
        mod.rolling_quantile_tail = checked
    try:
        yield checks
    finally:
        for mod in mods:
            mod.rolling_quantile_tail = real
    if on_host and torch.cuda.is_available():
        torch.cuda.synchronize()
    for site, dev, x, window, q, num_out, mp, out in saved:
        x, out = x.to(dev), out.to(dev)
        twin = qt.rolling_quantile_tail_reference(x, window, q, num_out, mp)
        a = torch.nan_to_num(out, nan=-9e9).view(torch.int32)
        b = torch.nan_to_num(twin, nan=-9e9).view(torch.int32)
        checks.append((site, tuple(x.shape), num_out, bool(torch.equal(a, b))))


def drive_backtest(device: str, m5: dict, m15: dict, chunks: tuple, ext_invariant: bool,
                   params=None, twin_check: bool = False, live: list | None = None) -> dict:
    """The warm tick through ``process_tick`` on a classic engine (the
    serial drive's settings), then ``process_ticks_backtest`` over one call
    per entry of ``chunks`` (that many live ticks, one chunk each). Fired
    tuples with their indicator payloads, every tick's wire, per chunk ms,
    peak, launches by site. ``twin_check`` holds every qtail launch at
    ``abp_core_batch`` against the twin on the same input
    (:func:`_twin_checked`). ``live`` passes
    the market's live ticks (:func:`live_ticks_of`) when already built."""
    from binquant_tpu_torch.backtest import driver
    from binquant_tpu_torch.io.replay import make_stub_engine, signal_tuples
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(
        capacity=S, window=W, context_config=ContextConfig(), device=device,
        incremental=False, ext_invariant=ext_invariant, **SERIAL,
    )
    queue_warm(engine, m5, m15)
    if live is None:
        live = live_ticks_of(m5, m15, sum(chunks))
    ticks = [(T_LIVE0 * 1000, [])] + live[: sum(chunks)]
    wires = _record_wires(engine)
    recs: list = []
    flush = driver._flush_backtest_plan
    driver._flush_backtest_plan = _timed_flush(flush, recs, device == "cuda", 1)
    checks: list = []
    out = {"fired": [], "indicators": {}}

    def take(fired):
        for sig, tup in zip(fired, signal_tuples(fired)):
            out["fired"].append(tup)
            out["indicators"][tup] = sig.analytics["indicators"]

    async def run():
        # the warm tick evaluates with the drive's params too
        engine.strategy_params = params
        take(await engine.process_tick(now_ms=ticks[0][0]))
        start = 1
        for T in chunks:
            take(await engine.process_ticks_backtest(ticks[start:start + T], params=params,
                                                     chunk=T))
            start += T
        take(await engine.flush_pending())

    try:
        with _twin_checked(checks) if twin_check else contextlib.nullcontext():
            asyncio.run(run())
    finally:
        driver._flush_backtest_plan = flush
    out.update(engine=engine, wires=wires, chunks=recs, checks=checks, paths=[],
               ticks=len(ticks), tick_times=[t for t, _ in ticks])
    return out


def _counts_by_strategy(fired: list) -> tuple[dict, dict]:
    trig: dict = {}
    auto: dict = {}
    for _, strat, _, _, at in fired:
        trig[strat] = trig.get(strat, 0) + 1
        auto[strat] = auto.get(strat, 0) + int(at)
    return trig, auto


def check_backtest(card: str = "cuda") -> dict:
    """The time-batched backtest (``[slice backtest]``): phase 3's market
    recipe with 48 live ticks on a classic engine, the warm tick serial,
    then a 16-tick and a 32-tick chunk. With ``ext_invariant`` off the fired
    set is the serial classic card drive's exactly (and the CPU backtest's
    on the first chunk); with it on, equal but for flips inside the
    declared gate margins. Two qtail launches at ``abp_core_batch`` per
    chunk, none at ``abp_core`` on batched ticks, each equal to the twin.
    Then ``run_param_sweep`` over 8 combos on the same stream, scoring on:
    per-combo counts against ``process_ticks_backtest`` runs at two combos'
    params, and against the CPU sweep on the first chunk. ``card="cpu"``
    rehearses it without a card."""
    from binquant_tpu_torch.backtest import run_param_sweep
    from binquant_tpu_torch.engine.step import STRATEGY_ORDER, WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.regime.context import ContextConfig
    from binquant_tpu_torch.strategies.params import (
        declared_gate_margins,
        grid_combo,
        make_param_grid,
    )

    cuda = card == "cuda"
    live = sum(BT_CHUNKS)
    bm5, bm15 = make_market(np.random.default_rng(SEED + 2), live_ticks=live)
    serial = drive(card, bm5, bm15, incremental=False, live_ticks=live)
    # the live ticks' klines, built once for every drive below
    klines = live_ticks_of(bm5, bm15, live)
    qt.reset_launches()  # the serial drive's launches are phase 3's kind
    bt = drive_backtest(card, bm5, bm15, BT_CHUNKS, ext_invariant=False, twin_check=True,
                        live=klines)
    counts = {"launches": qt.launches, "launches_by_site": _qtail_sites(cuda)}
    eng = bt["engine"]
    got = {k: getattr(eng, k) for k in ("backtest_ticks", "backtest_chunks",
                                         "backtest_overflow_reruns")}
    if got != {"backtest_ticks": live, "backtest_chunks": len(BT_CHUNKS),
               "backtest_overflow_reruns": 0}:
        fail(f"backtest counters {got}")
    if sorted(bt["fired"]) != sorted(serial["fired"]):
        only_bt = sorted(set(bt["fired"]) - set(serial["fired"]))[:5]
        only_serial = sorted(set(serial["fired"]) - set(bt["fired"]))[:5]
        fail(f"backtest fired set != serial classic card drive: {only_bt} / {only_serial}")
    wires_equal = len(bt["wires"]) - len(_wires_bit_equal(bt["wires"], serial["wires"]))
    for c in bt["chunks"]:
        if c["sites"] != {"abp_core_batch": 2}:
            fail(f"backtest chunk qtail launches by site {c['sites']}, expected 2 at abp_core_batch")
    batched = [c for c in bt["checks"] if c[0] == "abp_core_batch"]
    if len(batched) != 2 * len(BT_CHUNKS) or not all(c[3] for c in bt["checks"]):
        fail(f"backtest qtail launches vs twin: {bt['checks']}")
    shapes = sorted({(c[1], c[2]) for c in batched})

    # the CPU backtest on the first chunk
    cpu = drive_backtest("cpu", bm5, bm15, (BT_CPU_TICKS,), ext_invariant=False, live=klines)
    first = set(bt["tick_times"][: BT_CPU_TICKS + 1])
    if sorted(f for f in bt["fired"] if f[0] in first) != sorted(cpu["fired"]):
        fail("backtest fired set on the first chunk differs between the card and the CPU")
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    for i, (wg, wc) in enumerate(zip(bt["wires"], cpu["wires"], strict=False)):
        if wg[off] != wc[off] or not np.array_equal(
            wg[off + 1: off + 1 + 4 * K], wc[off + 1: off + 1 + 4 * K]
        ):
            fail(f"backtest tick {i}: fired block differs between the card and the CPU")
        if not np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True).all():
            fail(f"backtest tick {i}: wire floats differ between the card and the CPU")

    # ext_invariant on: the gate-margin contract against the serial drive
    ext = drive_backtest(card, bm5, bm15, BT_CHUNKS, ext_invariant=True, live=klines)
    if ext["engine"].backtest_chunks != len(BT_CHUNKS):
        fail("ext_invariant backtest did not batch")
    margins = declared_gate_margins()
    flips = sorted(set(ext["fired"]) ^ set(serial["fired"]))
    for f in flips:
        ind = ext["indicators"].get(f) or serial["indicators"].get(f) or {}
        side = "ext_invariant" if f in ext["indicators"] else "serial"
        print(f"[slice backtest] ext_invariant flip {f} fired on the {side} drive only, "
              f"gated indicators {{rsi: {ind.get('rsi')}, mfi: {ind.get('mfi')}}}")
        if not _gated_flip_ok(f, ind, margins):
            fail(f"ext_invariant backtest: flip outside the declared gate margins: {f}")

    # the sweep: 8 combos on the same stream, scoring on
    grid, combos = make_param_grid(SWEEP_AXES)

    def seq_of(n_live: int) -> list:
        return [(T_LIVE0 * 1000, lambda e: queue_warm(e, bm5, bm15))] + klines[:n_live]

    sweep_kw = dict(capacity=S, window=W, chunk=BT_CHUNKS[0], context_config=ContextConfig())
    before = _qtail_sites(cuda)
    sweep_checks: list = []
    with _twin_checked(sweep_checks):
        sweep = run_param_sweep(None, SWEEP_AXES, device=card, seq=seq_of(live), **sweep_kw)
    sweep_sites = _sites_since(before, cuda)
    n_abp = len(SWEEP_AXES["abp.score_quantile"])
    if sweep_sites != {"abp_core_batch": 2 * n_abp * sweep["dispatches"]}:
        fail(f"sweep qtail launches {sweep_sites}: expected one abp_core_batch pair per "
             f"score_quantile per chunk ({sweep['dispatches']} chunks)")
    # every launch of the sweep against the twin, the warm chunk's too
    sweep_shapes = sorted({(c[1], c[2]) for c in sweep_checks})
    if (len(sweep_checks) != sweep_sites["abp_core_batch"]
            or not all(c[0] == "abp_core_batch" and c[3] for c in sweep_checks)):
        fail(f"sweep qtail launches vs twin: {sweep_checks}")
    if ((S, BT_WARM_QTAIL[0]), BT_WARM_QTAIL[1]) not in sweep_shapes:
        fail(f"sweep qtail shapes {sweep_shapes}: the warm chunk's {BT_WARM_QTAIL} missing")
    # the sweep is the backend's other main path: its launches join the
    # drive's (its counts read just before and just after it)
    counts["launches"] += sum(sweep_sites.values())
    for k, v in sweep_sites.items():
        counts["launches_by_site"][k] = counts["launches_by_site"].get(k, 0) + v
    for p in SWEEP_CHECKED:
        run = drive_backtest(card, bm5, bm15, BT_CHUNKS, ext_invariant=False,
                             params=grid_combo(grid, p), live=klines)
        trig, auto = _counts_by_strategy(run["fired"])
        want_t = {s: n for s, n in zip(STRATEGY_ORDER, sweep["trig_counts"][p]) if n}
        want_a = {s: n for s, n in zip(STRATEGY_ORDER, sweep["autotrade_counts"][p]) if n}
        if trig != want_t or {k: v for k, v in auto.items() if v} != want_a:
            fail(f"sweep combo {p} {combos[p]}: counts {want_t}/{want_a} != backtest's "
                 f"{trig}/{auto}")
    first_checks: list = []
    with _twin_checked(first_checks):
        sweep_first = run_param_sweep(None, SWEEP_AXES, device=card, seq=seq_of(BT_CPU_TICKS),
                                      **sweep_kw)
    if not first_checks or not all(c[3] for c in first_checks):
        fail(f"first-chunk sweep qtail launches vs twin: {first_checks}")
    sweep_cpu = run_param_sweep(None, SWEEP_AXES, device="cpu", seq=seq_of(BT_CPU_TICKS),
                                **sweep_kw)
    for key in ("trig_counts", "autotrade_counts", "ranking"):
        if sweep_first[key] != sweep_cpu[key]:
            fail(f"sweep {key} differ between the card and the CPU on the first chunk")
    if (sweep_first["outcomes"]["ranking_by_return"]
            != sweep_cpu["outcomes"]["ranking_by_return"]):
        fail("sweep outcome ranking differs between the card and the CPU")

    candles_tick = S * 4
    chunk_rows = [
        {"ticks": c["ticks"], "ms": c["ms"], "ticks_per_s": c["ticks"] / c["ms"] * 1e3,
         "candles_per_s": c["ticks"] * candles_tick / c["ms"] * 1e3,
         "peak_above_base_bytes": c["peak_above_base_bytes"], "sites": c["sites"]}
        for c in bt["chunks"]
    ]
    ext_rows = [{"ticks": c["ticks"], "ms": c["ms"],
                 "peak_above_base_bytes": c["peak_above_base_bytes"]} for c in ext["chunks"]]
    serial_live = serial["tick_ms"][1:]
    result = {
        **counts,
        **got,
        "signals": len(bt["fired"]),
        "wires_bit_equal_to_serial": [wires_equal, len(bt["wires"])],
        "qtail_shapes": [list(s) for s in shapes],
        "chunks": chunk_rows,
        "ext_invariant_chunks": ext_rows,
        "ext_invariant_flips": len(flips),
        "serial_classic_tick_p50_ms": float(np.percentile(serial_live, 50)),
        "cpu_chunk_ms": [c["ms"] for c in cpu["chunks"]],
        "sweep": {
            "P": sweep["P"], "combos": combos, "dispatches": sweep["dispatches"],
            "chunk_ms": sweep["chunk_ms"], "wall_s": sweep["wall_s"],
            "combos_per_s": sweep["P"] * sweep["evaluated_ticks"] / sweep["wall_s"]
            if sweep["wall_s"] else None,
            "total_fired": sweep["total_fired"], "ranking": sweep["ranking"],
            "ranking_by_return": sweep["outcomes"]["ranking_by_return"],
            "launches_by_site": sweep_sites, "cpu_first_chunk_equal": True,
            "qtail_shapes": [list(sh) for sh in sweep_shapes],
            "qtail_equal_to_twin": len(sweep_checks),
        },
    }
    print(
        f"[slice backtest] S={S} W={W}: warm tick + chunks {list(BT_CHUNKS)} on a classic "
        f"engine, {result['signals']} signals equal to the serial classic card drive "
        f"(wires bit-equal {wires_equal}/{len(bt['wires'])}) and, on the first chunk, to the "
        f"cpu's; qtail 2 launches a chunk at abp_core_batch {shapes}, each equal to the twin; "
        + "; ".join(
            f"chunk {c['ticks']}: {c['ms']:.1f} ms, {c['ticks_per_s']:.1f} ticks/s, "
            f"{c['candles_per_s']:.0f} candles/s, peak +{_mib(c['peak_above_base_bytes'])} MiB"
            for c in chunk_rows)
        + f"; serial classic tick p50 {result['serial_classic_tick_p50_ms']:.2f} ms; "
        f"ext_invariant chunks {[round(c['ms'], 1) for c in ext_rows]} ms, {len(flips)} "
        f"flips, all inside the gate margins"
    )
    print(
        f"[slice backtest] sweep: {sweep['P']} combos over {list(SWEEP_AXES)}, "
        f"{sweep['dispatches']} chunks of {BT_CHUNKS[0]}, chunk ms "
        f"{[round(x, 1) for x in sweep['chunk_ms']]}, {result['sweep']['combos_per_s']:.1f} "
        f"combo-ticks/s; fired {sweep['total_fired']}; combos {list(SWEEP_CHECKED)} equal to "
        f"their process_ticks_backtest runs; the first chunk's counts and rankings equal to "
        f"the cpu sweep's; qtail {sweep_sites} at {sweep_shapes} (the warm chunk's "
        f"{BT_WARM_QTAIL} through the block kernel), all {len(sweep_checks)} launches equal "
        f"to the twin"
    )
    return result


# --------------------------------------------------------------------------
# phase 11: the port as a service (run_live over fake clients)
# --------------------------------------------------------------------------

LIVE11_TICKS = 4  # live ticks of the card's boot with the open-interest feed
LIVE11_SHORT = 3  # live ticks of the other two boots: every tick LSP fires on
LIVE11_AUDIT = 2  # the audit cadence: cold start, incremental, audit, incremental, ...
# 15m bars of history the phase's REST source holds a symbol (a young
# listing: the fetch asks for 400, the exchange has these; 5m: three times
# as many); ``--cold-boot`` serves the full 400 of each interval
LIVE11_HISTORY = 110
LSP_TICKS = (2, 3)  # the live ticks on which BTC stalls, so LSP's SHORT route opens
OI_GROWTH = (1.01, 1.02, 1.05)  # 900-s open-interest growth, by symbol index mod 3
OI_STALE = 9  # the symbol index whose open-interest fetch fails from OI_STALE_FROM
OI_STALE_FROM = 3  # the live tick from which it fails (its growth then reads stale)
WS_BAD_AT = 2  # the live tick whose frames carry one malformed frame
WS_CLOSE_AT = 3  # the live tick before whose frames one connection is closed
OI_SWEEP_PAUSE_S = 0.05  # the open-interest refresh's pause between sweeps (drill scale)
C3_FAMILIES = (
    "bqt_numeric_nonfinite_rows", "bqt_numeric_absmax", "bqt_numeric_anomaly_ticks_total",
    "bqt_fired_rows_per_tick", "bqt_carry_drift", "bqt_carry_drift_ulp",
    "bqt_carry_drift_alarms_total", "bqt_registry_symbols", "bqt_registry_capacity_errors_total",
    "bqt_symbols_per_tick",
)
WS_FAMILIES = ("bqt_ws_frames_total", "bqt_ws_reconnects_total", "bqt_ws_parse_errors_total")


def live_symbols() -> list[str]:
    """The KuCoin futures universe: XBTUSDTM (BTC) and S-1 ``…USDTM``
    contracts."""
    return ["XBTUSDTM"] + [f"S{i:04d}USDTM" for i in range(1, S)]


def make_live_market(rng: np.random.Generator):
    """W bars of 15m history and LIVE11_TICKS + 1 live bars (the last one
    only opens, closing the one before it), 5m bars under them: a 5m random
    walk as :func:`make_market` makes it, with its volume bursts. BTC (row 0)
    walks quietly through the history and moves 0.6% a live 15m bar, but on
    the bars the ticks of LSP_TICKS evaluate it stalls (0.05%), inside
    LiquidationSweepPump's stalled band: with the hot and falling breadth of
    phase 6's schedule, its SHORT route opens on those ticks only, where
    every 16th symbol trades heavy and the rest thin."""
    n_live = LIVE11_TICKS + 1
    m5, m15 = make_market(rng, live_ticks=n_live)
    n5 = m5["close"].shape[1]
    c0 = float(m5["close"][0, 0])
    hist = c0 * np.exp(np.cumsum(rng.normal(0.0, 0.0003, 3 * W)))
    moves = [0.0005 * (-1) ** j if j + 1 in LSP_TICKS else 0.006 * (-1) ** j
             for j in range(n_live)]
    live = hist[-1] * np.exp(np.cumsum(np.repeat(np.asarray(moves) / 3, 3)))
    btc = np.concatenate([hist, live])
    assert btc.shape[0] == n5
    # on the LSP bars most rows trade thin and every 16th heavy, so the
    # SHORT route fires on a few dozen rows a tick, inside the wire's slots
    heavy = np.arange(S) % 16 == 3
    for j in range(n_live):
        if j + 1 in LSP_TICKS:
            cols = slice(3 * (W + j), 3 * (W + j) + 3)
            m5["volume"][~heavy, cols] *= 0.3
            m5["volume"][heavy, cols] *= 3.0
    m5["close"][0] = btc
    m5["open"][0] = np.concatenate([[c0], btc[:-1]])
    m5["high"][0] = np.maximum(m5["open"][0], btc) * 1.0005
    m5["low"][0] = np.minimum(m5["open"][0], btc) * 0.9995
    g = lambda a: a.reshape(S, -1, 3)  # noqa: E731
    m15.update(open=g(m5["open"])[:, :, 0], high=g(m5["high"]).max(axis=2),
               low=g(m5["low"]).min(axis=2), close=g(m5["close"])[:, :, 2],
               volume=g(m5["volume"]).sum(axis=2))
    return m5, m15


def _bar(m: dict, row: int, i: int) -> tuple:
    return tuple(float(m[k][row, i]) for k in ("open", "high", "low", "close", "volume"))


def _partial(bar: tuple) -> tuple:
    """An update of the candle in progress: its open, half its move, half
    its volume."""
    o, _, _, c, v = bar
    mid = o + (c - o) / 2
    return (o, max(o, mid), min(o, mid), mid, v / 2)


def _frame(symbol: str, interval: str, ts_s: int, bar: tuple) -> str:
    """A KuCoin futures candle push, shaped as the recorded session's
    (``tests/fixtures/kucoin_session.json``): string-encoded numbers, a
    nanosecond push time."""
    o, h, lo, c, v = bar
    return json.dumps({
        "type": "message",
        "topic": f"/contractMarket/limitCandle:{symbol}_{interval}",
        "subject": "candle.stick",
        "data": {"symbol": symbol, "candles": [str(ts_s), repr(o), repr(h), repr(lo), repr(c),
                                               repr(v)],
                 "granularity": 5 if interval == "5min" else 15, "time": ts_s * 10**9 + 1},
    })


def _kline11(symbol: str, interval_s: int, ts_s: int, bar: tuple) -> dict:
    o, h, lo, c, v = bar
    return {"symbol": symbol, "open_time": ts_s * 1000,
            "close_time": (ts_s + interval_s) * 1000 - 1, "open": o, "high": h, "low": lo,
            "close": c, "volume": v, "quote_asset_volume": 0.0, "number_of_trades": 0.0,
            "taker_buy_base_volume": 0.0, "taker_buy_quote_volume": 0.0, "exchange": "kucoin"}


def live_bursts(m5: dict, m15: dict) -> list:
    """The websocket traffic of a session, burst by burst: burst 0 opens
    live bar 0 (its first 5m and 15m updates); burst k (1..LIVE11_TICKS)
    brings the rest of 15m bar k-1 and its three 5m bars (an unclosed update,
    then the final one) and opens the next, which closes them. Each burst is
    ``(frames by topic, the klines it must put on the queue)``."""
    names = live_symbols()
    b5, b15 = 3 * W, W  # the first live bar's column
    t15 = lambda j: T_LIVE0 + 900 * j  # noqa: E731
    t5 = lambda j: T_LIVE0 + 300 * j  # noqa: E731
    bursts = []
    first: dict = {}
    for r, name in enumerate(names):
        first[f"{name}_5min"] = [_frame(name, "5min", t5(0), _partial(_bar(m5, r, b5)))]
        first[f"{name}_15min"] = [_frame(name, "15min", t15(0), _partial(_bar(m15, r, b15)))]
    bursts.append((first, []))
    for k in range(1, LIVE11_TICKS + 1):
        frames: dict = {}
        want: list = []
        for r, name in enumerate(names):
            f5 = []
            j0 = 3 * (k - 1)
            for j in range(j0, j0 + 3):
                bar = _bar(m5, r, b5 + j)
                if j != j0:  # bar j0 got its first update in the previous burst
                    f5.append(_frame(name, "5min", t5(j), _partial(bar)))
                f5.append(_frame(name, "5min", t5(j), bar))
                want.append(_kline11(name, 300, t5(j), bar))
            f5.append(_frame(name, "5min", t5(j0 + 3), _partial(_bar(m5, r, b5 + j0 + 3))))
            bar15 = _bar(m15, r, b15 + k - 1)
            frames[f"{name}_5min"] = f5
            frames[f"{name}_15min"] = [
                _frame(name, "15min", t15(k - 1), _partial(bar15)),
                _frame(name, "15min", t15(k - 1), bar15),
                _frame(name, "15min", t15(k), _partial(_bar(m15, r, b15 + k))),
            ]
            want.append(_kline11(name, 900, t15(k - 1), bar15))
        if k == WS_BAD_AT:
            # valid JSON, an open time that is not a number
            frames[f"{names[1]}_5min"].insert(0, json.dumps({
                "type": "message", "topic": f"/contractMarket/limitCandle:{names[1]}_5min",
                "data": {"candles": ["not-a-time", "1", "1", "1", "1", "1"]}}))
        bursts.append((frames, want))
    return bursts


class KucoinWire:
    """Fake KuCoin futures websocket connections for the connector's
    ``connect``/``token_fetch`` seams: records each connection's subscribed
    topics and pings, and serves it the frames :meth:`push` routes to it by
    topic; :meth:`drop` closes one connection (its next read raises)."""

    _CLOSE = object()

    def __init__(self) -> None:
        self.conns: dict[int, dict] = {}  # connectId index -> current connection
        self.connects = 0
        self.token_fetches = 0
        self.pings = 0
        self.last_frame_t = 0.0
        wire = self

        class Ws:
            def __init__(self, conn: dict) -> None:
                self.conn = conn

            async def send(self, msg: str) -> None:
                m = json.loads(msg)
                if m.get("type") == "subscribe":
                    prefix, suffixes = m["topic"].split(":", 1)
                    self.conn["topics"].extend(suffixes.split(","))
                elif m.get("type") == "ping":
                    wire.pings += 1

            def __aiter__(self):
                return self

            async def __anext__(self) -> str:
                self.conn["reading"] = True
                item = await self.conn["queue"].get()
                if item is KucoinWire._CLOSE:
                    raise ConnectionError("socket closed by the peer")
                if self.conn["queue"].empty():
                    wire.last_frame_t = time.perf_counter()
                return item

        class Connection:
            def __init__(self, url: str) -> None:
                self.idx = int(url.rsplit("connectId=bq", 1)[1])

            async def __aenter__(self):
                conn = {"topics": [], "queue": asyncio.Queue()}
                wire.conns[self.idx] = conn
                wire.connects += 1
                return Ws(conn)

            async def __aexit__(self, *exc) -> bool:
                return False

        self._connection = Connection

    def connect(self, url: str):
        return self._connection(url)

    def token_fetch(self) -> tuple[str, str, float]:
        self.token_fetches += 1
        return "wss://smoke.invalid/endpoint", "smoke-token", 0.5

    def subscribed(self, topics_total: int) -> bool:
        """Every topic subscribed and every connection reading its frames."""
        return (sum(len(c["topics"]) for c in self.conns.values()) == topics_total
                and all(c.get("reading") for c in self.conns.values()))

    def push(self, frames: dict) -> int:
        """Route every frame to the connection subscribed to its topic;
        returns the frames sent."""
        route = {t: c for c in self.conns.values() for t in c["topics"]}
        n = 0
        for key, fs in frames.items():
            q = route[key]["queue"]
            for f in fs:
                q.put_nowait(f)
            n += len(fs)
        return n

    def drop(self, idx: int) -> dict:
        conn = self.conns[idx]
        conn["queue"].put_nowait(KucoinWire._CLOSE)
        return conn


class LiveFutures:
    """The KuCoin futures REST client over the market: ``get_ui_klines`` in
    the ``/kline/query`` row shape (the 400 bars closed by the boot, then
    the first live bar, still open), and ``get_open_interest`` on the
    service's clock, growing by OI_GROWTH[i % 3] every 15 minutes
    (OI_STALE fails from live tick OI_STALE_FROM). Open-interest requests
    wait on ``gate`` (a worker thread's), so the drive decides when a sweep
    may run; a request made on the event loop's thread (a tick would make
    it there) is counted in ``loop_calls`` and never waits."""

    def __init__(self, history: dict, clock: dict) -> None:
        import threading

        self.history = history
        self.clock = clock
        self.index = {name: r for r, name in enumerate(live_symbols())}
        self.gate = threading.Event()
        self.lock = threading.Lock()
        self.in_flight = 0
        self.oi_calls = 0
        self.loop_calls = 0
        self.loop_thread = threading.get_ident()

    def get_ui_klines(self, symbol: str, granularity_min: int = 15, limit: int = 400) -> list:
        rows = self.history[granularity_min][self.index[symbol]]
        return rows[max(rows.shape[0] - limit - 1, 0):].tolist()

    def get_open_interest(self, symbol: str) -> float:
        import threading

        if threading.get_ident() == self.loop_thread:
            self.loop_calls += 1
        elif not self.gate.wait(timeout=120.0):
            raise TimeoutError("open-interest gate never opened")
        with self.lock:
            self.in_flight += 1
        try:
            i = self.index[symbol]
            k = (self.clock["ms"] // 1000 - T_LIVE0) // 900
            if i == OI_STALE and k >= OI_STALE_FROM:
                raise ConnectionError(f"{symbol}: open interest unavailable")
            return 1000.0 * (1.0 + i % 7) * OI_GROWTH[i % 3] ** (k + 2)
        finally:
            with self.lock:
                self.in_flight -= 1
                self.oi_calls += 1


def live_history(m5: dict, m15: dict, bars15: int = 400) -> dict:
    """granularity (min) -> (S, n + 1, 6) ``/kline/query`` rows ``[time_ms,
    open, high, low, close, volume]``: the last n bars closed at the boot
    (``bars15`` 15m bars; three times as many 5m bars, at most 400) and the
    first live bar, still open (the backfill drops it)."""
    out = {}
    for g, m, n_hist in ((15, m15, W), (5, m5, 3 * W)):
        n = bars15 if g == 15 else min(3 * bars15, 400)
        cols = slice(n_hist - n, n_hist + 1)
        ts = (T_LIVE0 - 60 * g * np.arange(n, -1, -1)) * 1000
        vals = [m[k][:, cols] for k in ("open", "high", "low", "close", "volume")]
        out[g] = np.stack([np.broadcast_to(ts, vals[0].shape).astype(np.float64)] + vals,
                          axis=-1)
    return out


def live_backend():
    """The binbot backend of the service: the stub's answers with phase 6's
    breadth schedule and phase 7's autotrade backend (without faults), the
    KuCoin futures settings (autotrade off: every signal still reaches the
    autotrade consumer) and the universe as the symbol list."""
    backend = autotrade_backend(False)
    backend.breadth = {"schedule": service_breadth()}
    symbols_payload = [{"id": n, "base_asset": n[:-5], "quote_asset": "USDT",
                        "futures_leverage": 5.0} for n in live_symbols()]
    request = backend.request

    def answer(method: str, url: str, **kwargs):
        if url.endswith("/autotrade-settings/bots"):
            backend.requests.append((method, url, None))
            return backend._Resp({"data": {"autotrade": False, "exchange_id": "kucoin",
                                           "market_type": "futures"}})
        if url.endswith("/symbols"):
            backend.requests.append((method, url, None))
            return backend._Resp({"data": symbols_payload})
        return request(method, url, **kwargs)

    backend.request = answer
    return backend


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric_samples(text: str) -> dict:
    """family -> {sample line key: value} of a /metrics body."""
    kinds: dict = {}
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and kinds.get(name[: -len(suffix)]) == "histogram":
                fam = name[: -len(suffix)]
        out.setdefault(fam, {})[key] = value
    return out


def _gauges_to_nan() -> None:
    """Every gauge child of the process registry set to NaN, so a family a
    run sets shows as changed in its scrape (the registry is shared by the
    runs of one process)."""
    from binquant_tpu_torch.obs.registry import REGISTRY

    for fam in REGISTRY.collect():
        if fam.kind == "gauge":
            for _, child in fam.children():
                child.set(float("nan"))


def live_boot(device: str, history: dict, bursts: list, tmp: Path, tag: str,
              oi: bool = True, backfill_chunk: int = 50, ticks: int = LIVE11_TICKS) -> dict:
    """One cold boot of the service: ``run_live`` on ``device`` over the fake
    binbot backend, Telegram transport, KuCoin futures client (history and,
    with ``oi``, open interest) and websocket, on the service clock
    ``T_LIVE0`` (the first live bar open), then ``ticks`` live ticks, each
    the clock moved to the bar's close, one open-interest sweep let through
    (with ``oi``), and its burst of frames pushed; connection 1 is dropped
    before tick WS_CLOSE_AT and must reconnect. Per tick: the ms from the
    push to the tick's signals emitted, the path, qtail calls by site, the
    klines the frames put on the queue, the autotrade payloads delivered
    and the tick path's open-interest calls. The /metrics samples before
    and after the drive."""
    from binquant_tpu_torch.__main__ import run_live
    from binquant_tpu_torch.config import Config
    from binquant_tpu_torch.obs.exposition import render_text
    from binquant_tpu_torch.obs.instruments import WS_PARSE_ERRORS, WS_RECONNECTS
    from binquant_tpu_torch.regime.context import ContextConfig

    cuda = device == "cuda"
    clock = {"ms": T_LIVE0 * 1000}
    wire, futures, backend = KucoinWire(), LiveFutures(history, clock), live_backend()
    sent: list[str] = []

    async def transport(chat_id: str, text: str) -> None:
        sent.append(text)

    port = _free_port()
    config = Config(
        max_symbols=S, window_bars=W, carry_audit_every_ticks=LIVE11_AUDIT, env="CI",
        delivery_wal_path=str(tmp / f"{tag}.wal.jsonl"),
        fanout_outbox_path=str(tmp / f"{tag}.fanout.jsonl"),
        heartbeat_path=str(tmp / f"{tag}.heartbeat"), metrics_port=port,
        telegram_bot_token="", telegram_user_id="smoke", event_log="", checkpoint_path="",
        log_level="WARNING",  # the service's INFO lines (one a signal) would bury the output
    )
    rec = {"klines": [], "payloads": [], "tick_oi_calls": [], "fired": [], "tick_ms": [],
           "paths": [], "sites": [], "overflowed": [], "frames": [], "parse_s": [],
           "ingested": [], "first_signal_tick": None, "oi_sweeps": []}
    holder: dict = {}

    def on_engine(engine) -> None:
        holder["engine"] = engine
        # drill scale: no one-second Telegram pacing, one sweep a batch
        engine.telegram_consumer._min_send_interval_seconds = 0.0
        cache = engine.oi_cache
        cache.batch_size = S
        cache.batch_interval_s = OI_SWEEP_PAUSE_S
        if not oi:
            cache.futures_api = None  # the engine without the feed: futures_api=None
        ingest = engine.ingest

        def recorded(kline):
            rec["klines"].append(kline)
            return ingest(kline)

        engine.ingest = recorded
        at, admit = engine.at_consumer, engine.at_consumer.process_autotrade_restrictions

        async def received(result):
            rec["payloads"].append(result)
            await admit(result)

        at.process_autotrade_restrictions = received
        process_tick, finalize = engine.process_tick, engine._finalize_tick

        async def counted(now_ms=None):
            c0 = futures.oi_calls
            out = await process_tick(now_ms)
            rec["tick_oi_calls"].append(futures.oi_calls - c0)
            return out

        async def finalized(pending):
            out = await finalize(pending)
            rec["fired"].extend((pending.ts_ms, s.strategy, s.symbol, float(s.value.score))
                                for s in out)
            return out

        engine.process_tick, engine._finalize_tick = counted, finalized

    _gauges_to_nan()
    before = _metric_samples(render_text())
    parse0 = WS_PARSE_ERRORS.labels(exchange="kucoin").value
    recon0 = WS_RECONNECTS.labels(exchange="kucoin").value
    topics_total = 2 * S

    async def wait_for(cond, what: str, task, timeout_s: float = 600.0) -> None:
        t0 = time.perf_counter()
        while not cond():
            if task.done():
                task.result()  # raises the service's exception
                fail(f"[slice live] {tag}: the service returned while waiting for {what}")
            if time.perf_counter() - t0 > timeout_s:
                fail(f"[slice live] {tag}: timed out waiting for {what}")
            await asyncio.sleep(0.002)

    async def sweep(task) -> None:
        """Let one whole open-interest sweep run at the current clock."""
        engine = holder["engine"]
        failing = int((clock["ms"] // 1000 - T_LIVE0) // 900 >= OI_STALE_FROM)
        r0, c0 = engine.oi_cache.requests_made, futures.oi_calls
        futures.gate.set()
        await wait_for(lambda: engine.oi_cache.requests_made >= r0 + S - failing,
                       "an open-interest sweep", task)
        futures.gate.clear()
        await wait_for(lambda: futures.in_flight == 0, "the sweep's requests to land", task)
        rec["oi_sweeps"].append((engine.oi_cache.requests_made - r0, futures.oi_calls - c0))

    async def drive() -> None:
        t_boot = time.perf_counter()
        task = asyncio.create_task(run_live(
            device, config=config, binbot_session=backend, telegram_transport=transport,
            futures_api=futures, ws_connect=wire.connect, ws_token_fetch=wire.token_fetch,
            connector_options=dict(initial_backoff_s=0.01, reconnect_seed=SEED),
            clock=lambda: clock["ms"], tick_interval_s=0.0, backfill_chunk=backfill_chunk,
            on_engine=on_engine,
        ))
        await wait_for(lambda: wire.subscribed(topics_total), "the subscriptions", task)
        rec["connections"] = len(wire.conns)
        rec["frames"].append(wire.push(bursts[0][0]))
        await wait_for(lambda: "engine" in holder and holder["engine"].backfill_stats is not None,
                       "the backfill", task)
        engine = holder["engine"]
        rec["ready_s"] = time.perf_counter() - t_boot
        rec["backfill"] = dict(engine.backfill_stats)
        if cuda:
            import torch

            torch.cuda.synchronize()
        if oi:
            await sweep(task)  # the baseline sample, at the boot's clock
        for k in range(1, ticks + 1):
            clock["ms"] = (T_LIVE0 + 900 * k) * 1000
            if oi:
                await sweep(task)
            if k == WS_CLOSE_AT:
                idx = min(1, len(wire.conns) - 1)
                wire.drop(idx)
                await wait_for(lambda: wire.connects > rec["connections"] and wire.subscribed(
                    topics_total), "the reconnect", task)
            frames, want = bursts[k]
            ticks0, n0 = engine.ticks_processed, len(rec["klines"])
            before_sites = _qtail_sites(cuda)
            over0, p0 = engine.overflow_ticks, len(rec["fired"])
            t0 = time.perf_counter()
            rec["frames"].append(wire.push(frames))
            await wait_for(lambda: engine.ticks_processed > ticks0 and not engine._pending,
                           f"live tick {k}", task)
            rec["tick_ms"].append((time.perf_counter() - t0) * 1000.0)
            rec["parse_s"].append(wire.last_frame_t - t0)
            rec["paths"].append(engine.last_path)
            rec["overflowed"].append(engine.overflow_ticks > over0)
            rec["sites"].append(_sites_since(before_sites, cuda))
            got = rec["klines"][n0:]
            rec["ingested"].append(len(got))
            key = lambda d: (d["symbol"], d["open_time"], d["close_time"])  # noqa: E731
            if sorted(got, key=key) != sorted(want, key=key):
                fail(f"[slice live] {tag}: tick {k}'s frames put {len(got)} klines on the "
                     f"queue, expected {len(want)} equal to their bars")
            if rec["first_signal_tick"] is None and len(rec["fired"]) > p0:
                rec["first_signal_tick"] = k
                rec["boot_to_first_signal_s"] = rec["ready_s"] + rec["tick_ms"][-1] / 1000.0
            await settle(engine)
            if k == LIVE11_SHORT:
                # the point the shorter boots end at: their families compare here
                rec["metrics_short"] = (await http_get(port, "/metrics"))[1]
        rec["parse_errors"] = WS_PARSE_ERRORS.labels(exchange="kucoin").value - parse0
        rec["reconnects"] = WS_RECONNECTS.labels(exchange="kucoin").value - recon0
        code, text = await http_get(port, "/metrics")
        if code != 200:
            fail(f"[slice live] {tag}: /metrics answered {code}")
        rec["metrics"] = text
        futures.gate.set()  # the refresh's waiting requests return; the loop then stops
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        else:
            fail(f"[slice live] {tag}: run_live returned instead of being cancelled")

    asyncio.run(drive())
    engine = holder["engine"]
    rec.update(engine=engine, before=before, pings=wire.pings, token_fetches=wire.token_fetches,
               loop_calls=futures.loop_calls,
               delivered=delivered_tuples_of(rec["payloads"], engine))
    return rec


def delivered_tuples_of(payloads: list, engine) -> list:
    from binquant_tpu_torch.io.replay import delivered_tuples

    return [t + (float(p.score),) for t, p in zip(delivered_tuples(payloads, engine.tracer),
                                                  payloads)]


def _family_changes(before: dict, after: dict) -> set:
    """Families with a sample that is new or moved between two scrapes."""
    nan = {"NaN"}
    out = set()
    for fam, samples in after.items():
        old = before.get(fam, {})
        for key, value in samples.items():
            if key not in old or (old[key] != value and not {old[key], value} <= nan):
                out.add(fam)
                break
    return out


def check_live(card: str = "cuda") -> dict:
    """``[slice live]``: the port's ``run_live`` as a KuCoin futures
    deployment at S symbols, W bars, booted cold three times over fakes of
    every network client (see :func:`live_boot`), each backfill in one
    flush: on the card with the open-interest feed, on the card without it
    (``futures_api=None``) and on the CPU with it. Checks: every closed candle frame put exactly one kline
    on the queue, equal to its bar, unclosed ones none; the malformed frame
    and the dropped connection counted; the card's delivered signals equal
    the CPU's (fired set exact, scores at the wire contract); the open
    interest vetoes at least one LiquidationSweepPump row that fired
    without it (each a symbol growing under 1.02) and scales at least one
    by its growth; no tick made an open-interest request; /metrics carries
    every C3 and websocket family, and the card's changed families equal
    the CPU's; qtail launches by site per tick equal the CPU twin's calls,
    every launch equal to the twin."""
    from binquant_tpu_torch.ops import quantile_tail as qt

    cuda = card == "cuda"
    lm5, lm15 = make_live_market(np.random.default_rng(SEED + 5))
    bursts = live_bursts(lm5, lm15)
    history = live_history(lm5, lm15, LIVE11_HISTORY)
    bars = S * (LIVE11_HISTORY + min(3 * LIVE11_HISTORY, 400))
    checks: list = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        qt.reset_launches()  # launches made elsewhere do not count
        with _twin_checked(checks) if cuda else contextlib.nullcontext():
            a = live_boot(card, history, bursts, tmp, "oi", backfill_chunk=S)
        launches, n_launches = dict(qt.launches_by_site), qt.launches
        b = live_boot(card, history, bursts, tmp, "no_oi", oi=False, backfill_chunk=S,
                      ticks=LIVE11_SHORT)
        qt.reset_launches()
        c = live_boot("cpu", history, bursts, tmp, "cpu", backfill_chunk=S,
                      ticks=LIVE11_SHORT)
    if cuda and (not checks or not all(eq for *_, eq in checks)):
        fail(f"[slice live] qtail launches unequal to the twin: {checks}")
    for run, label in ((a, "card"), (b, "card without open interest"), (c, "cpu")):
        if run["parse_errors"] != 1 or run["reconnects"] != 1:
            fail(f"[slice live] {label}: {run['parse_errors']} parse errors and "
                 f"{run['reconnects']} reconnects counted, expected 1 and 1")
        if any(run["tick_oi_calls"]) or run["loop_calls"]:
            fail(f"[slice live] {label}: open-interest requests on the tick path "
                 f"{run['tick_oi_calls']}, on the loop {run['loop_calls']}")
        if run["backfill"]["bars"] != bars or run["backfill"]["fetches_failed"]:
            fail(f"[slice live] {label}: backfill {run['backfill']}")
    want_paths = ["cold_start"] + ["audit" if t % LIVE11_AUDIT == 0 else "incremental"
                                   for t in range(1, LIVE11_TICKS)]
    for run, label in ((a, "card"), (b, "card without open interest"), (c, "cpu")):
        if run["paths"] != want_paths[: len(run["paths"])]:
            fail(f"[slice live] {label} routing {run['paths']}, expected {want_paths}")
    short = LIVE11_SHORT
    if a["sites"][:short] != c["sites"] or a["overflowed"][:short] != c["overflowed"]:
        fail(f"[slice live] qtail calls by site per tick: card {a['sites']} "
             f"cpu {c['sites']} (overflowed {a['overflowed']} / {c['overflowed']})")
    for p, ov, sites in zip(a["paths"], a["overflowed"], a["sites"]):
        want = dict(EXPECT_SITES[p])
        for k2, v in (_expected_sites(p, dormant=True) if ov else {}).items():
            want[k2] = want.get(k2, 0) + v
        if sites != want:
            fail(f"[slice live] qtail launches by site {a['sites']} on paths {a['paths']}")
    # the card's delivered signals vs the CPU's
    t_short = (T_LIVE0 + 900 * LIVE11_SHORT) * 1000  # the CPU's last tick
    da = sorted(t for t in a["delivered"] if t[0] <= t_short)
    dc = sorted(c["delivered"])
    if [t[:5] for t in da] != [t[:5] for t in dc]:
        fail(f"[slice live] delivered signals differ: card {len(da)} cpu {len(dc)}")
    if not all(np.isclose(x[5], y[5], rtol=1e-4, atol=1e-5) for x, y in zip(da, dc)):
        fail("[slice live] delivered scores differ beyond the wire contract")
    # the open-interest gate
    lsp = "liquidation_sweep_pump"
    growth_of = {name: OI_GROWTH[i % 3] for i, name in enumerate(live_symbols())}
    oi_l = {(t[0], t[2]): t[3] for t in a["fired"] if t[1] == lsp and t[0] <= t_short}
    if any(t[1] == lsp for t in a["fired"] if t[0] > t_short):
        fail("[slice live] LSP fired after the ticks the other boots cover")
    no_l = {(t[0], t[2]): t[3] for t in b["fired"] if t[1] == lsp}
    stale = live_symbols()[OI_STALE]
    vetoed = sorted(set(no_l) - set(oi_l))
    extra = sorted(set(oi_l) - set(no_l))
    scaled = []
    for key in set(oi_l) & set(no_l):
        tick_k = (key[0] // 1000 - T_LIVE0) // 900
        g = growth_of[key[1]]
        if key[1] == stale and tick_k >= OI_STALE_FROM:
            g = 1.0
        if not np.isclose(oi_l[key], no_l[key] * max(g, 1.0), rtol=1e-4, atol=1e-5):
            fail(f"[slice live] LSP score of {key}: {oi_l[key]} with open interest, "
                 f"{no_l[key]} without, growth {g}")
        if g > 1.0:
            scaled.append(key)
    bad_veto = [k2 for k2 in vetoed if growth_of[k2[1]] >= 1.02
                or (k2[1] == stale and (k2[0] // 1000 - T_LIVE0) // 900 >= OI_STALE_FROM)]
    if len(no_l) < 24 or not vetoed or not scaled or extra or bad_veto:
        fail(f"[slice live] the open-interest gate: LSP fired {len(no_l)} rows without it, "
             f"{len(oi_l)} with it; vetoed {len(vetoed)} (growth >= 1.02: {bad_veto}), "
             f"scaled {len(scaled)}, fired only with it {extra}")
    # /metrics families
    fams_a = _metric_samples(a["metrics"])
    typed = {line.split()[2] for line in a["metrics"].splitlines() if line.startswith("# TYPE ")}
    # every family rendered, and with samples but the alarm counter (no
    # alarm on a clean stream: its labeled children never exist)
    missing = [f for f in C3_FAMILIES + WS_FAMILIES if f not in typed or (
        not fams_a.get(f) and f != "bqt_carry_drift_alarms_total")]
    if missing:
        fail(f"[slice live] /metrics lacks {missing}")
    changed_a = _family_changes(a["before"], _metric_samples(a["metrics_short"]))
    changed_c = _family_changes(c["before"], _metric_samples(c["metrics_short"]))
    if changed_a != changed_c:
        fail(f"[slice live] families set by the card run {sorted(changed_a - changed_c)} "
             f"but not the cpu's; by the cpu's only {sorted(changed_c - changed_a)}")
    frames = sum(a["frames"])
    parse_rate = [f / t for f, t in zip(a["frames"][1:], a["parse_s"]) if t > 0]
    incr_ms = [t for t, p in zip(a["tick_ms"], a["paths"]) if p == "incremental"]
    sweeps = a["oi_sweeps"]
    result = {
        "routing": a["paths"],
        "overflowed": a["overflowed"],
        "launches": n_launches,
        "launches_by_site": launches,
        "launches_by_tick": a["sites"],
        "twin_checked": len(checks),
        "connections": a["connections"],
        "frames": frames,
        "klines_per_tick": a["ingested"],
        "frames_per_s_p50": _p(parse_rate, 50),
        "parse_errors": a["parse_errors"],
        "reconnects": a["reconnects"],
        "token_fetches": a["token_fetches"],
        "pings": a["pings"],
        "signals": len(da),
        "signals_card_all": len(a["delivered"]),
        "signals_cpu": len(dc),
        "lsp": {"fired_without_oi": len(no_l), "fired_with_oi": len(oi_l),
                "vetoed": len(vetoed), "scaled": len(scaled)},
        "oi_requests_per_sweep": [s[0] for s in sweeps],
        "oi_calls_per_sweep": [s[1] for s in sweeps],
        "tick_path_oi_calls": sum(a["tick_oi_calls"]),
        "backfill": {"card": a["backfill"], "card_one_flush": b["backfill"], "cpu": c["backfill"]},
        "ready_s": {"card": a["ready_s"], "card_one_flush": b["ready_s"], "cpu": c["ready_s"]},
        "first_tick_ms": a["tick_ms"][0],
        "first_signal_tick": a["first_signal_tick"],
        "boot_to_first_signal_s": a.get("boot_to_first_signal_s"),
        "tick_ms": a["tick_ms"],
        "incremental_tick_p50_ms": _p(incr_ms, 50) if incr_ms else None,
        "cpu_tick_ms": c["tick_ms"],
        "changed_families": len(changed_a),
    }
    print(
        f"[slice live] S={S} W={W}: run_live booted cold as a KuCoin futures deployment over "
        f"fakes ({a['connections']} websocket connections, {a['token_fetches']} bullet "
        f"fetches, {a['pings']} pings); backfill {a['backfill']['bars']} bars in one flush "
        f"{a['backfill']['seconds']:.2f} s (card without open interest "
        f"{b['backfill']['seconds']:.2f} s, cpu {c['backfill']['seconds']:.2f} s); boot to "
        f"ready {a['ready_s']:.2f} s; first tick {a['tick_ms'][0]:.1f} ms queue to emitted; "
        f"boot to the first signal {result['boot_to_first_signal_s']} s (tick "
        f"{a['first_signal_tick']}); routing {a['paths']}"
    )
    print(
        f"[slice live] {frames} frames, {result['frames_per_s_p50']:.0f} frames/s parsed (p50 "
        f"over bursts), klines per tick {a['ingested']} all equal to their bars, "
        f"1 parse error and 1 reconnect counted; incremental tick p50 "
        f"{result['incremental_tick_p50_ms']} ms through the connector; {len(da)} delivered "
        f"signals equal to the cpu's (scores at the wire contract); LSP fired "
        f"{len(no_l)} rows without open interest, {len(oi_l)} with it: {len(vetoed)} vetoed "
        f"(growth 1.01), {len(scaled)} scaled by their growth; open-interest requests per "
        f"sweep {result['oi_requests_per_sweep']}, 0 on the tick path; qtail {n_launches} "
        f"{launches}, {len(checks)} held to the twin; {len(changed_a)} metric families set, "
        f"the cpu's the same"
    )
    return result


# -- phase 12: the scenario engine, the chaos drills and the soak ----------

SCN_WIDE = "rewrite_storm"  # part A's family, at S symbols and W bars


def scenario_tick_sites(incremental: bool, path: str, overflowed: bool) -> dict:
    """qtail calls by site one serial tick of a corpus engine makes: 1 at
    ``abp_core`` on a classic engine; on an incremental engine 2 on a full
    tick (``abp_core`` and ``abp_init_from_window``: cold start, rewrite,
    churn, audit, a restore) and none on an incremental one. An overflowed
    tick's fallback re-runs the tick's path evaluating every strategy, so
    its calls are doubled and the spike detector's added."""
    if not incremental:
        want = {"abp_core": 1}
    elif path == "incremental":
        want = {}
    else:
        want = {"abp_core": 1, "abp_init_from_window": 1}
    if overflowed:
        want = {k: 2 * v for k, v in want.items()}
        want["detect_spikes"] = 1
    return want


class CorpusRecorder:
    """Records every engine ``sim.runner.corpus_engine`` builds while it is
    installed (the corpus drives, the drills and the soak build theirs
    there): per serial tick (``process_tick``, which every serial tick, a
    chunk-breaking one and an overflow re-drive go through) its time, path,
    overflow and qtail calls by site; per scanned chunk its ms and calls;
    the indicators of every fired signal; the peak device memory of each
    ``drive_scenario`` above what was allocated once its engine was built;
    and the seconds ``write_scenario_file`` and ``tick_seq`` took."""

    def __init__(self, cuda: bool) -> None:
        self.cuda = cuda
        self.engines: list[dict] = []
        self.drives: list[dict] = []
        self.gen_s: list[float] = []
        self.parse_s: list[float] = []
        self.indicators: dict = {}

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def __enter__(self) -> "CorpusRecorder":
        from binquant_tpu_torch.sim import runner

        self._saved = {k: getattr(runner, k) for k in (
            "corpus_engine", "drive_scenario", "write_scenario_file", "tick_seq")}
        saved = self._saved

        def build(**knobs):
            import torch

            engine = saved["corpus_engine"](**knobs)
            rec = {"incremental": engine.incremental, "ticks": [], "chunks": [],
                   "base": None}
            self._wrap(engine, rec)
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                rec["base"] = torch.cuda.memory_allocated()
            self.engines.append(rec)
            return engine

        def drive_scenario(scenario, path, *, scanned, incremental, device="cuda"):
            import torch

            t0 = time.perf_counter()
            out = saved["drive_scenario"](scenario, path, scanned=scanned,
                                          incremental=incremental, device=device)
            self._sync()
            rec = self.engines[-1]
            self.drives.append({
                "drive": "scanned" if scanned else ("serial" if incremental else "classic"),
                "engine": rec, "wall_s": time.perf_counter() - t0,
                "peak_above_bytes": (torch.cuda.max_memory_allocated() - rec["base"])
                if self.cuda else None,
            })
            return out

        def timed(name, sink):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = saved[name](*args, **kwargs)
                sink.append(time.perf_counter() - t0)
                return out
            return call

        runner.corpus_engine = build
        runner.drive_scenario = drive_scenario
        runner.write_scenario_file = timed("write_scenario_file", self.gen_s)
        runner.tick_seq = timed("tick_seq", self.parse_s)
        return self

    def __exit__(self, *exc) -> None:
        from binquant_tpu_torch.sim import runner

        for k, v in self._saved.items():
            setattr(runner, k, v)

    def _wrap(self, engine, rec: dict) -> None:
        from binquant_tpu_torch.io.replay import signal_tuples

        process_tick, flush = engine.process_tick, engine._flush_scan_plan

        def keep(fired) -> None:
            for sig, tup in zip(fired, signal_tuples(fired)):
                self.indicators[tup] = sig.analytics.get("indicators") or {}

        async def tick(now_ms=None):
            self._sync()
            before, overflows = _qtail_sites(self.cuda), engine.overflow_ticks
            t0 = time.perf_counter()
            fired = await process_tick(now_ms=now_ms)
            self._sync()
            rec["ticks"].append({
                "now_ms": now_ms, "ms": (time.perf_counter() - t0) * 1000.0,
                "path": engine.last_path, "overflowed": engine.overflow_ticks > overflows,
                "sites": _sites_since(before, self.cuda),
            })
            keep(fired)
            return fired

        async def chunk(plan):
            self._sync()
            before = _qtail_sites(self.cuda)
            t0 = time.perf_counter()
            fired = await flush(plan)
            self._sync()
            rec["chunks"].append({"ticks": len(plan["ticks"]),
                                  "ms": (time.perf_counter() - t0) * 1000.0,
                                  "sites": _sites_since(before, self.cuda)})
            keep(fired)
            return fired

        engine.process_tick = tick
        engine._flush_scan_plan = chunk


def _add_sites(total: dict, sites: dict) -> dict:
    for k, v in sites.items():
        total[k] = total.get(k, 0) + v
    return total


def check_corpus_launches(rec: CorpusRecorder, label: str) -> dict:
    """Every recorded serial tick made exactly the qtail calls
    :func:`scenario_tick_sites` gives for its path; a scanned chunk makes
    none of its own (its overflow re-drive's ticks are serial ticks).
    Returns the calls by site over the recorded ticks."""
    total: dict = {}
    for e in rec.engines:
        for t in e["ticks"]:
            want = scenario_tick_sites(e["incremental"], t["path"], t["overflowed"])
            if t["sites"] != want:
                fail(f"{label}: a {t['path']} tick (overflowed {t['overflowed']}) made qtail "
                     f"calls {t['sites']}, expected {want}")
            _add_sites(total, t["sites"])
    return total


def _flip_report(name: str, got: list, pinned: list, indicators: dict) -> tuple[int, list]:
    """Signals the card's set and the pinned set disagree on: (flips inside
    the declared gate margins, the others). A flip the card fired is judged
    by its payload's gated indicator; one only the pins hold has no card
    payload and counts as outside."""
    from binquant_tpu_torch.strategies.params import declared_gate_margins

    margins = declared_gate_margins()
    inside, outside = 0, []
    for f in sorted(set(map(tuple, got)) ^ set(map(tuple, pinned))):
        ind = indicators.get(tuple(f))
        side = "the card" if ind is not None else "the pins"
        print(f"[slice scenarios] {name}: flip {f} held by {side} only, gated indicators "
              f"{{rsi: {(ind or {}).get('rsi')}, mfi: {(ind or {}).get('mfi')}}}")
        if ind is not None and _gated_flip_ok(tuple(f), ind, margins):
            inside += 1
        else:
            outside.append(tuple(f))
    return inside, outside


def _tick_stats(ticks: list) -> dict:
    ms = [t["ms"] for t in ticks]
    return {"ticks": len(ms), "p50_ms": _p(ms, 50) if ms else None,
            "p99_ms": _p(ms, 99) if ms else None}


def scenario_wide(card: str, workdir: Path) -> dict:
    """Part A: ``rewrite_storm`` at S symbols and W bars (its own 112 ticks,
    seed 29, chunks of 32) through ``run_spec``: the three drives' fired
    sets equal, routing exactly {cold_start, rewrite} with rewrite >= 6 and
    equal between the serial and the scanned drive, every invariant of the
    runner green but the overflow script, which at this width is counted:
    the scanned drive must overflow on the serial drive's overflowing ticks,
    re-driving them. qtail calls per tick by path; each held against the
    twin."""
    import dataclasses

    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.sim import runner
    from binquant_tpu_torch.sim.scenarios import SCENARIOS, Scenario

    cuda = card == "cuda"
    base = SCENARIOS[SCN_WIDE]
    spec = dataclasses.replace(base.spec, n_symbols=S, capacity=S, window=W)
    checks: list = []
    qt.reset_launches()
    with CorpusRecorder(cuda) as rec, _twin_checked(checks, on_host=True):
        verdict = runner.run_spec(Scenario(spec=spec, build=base.build), workdir, device=card)
    launches = qt.launches
    by_site = _qtail_sites(cuda)
    failed = sorted(k for k, v in verdict["checks"].items() if not v and k != "overflow_script")
    if failed:
        fail(f"[slice scenarios] {SCN_WIDE} at S={S} W={W}: checks failed: {failed}")
    routing = verdict["routing"]
    if set(routing) != {"cold_start", "rewrite"} or routing["rewrite"] < 6:
        fail(f"[slice scenarios] {SCN_WIDE}: routing {routing}")
    drives = {d["drive"]: d for d in rec.drives}
    serial, scanned = drives["serial"]["engine"], drives["scanned"]["engine"]
    over = {k: sorted(t["now_ms"] for t in d["engine"]["ticks"] if t["overflowed"])
            for k, d in drives.items()}
    if over["scanned"] != over["serial"]:
        fail(f"[slice scenarios] {SCN_WIDE}: overflowing ticks, serial {over['serial']} vs the "
             f"scanned drive's re-drives {over['scanned']}")
    recorded = check_corpus_launches(rec, f"[slice scenarios] {SCN_WIDE}")
    if recorded != by_site:
        fail(f"[slice scenarios] {SCN_WIDE}: qtail calls {by_site}, the ticks' own {recorded}")
    if cuda and (not checks or len(checks) != launches) or not all(eq for *_, eq in checks):
        fail(f"[slice scenarios] {SCN_WIDE}: {launches} qtail launches, {len(checks)} held "
             f"against the twin, {sum(not eq for *_, eq in checks)} differing")
    per_drive = {}
    for k, d in drives.items():
        e = d["engine"]
        sites: dict = {}
        for t in e["ticks"]:
            _add_sites(sites, t["sites"])
        full = [t for t in e["ticks"] if t["path"] != "incremental"]
        incr = [t for t in e["ticks"] if t["path"] == "incremental"]
        per_drive[k] = {
            "wall_s": d["wall_s"], "serial_ticks": _tick_stats(e["ticks"]),
            "full_ticks": _tick_stats(full), "incremental_ticks": _tick_stats(incr),
            "chunk_ms": [c["ms"] for c in e["chunks"]],
            "chunk_ticks": [c["ticks"] for c in e["chunks"]],
            "overflow_ticks": len(over[k]), "peak_above_bytes": d["peak_above_bytes"],
            "launches_by_site": sites,
        }
    result = {
        "launches": launches, "launches_by_site": by_site, "twin_checked": len(checks),
        "signals": verdict["signals"], "routing": routing, "lines": verdict["lines"],
        "gen_s": rec.gen_s, "parse_s": rec.parse_s, "drives": per_drive,
        "checks": verdict["checks"],
    }
    sd = per_drive
    print(f"[slice scenarios] {SCN_WIDE} at S={S} W={W}: {verdict['lines']} lines generated in "
          f"{rec.gen_s[0]:.1f} s, parsed in {[round(x, 1) for x in rec.parse_s]} s (one per "
          f"drive); {verdict['signals']} signals, the three fired sets equal; routing {routing} "
          f"(serial = scanned); overflow ticks serial/scanned/classic "
          f"{[sd[k]['overflow_ticks'] for k in ('serial', 'scanned', 'classic')]} (each re-driven "
          f"by the scanned drive); every runner check green but the overflow script")
    for k in ("serial", "scanned", "classic"):
        d = sd[k]
        print(f"[slice scenarios]   {k}: {d['wall_s']:.1f} s; serial ticks {d['serial_ticks']}; "
              f"full {d['full_ticks']['p50_ms']}, incremental {d['incremental_ticks']['p50_ms']} "
              f"ms p50; chunks {d['chunk_ticks']} in {[round(x, 1) for x in d['chunk_ms']]} ms; "
              f"peak above the resident state {_mib(d['peak_above_bytes'])} MiB; qtail "
              f"{d['launches_by_site']}")
    print(f"[slice scenarios]   qtail {launches} launches {by_site}, each equal to its twin "
          f"({len(checks)} checked)")
    return result


def scenario_corpus(card: str, workdir: Path) -> dict:
    """Part B: the corpus at its own shapes (``run_corpus(include_slow=False,
    chaos=True)``): every scenario's checks green and its signal set equal
    to its pinned set but for flips inside the declared gate margins
    (counted, printed); the three drills ok."""
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.sim import runner

    cuda = card == "cuda"
    pinned = runner.load_pinned()
    if pinned is None:
        fail("[slice scenarios] the pinned corpus tests/fixtures/scenario_signals.json is missing")
    checks: list = []
    qt.reset_launches()
    t0 = time.perf_counter()
    with CorpusRecorder(cuda) as rec, _twin_checked(checks, on_host=True):
        verdicts = runner.run_corpus(include_slow=False, chaos=True, workdir=workdir,
                                     device=card)
    wall = time.perf_counter() - t0
    launches, by_site = qt.launches, _qtail_sites(cuda)
    recorded = check_corpus_launches(rec, "[slice scenarios] corpus")
    if recorded != by_site:
        fail(f"[slice scenarios] corpus: qtail calls {by_site}, the ticks' own {recorded}")
    if cuda and (not checks or len(checks) != launches) or not all(eq for *_, eq in checks):
        fail(f"[slice scenarios] corpus: {launches} qtail launches, {len(checks)} held against "
             f"the twin, {sum(not eq for *_, eq in checks)} differing")
    flips_inside = 0
    rows = []
    for v in verdicts:
        print(f"[slice scenarios] {runner.render_verdict(v)}")
        name = v["scenario"]
        if "signal_set" in v:
            inside, outside = _flip_report(name, v["signal_set"], pinned[name]["signals"],
                                           rec.indicators)
            flips_inside += inside
            if outside:
                fail(f"[slice scenarios] {name}: signal set differs from the pins outside the "
                     f"declared gate margins: {outside}")
            failed = sorted(k for k, ok in v["checks"].items()
                            if not ok and not (k == "pinned_signal_set" and inside))
        else:
            print(f"[slice scenarios]   {name} checks {v['checks']}")
            failed = sorted(k for k, ok in v["checks"].items() if not ok)
        if failed:
            fail(f"[slice scenarios] {name}: checks failed: {failed}")
        rows.append({k: v.get(k) for k in ("scenario", "ok", "signals", "ticks", "routing")})
    result = {"launches": launches, "launches_by_site": by_site, "twin_checked": len(checks),
              "wall_s": wall, "flips_inside_margins": flips_inside, "runs": rows,
              "drive_wall_s": [round(d["wall_s"], 2) for d in rec.drives]}
    print(f"[slice scenarios] corpus: {len(verdicts) - 3} scenarios x 3 drives and 3 drills in "
          f"{wall:.1f} s, every signal set equal to its pins ({flips_inside} flips inside the "
          f"gate margins); qtail {launches} launches {by_site}, each equal to its twin")
    return result


def scenario_soak(card: str, workdir: Path) -> dict:
    """Part C: ``soak_drill(full=False)``: the verdict ok, every fault
    window attributed and none vacuous, zero autotrade loss and no
    duplicate ack across the kill, the resumed run's signals equal to the
    oracle's. Prints the victim's wall time and the close→ack p99 per
    sink."""
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.soak import drill

    cuda = card == "cuda"
    checks: list = []
    qt.reset_launches()
    ext_sites: dict = {}
    ext = drill._ext_parity

    def counted_ext(*args, **kwargs):
        before = _qtail_sites(cuda)
        out = ext(*args, **kwargs)
        _add_sites(ext_sites, _sites_since(before, cuda))
        return out

    drill._ext_parity = counted_ext
    try:
        with CorpusRecorder(cuda) as rec, _twin_checked(checks, on_host=True):
            facts = drill.soak_drill(workdir=str(workdir), full=False, device=card)
    finally:
        drill._ext_parity = ext
    launches, by_site = qt.launches, _qtail_sites(cuda)
    recorded = check_corpus_launches(rec, "[slice scenarios] soak")
    if _add_sites(dict(recorded), ext_sites) != by_site:
        fail(f"[slice scenarios] soak: qtail calls {by_site}, the ticks' own {recorded} and the "
             f"ext-parity backtests' {ext_sites}")
    if cuda and (not checks or len(checks) != launches) or not all(eq for *_, eq in checks):
        fail(f"[slice scenarios] soak: {launches} qtail launches, {len(checks)} held against "
             f"the twin, {sum(not eq for *_, eq in checks)} differing")
    verdict = facts["verdict"]
    vacuous = verdict["non_vacuity_failures"]
    untripped = [f["name"] for f in verdict["faults"] if not f["non_vacuous"]]
    if not facts["ok"] or not verdict["ok"] or vacuous or untripped or verdict["unattributed"]:
        fail(f"[slice scenarios] soak: ok {facts['ok']}, verdict {verdict['ok']}, checks "
             f"{facts['checks']}, vacuous {vacuous}, unattributed {verdict['unattributed']}, "
             f"burning {verdict['burning_at_end']}")
    for k in ("zero_loss", "zero_duplicate", "signal_parity", "kill_left_unacked_wal",
              "wal_replayed"):
        if not facts["checks"][k]:
            fail(f"[slice scenarios] soak: {k} failed")
    result = {
        "launches": launches, "launches_by_site": by_site, "twin_checked": len(checks),
        "ext_parity_sites": ext_sites, "checks": facts["checks"],
        "victim_wall_s": facts["victim_wall_s"], "resumed_wall_s": facts["resumed_wall_s"],
        "victim_p99_ms": facts["victim_p99"], "resumed_p99_ms": facts.get("resumed_p99"),
        "episodes": len(verdict["episodes"]), "faults": len(verdict["faults"]),
        "unacked_at_kill": facts["unacked_at_kill"], "wal_replayed": facts["wal_replayed"],
        "candles_per_s": facts["candles_per_s"],
    }
    print(f"[slice scenarios] soak: verdict ok, {len(verdict['faults'])} fault windows all "
          f"attributed and non-vacuous, {len(verdict['episodes'])} episodes; zero autotrade loss, "
          f"no duplicate ack across the kill ({facts['unacked_at_kill']} unacked at the kill, "
          f"{facts['wal_replayed']} replayed); the resumed signals equal the oracle's; victim "
          f"{facts['victim_wall_s']:.1f} s, resumed {facts['resumed_wall_s']:.1f} s; close→ack "
          f"p99 ms victim {facts['victim_p99']}, resumed {facts.get('resumed_p99')}; qtail "
          f"{launches} launches {by_site} (the ext-parity backtests {ext_sites}), each equal to "
          f"its twin")
    return result


SCENARIO_PARTS = {"wide": scenario_wide, "corpus": scenario_corpus, "soak": scenario_soak}


def check_scenarios(names: tuple, card: str = "cuda") -> dict:
    """Phase 12 (``[slice scenarios]``): the named parts of A (``wide``), B
    (``corpus``) and C (``soak``), in a temporary directory of their own.
    Returns their results, the launches summed."""
    (ROOT / "build").mkdir(exist_ok=True)
    parts = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name in names:
            t0 = time.perf_counter()
            parts[name] = SCENARIO_PARTS[name](card, Path(tmp) / name)
            parts[name]["seconds"] = time.perf_counter() - t0
            shutil.rmtree(Path(tmp) / name, ignore_errors=True)
            torch_empty_cache()
    by_site: dict = {}
    for p in parts.values():
        _add_sites(by_site, p["launches_by_site"])
    return {"launches": sum(p["launches"] for p in parts.values()), "launches_by_site": by_site,
            **parts}


# --------------------------------------------------------------------------
# phase 13: the per-symbol oracle and the A/B check
# --------------------------------------------------------------------------

AB_CAPACITY, AB_WINDOW = 64, 200  # the reference's A/B fixtures' engine shape
# the seed-7 A/B fixture's washed-out breadth: LSP's LONG route and the
# grid-only policy open, so all five live strategies fire
WASHED_BREADTH = {
    "timestamp": [1, 2, 3],
    "market_breadth": [-0.50, -0.47, -0.44],
    "market_breadth_ma": [-0.50, -0.46],
}


def ab_cases() -> dict:
    """The reference's four A/B fixtures (``tests/test_ab_parity.py``): the
    fixture file each replays and ``run_replay_ab``'s arguments."""
    from binquant_tpu_torch.oracle import DORMANT_ORACLE_EXTENDED, DORMANT_ORACLE_STRATEGIES

    return {
        "seed7": ("replay", dict(incremental=True, donate=True)),
        "seed7_washed": ("replay", dict(breadth=WASHED_BREADTH, incremental=True, donate=True)),
        "dormant": ("dormant", dict(enabled_strategies=set(DORMANT_ORACLE_STRATEGIES))),
        "dormant_extended": ("extended", dict(
            enabled_strategies=set(DORMANT_ORACLE_EXTENDED), breadth=RISING_BREADTH,
            dominance_is_losers=True, market_domination_reversal=True,
        )),
    }


def ab_files(workdir: Path) -> dict:
    """The three fixture files of :func:`ab_cases`, written to ``workdir``."""
    from binquant_tpu_torch.io import replay

    workdir.mkdir(parents=True, exist_ok=True)
    files = {name: workdir / f"{name}.jsonl" for name in ("replay", "dormant", "extended")}
    replay.generate_replay_file(files["replay"], n_symbols=24, n_ticks=120, seed=7)
    replay.generate_dormant_replay(files["dormant"])
    replay.generate_dormant_extended_replay(files["extended"])
    return files


def timed_oracle(path: Path, kw: dict) -> tuple[list, float]:
    """One fixture through ``run_replay_oracle`` (the oracle arm's own
    arguments of ``kw``) and its seconds."""
    from binquant_tpu_torch.io import replay

    t0 = time.perf_counter()
    kw = {k: v for k, v in kw.items() if k not in ("incremental", "donate")}
    return replay.run_replay_oracle(path, window=AB_WINDOW, **kw), time.perf_counter() - t0


def oracle_ab(card: str, files: dict, oracles: dict) -> dict:
    """Part A: ``run_replay_ab`` on the four A/B fixtures, the engine arm on
    ``card`` at the fixtures' 64 rows and 200 bars, the oracle arm the
    precomputed run in ``oracles`` (futures of :func:`timed_oracle`): the
    sets equal and non-empty, the breadth run firing all five live
    strategies and each dormant run its whole set, the seed-7 engines
    taking incremental ticks, every qtail call held against the twin."""
    from binquant_tpu_torch.io import replay
    from binquant_tpu_torch.oracle import LIVE_STRATEGIES

    cuda = card == "cuda"
    out: dict = {}
    by_site: dict = {}
    for name, (file, kw) in ab_cases().items():
        oracle, oracle_s = oracles[name].result()
        checks: list = []
        before = _qtail_sites(cuda)
        t0 = time.perf_counter()
        with _twin_checked(checks, on_host=True):
            res = replay.run_replay_ab(files[file], capacity=AB_CAPACITY, window=AB_WINDOW,
                                       oracle_signals=oracle, device=card, **kw)
        engine_s = time.perf_counter() - t0
        sites = _sites_since(before, cuda)
        _add_sites(by_site, sites)
        stats = res["tpu_stats"]
        label = f"[slice oracle] A {name}"
        if not res["match"]:
            fail(f"{label}: the engine and the oracle differ: engine only "
                 f"{res['only_tpu'][:5]}, oracle only {res['only_oracle'][:5]}")
        if res["tpu_count"] == 0:
            fail(f"{label}: nothing fired; the match would be vacuous")
        # the breadth run fires the live set, each dormant run its whole set
        want = (sorted(LIVE_STRATEGIES) if name == "seed7_washed"
                else sorted(kw.get("enabled_strategies") or []) or None)
        if want is not None and res["strategies"] != want:
            fail(f"{label}: strategies fired {res['strategies']}, expected {want}")
        if name.startswith("seed7") and stats["incremental_ticks"] == 0:
            fail(f"{label}: the engine took no incremental tick")
        need = {"detect_spikes"} if name == "dormant_extended" else (
            {"abp_core", "abp_init_from_window"} if name.startswith("seed7") else set())
        if not need <= set(sites):
            fail(f"{label}: qtail calls by site {sites}, missing {sorted(need - set(sites))}")
        if len(checks) != sum(sites.values()) or not all(c[3] for c in checks):
            fail(f"{label}: {len(checks)} twin checks for {sum(sites.values())} qtail calls, "
                 f"{sum(not c[3] for c in checks)} unequal")
        out[name] = {
            "signals": res["tpu_count"], "strategies": res["strategies"],
            "ticks": stats["ticks"], "incremental_ticks": stats["incremental_ticks"],
            "full_recompute_ticks": stats["full_recompute_ticks"],
            "engine_s": engine_s, "engine_tick_p50_ms": stats["tick_p50_ms"],
            "oracle_s": oracle_s, "qtail_by_site": sites, "twin_checks": len(checks),
        }
        print(f"{label}: match True, {res['tpu_count']} signals {res['strategies']}; engine "
              f"{stats['ticks']} ticks ({stats['incremental_ticks']} incremental, "
              f"{stats['full_recompute_ticks']} full) in {engine_s:.1f} s, tick p50 "
              f"{stats['tick_p50_ms']:.1f} ms; oracle {oracle_s:.2f} s; qtail {sites}, each "
              f"equal to its twin", flush=True)
    return {"launches": sum(by_site.values()) if cuda else 0,
            "launches_by_site": by_site if cuda else {}, "cases": out}


def warm_klines(m5: dict, m15: dict):
    """The warm history as the kline dicts the oracle reads, holding the
    values the engine's rings hold (the float32 planes :func:`queue_warm`
    adds): the 15m bars, then the 5m bars, bar by bar over the symbols."""
    names = symbols()
    n5 = min(3 * W, W)
    for m, cols, interval, t0 in (
        (m15, slice(0, W), 900, T_LIVE0 - 900 * W),
        (m5, slice(3 * W - n5, 3 * W), 300, T_LIVE0 - 300 * n5),
    ):
        planes = bar_values(m, cols, interval)
        for k in range(planes.shape[1]):
            ts = t0 + interval * k
            for name, v in zip(names, planes[:, k, :7].tolist()):
                yield {
                    "symbol": name, "open_time": ts * 1000,
                    "close_time": (ts + interval) * 1000 - 1,
                    "open": v[0], "high": v[1], "low": v[2], "close": v[3], "volume": v[4],
                    "quote_asset_volume": v[5], "number_of_trades": v[6],
                }


def oracle_stream(s: int, w: int) -> dict:
    """Part B's oracle arm: phase 3's market at ``s`` symbols and ``w`` bars
    (made anew from the seed), its warm history ingested as kline dicts,
    then the warm tick and CLASSIC_TICKS live ticks evaluated (window ``w``,
    the engine's default context gates). Returns the fired tuples, the
    ingest seconds and the ms of each tick."""
    from binquant_tpu_torch.io.replay import drive_oracle
    from binquant_tpu_torch.oracle import OracleEvaluator
    from binquant_tpu_torch.regime.context import ContextConfig

    global S, W
    S, W = s, w  # this may run in a process of its own
    m5, m15 = make_market(np.random.default_rng(SEED), live_ticks=CLASSIC_TICKS)
    cc = ContextConfig()
    oracle = OracleEvaluator(window=W, required_fresh_symbols=cc.required_fresh_symbols,
                             min_coverage_ratio=cc.min_coverage_ratio, is_futures=True)
    t0 = time.perf_counter()
    n_warm = 0
    for k in warm_klines(m5, m15):
        oracle.ingest(k)
        n_warm += 1
    ingest_s = time.perf_counter() - t0
    ticks = [(T_LIVE0 * 1000, [])] + live_ticks_of(m5, m15, CLASSIC_TICKS)
    stamps: list = []

    def timed(seq):
        for tick in seq:
            stamps.append(time.perf_counter())
            yield tick
        stamps.append(time.perf_counter())

    fired = drive_oracle(oracle, timed(ticks))
    return {"fired": fired, "warm_klines": n_warm, "ingest_s": ingest_s,
            "tick_ms": (np.diff(stamps) * 1000.0).tolist()}


def _oracle_gates(m5: dict, m15: dict, flip: tuple, ticks: list) -> dict:
    """The gated RSI and MFI the oracle read for a row it fired and the card
    did not (no card payload exists for it): rebuilt from the bars the
    oracle held at that tick, by the oracle's own formulas."""
    from types import SimpleNamespace

    from binquant_tpu_torch.oracle import evaluator as ev
    from binquant_tpu_torch.oracle import frame as F

    tick = [t for t, _ in ticks].index(flip[0])
    row = symbols().index(flip[2])
    five = flip[1] in ("coinrule_price_tracker", "inverse_price_tracker")
    m, interval, per = (m5, 300, 3) if five else (m15, 900, 1)
    warm = bar_values(m, slice(per * W - W, per * W), interval)[row, :, :5].astype(np.float64)
    live = np.stack([m[k][row, per * W: per * (W + tick)]
                     for k in ("open", "high", "low", "close", "volume")], axis=1)
    bars = np.concatenate([warm, live])[-W:]
    frame = SimpleNamespace(open=bars[:, 0], high=bars[:, 1], low=bars[:, 2], close=bars[:, 3],
                            volume=bars[:, 4])
    if five:
        return {"rsi": ev._rsi14_sma(frame.close), "mfi": ev._mfi14(frame)}
    delta = F.diff(frame.close)
    gain = F.ewm_mean(F.clip(delta, lower=0), alpha=1 / 14, min_periods=14)[-1]
    loss = F.ewm_mean(F.clip(-delta, lower=0), alpha=1 / 14, min_periods=14)[-1]
    return {"rsi": 100.0 * gain / (gain + loss) if gain + loss != 0 else 50.0}


def oracle_wide(card: str, stream) -> dict:
    """Part B: phase 3's market at S symbols and W bars, the warm tick and
    CLASSIC_TICKS live ticks through a classic card engine, against the
    oracle's run of the same stream (``stream``, a future of
    :func:`oracle_stream`): the fired sets equal but for flips inside
    ``declared_gate_margins()``, judged by the card's payload where the card
    fired (as phase 4 judges them) and by the oracle's own indicators where
    only the oracle did, each printed."""
    from binquant_tpu_torch.strategies.params import declared_gate_margins

    cuda = card == "cuda"
    m5, m15 = make_market(np.random.default_rng(SEED), live_ticks=CLASSIC_TICKS)
    checks: list = []
    before = _qtail_sites(cuda)
    with _twin_checked(checks, on_host=True):
        gpu = drive(card, m5, m15, incremental=False, live_ticks=CLASSIC_TICKS)
    sites = _sites_since(before, cuda)
    if len(checks) != sum(sites.values()) or not all(c[3] for c in checks):
        fail(f"[slice oracle] B: {len(checks)} twin checks for {sum(sites.values())} qtail "
             f"calls, {sum(not c[3] for c in checks)} unequal")
    if sites != {"abp_core": gpu["ticks"]}:
        fail(f"[slice oracle] B: qtail calls by site {sites}, expected abp_core once a tick")
    run = stream.result()
    fired, tick_ms = run["fired"], run["tick_ms"]
    if not gpu["fired"] or not fired:
        fail(f"[slice oracle] B: {len(gpu['fired'])} card and {len(fired)} oracle signals")
    margins = declared_gate_margins()
    ticks = [(t, []) for t in gpu["tick_times"]]
    flips = sorted(set(gpu["fired"]) ^ set(fired))
    for f in flips:
        card_side = f in gpu["indicators"]
        ind = gpu["indicators"][f] if card_side else _oracle_gates(m5, m15, f, ticks)
        print(f"[slice oracle] B: flip {f} fired by the {'card' if card_side else 'oracle'} "
              f"only, gated indicators {{rsi: {ind.get('rsi')}, mfi: {ind.get('mfi')}}}")
        if not _gated_flip_ok(f, ind, margins):
            fail(f"[slice oracle] B: the card and the oracle differ outside the declared gate "
                 f"margins: {f}")
    live = np.asarray(gpu["tick_ms"][1:])
    per_sym = np.asarray(tick_ms) / S
    result = {
        "ticks": gpu["ticks"], "launches": sum(sites.values()) if cuda else 0,
        "launches_by_site": sites if cuda else {}, "twin_checks": len(checks),
        "signals_card": len(gpu["fired"]), "signals_oracle": len(fired),
        "signals_by_strategy": _by_strategy(gpu["fired"]), "flips": flips,
        "oracle_warm_klines": run["warm_klines"], "oracle_ingest_s": run["ingest_s"],
        "oracle_tick_ms": tick_ms, "oracle_ms_per_symbol_tick": per_sym.tolist(),
        "oracle_tick_p50_ms": float(np.percentile(tick_ms, 50)),
        "card_tick_p50_ms": float(np.percentile(live, 50)),
        "card_warm_tick_ms": gpu["tick_ms"][0],
    }
    print(
        f"[slice oracle] B: S={S} W={W}, {gpu['ticks']} classic ticks (1 warm + {CLASSIC_TICKS} "
        f"live): card {len(gpu['fired'])} signals {result['signals_by_strategy']}, oracle "
        f"{len(fired)}, {len(flips)} flips (inside the gate margins); oracle ingest "
        f"{run['ingest_s']:.1f} s for {run['warm_klines']} warm klines, evaluate ms per tick "
        f"{[round(t, 1) for t in tick_ms]} ({np.median(per_sym):.3f} ms per symbol-tick), "
        f"card classic tick p50 {result['card_tick_p50_ms']:.2f} ms (warm "
        f"{result['card_warm_tick_ms']:.1f} ms); qtail {sites}, each equal to its twin",
        flush=True,
    )
    return result


def indicator_cases(ind) -> dict:
    """The batched indicator library's calls on a ring's (S, W) planes."""
    return {
        "sma": lambda m: ind.sma(m["close"], 20),
        "ema": lambda m: ind.ema(m["close"], 20),
        "typical_price": lambda m: ind.typical_price(m["high"], m["low"], m["close"]),
        "true_range": lambda m: ind.true_range(m["high"], m["low"], m["close"]),
        "atr": lambda m: ind.atr(m["high"], m["low"], m["close"], 14),
        "atr_wilder": lambda m: ind.atr_wilder(m["high"], m["low"], m["close"], 14),
        "rsi_wilder": lambda m: ind.rsi_wilder(m["close"], 14),
        "rsi_sma": lambda m: ind.rsi_sma(m["close"], 14),
        "macd": lambda m: ind.macd(m["close"]),
        "mfi": lambda m: ind.mfi(m["high"], m["low"], m["close"], m["volume"], 14),
        "bollinger": lambda m: ind.bollinger(m["close"], 20),
        "twap": lambda m: ind.twap(m["open"], m["high"], m["low"], m["close"], 20),
        "supertrend": lambda m: ind.supertrend(m["high"], m["low"], m["close"], 10, 3.0),
        "adx": lambda m: ind.adx(m["high"], m["low"], m["close"], 14),
        "connors_rsi": lambda m: ind.connors_rsi(m["close"]),
        "zscore": lambda m: ind.zscore(m["close"], 20),
        "log_returns": lambda m: ind.log_returns(m["close"]),
        "rolling_beta_corr": lambda m: ind.rolling_beta_corr(
            ind.log_returns(m["close"]), ind.log_returns(m["close"][:1]), 50),
        "ma_spreads": lambda m: ind.ma_spreads(m["close"]),
        "bb_spreads": lambda m: ind.bb_spreads(ind.bollinger(m["close"], 20)),
    }


def cancelling_scales(close: np.ndarray) -> dict:
    """The functions that return a small difference of two larger terms,
    and the sum of those terms' magnitudes, per element: the wire contract
    (rtol 1e-4 of each term) bounds them at rtol times it. The MACD line,
    its signal and histogram: two to four price-scale EMAs; the z-score:
    the price and its mean over the 20-bar std; the MA and band spreads:
    two averages (or bands) over one of them."""
    win = np.lib.stride_tricks.sliding_window_view(close, 20, axis=1)
    std = np.concatenate([np.full((close.shape[0], 19), np.nan), win.std(axis=-1)], axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.nan_to_num(2 * np.abs(close) / std, nan=0.0, posinf=0.0)
    return {"macd": 4 * np.abs(close), "zscore": z, "ma_spreads": 2.0, "bb_spreads": 2.0}


def check_indicators(card: str) -> dict:
    """Part C: the batched indicator library (``ops/indicators.py``) on
    phase 3's 5m ring (S symbols, its W warm bars), every function on
    ``card`` and on the CPU: NaN positions equal, values within the wire
    contract (``rtol=1e-4, atol=1e-5``; a difference of larger terms at the
    contract of those terms, :func:`cancelling_scales`), the supertrend's
    direction exactly. It prints each function's largest difference and ms
    per call on ``card`` (host clock around a synchronised call, the best
    of three)."""
    import torch

    from binquant_tpu_torch.ops import indicators as ind

    m5, _ = make_market(np.random.default_rng(SEED), live_ticks=CLASSIC_TICKS)
    ring = bar_values(m5, slice(2 * W, 3 * W), 300)  # (S, W, 10), the 5m ring's warm bars
    host = {k: torch.from_numpy(np.ascontiguousarray(ring[:, :, i]))
            for i, k in enumerate(("open", "high", "low", "close", "volume"))}
    dev = {k: v.to(card) for k, v in host.items()}
    scales = cancelling_scales(host["close"].numpy().astype(np.float64))

    def sync() -> None:
        if card == "cuda":
            torch.cuda.synchronize()

    out: dict = {}
    for name, fn in indicator_cases(ind).items():
        got, want = fn(dev), fn(host)
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn(dev)
            sync()
            times.append((time.perf_counter() - t0) * 1000.0)
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        atol = 1e-4 * scales[name] if name in scales else 1e-5
        err = 0.0
        for a, b in pairs:
            a, b = a.cpu().numpy(), b.numpy()
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                fail(f"[slice oracle] C: {name}: NaN positions differ between the card and the CPU")
            ok = np.isclose(a, b, rtol=1e-4, atol=atol, equal_nan=True)
            if not ok.all():
                bad = np.flatnonzero(~ok)[:5]
                fail(f"[slice oracle] C: {name}: card and CPU differ at {bad.tolist()}: "
                     f"{a.flat[bad]} vs {b.flat[bad]}")
            fin = np.isfinite(a) & np.isfinite(b)
            err = max(err, float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0)
        if name == "supertrend" and not np.array_equal(
            np.nan_to_num(got.direction.cpu().numpy(), nan=0.0),
            np.nan_to_num(want.direction.numpy(), nan=0.0),
        ):
            fail("[slice oracle] C: the supertrend's direction differs between the card and the CPU")
        out[name] = {"ms": min(times), "max_abs_err": err}
    errs = ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in out.items())
    ms = ", ".join(f"{k} {v['ms']:.3f}" for k, v in out.items())
    print(f"[slice oracle] C: the indicator library on the {S}x{W} 5m ring, card vs CPU within "
          f"the wire contract; largest difference: {errs}; ms per call: {ms}", flush=True)
    return out


def check_oracle(card: str = "cuda") -> dict:
    """Phase 13 (``[slice oracle]``): part A, the A/B fixtures, then part B,
    the full-width market, then part C, the indicator library card against
    CPU. The oracle arm of A and B runs on the host in a
    worker process of its own (spawned, killed with this one), its five
    runs queued at the start, so it works while the card's engines run;
    its times are taken beside them. Returns both parts, the launches
    summed."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    (ROOT / "build").mkdir(exist_ok=True)
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ProcessPoolExecutor(
        1, mp_context=spawn, initializer=_die_with_parent
    ) as pool:
        files = ab_files(Path(tmp))
        oracles = {name: pool.submit(timed_oracle, files[file], kw)
                   for name, (file, kw) in ab_cases().items()}
        stream = pool.submit(oracle_stream, S, W)
        t0 = time.perf_counter()
        ab = oracle_ab(card, files, oracles)
        ab["seconds"] = time.perf_counter() - t0
        torch_empty_cache()
        t0 = time.perf_counter()
        wide = oracle_wide(card, stream)
        wide["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    indicators = check_indicators(card)
    indicators_s = time.perf_counter() - t0
    by_site: dict = {}
    for p in (ab, wide):
        _add_sites(by_site, p["launches_by_site"])
    return {"launches": ab["launches"] + wide["launches"], "launches_by_site": by_site,
            "ab": ab, "wide": wide, "indicators": indicators, "indicators_s": indicators_s}


# phase 14's sweep: the demo's stream over two values of one of its axes
STAGES_SWEEP_ARGS = ("--demo", "--axis", "pt.rsi_oversold=15,45")
# qtail launches of one call of each profiled stage that reaches the kernel
STAGES_QTAIL = {
    "abp": {"abp_core": 1},
    "detect_spikes": {"detect_spikes": 1},
    "tick_step (device-resident inputs)": {
        "abp_core": 1, "abp_init_from_window": 1, "detect_spikes": 1},
}


def stage_ticks(device: str, symbols: int, window: int) -> dict:
    """The profiler market's full and incremental ``tick_step`` on
    ``device``: each wire on the host, and the signals each fired."""
    from binquant_tpu_torch.engine.step import init_indicator_carry, tick_step
    from binquant_tpu_torch.regime.context import ContextConfig
    from binquant_tpu_torch.tools import profile_stages as ps

    market = ps.make_market(symbols, window)
    state = ps.fill_rings(market, device)
    upd = ps.to_device(market.upd, device)
    inputs = ps.to_device(ps.host_inputs(market), device)
    full = tick_step(state, upd, upd, inputs, ContextConfig())[1]
    synced = state._replace(
        indicator_carry=init_indicator_carry(state.buf5, state.buf15, inputs.btc_row))
    incr = tick_step(synced, upd, upd, inputs, ContextConfig(), incremental=True)[1]
    return {kind: {"wire": out.wire.cpu().numpy(),
                   "fired": int(out.summary.trigger.sum())}
            for kind, out in (("full", full), ("incremental", incr))}


def stage_sweep(device: str, path: str) -> tuple[int, dict | None]:
    """``sweep_report`` over phase 14's grid on ``device``: its exit code and
    its JSON result."""
    from binquant_tpu_torch.tools import sweep_report

    rc = sweep_report.main([*STAGES_SWEEP_ARGS, "--device", device, "--json", path])
    return rc, json.loads(Path(path).read_text()) if rc == 0 else None


def stage_cpu_side(tmp: str, symbols: int, window: int) -> tuple[dict, tuple]:
    """Phase 14's CPU side (a worker process's job): the ticks, the sweep."""
    return stage_ticks("cpu", symbols, window), stage_sweep("cpu", f"{tmp}/cpu.json")


def check_stages(card: str = "cuda") -> dict:
    """Phase 14 (``[slice stages]``): the per-stage profile of the tick on
    the card, its ``tick_step`` rows against the CPU, the sweep report's
    demo against the CPU (that side in a worker process); every qtail
    launch held against the twin."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    (ROOT / "build").mkdir(exist_ok=True)
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, ProcessPoolExecutor(
        1, mp_context=spawn, initializer=_die_with_parent
    ) as pool:
        return _check_stages(card, tmp, pool.submit(stage_cpu_side, tmp, S, W))


def _check_stages(card: str, tmp: str, cpu_side) -> dict:
    from binquant_tpu_torch.engine.step import WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.tools import profile_stages as ps

    t_phase = time.perf_counter()
    checks: list = []
    qt.reset_launches()
    with _twin_checked(checks, by_reference=True):
        prof = ps.run(S, W, card, out=sys.stdout)
    profile_s = time.perf_counter() - t_phase
    if [r["name"] for r in prof["rows"]] != list(ps.STAGES):
        fail("[slice stages] the profile's rows are not the reference's stages in order")
    by_name = {r["name"]: r for r in prof["rows"]}
    if card == "cuda":
        for name, sites in STAGES_QTAIL.items():
            if by_name[name]["qtail"] != sites:
                fail(f"[slice stages] {name}: qtail launches {by_name[name]['qtail']}, "
                     f"expected {sites}")
        unmeasured = [r["name"] for r in prof["rows"] if r["device_ops"] is None]
        if unmeasured:
            fail(f"[slice stages] torch.profiler lost the device operations of {unmeasured}")

    # the tick_step rows' outputs, card against CPU, on the same market
    t0 = time.perf_counter()
    with _twin_checked(checks):
        got = stage_ticks(card, S, W)
    ticks_s = time.perf_counter() - t0
    # the sweep report's demo on the card
    t0 = time.perf_counter()
    with _twin_checked(checks):
        rc, sweep_card = stage_sweep(card, f"{tmp}/card.json")
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, (rc_cpu, sweep_cpu) = cpu_side.result()
    wait_s = time.perf_counter() - t0
    off, K = WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED
    wire_err = {}
    for kind in ("full", "incremental"):
        wg, wc = got[kind]["wire"], ref[kind]["wire"]
        if got[kind]["fired"] != ref[kind]["fired"] or not got[kind]["fired"]:
            fail(f"[slice stages] {kind} tick_step: {got[kind]['fired']} signals on the "
                 f"card, {ref[kind]['fired']} on the CPU")
        if wg[off] != wc[off] or not np.array_equal(wg[off: off + 1 + 4 * K],
                                                     wc[off: off + 1 + 4 * K]):
            fail(f"[slice stages] {kind} tick_step: fired blocks differ from the CPU's")
        if not np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True).all():
            bad = np.flatnonzero(~np.isclose(wg, wc, rtol=1e-4, atol=1e-5, equal_nan=True))
            fail(f"[slice stages] {kind} tick_step: wire floats differ at {bad[:5].tolist()}")
        fin = np.isfinite(wg) & np.isfinite(wc)
        wire_err[kind] = float(np.abs(wg[fin] - wc[fin]).max())
    if rc or rc_cpu:
        fail(f"[slice stages] sweep_report --demo exited {rc} on the card, {rc_cpu} on the CPU")
    if sweep_card["trig_counts"] != sweep_cpu["trig_counts"]:
        fail(f"[slice stages] sweep fire counts differ: {sweep_card['total_fired']} on the "
             f"card, {sweep_cpu['total_fired']} on the CPU")
    if not any(sweep_card["total_fired"]):
        fail("[slice stages] the sweep's demo fired nothing")

    launches, by_site = qt.launches, dict(qt.launches_by_site)
    shapes = sorted({f"{site} {'x'.join(map(str, shape))} K={k}"
                     for site, shape, k, _ in checks})
    if card == "cuda" and (len(checks) != launches or not launches):
        fail(f"[slice stages] {len(checks)} twin checks for {launches} qtail launches")
    if not all(c[3] for c in checks):
        fail(f"[slice stages] qtail differs from its twin: {[c for c in checks if not c[3]][:3]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ) if card == "cuda" else None
    card_line = smi.stdout.strip() if smi is not None and smi.stdout.strip() else "n/a"
    totals = prof["totals"]
    seconds = time.perf_counter() - t_phase
    print(f"[slice stages] S={S} W={W} on {card_line}: {len(prof['rows'])} stages; the "
          f"compute stages {totals['sum_of_compute_stages_ms']:.1f} ms of p50, "
          f"{totals.get('stage_ops')} of the full tick's {totals.get('full_tick_ops')} device "
          f"operations ({totals.get('stage_ops_share')}); full vs incremental "
          f"{totals.get('full_vs_incremental', 0):.2f}x; tick_step card vs CPU: "
          f"{got['full']['fired']} / {got['incremental']['fired']} signals, wire max error "
          f"{wire_err}; sweep demo (P={sweep_card['P']}) fires {sweep_card['total_fired']} "
          f"equal to the CPU's, {sweep_card['wall_s']} s on the card, "
          f"{sweep_cpu['wall_s']} s on the CPU; qtail {launches} launches {by_site} at "
          f"{shapes}, "
          f"{len(checks)} twin checks, all equal; profile {profile_s:.1f} s, ticks "
          f"{ticks_s:.1f} s, sweep {sweep_s:.1f} s, then {wait_s:.1f} s waiting for the "
          f"CPU's side; phase {seconds:.1f} s")
    return {"launches": launches, "launches_by_site": by_site, "card": card_line,
            "rows": prof["rows"], "totals": totals, "wire_max_err": wire_err,
            "fired": {k: got[k]["fired"] for k in got},
            "sweep": {k: sweep_card[k] for k in ("P", "total_fired", "wall_s", "dispatches")},
            "sweep_cpu_wall_s": sweep_cpu["wall_s"], "twin_checks": len(checks),
            "qtail_shapes": shapes,
            "seconds": seconds}


def cold_boot(card: str = "cuda") -> dict:
    """``--cold-boot``: the time to the first signal after a cold boot of
    the service as a user starts it, the backfill at the production flush
    of every 50 symbols: phase 11's card boot with the open-interest feed,
    to its first live tick. Prints the backfill's seconds, boot to ready,
    the first tick's ms from the frames' push to its signals emitted, and
    boot to the first signal."""
    lm5, lm15 = make_live_market(np.random.default_rng(SEED + 5))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        run = live_boot(card, live_history(lm5, lm15), live_bursts(lm5, lm15), Path(tmp),
                        "cold", ticks=1)
    if run["first_signal_tick"] != 1:
        fail(f"[cold boot] the first live tick emitted no signal ({run['paths']})")
    result = {"backfill": run["backfill"], "ready_s": run["ready_s"],
              "first_tick_ms": run["tick_ms"][0],
              "boot_to_first_signal_s": run["boot_to_first_signal_s"]}
    print(f"[cold boot] S={S} W={W}: backfill {run['backfill']['bars']} bars in "
          f"{run['backfill']['seconds']:.2f} s (a flush every 50 symbols), boot to ready "
          f"{run['ready_s']:.2f} s, first tick {run['tick_ms'][0]:.1f} ms from the frames' push "
          f"to emitted, boot to the first signal {run['boot_to_first_signal_s']:.2f} s")
    return result


def torch_empty_cache() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _profile_report(prof, paths: list[str]) -> dict:
    """Device activities of a profiled drive assigned to the
    ``chip_smoke_tick`` range they start in, reported per tick kind
    (incremental, full): host wall time, device busy time (the union of the
    activity intervals), idle share, activities per tick, qtail device time,
    and the costliest kernels. Device numbers are ``None`` when the profiler
    saw no CUDA activity."""
    import bisect

    import torch

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the host's tick ranges; the profiler mirrors each as a range on the
    # device's timeline too, which is an annotation, not device work
    ranges = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events if e.name == "chip_smoke_tick" and e.device_type != cuda
    )
    kinds = ["incremental" if p == "incremental" else "full" for p in paths[1:]]
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in events
        if e.device_type == cuda and e.name != "chip_smoke_tick"
    )
    starts = [r[0] for r in ranges]
    per_tick = [{"spans": []} for _ in ranges]
    for sp in spans:
        i = bisect.bisect_right(starts, sp[0]) - 1
        if 0 <= i < len(ranges) and sp[0] <= ranges[i][1]:
            per_tick[i]["spans"].append(sp)
    result: dict = {"ticks_profiled": len(ranges), "measured": bool(spans)}
    for kind in ("incremental", "full"):
        idx = [i for i, k in enumerate(kinds) if k == kind and i < len(per_tick)]
        if not idx:
            continue
        busy_total, n_total, qtail_total, wall_total = 0.0, 0, 0.0, 0.0
        by_name: dict[str, float] = {}
        count: dict[str, int] = {}
        for i in idx:
            end_us, busy = float("-inf"), 0.0
            for start, end, name in sorted(per_tick[i]["spans"]):
                busy += max(0.0, end - max(start, end_us))
                end_us = max(end_us, end)
                by_name[name] = by_name.get(name, 0.0) + (end - start)
                count[name] = count.get(name, 0) + 1
                if "qtail" in name:
                    qtail_total += end - start
            busy_total += busy
            n_total += len(per_tick[i]["spans"])
            wall_total += ranges[i][1] - ranges[i][0]
        n = len(idx)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        result[kind] = {
            "ticks": n,
            "tick_wall_ms": wall_total / 1e3 / n,
            "device_busy_ms_per_tick": busy_total / 1e3 / n if spans else None,
            "device_idle_share": 1.0 - busy_total / wall_total if spans else None,
            "device_activities_per_tick": n_total / n if spans else None,
            "qtail_device_ms_per_tick": qtail_total / 1e3 / n if spans else None,
            "top_device_ms_per_tick": [
                {"name": k[:90], "ms": us / 1e3 / n, "calls_per_tick": count[k] / n}
                for k, us in top
            ],
        }
    return result


def profile_slice(m5, m15, cm5, cm15) -> dict:
    """Where a tick's time goes on the card: the incremental drive (serial,
    no digests), the dormant market's classic and incremental drives with
    every strategy on the wire, and the production drive (depth 1, rings in
    place, digests and meter on) once more each under ``torch.profiler``
    (:func:`_profile_report`)."""
    from torch.profiler import ProfilerActivity, profile

    from binquant_tpu_torch.engine.step import STRATEGY_ORDER
    from binquant_tpu_torch.io.replay import dormant_market_bars

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = drive("cuda", m5, m15, incremental=True, live_ticks=LIVE_TICKS, profiler=prof)
    result = {"incremental": _profile_report(prof, run["paths"][: LIVE_TICKS + 1])}
    dm5, dm15 = market_from_bars(dormant_market_bars(S, W + DORMANT_TICKS))
    for incremental in (False, True):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        run = drive("cuda", dm5, dm15, incremental, DORMANT_TICKS, profiler=prof,
                    enabled=set(STRATEGY_ORDER))
        key = "dormant_incremental" if incremental else "dormant_classic"
        result[key] = _profile_report(prof, run["paths"])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = drive_pipelined({"main": ("cuda", 1, True, True)}, cm5, cm15, profiler=prof)["main"]
    result["pipelined"] = _profile_report(prof, run["paths"][: LIVE_TICKS + 1])
    print(f"[profile] {json.dumps(result)}")
    return result


class Laps:
    """Prints ``[time] <name>: <seconds since the last lap>``."""

    def __init__(self) -> None:
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"[time] {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


SHARDS = 4  # the sharded phase's shards, all on the one card
SHARD_LIVE = 4  # live ticks of each sharded parity drive (the incremental one audits the last)
SHARD_CRASH = 4  # live ticks of the sharded crash replay (the crash the last)


def sharded_engine(device: str, mesh, **kw):
    """A stub engine on ``device`` at S x W, placed on ``mesh`` by its own
    mesh method (None: unsharded); the plane, the fan-out and the switched
    observability off."""
    from binquant_tpu_torch.io.replay import make_stub_engine
    from binquant_tpu_torch.regime.context import ContextConfig

    engine = make_stub_engine(capacity=S, window=W, context_config=ContextConfig(),
                              device=device, **{"delivery": False, **OBS_OFF, **FANOUT_OFF, **kw})
    if mesh is not None:
        engine.place_on_mesh(mesh)
    return engine


def _bits(t):
    import torch

    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def replicated_equal(state) -> bool:
    """Every leaf the placement replicates holds the same bits on every shard."""
    import torch

    from binquant_tpu_torch.parallel.mesh import tree_leaves

    for split, *leaves in zip(tree_leaves(state.split), *(tree_leaves(s) for s in state.shards)):
        if not split and not all(torch.equal(_bits(x), _bits(leaves[0])) for x in leaves[1:]):
            return False
    return True


def wire_parity(a: np.ndarray, b: np.ndarray) -> tuple[bool, bool, float]:
    """(bit-equal, within the reference's ``_parity_check`` rule: the fired
    block exact, floats to atol/rtol 1e-5 with NaN equal, the largest
    finite difference)."""
    from binquant_tpu_torch.engine.step import WIRE_FIRED_COUNT_OFF, WIRE_MAX_FIRED

    off = WIRE_FIRED_COUNT_OFF
    end = off + 1 + 6 * WIRE_MAX_FIRED
    exact = a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    ok = (a.shape == b.shape and np.array_equal(a[off:end], b[off:end])
          and bool(np.isclose(a, b, atol=1e-5, rtol=1e-5, equal_nan=True).all()))
    fin = np.isfinite(a) & np.isfinite(b) if a.shape == b.shape else np.zeros(0, bool)
    return exact, ok, float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def sharded_parity(card: str, mesh, m5: dict, m15: dict, incremental: bool) -> dict:
    """An unsharded and a sharded serial engine on the card take each tick
    of one stream in turn (the warm tick, then SHARD_LIVE live ticks; the
    incremental engines audit the last with the drift meter on): the same
    routing, wires within the reference's rule (bit-equal counted), the
    sharded state's replicated leaves equal on every shard after each tick,
    the drift meter's verdicts equal; host ms per tick and the cross-shard
    traffic per tick by kind."""
    import torch

    from binquant_tpu_torch.parallel.collectives import TRAFFIC

    flags = dict(incremental=incremental, carry_audit_every=SHARD_LIVE, pipeline_depth=0,
                 donate=False, numeric_digest=True, ingest_digest=True,
                 drift_meter=incremental, outcomes=False)
    plain = sharded_engine(card, None, **flags)
    placed = sharded_engine(card, mesh, **flags)
    ticks = tick_plan(plain, m5, m15, SHARD_LIVE)
    queue_warm(placed, m5, m15)
    rec: dict = {"kinds": [], "plain_ms": [], "sharded_ms": [], "bit_equal": 0,
                 "max_err": 0.0, "traffic": [], "fired": 0}

    async def run():
        for now_ms, klines in ticks:
            times = []
            for engine in (plain, placed):
                for k in klines:
                    engine.ingest(k)
                torch.cuda.synchronize()
                TRAFFIC.reset()
                t0 = time.perf_counter()
                fired = await engine.process_tick(now_ms=now_ms)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1000.0)
                rec["fired"] += len(fired) if engine is plain else 0
            kind = plain.last_path
            if placed.last_path != kind:
                fail(f"[slice sharded] routing: {placed.last_path} sharded, {kind} unsharded")
            exact, ok, err = wire_parity(placed.last_wire, plain.last_wire)
            if not ok:
                fail(f"[slice sharded] the {kind} tick's wire differs from the unsharded "
                     f"one past the reference's rule (max {err})")
            if not replicated_equal(placed.state):
                fail(f"[slice sharded] after a {kind} tick a replicated leaf differs "
                     "between shards")
            rec["bit_equal"] += exact
            rec["max_err"] = max(rec["max_err"], err)
            rec["kinds"].append(kind)
            rec["plain_ms"].append(times[0])
            rec["sharded_ms"].append(times[1])
            rec["traffic"].append(TRAFFIC.snapshot())

    asyncio.run(run())
    if incremental:
        if plain.drift.audits != 1 or placed.drift.audits != 1:
            fail(f"[slice sharded] drift audits: {plain.drift.audits} unsharded, "
                 f"{placed.drift.audits} sharded (expected 1)")
        d_plain, d_placed = plain.drift.last, placed.drift.last
        if {f: v["compared"] for f, v in d_plain.items()} != {
                f: v["compared"] for f, v in d_placed.items()}:
            fail("[slice sharded] the drift meter compared other positions sharded")

        def breached(d: dict, tol: float) -> list:
            return sorted(f for f, v in d.items() if v["compared"] > 0 and v["max_rel"] > tol)

        verdicts = (breached(d_plain, plain.drift.tol), breached(d_placed, placed.drift.tol))
        if verdicts[0] != verdicts[1]:
            fail(f"[slice sharded] drift verdicts: {verdicts[1]} breached sharded, "
                 f"{verdicts[0]} unsharded")
        rec["drift"] = {
            "equal": d_plain == d_placed,
            "breached": verdicts[0],
            "max_rel_diff": max(abs(d_plain[f]["max_rel"] - d_placed[f]["max_rel"])
                                for f in d_plain),
        }
    rec["engines"] = (plain, placed)
    return rec


async def _replay(engine, ticks) -> list:
    from binquant_tpu_torch.io.replay import signal_tuples

    out = []
    for now_ms, klines in ticks:
        for k in klines:
            engine.ingest(k)
        out += signal_tuples(await engine.process_tick(now_ms=now_ms))
    return out + signal_tuples(await engine.flush_pending())


def sharded_crash(card: str, mesh, cm5: dict, cm15: dict, depth: int) -> dict:
    """Phase 5's crash market, its last SHARD_CRASH ticks (the crash tick,
    which overflows the wire, the last), through an unsharded and a sharded
    engine at the production loop's defaults at ``depth``: the same signal
    tuples, the overflow's fallback on both."""
    import torch

    warm = W + LIVE_TICKS + 1 - SHARD_CRASH
    out = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        engine = sharded_engine(card, m, pipeline_depth=depth)
        ticks = tick_plan(engine, cm5, cm15, SHARD_CRASH, warm)
        t0 = time.perf_counter()
        fired = asyncio.run(_replay(engine, ticks))
        torch.cuda.synchronize()
        out[name] = {"fired": fired, "s": time.perf_counter() - t0,
                     "overflow_ticks": engine.overflow_ticks, "fresh_slots": engine.fresh_slots,
                     "inplace_ticks": engine.inplace_ticks}
    if out["sharded"]["fired"] != out["unsharded"]["fired"]:
        fail(f"[slice sharded] crash replay at depth {depth}: "
             f"{len(out['sharded']['fired'])} signals sharded, "
             f"{len(out['unsharded']['fired'])} unsharded, not the same tuples")
    if not out["sharded"]["overflow_ticks"] or len(out["sharded"]["fired"]) <= 128:
        fail(f"[slice sharded] crash replay at depth {depth}: the crash did not overflow")
    return out


def device_ops(calls: list) -> list:
    """The device operations of each call, from one ``torch.profiler``
    session whose activities the calls' spin-kernel marks split (the
    technique of ``binquant_tpu_torch/tools/profile_stages.py``); None for
    every call when the session lost a mark."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from binquant_tpu_torch.tools.profile_stages import EDGE_S, MARK_CYCLES, MARK_KERNEL

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        for fn in calls:
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        time.sleep(EDGE_S)
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted(
        (e.start_ns(), MARK_KERNEL in e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda and not e.is_user_annotation()
    )
    marks = [i for i, e in enumerate(events) if e[1]]
    if len(marks) != 2 * len(calls):
        return [None] * len(calls)
    return [marks[2 * k + 1] - marks[2 * k] - 1 for k in range(len(calls))]


def step_calls(engine, incremental: bool, maintain_carry: bool):
    """One copying tick step on ``engine``'s state with no updates: its
    classic, full or incremental evaluation, for the operation counts."""
    from binquant_tpu_torch.engine.step import tick_step_wire

    inputs = engine._host_inputs(0, T_LIVE0 + 900 * (SHARD_LIVE - 1),
                                 T_LIVE0 + 900 * SHARD_LIVE - 300, False)
    empty = engine._empty_updates()
    return lambda: tick_step_wire(engine.state, empty, empty, inputs, engine.context_config,
                                  incremental=incremental, maintain_carry=maintain_carry)


def row_count_bits(engine) -> dict:
    """Whether the per-row library operations the tick runs give a row the
    same bits in a batch of S/SHARDS rows as in the batch of S: the EWM's
    decay-matrix product, a row sum, a cumulative sum, and the tick's own
    fixed-order sum, each on the unsharded engine's 15m closes, per shard's
    rows against the same rows of the whole batch. ``{op: (bit-equal on
    every shard, the largest difference)}``."""
    import torch

    from binquant_tpu_torch.engine.buffer import Field, materialize
    from binquant_tpu_torch.ops.rolling import ewm_mean, fixed_order_sum

    x = materialize(engine.state.buf15).values[:, :, Field.CLOSE]
    ops = {
        "ewm matmul": lambda a: ewm_mean(a, span=20.0),
        "row sum": lambda a: torch.where(torch.isfinite(a), a, 0.0).sum(dim=-1),
        "cumsum": lambda a: torch.where(torch.isfinite(a), a, 0.0).cumsum(dim=-1),
        "fixed-order sum": lambda a: fixed_order_sum(torch.where(torch.isfinite(a), a, 0.0)),
    }
    out = {}
    for name, fn in ops.items():
        whole = fn(x)
        equal, err = True, 0.0
        for k in range(SHARDS):
            lo, hi = k * S // SHARDS, (k + 1) * S // SHARDS
            part, ref = fn(x[lo:hi].contiguous()), whole[lo:hi]
            equal &= bool(torch.equal(_bits(part), _bits(ref)))
            fin = torch.isfinite(part) & torch.isfinite(ref)
            if bool(fin.any()):
                err = max(err, float((part - ref)[fin].abs().max()))
        out[name] = (equal, err)
    return out


def check_sharded(card: str = "cuda") -> dict:
    """Phase 15: the sharded tick at S x W over SHARDS shards on the one
    card (``make_mesh([card] * SHARDS)``, the counterpart of the reference's
    virtual CPU mesh): tick parity against the unsharded tick (classic,
    incremental after a resync, an audit with the drift meter), phase 5's
    crash replay through engines placed on the mesh by their own mesh
    method at depth 1 and 2, every qtail launch held against its twin, the
    cross-shard traffic under the reference's limit, host p50 per tick kind
    and the device operations per tick, sharded and unsharded."""
    import torch

    from binquant_tpu_torch.engine.buffer import NUM_FIELDS
    from binquant_tpu_torch.ops import quantile_tail as qt
    from binquant_tpu_torch.parallel.collectives import check_traffic, traffic_limit
    from binquant_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh([card] * SHARDS)
    m5, m15 = make_market(np.random.default_rng(SEED + 3), live_ticks=SHARD_LIVE)
    cm5, cm15 = make_crash_market(np.random.default_rng(SEED + 1))
    qt.reset_launches()
    checks: list = []
    part_s: dict = {}
    with _twin_checked(checks):
        t0 = time.perf_counter()
        incr = sharded_parity(card, mesh, m5, m15, incremental=True)
        part_s["incremental parity"] = time.perf_counter() - t0
        classic = sharded_parity(card, mesh, m5, m15, incremental=False)
        part_s["classic parity"] = time.perf_counter() - t0 - sum(part_s.values())
        crash = {}
        for d in (1, 2):
            crash[d] = sharded_crash(card, mesh, cm5, cm15, d)
            part_s[f"crash depth {d}"] = time.perf_counter() - t0 - sum(part_s.values())
    launches, by_site = qt.launches, dict(qt.launches_by_site)
    by_shard = dict(sorted(qt.launches_by_shard.items()))
    if card == "cuda" and (len(checks) != launches or not launches):
        fail(f"[slice sharded] {len(checks)} twin checks for {launches} qtail launches")
    if not all(c[3] for c in checks):
        fail(f"[slice sharded] qtail differs from its twin: {[c for c in checks if not c[3]][:3]}")
    if card == "cuda" and (sorted(by_shard) != list(range(SHARDS))
                           or len(set(by_shard.values())) != 1):
        fail(f"[slice sharded] qtail launches by shard {by_shard}: not every shard alike")

    limit = traffic_limit(S, W, NUM_FIELDS)
    kinds: dict = {}
    for rec in (incr, classic):
        for kind, plain_ms, sharded_ms, snap in zip(rec["kinds"], rec["plain_ms"],
                                                    rec["sharded_ms"], rec["traffic"]):
            check_traffic(snap, limit)
            k = kinds.setdefault(kind, {"plain_ms": [], "sharded_ms": [], "bytes": [],
                                        "largest": 0, "collectives": []})
            k["plain_ms"].append(plain_ms)
            k["sharded_ms"].append(sharded_ms)
            k["bytes"].append(snap["bytes"])
            k["collectives"].append(snap["collectives"])
            k["largest"] = max(k["largest"], snap["largest"])

    # the device operations of one copying step of each evaluation, on the
    # incremental pair's final states (their last tick a full audit)
    t0 = time.perf_counter()
    plain, placed = incr["engines"]
    rows = row_count_bits(plain)
    evals = {"classic": (False, False), "full": (False, True), "incremental": (True, True)}
    calls = [step_calls(engine, *evals[e]) for e in evals for engine in (plain, placed)]
    for fn in calls:  # one untimed pass, so nothing is first-call in the session
        fn()
    ops = device_ops(calls) if card == "cuda" else [None] * len(calls)
    if card == "cuda" and None in ops:
        fail("[slice sharded] torch.profiler lost the device operations of a step")
    op_counts = {e: {"unsharded": ops[2 * i], "sharded": ops[2 * i + 1]}
                 for i, e in enumerate(evals)}
    del incr["engines"], classic["engines"], plain, placed
    torch_empty_cache()
    part_s["operation counts"] = time.perf_counter() - t0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ) if card == "cuda" else None
    card_line = smi.stdout.strip() if smi is not None and smi.stdout.strip() else "n/a"
    seconds = time.perf_counter() - t_phase
    summary = {}
    print(f"[slice sharded] S={S} W={W} over {SHARDS} shards on {mesh.devices[0]} "
          f"({card_line}); cross-shard limit {limit} bytes")
    for kind, k in kinds.items():
        p50_plain, p50_sharded = _p(k["plain_ms"], 50), _p(k["sharded_ms"], 50)
        summary[kind] = {
            "ticks": len(k["plain_ms"]), "p50_ms_unsharded": p50_plain,
            "p50_ms_sharded": p50_sharded, "ratio": p50_sharded / p50_plain,
            "bytes_per_tick": _p(k["bytes"], 50), "largest_bytes": k["largest"],
            "collectives_per_tick": _p(k["collectives"], 50),
        }
        print(f"[slice sharded] {kind}: {len(k['plain_ms'])} ticks, host p50 "
              f"{p50_sharded:.1f} ms sharded vs {p50_plain:.1f} ms unsharded "
              f"({p50_sharded / p50_plain:.2f}x); cross-shard {_p(k['bytes'], 50):.0f} bytes "
              f"a tick in {_p(k['collectives'], 50):.0f} collectives, the largest "
              f"{k['largest']} bytes")
    for e, c in op_counts.items():
        print(f"[slice sharded] device operations of one {e} step: {c['sharded']} sharded, "
              f"{c['unsharded']} unsharded")
    for rec, label in ((incr, "incremental drive"), (classic, "classic drive")):
        print(f"[slice sharded] parity, {label} {rec['kinds']}: wires bit-equal on "
              f"{rec['bit_equal']} of {len(rec['kinds'])} ticks, max difference "
              f"{rec['max_err']:.3g}; replicated leaves equal on every shard after each "
              f"tick; {rec['fired']} signals" + (
                  f"; drift meter: breached {rec['drift']['breached']} on both, max_rel "
                  f"{'equal' if rec['drift']['equal'] else 'within'} "
                  f"{rec['drift']['max_rel_diff']:.3g}" if "drift" in rec else ""))
    print(f"[slice sharded] a row's bits in a batch of {S // SHARDS} rows vs {S}: " + "; ".join(
        f"{op} {'equal' if eq else 'differ'} (max {err:.3g})" for op, (eq, err) in rows.items()))
    for d, c in crash.items():
        print(f"[slice sharded] crash replay, depth {d}: {len(c['sharded']['fired'])} signals, "
              f"the unsharded engine's tuples; overflow ticks {c['sharded']['overflow_ticks']}; "
              f"fresh slots {c['sharded']['fresh_slots']}; in-place ticks "
              f"{c['sharded']['inplace_ticks']}; {c['sharded']['s']:.1f} s sharded vs "
              f"{c['unsharded']['s']:.1f} s unsharded")
    print(f"[slice sharded] qtail {launches} launches by shard {by_shard} by site {by_site}; "
          f"{len(checks)} twin checks, all equal; phase {seconds:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()) + ")")
    return {"launches": launches, "launches_by_site": by_site, "launches_by_shard": by_shard,
            "card": card_line, "kinds": summary, "device_ops": op_counts,
            "bit_equal": {"incremental": [incr["bit_equal"], len(incr["kinds"])],
                          "classic": [classic["bit_equal"], len(classic["kinds"])]},
            "max_err": max(incr["max_err"], classic["max_err"]),
            "drift": incr.get("drift"),
            "row_count_bits": {op: {"equal": eq, "max_diff": err} for op, (eq, err) in rows.items()},
            "crash": {d: {k: {kk: (len(vv) if kk == "fired" else vv) for kk, vv in v.items()}
                          for k, v in c.items()} for d, c in crash.items()},
            "twin_checks": len(checks), "seconds": seconds, "part_s": part_s}


def second_phases(lap: Laps) -> dict:
    """Phases 3, 4, 9, 10, 14 and 13, the second process's share: their
    results by slice, as the first process puts them in the slice line."""
    m5, m15 = make_market(np.random.default_rng(SEED))
    # phase 3: the classic and the incremental live paths
    classic = check_classic(m5, m15)
    serial_ref: dict = {}  # the serial incremental card drive, for phase 10
    incremental = check_incremental(m5, m15, classic, keep=serial_ref)
    lap("classic and incremental")
    # phase 4: the dormant strategy set with the spike detector
    dormant = check_dormant()
    lap("dormant")
    torch_empty_cache()
    # phase 9: the subscription fan-out plane, on phase 5's market
    cm5, cm15 = make_crash_market(np.random.default_rng(SEED + 1))
    fanout = check_fanout(cm5, cm15)
    lap("fanout")
    torch_empty_cache()
    # phase 10: the scanned drive (phase 3's market, then phase 5's crash)
    # and the time-batched backtest with the sweep
    scanned = check_scanned(m5, m15, serial_ref, cm5, cm15)
    serial_ref.clear()
    lap("scanned")
    backtest = check_backtest()
    lap("backtest")
    torch_empty_cache()
    # phase 14: the per-stage profile of the tick and the tools, here: its
    # profiler sessions count what the card ran only in a process that has
    # opened no profiler before (phase 8 opens one in the first process)
    stages = check_stages()
    lap("stages")
    torch_empty_cache()
    # phase 13: the per-symbol oracle (it opens no profiler)
    oracle = check_oracle()
    lap("oracle")
    return {
        "classic": {k: v for k, v in classic.items()
                    if k not in ("fired", "indicators", "tick_times")},
        "incremental": incremental,
        "dormant": dormant,
        "fanout": {k: v for k, v in fanout.items() if k != "paths"},
        "scanned": scanned,
        "backtest": backtest,
        "stages": {k: v for k, v in stages.items() if k != "rows"},
        "oracle": oracle,
    }


def _die_with_parent() -> None:
    """Have the kernel kill this process when the process that started it
    ends, however it ends; exit at once if it has ended already."""
    import ctypes
    import signal

    parent = os.getppid()
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        sys.exit(1)


def third_phases(lap: Laps) -> dict:
    """Phase 12's parts A and B, then phase 15: the third process's share."""
    scenarios = check_scenarios(("wide", "corpus"))
    lap("scenarios: wide and corpus")
    torch_empty_cache()
    # phase 15: the sharded tick over four shards on the card, here: its
    # profiler session counts what the card ran only in a process that has
    # opened no profiler before (phase 14 opens them in the second)
    sharded = check_sharded()
    lap("sharded")
    return {"scenarios": scenarios, "sharded": sharded}


# the processes main starts beside itself: flag -> (the phases it runs, their names)
PARTS = {
    "--second": (second_phases, "phases 3, 4, 9, 10, 14 and 13"),
    "--third": (third_phases, "phases 12 A and B and 15"),
}


def start_part(flag: str, out: Path) -> subprocess.Popen:
    """Start ``chip_smoke.py <flag> out``: its standard output goes to
    ``out.log``, its standard error to this process's, its temporary files
    to a directory of its own under ``build/``."""
    tmp = out.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, TMPDIR=str(tmp), PYTHONUNBUFFERED="1")
    with open(out.with_suffix(".log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(out)],
            cwd=ROOT, env=env, stdout=log, stdin=subprocess.DEVNULL,
        )


def finish_part(flag: str, proc: subprocess.Popen, out: Path, wait: bool) -> dict | None:
    """A started process's results once it has ended (``wait``: until it
    has), its log printed here; None while it runs. Fails if it failed."""
    if not wait and proc.poll() is None:
        return None
    rc = proc.wait()
    print(out.with_suffix(".log").read_text(), end="", flush=True)
    if rc != 0:
        fail(f"the process of {PARTS[flag][1]} ({flag}) exited with {rc}")
    return json.loads(out.read_text())


def main() -> int:
    if not (ROOT / "binquant_tpu_torch" / "csrc" / "qtail.cu").is_file():
        print("chip_smoke: run from a checkout holding binquant_tpu_torch/", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    part = next((flag for flag in PARTS if flag in args), None)
    part_out = Path(args[args.index(part) + 1]) if part is not None else None
    if part is not None:
        _die_with_parent()
    # a CI run: the stub engines' Config skips the production check of the
    # deployment's variables (the processes started below inherit it)
    os.environ["ENV"] = "CI"
    # the smoke needs one card: on a host with several, use the first only
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0].strip()
    # the two processes' CPU engines share the host's cores: their OpenMP
    # threads sleep between parallel regions instead of spinning (read when
    # torch loads its OpenMP runtime; the second process inherits it)
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        fail(f"expected one visible card, found {torch.cuda.device_count()}")
    sys.path.insert(0, str(ROOT))

    from binquant_tpu_torch.ops import quantile_tail as qt

    # phase 1: build (one nvcc per kernel source; the port has one)
    t0 = time.perf_counter()
    lib, compile_s = qt.build(verbose=part is None)
    print(f"[build] {lib.name}: nvcc {compile_s:.2f} s (set-up {time.perf_counter() - t0:.2f} s)")
    lap = Laps()
    lap.t = t0
    if part is not None:
        slices = PARTS[part][0](lap)
        tmp = part_out.with_name(part_out.name + ".part")
        tmp.write_text(json.dumps(slices))
        tmp.replace(part_out)
        return 0
    if "--cold-boot" in args:
        print(json.dumps({"cold_boot": cold_boot()}))
        lap("cold boot")
        return 0
    if "--fold-ab" in args:
        cm5, cm15 = make_crash_market(np.random.default_rng(SEED + 1))
        print(json.dumps({"fold_ab": fold_ab(cm5, cm15)}))
        lap("fold A/B")
        return 0
    # phase 2: kernel vs twin, alone on the card
    qreport = check_quantile_kernel()
    lap("build and kernel")

    (ROOT / "build").mkdir(exist_ok=True)
    parts = Path(tempfile.mkdtemp(prefix="chip_smoke.", dir=ROOT / "build"))
    outs = {flag: parts / f"{flag.strip('-')}.json" for flag in PARTS}
    procs = {flag: start_part(flag, out) for flag, out in outs.items()}
    got: dict = {}

    def collect(wait: bool = False) -> None:
        """Read each started process that has ended (``wait``: wait for all)."""
        for flag, proc in procs.items():
            if flag not in got:
                res = finish_part(flag, proc, outs[flag], wait)
                if res is not None:
                    got[flag] = res
                    print(f"[time] the process of {PARTS[flag][1]} ended "
                          f"{time.perf_counter() - t0:.1f} s after the start", flush=True)

    try:
        # phase 5: the production loop, on its own seeded market
        cm5, cm15 = make_crash_market(np.random.default_rng(SEED + 1))
        pipelined = check_pipelined(cm5, cm15)
        lap("pipelined")
        collect()
        # phase 6: the service around the tick, on the same market's downtrend
        service = check_service(cm5, cm15)
        lap("service")
        collect()
        # phase 7: the delivery plane and the real sinks, on phase 5's market
        delivery = check_delivery(cm5, cm15)
        lap("delivery")
        collect()
        # phase 8: the tick's default observability, on phase 5's market
        observability = check_observability(cm5, cm15)
        lap("observability")
        torch_empty_cache()
        collect()
        # phase 11: the port as a service, booted cold through run_live
        live = check_live()
        lap("live")
        torch_empty_cache()
        collect()
        # phase 12's part C: here, where the two other processes' shares of
        # the smoke leave the most room
        soak = check_scenarios(("soak",))
        lap("scenarios: soak")
        collect(wait=True)
        print(f"[time] all phases, all processes: {time.perf_counter() - t0:.1f} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(parts, ignore_errors=True)
    second = got["--second"]
    slices = {
        **{k: second[k] for k in ("classic", "incremental", "dormant")},
        "pipelined": pipelined,
        "service": service,
        "delivery": delivery,
        "observability": {k: v for k, v in observability.items() if k != "paths"},
        **{k: second[k] for k in ("fanout", "scanned", "backtest")},
        "live": live,
        "scenarios": got["--third"]["scenarios"],
        "scenario_soak": soak,
        "oracle": second["oracle"],
        "stages": second["stages"],
        "sharded": got["--third"]["sharded"],
    }
    if "--profile" in args:
        m5, m15 = make_market(np.random.default_rng(SEED))
        slices["profile"] = profile_slice(m5, m15, cm5, cm15)

    abp = qreport["abp"]
    by_site: dict[str, int] = {}
    drives = {k: v for k, v in slices.items() if k != "profile"}
    for run in drives.values():
        for k, v in run["launches_by_site"].items():
            by_site[k] = by_site.get(k, 0) + v
    kernels = [
        {
            "name": "rolling_quantile_tail",
            "route": "cuda",
            "source": "binquant_tpu_torch/csrc/qtail.cu",
            "replaces": "binquant_tpu/ops/pallas_rolling.py:40",
            "launches": sum(r["launches"] for r in drives.values()),
            "launches_by_site": by_site,
            "launches_by_drive": {k: r["launches"] for k, r in drives.items()},
            "max_abs_err": abp["max_abs_err"],
            "ms": abp["kernel_ms"],
            "plain_ms": abp["twin_ms"],
            "bound_ms": abp["bound_ms"],
            "bound_by": abp["bound_by"],
            "library_ms": abp["library_ms"],
            "call_ms": abp["call_ms"],
            "floor_ms": abp["floor_ms"],
            "equal_to_twin": all(r["equal_to_twin"] for r in qreport.values()),
        }
    ]
    print(json.dumps({"qtail_cases": qreport, "slice": slices}))
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
