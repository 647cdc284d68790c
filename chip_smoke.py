#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Drives `diamond_types_tpu_torch` only (no JAX, nothing of the JAX
package), in phases, each printing one JSON line:

  1. build    - compile every kernel in `diamond_types_tpu_torch/csrc/`
                with nvcc (one process per source, started together) and,
                at the same time, the port's native library with g++
                (`native/build.py`), which the kernel phases do not wait
                for; each one's seconds, and how long the serve phase then
                waited for the native library.
  2. kernel   - each kernel against its plain PyTorch version on the card,
                exactly equal on every shape:
                K1 (`apply_ops_window`) over random windows: poisoned rows,
                padding rows, deletes into the roll's wrap region, ops past
                cap; b in {1, 8, 256}, cap in {256, 4096, 32768, 65536},
                n in {1, 64, 256}; then cap 4,100 (no multiple of the
                tile), cap == max_ins (16 and 64), b 8 at caps 8,192 and
                16,384, and tapes of 1,024 and 2,048 ops.
                K2 (`xform_positions`) on random [b, n] columns, b in
                {1, 7, 8, 256, 257}, n from 0 to 4,096 around the edges of
                its warp's 128-element chunks and of 32 lanes (31-33,
                255-257, 2,047-2,049), with rows whose prefix sum of
                nv - ov is negative throughout.
                K3 (`materialize_runs`) on random run tables up to 70,000
                runs, with cap < total, empty runs and runs that start
                past cap, a cap that is no multiple of its gather's
                512-output tile and b 1 at cap 65,536; and on the tiled
                gather's hazards: total 0, one run spanning every tile,
                a tile's worth of zero-length runs sharing a live run's
                start, arena offsets past the pool; and the history
                path's shared rows (one perm, arena_off and arena row for
                256 rows of visibility) with cap < total and empty runs.
  3. serve    - the main path: 256 documents, each typed by one agent
                (2,048-12,288 chars), resident as `FusedDocSession`s on the
                card; 4 flush windows in which two more agents fork from
                each tip and edit concurrently and the first agent merges.
                Each window plans every tail with `xform.plan_tails_device`
                (host extract, then ONE device resolve: the linearize
                kernel and K2 on one uploaded buffer, every resolve's
                buffer held against the plain chain after the phase),
                groups them by cap and replays them through
                `kernel_fused_replay` (K1) in buckets of 8 (one window: one
                wide bucket per cap); the K1 inputs of window 0 and of the
                wide window are captured (each bucket packed once more,
                outside the timed replay). Window 0 also times the host
                `plan_tail` over the same sessions, without adopting those
                plans; window 1 is traced with `torch.profiler` (device
                activity only) for the device's busy share of its flush.
                Requires 0 fence failures, 0 fallbacks, device-
                planned documents in every window, K1 launches == buckets,
                K2 launches == resolves, and every text equal to the host's
                after every window: the first agent's branch, which merged
                every agent (the checkout phase holds the last window's
                branches against fresh host checkouts).
  4. scheduler - the serve layer's entry point: the same kind of 256
                documents and 6 rounds of concurrent edits (its own
                generator), through `MergeScheduler(4, engine="device",
                device_plan=True, flush_docs=8, flush_workers=True,
                max_sessions_per_shard=128)`: per round `submit` for every
                edited document, `pump()`, `drain()`; round 1 traced by
                `torch.profiler` (device activity only). Requires every
                text equal to the host's merge after every round (16 of
                those merged branches equal to fresh host checkouts after
                the last), 0 host fallbacks, no worker exception, device-
                planned documents in every round, K1 launches == fused
                calls + per-doc syncs that replayed, K2 launches ==
                resolves, and every K1 and K2 call of the rounds exactly
                equal to the kernel's plain version on its inputs (K1's
                calls stacked by (n, cap) for the plain version). Prints
                per round wall ms, docs and ops per second, and the flush
                latency p50/p99, occupancy, builds and evictions.
                Then the same documents and edits (the same generator
                seed) once more with `mesh_window=True` (line
                "scheduler_window"): each `pump()` folds every due bucket
                into one window, one K1 launch per (cap, max_ins) class
                and one K2 resolve per window. Requires the same texts and
                checks, 0 per-shard fused calls, K1 launches == window
                class dispatches + per-doc replays, K2 launches ==
                resolves <= windows, and arena hits + misses (counted by a
                wrapper around `arena.acquire`) == dispatches. Each of the
                two lines has a "summary": docs/s, ops/s and wall per
                round, flush and queue-wait p50/p99, K1 and K2 launches
                per round, device calls per window, mesh occupancy, staged
                bytes per window, arena hits and misses, host fallbacks
                and the device busy share of round 1; each round splits
                its resolve seconds into linearize, K2 and assembly.
  5. serve_bench - `run_serve_bench` on the card in trace, concurrent and
                flash modes, and in concurrent mode with the flush window
                (4 shards, 64 documents, 8 feed rounds and 8 steady
                rounds, device planning on, every session resident); each
                must pass its parity gate, hold its SLO verdict and launch
                K1. The bench runs instrumented (1% trace sampling, live
                telemetry, the journey, the device profiler), as the JAX
                package's does; each run prints its devprof and slo_ok.
  6. checkout - `merge_kernel.prepare_doc` and `checkout_batch_device`
                (`fugue_linearize` and one K3 call per checkout: a row
                scan and a tiled gather, two kernels counted as one
                launch) over all 256 served documents, grouped by pow2
                cap; then `merge_device` of 16 documents from their
                window-0 frontier. Every text must equal the host's (the
                tip checkout, timed as the yardstick, which must also equal
                the serve phase's merged branches; a `Branch` checked out
                at that frontier that merges the tip), and K3 launches ==
                calls. Then every one
                of those K3 calls is held against its plain version and
                timed (b, runs, cap, call_ms, device_ms, bound_ms, and the
                gather's CTAs as derived from the launcher's grid rule, b
                * ceil(cap / 512), not observed), and one batch call per
                cap is taken apart: `pad_docs` + upload (host clock),
                `fugue_linearize` and K3 (CUDA events), download + decode
                (host clock).
  7. history  - batched time travel, `plan_kernels.texts_at_versions`: a
                history of ~40,000 ops that three agents write
                concurrently, merging the tip now and then (final text
                32k-64k chars), at 256 snapshot entries spread over its
                plan, through source="native" (one tape replay on the
                card, then ONE K3 call over [256, n_slots] at cap 65,536
                with the order, offsets and arena as shared rows); and a
                ~2,000-op history at 32 entries through source="python"
                (`DenseExecutor`). Requires K3 launches == calls (2),
                every K3 call equal to its plain version, every one of
                the 256 versions equal to the C++ tracker's text at its
                `entry_frontier`, 4 spread ones to the Python checkout,
                and every small version to the Python checkout. Prints the
                call's parts (compile_plan2, source, pack_plan_tape,
                execute_tape host ms, device busy ms and events from
                `torch.profiler`, the tables, K3 with its copies and
                decode), K3's call_ms, device_ms and HBM bound at that
                shape, and the host's yardsticks: the C++ tracker's ms
                for all 256 versions, timed, and the Python checkout's
                median ms of 4 versions (times 256: extrapolated).
  8. graph    - the causal-graph kernels (X6) on the card: BASELINE config
                5's graph (10,000 roots of 8 LVs, one run naming all
                10,000 tips, then a chain of 2,048 runs) and the history's
                graph; per graph 4,096 (frontier, target) pairs through
                `make_contains_fn` (one [4,096, runs] reach matrix) and two
                `make_diff_fn` pairs, every answer equal to the host
                `Graph`'s; rounds to the fixed point, flag reads (syncs),
                ms per batch (host clock), device busy ms and events of a
                batch, and the host's ms for the same queries.
  9. merge_step - `parallel.mesh.multichip_merge_step` on one card at full
                width: the multichip example batch (b 256, 512 ops,
                max_ins 16, cap 16,384) replayed from empty documents by
                K1 (one launch per device slice; K1 launches == slices)
                and config 5's reach from the chain tip; K1's output equal
                to its plain version, the reach covering every fan-in root
                and equal to X6's. Prints K1's call_ms, device_ms and
                bound at that shape, and the reach's rounds, syncs and ms.
 10. zone_kernel - X8 (`kernels.zone_tape_run`, the zone engine's whole
                step tape in one launch) against its plain version on the
                card: tapes of a ~2,000-op three-agent history packed with
                the default budgets and with tiny ones (MB 2, MC 8, MD 2:
                continuation blocks and delete spill), all ten carry planes
                equal; B 8 in one launch (each replica its own seq keys)
                against eight B-1 runs; the text against the C++ tracker's;
                then X8 forced to every cluster size (1, 2, 4, 8, 16) in
                both memory forms (`cluster=`), each against the plain
                version; "pick" is the rule's launch shape there.
 11. zone     - `zone_checkout_device` of the history phase's ~40k-op oplog
                from [] to its tip (one X8 launch), text and frontier equal
                to the C++ tracker's; W, plen, n_idx, T; the parts in ms
                (prepare, pack, upload, X8 call_ms and device_ms, the plain
                version on the card, text assembly); the host yardstick
                `merge_native` on the same merge. X8's launch shape
                (`x8.cluster`, `x8.form`: the rule's pick,
                `kernels.cluster_size`), its times, the same times at c 1
                in global memory (`x8.c1_global`, the layout before
                clusters) on the same run, its bound there (the sum over
                steps of each step's bytes) and the serial chain's floor:
                each APPLY step at least an empty APPLY step's time and
                each row step a self-FORK's, both measured with X8 at the
                pick's shape and W (`empty_apply_step_us`,
                `self_fork_step_us`; `barrier_us` is the empty step over
                its two cluster barriers: its time per barrier-separated
                phase).
 12. zone_batch - BASELINE config 4's shape on that tape:
                `execute_zone_batch` at B 1, 132 and 1,024 (one launch each,
                every replica's rank and ever equal to B 1's; carry bytes,
                ms, replicas per second); the sweep: at each B, X8 at every
                launch shape that fits (at B 1 all ten), the least of two
                launches each, every replica equal to B 1's, with the
                rule's pick and the best shape; `execute_zone_batch_sliced`
                at B 132 in slices of 128 steps (one launch per slice),
                equal.
 13. zone_sharded - the zone engine's multi-device forms, the card named
                several times (the split, placement and gathers run; no
                copy between cards takes place): `execute_zone_batch` at
                B 1,024 over the card named 4 times (four X8 launches of
                256 replicas), every replica equal to B 1's, and B 1,022
                refused before any launch; a `DeviceZoneSession(devices=
                [card] * 3, n_rows=4)` over the device soak's 300-op growth
                history through the JAX package's sharded-session drills
                (concurrent edits; forks past the row count, then a
                revisit of an evicted frontier; a bulk insert past the
                slot headroom; a new agent): the text equal to the C++
                tracker's after every sync, a resync forced by each
                drill, the state rows in three equal blocks, every X8
                launch of the session held against its plain version on
                the card.
 14. scheduler_zone - the zone-session bank: the scheduler phase's 256
                documents and edits (its generator seed) through
                `MergeScheduler(fused=False)`, every `DeviceZoneSession`
                resident: 2 of its 6 rounds, whose new agents make every
                session resync, then 2 rounds with the last round's agents,
                where sessions continue their carries in place (listed in
                "shortened"); round 1 traced; every text equal to the
                host's merge after every round, 0 host fallbacks, X8
                launches == the sessions' tape runs, and every launch held
                exactly against the plain version on the same carry and
                tape; docs/s, flush p50/p99, builds, resyncs, continued
                launches, the device busy share and `cluster_hist`, the
                rule's launch shape over the launches (derived from each
                session's carry shape with `kernels.cluster_size`, as the
                wrapper picks it).
 15. scheduler_hydrated - the serve layer over the residency tier: the
                scheduler phase's 256 documents (its generator seed), each
                saved to a `TieredStore` home under a temporary root (removed
                at the end) and served through `MergeScheduler(4 shards,
                device_plan, flush_workers)` whose resolve is a
                `Hydrator(workers=2, warm_max=64)`'s, attached with
                `attach_hydrator`. Each round takes the documents in waves
                of 32: a wave is opened (admitted and flushed: the gate
                defers the cold ones, they hydrate, the bank rebuilds their
                stale sessions on the warm oplogs), then edited
                (`round_edits`'s shape as a position script, applied to the
                warm oplog under the oplog guard and to an in-memory mirror
                that never touches the tier) and flushed again (K2 plans
                the tails, K1 replays them); later waves evict it to its
                snapshot. 4 rounds on per-shard flush workers, then 3 with
                `mesh_window=True` (a new Hydrator over the same store), so
                both gate sites run; round 1 traced. Requires every text
                after its wave equal to the mirror's tip branch, a fresh
                `TieredStore` over the root loading every document to the
                C++ tracker's merge of the mirror, 0 flush leaks,
                quarantines and host fallbacks, the lock witness acyclic,
                K1 launches == fused calls (window dispatches) + per-doc
                replays, K2 launches == resolves, and every K1 and K2 call
                exactly equal to the plain version. Prints docs/s, flush
                and cold-start p50/p99 per stage, the hydration block,
                builds, evictions by site (stale-oplog rebuilds among them),
                K1/K2 launches a round and round 1's device busy share.
 16. storage_soak - `storage.soak.run_storage_soak(churn=True, crash=True,
                slow=True)` at its defaults (120 documents, 12 warm, 8
                rounds, the host engine): crash-restart, compaction killed
                at each fsync point, torn tails, corrupt homes, slow loads;
                fails unless its verdict is ok.
 17. scheduler_qos - the QoS controller steering the device scheduler:
                the scheduler phase's kind of 256 documents (its own
                generator), named `t{k}-doc{nnn}` over 4 tenants, each with
                a class fixed by the generator (128 interactive, 80 bulk,
                48 catchup), through `MergeScheduler(4 shards, device_plan,
                flush_docs=8, flush_workers)` with `attach_qos(QosController(
                interval_s=0.05))`, the controller reading a `TimeSeries`
                through `attach_obs`, and `start_pump()` running (the pump's
                and the controller's threads). 5 rounds: every edit passes
                `controller.admit(cls, tenant_of(doc))` first (a shed edit
                is never applied), admitted ones are applied and submitted
                with their class, spread evenly over 1 s (a synthetic
                arrival process: one edit per admitted document a round;
                the pump flushes what its size or published deadline makes
                due), `drain()` ends the round; round 4 runs
                under `force_mesh_state("warning")`, round 5 under
                "burning". Requires every K1 and K2 call equal to its plain
                version, the controller's steps growing every round, every
                text equal to the host mirror's after every round, 0 host
                and plan fallbacks, interactive's published deadline never
                past the static deadline, no bulk or catchup admit in round
                5 and the lock witness acyclic. Prints docs/s and flush
                p50/p99 a round, queue wait p50/p99, K1/K2 launches a
                round, the `QosMetrics` snapshot (per class admitted, shed,
                deferred and deadline_s; the controller's decisions) and
                round 1's device busy share.
 18. scheduler_obs - the observability bundle on the device scheduler:
                scheduler_qos's setup (256 documents from this phase's own
                generator, 128 interactive, 80 bulk, 48 catchup over 4
                tenants; 4 shards, flush_docs 8, flush workers, device
                planning, `attach_qos(QosController(interval_s=0.05))`)
                with `attach_obs(Observability(sample_rate=0.1, seed=<from
                the generator>, incident_dir=<a temporary directory>))`,
                the device profiler (`obs.devprof.PROFILER`) reset and
                enabled for the phase only, and `start_pump()` running; 3
                free rounds with each round's submits spread over 1 s.
                Requires every K1 and K2 call equal to its plain version,
                every text equal to the host mirror's after every round, 0
                host and plan fallbacks, sampled `serve.admit`,
                `serve.flush` and `serve.device_sync` spans with every
                device_sync under a flush span, devprof's fused device
                calls equal to the scheduler's, devprof's device wait at
                most its flush wall and transfers under the JAX package's
                (rung, purpose) tags, every sampled journey adopted, the
                `serve.flush` p99 over 30 s above 0 after each round,
                interactive's published deadline never past the static
                one, the SLO verdict ok, `serve.flush` exemplars carrying
                sampled trace ids, `obs.snapshot()` JSON-serialisable and
                rendered by `render_metrics`, and the lock witness acyclic.
                Prints docs/s and flush p50/p99 a round, devprof's
                device_fraction (all flushes and fused calls), transfer
                bytes by rung.purpose, the tracer's stats, the journey,
                the SLO verdict, the incident count, and round 0's busy
                share from `torch.profiler` (the card busy) beside
                devprof's device_fraction for the same round (the flushes
                waiting on the fence).
 19. replicated - the replication mesh and its server on the card: three
                port servers in this process (`tools.server.serve(port=0,
                data_dir=<a temporary directory each>, serve_shards=2,
                device=<the card>)`: each merges with its fused device
                scheduler, device plan on), wired into one mesh by
                `attach_replication` (the admit gate `node.owns`, the
                lease-epoch fence `node.active_epoch`; lease TTL 30 s, a
                shared seeded `FaultInjector`), the control plane stepped
                inline (probe, maintain, anti-entropy). 96 documents of
                the scheduler phase's kind, created through `SyncClient`
                at their rendezvous owner, each with two clients on two
                different nodes; 4 rounds in which every client makes 1-4
                edits (pull, edit, sync; 8 client threads), so about two
                thirds of the pushes are proxied to the owner. Round 2
                stops the pumps, runs its traffic and hands 8 queued
                documents to another node with a placement override (the
                handoff's drain fences their queued merges), then restarts
                the pumps; round 3 partitions one node from both others
                for its traffic, then heals. After each round, with a
                deadline: every node holds every document at the mirror's
                version (the union of the clients' oplogs); then every
                node's text equals the mirror's C++ tracker checkout
                (`Branch.merge_reference`), exactly one node holds each
                document's ACTIVE lease, and its scheduler's text equals
                the mirror; each owner's device session that is caught
                up with its oplog is read on the card and equals the
                mirror too, at least 8 documents a node. Then, with
                DT_SERVER_DEVICE set, POST /doc/{id}/history on 4
                documents' owners: one K3 launch per
                strip, each equal to its plain version, each strip's texts
                equal to the host's checkout at the same LV. Requires every
                K1 and K2 call equal to its plain version, K1 launches ==
                fused calls + per-doc replays and K2 launches == resolves
                over the three schedulers, every X8 launch (where
                `Branch.merge`'s engine policy picks the zone engine for a
                client's or a server's merge, as it may once the zone
                phases have run) equal to its plain version on a copy of
                its carry, 0 host and plan fallbacks (the
                length fence never failed), epoch-fenced work in round 2,
                proxied writes and the lock witness acyclic. Prints per
                round the wall, traffic and convergence seconds, per node
                docs/s, submits, denials, fenced work, builds and
                evictions, pushes, proxied and locally accepted writes and
                K1/K2 launches; per node flush p50/p99, queue wait p99,
                the proxy, handoff, anti-entropy, merge-gate and wire
                counters; the handoffs' ms, the seconds to converge after
                the heal, the history strips' ms, the `dt_wire_*` families
                and round 1's device busy share.
 20. scenario - the scenario harness over three replicas' device
                schedulers: `workload.run_scenario(get_scenario(
                "flash-crowd"), qos=True, device=<the card>)`, the scenario
                registered unchanged (3 servers, serve_shards 2, follower
                reads on every server, 2 tenants x 8 documents, 20 virtual
                seconds at ticks of 0.5 s; bursty arrivals at 12/s with x8
                bursts of 1.5 s every 6 s; a hot set of 2 documents at
                weight 0.85 rotating every 5 s; 20 reads per write; session
                churn every 4 s: ~600-800 writes and ~12,000-16,000 reads
                over real HTTP), the QoS controller on every server. Every
                server the run boots is kept (`Served`: a wrapper on
                `tools.server.serve`), every `ReadPath.read` recorded, and
                tick 24 traced by `torch.profiler` for the card's busy
                share. Requires byte-identical convergence after the
                reconcile and the scorecard ok, no read served locally
                past a `max_staleness` budget it carried, every K1, K2, X8
                (and K3) call of the run equal to its plain version, K1
                launches == fused calls + per-doc replays and K2 launches
                == resolves over the three schedulers, 0 host and plan
                fallbacks and no scheduler fault. Prints the scorecard's
                top-level numbers, writes and reads attempted, succeeded
                and refused, the read path's counters (local, waited,
                proxied, refused, cache), staleness and read latency
                p50/p99, per-node flush p50/p99 and docs/s, burn-minutes,
                launches and the traced tick's device busy share.
 21. follower_reads - `read.bench.run_read_bench` at its defaults (2
                servers, 3 documents of 16 KiB, 6 readers x 120 Zipf-1.2
                reads a phase, a min-version token every 4th read) with
                serve_shards 2 on the card: the control phase (every
                follower read proxied to the owner) against follower reads
                under a 2 s budget, every response checked client-side for
                its staleness and token. Requires the bench's pass and the
                same kernel checks; prints local against proxied read
                latency, the bench's speedup and verdict.
 22. replicate_soak - `replicate.soak.run_replicate_soak(servers=3,
                rounds=8, crash=True, asym=True, churn=True,
                serve_shards=2, device=<the card>)`: drops, one-way
                partitions, two crash-restarts on their journals, a join
                and a leave, with the device schedulers under the crash.
                Requires the soak's verdict (converged, zero split-brain),
                the lock witness acyclic and the same kernel checks over
                every server incarnation's scheduler.
 23. cli      - `tools.cli.main` in-process, as a user types it:
                `serve-bench --shards 4 --docs 64 --mode concurrent
                --device-plan --json --metrics-out <tmp>` on the CLI's
                default device (the card; K2 plans the tails, K1 replays
                them), then the same at `--docs 16 --no-fused` (the
                zone-session bank, X8 per sync), at the CLI's own widths
                (4 sessions a shard). Each must exit 0 (parity and SLO)
                and print the report it wrote; K1 launches == fused calls
                + per-doc replays, K2 == resolves, X8 == its calls, every
                K1, K2 and X8 call equal to its plain version, 0 host and
                plan fallbacks.
 24. device_soak - `tools.device_soak.main(["--corpus", <the history
                phase's ~40k-op oplog as a .dt file>, "--hours", "0.006",
                "--log", <tmp>, "--device", "cuda"])`: ~22 s of 2-agent
                merge-per-edit traffic through one `DeviceZoneSession`,
                the session's text checked against the C++ tracker after
                every sync by the soak itself. Requires soak_start,
                session_built and soak_end in its log, no PARITY_MISMATCH
                and no device_crash, syncs > 0, X8 launches == its calls,
                every continuation launch equal to its plain version and
                of the resync launches the first (the build over the whole
                zone, whose plain version takes seconds). At the session's
                width (pow2(2 W)) 22 s of growth forces no resync, so the
                same command then soaks a 300-op history of the same
                generator for ~5 s, whose small zone the growth outgrows:
                resyncs >= 1, every launch held against its plain version.
 25. replay_batch - `kernels.replay_batch_kernel` (the counterpart of
                `replay_batch_pallas`: one K1 launch over a whole op
                sequence from empty rows) against its plain version at b
                128, n 64, cap 4,096, max_ins 16 on in-contract ops; its
                call_ms, device_ms, plain ms and HBM bound. It is on no
                serve path.
 26. kernels  - one line for K1, K2, K3, X8 and `replay_batch_kernel`:
                launches on the main path (K1
                and K2 in the serve phase, K3 in the checkout phase; per
                path in `launches_by_path`, the scheduler's, the flush
                window's, the hydrated scheduler's, the QoS scheduler's,
                the observed scheduler's, the replicated mesh's, the
                scenario's, the follower reads', the soak's and the CLI's
                (K1, K2, and X8 where the engine policy gives a merge to
                the zone engine; the CLI's zone-session bench and the
                device soak for X8), the history's and the replicated mesh's (K3, and
                a later phase's where one launches it) and the merge
                step's (K1) too; `replay_batch_kernel`'s from its own check), max
                error against the plain version (see below), and at the
                main path's widest call two times: `call_ms` (CUDA events
                around back-to-back wrapper calls: host and device) and
                `device_ms` (the card's own time per call: CUDA events
                around calls queued behind a sleep on the card, so the
                host's work is not in it); for K3 also `device_ms` with
                the L2 cold (a 256 MB buffer overwritten before each call)
                and its `device_ms` at each merge call. "ms", "plain_ms"
                and "library_ms" are call times, as in earlier slices. Beside
                them the HBM bound and the library yardstick's call_ms and
                device_ms (`torch.cumsum` for K2); then the card's name and
                power limit. max_abs_err covers the kernel phases, the serve
                phase's captured calls, the scheduler runs' calls, the
                served phases' calls (replicated, scenario, follower_reads,
                replicate_soak, cli), the device soak's held X8 launches,
                the history's and the history strips' K3
                calls and the merge step's K1 call; K3's line
                has its numbers at the history's shape under "history",
                K1's at the merge step's under "merge_step". The
                serve line carries K1's call_ms and
                device_ms at every captured bucket, and K1's CTAs per
                launch as derived from the launcher's grid rule
                (b * ceil(cap / 512)), not observed. X8's entry has its
                launches per path (zone, zone_batch, zone_sharded,
                scheduler_zone, the four served phases, cli and
                device_soak), its max error over the zone_kernel, zone,
                zone_sharded, scheduler_zone, served, cli and device_soak
                phases' launches, its times at the zone phase's shape and its
                bounds there: `bound_ms`, the sum over steps of each
                step's inputs read once and outputs written once, at HBM
                rate; `whole_tape_ms`, the tape once and the carry in and
                out once (a lower limit blind to the chain); and
                `serial_floor_ms`, the chain's barrier-separated phases
                times one phase's measured time.

The host's reference merges call the C++ tracker directly
(`Branch.merge_reference`), so no engine switch or policy state can make a
reference the engine under test; the history phase's "Python checkout"
yardstick runs with DT_TPU_NO_NATIVE set.

Each phase draws from its own generator, seeded by (--seed, phase), so the
served documents do not change when the kernel phases' shapes do.

Each phase's counts are set to 0 just before it drives its path and read
just after. The last line is {"ok": true, "device": {...}}; any failure
exits nonzero before it. Without CUDA, or without the package beside this
script, it fails at once.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

MAX_INS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# (b, cap, n, max_ins): the PR 1 grid, then the hazards of K1's tiled
# gather: a cap that is no multiple of the tile (4,100), cap == max_ins,
# the main path's flush-docs buckets at every cap, tapes of 1,024 and 2,048
# ops (past one staging tile of the op scalars)
KERNEL_SHAPES = ([(b, cap, n, MAX_INS) for b in (1, 8, 256)
                  for cap in (256, 4096, 32768, 65536) for n in (1, 64, 256)]
                 + [(8, 4100, 256, MAX_INS), (3, 4100, 64, MAX_INS),
                    (8, MAX_INS, 64, MAX_INS), (8, 64, 64, 64),
                    (8, 8192, 256, MAX_INS), (8, 16384, 256, MAX_INS),
                    (8, 8192, 1024, MAX_INS), (8, 8192, 2048, MAX_INS)])
# K2 at the edges of its warp's 128-element chunks and of 32 lanes, past
# 2,048 elements, and at the PR 2 shapes
K2_SHAPES = [(b, n) for b in (1, 7, 8, 256, 257)
             for n in (0, 1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                       2047, 2048, 2049, 4096)]
# (kind, b, runs, cap, arena pool): random tables - one run; truncation
# with runs past cap; past the TPU kernel's 8,192-run table; a main-path-
# like batch; truncation at 16,384 runs; 70,000 runs; a cap that is no
# multiple of the gather's 512-output tile; b 1 at cap 65,536, truncated
# and zero-filled - then the tiled gather's hazards by name
K3_CASES = [("random", 1, 1, 8, 8), ("random", 8, 511, 256, 2048),
            ("random", 8, 16384, 65536, 40000),
            ("random", 256, 4096, 8192, 16384),
            ("random", 4, 16384, 4096, 40000),
            ("random", 2, 70000, 8192, 150000),
            ("random", 3, 900, 4100, 5000),
            ("random", 1, 2048, 65536, 40000),
            ("random", 1, 512, 65536, 40000),
            ("total_zero", 2, 64, 1024, 64),
            ("one_run_spans_every_tile", 2, 6, 16384, 16584),
            ("zero_length_runs_then_live_run", 2, 1600, 2048, 4096),
            ("arena_off_past_pool", 3, 256, 2048, 512),
            ("shared_rows", 256, 4096, 4096, 16384),
            ("shared_rows", 256, 9341, 65536, 40000)]
K3_TILE = 512                      # outputs per CTA of K3's gather
L2_FLUSH_BYTES = 256 << 20         # overwritten before each cold-L2 call
# device activity only: tracing every host op would multiply the window's
# wall time
PROFILED = [torch.profiler.ProfilerActivity.CUDA]
ALPHABET = "abcdefghijklmnopqrstuvwxyz      ,.\nAEIOUé中文😀"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def exact_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max |a - b| over int32 tensors, computed in int64."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ---- phase 1: build ---------------------------------------------------------

def phase_build(pool: ThreadPoolExecutor):
    """nvcc for each kernel and g++ for the native library, all at once.
    Returns the build line once the kernels are built, and the native
    build's future (in `pool`): the kernel phases do not need the native
    library, so the caller joins it after them."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.native import build as native_build
    t0 = time.perf_counter()
    native = pool.submit(native_build.build)
    info = kernels.build()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, v in info.items()}
    return {"phase": "build", "seconds": secs, "kernels": sorted(info),
            "kernel_seconds": {k: v["seconds"] for k, v in info.items()},
            "ptxas": ptxas}, native


# ---- phase 2: kernel against plain -------------------------------------------

def random_window(rng: np.random.Generator, b: int, n: int, cap: int,
                  mi: int, device) -> List[torch.Tensor]:
    """A random window of every op kind. Rows 1 and b//2 carry one op past
    max_ins (poison); the last quarter of rows are inert padding (-1
    length, zero ops); a quarter of the ops sit at the buffer's end, where
    deletes pull the roll's wrap-around into the row."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    docs = torch.randint(1, 0x10FFFF, (b, cap), generator=gen,
                         dtype=torch.int32, device=device)
    lens = rng.integers(0, cap, b)
    shape = (b, n)
    pos = rng.integers(0, cap + 3, shape)
    pos = np.where(rng.random(shape) < 0.25,
                   cap - rng.integers(1, mi + 2, shape), pos)
    kind = rng.integers(0, 4, shape)               # ins, del, replace, no-op
    dlen = np.where((kind == 1) | (kind == 2), rng.integers(1, mi + 1, shape),
                    0)
    ilen = np.where((kind == 0) | (kind == 2), rng.integers(1, mi + 1, shape),
                    0)
    chars = rng.integers(1, 0x10FFFF, shape + (mi,))
    if b >= 8:
        for r in (1, b // 2):
            dlen[r, int(rng.integers(0, n))] = mi + 1
        for r in range(b - b // 4, b):
            lens[r] = -1
            pos[r] = dlen[r] = ilen[r] = 0
            chars[r] = 0
    host = [lens, pos, dlen, ilen, chars]
    return [docs] + [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                     .to(device) for a in host]


def k1_calls_err(calls, mi: int) -> int:
    """Every call in `calls` (K1's arguments) launched again and held
    against K1's plain version on the same inputs. Rows are independent,
    so the calls that share (n, cap) are stacked along the batch axis and
    the plain version runs once per (n, cap)."""
    from diamond_types_tpu_torch.gpu import kernels
    groups: Dict[tuple, List[tuple]] = {}
    for args in calls:
        groups.setdefault((args[2].shape[1], args[0].shape[1]),
                          []).append(args)
    worst = 0
    for group in groups.values():
        got = [kernels.apply_ops_window(*args[:6], mi) for args in group]
        stacked = [torch.cat([args[i] for args in group]) for i in range(6)]
        want_d, want_l = kernels.apply_ops_window_plain(*stacked, mi)
        torch.cuda.synchronize()
        worst = max(worst,
                    exact_err(torch.cat([d for d, _ in got]), want_d),
                    exact_err(torch.cat([ln for _, ln in got]), want_l))
    return worst


def window_bytes(b: int, n: int, cap: int, mi: int) -> int:
    """Bytes K1 must move at minimum: every input read once (docs, lens,
    the op tape), every output written once (docs, lens)."""
    return 4 * (2 * b * cap + 2 * b + b * n * (3 + mi))


def phase_kernel_vs_plain(rng: np.random.Generator, device) -> dict:
    from diamond_types_tpu_torch.gpu import kernels
    worst = 0
    shapes = []
    for b, cap, n, mi in KERNEL_SHAPES:
        args = random_window(rng, b, n, cap, mi, device)
        got_d, got_l = kernels.apply_ops_window(*args, mi)
        want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
        torch.cuda.synchronize()
        err = max(exact_err(got_d, want_d), exact_err(got_l, want_l))
        poisoned = int((want_l == -1).sum())
        check(err == 0 and torch.equal(got_d, want_d)
              and torch.equal(got_l, want_l),
              f"K1 differs from its plain version at b={b} cap={cap} "
              f"n={n} max_ins={mi}: max abs err {err}")
        worst = max(worst, err)
        shapes.append([b, cap, n, mi, poisoned])
    return {"phase": "kernel_vs_plain", "kernel": "apply_ops_window",
            "shapes": len(shapes), "max_abs_err": worst,
            "b_cap_n_maxins_poisoned": shapes, "exact": True}


def k2_err(nv: torch.Tensor, ov: torch.Tensor) -> int:
    """Launch K2 once and hold it against its plain version."""
    from diamond_types_tpu_torch.gpu import kernels
    got = kernels.xform_positions(nv, ov)
    want = kernels.xform_positions_plain(nv, ov)
    torch.cuda.synchronize()
    return max(exact_err(g, w) for g, w in zip(got, want))


def resolve_err(buf: torch.Tensor, b: int, n: int) -> int:
    """Hold one resolve's buffer, as the card left it (`kernels.resolve_rows`:
    the linearize kernel and K2), against the plain chain run on the CPU
    from its columns: every word of the columns and the outputs (not the
    kernel's scratch, which rows wider than 4,096 use)."""
    from diamond_types_tpu_torch.gpu import kernels
    torch.cuda.synchronize()
    out = 11 * b * n + 2 * b
    got = buf[:out].cpu()
    want = torch.zeros(kernels.resolve_words(b, n), dtype=torch.int32)
    want[:7 * b * n] = got[:7 * b * n]
    kernels.resolve_rows(want, b, n)
    return exact_err(got, want[:out])


def phase_k2_vs_plain(rng: np.random.Generator, device) -> dict:
    worst = 0
    for b, n in K2_SHAPES:
        nv = rng.integers(0, 49, (b, n))
        ov = rng.integers(0, 49, (b, n))
        neg = slice(b - max(b // 4, 1), b)    # prefix sum < 0 throughout
        ov[neg] = nv[neg] + rng.integers(1, 8, ov[neg].shape)
        nv, ov = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
                  .to(device) for a in (nv, ov))
        err = k2_err(nv, ov)
        check(err == 0, f"K2 differs from its plain version at b={b} "
              f"n={n}: max abs err {err}")
        worst = max(worst, err)
    return {"phase": "kernel_vs_plain", "kernel": "xform_positions",
            "shapes": len(K2_SHAPES), "b_n": K2_SHAPES,
            "max_abs_err": worst, "exact": True}


def k3_err(args: List[torch.Tensor], cap: int) -> int:
    """Launch K3 once and hold it against its plain version."""
    from diamond_types_tpu_torch.gpu import kernels, linearize
    got = kernels.materialize_runs(*args, cap)
    want = linearize.materialize(*args, cap)
    torch.cuda.synchronize()
    return max(exact_err(g, w) for g, w in zip(got, want))


def k3_table(rng: np.random.Generator, kind: str, b: int, n: int, cap: int,
             pool: int, device) -> List[torch.Tensor]:
    """perm, vis_len, arena_off, arena for K3. "random": lengths 0-5 (0-99
    on every other row, runs of several warps) with 30% empty runs. The
    hazards, with runs set in document (perm) order: "total_zero" (every
    run empty); "one_run_spans_every_tile" (one run longer than cap, in
    the last row behind a zero-length run at the same start);
    "zero_length_runs_then_live_run" (a live run, then three tiles' worth
    of empty runs that start where it ends - the next tile's first output,
    in the last row inside a thread's 4 outputs - then live runs); "arena_off_past_pool" (offsets past the pool in the first
    row, negative in half the last row's runs: the clamp's work);
    "shared_rows" (the history path's form: ONE perm, arena_off and arena
    row, [1, n] and [1, pool], for b rows of visibility with 30% empty
    runs, cap < total on the first cases' rows)."""
    if kind == "shared_rows":
        vl = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
        host = [rng.permutation(n)[None], vl,
                rng.integers(0, pool - 5, (1, n)),
                rng.integers(1, 0x10FFFF, (1, pool))]
        return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                .to(device) for a in host]
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    vl = rng.integers(0, 6, (b, n))
    vl[::2] = rng.integers(0, 100, (len(vl[::2]), n))
    vl *= rng.random((b, n)) < 0.7
    off = rng.integers(0, pool, (b, n))
    if kind == "total_zero":
        vl[:] = 0
    elif kind == "one_run_spans_every_tile":
        vl[:] = 0
        vl[:, 0] = cap + 100
        vl[-1, 0], vl[-1, 1] = 0, cap + 3
        off[:] = rng.integers(0, pool - cap - 100, (b, n))
    elif kind == "zero_length_runs_then_live_run":
        vl[:, :3 * K3_TILE + 2] = 0
        vl[:, 0] = K3_TILE
        vl[-1, 0] = K3_TILE - 2
        vl[:, 3 * K3_TILE + 1] = 5
    elif kind == "arena_off_past_pool":
        off[0] = rng.integers(pool, pool + 5000, n)
        off[-1, ::2] = -rng.integers(1, 5000, (n + 1) // 2)
    if kind != "random":                  # lengths given in perm order
        vis, offs = np.zeros_like(vl), np.zeros_like(off)
        for r in range(b):
            vis[r, perm[r]] = vl[r]
            offs[r, perm[r]] = off[r]
        vl, off = vis, offs
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (perm, vl, off, arena)]


def phase_k3_vs_plain(rng: np.random.Generator, device) -> dict:
    worst = 0
    cases = []
    for kind, b, n, cap, pool in K3_CASES:
        args = k3_table(rng, kind, b, n, cap, pool, device)
        err = k3_err(args, cap)
        check(err == 0, f"K3 differs from its plain version on {kind} at "
              f"b={b} runs={n} cap={cap}: max abs err {err}")
        worst = max(worst, err)
        cases.append([kind, b, n, cap, int(args[1].long().sum(1).max())])
    return {"phase": "kernel_vs_plain", "kernel": "materialize_runs",
            "shapes": len(cases), "kind_b_runs_cap_maxtotal": cases,
            "max_abs_err": worst, "exact": True}


# ---- phase 3: the serve flush (main path) -----------------------------------

@dataclass
class ServeConfig:
    n_docs: int = 256
    base_min: int = 2048
    base_max: int = 12288
    windows: int = 4              # few: the smoke has a time budget
    wide_window: int = 2          # this window replays one bucket per cap
    flush_docs: int = 8
    edits_min: int = 8
    edits_max: int = 64
    ins_max: int = 48
    del_max: int = 40
    max_ins: int = MAX_INS
    headroom: float = 2.0
    profile_window: int = 1        # this window is traced: device share


def rand_text(rng: np.random.Generator, k: int) -> str:
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), k))


def fork(branch):
    from diamond_types_tpu_torch import Branch
    from diamond_types_tpu_torch.utils.rope import Rope
    out = Branch()
    out.version = list(branch.version)
    out.content = Rope(branch.snapshot())
    return out


def host_branch(ol, frontier=None):
    """The host reference: a branch of `ol` at `frontier` (default: the
    tip), merged by the C++ tracker called directly
    (`Branch.merge_reference`), which no engine switch or policy reaches."""
    from diamond_types_tpu_torch import Branch
    out = Branch()
    out.merge_reference(ol, ol.version if frontier is None else frontier)
    return out


def random_edits(rng, ol, agent: int, branch, k: int,
                 cfg: ServeConfig) -> None:
    for _ in range(k):
        cur = len(branch)
        if cur and rng.random() < 0.4:
            p = int(rng.integers(0, cur))
            end = min(cur, p + int(rng.integers(1, cfg.del_max + 1)))
            branch.delete(ol, agent, p, end)
        else:
            p = int(rng.integers(0, cur + 1))
            branch.insert(ol, agent, p, rand_text(
                rng, int(rng.integers(1, cfg.ins_max + 1))))


def build_docs(rng, cfg: ServeConfig):
    from diamond_types_tpu_torch import OpLog
    ols = []
    for d in range(cfg.n_docs):
        ol = OpLog()
        ol.doc_id = f"doc{d}"
        a = ol.get_or_create_agent_id("typist")
        n = int(rng.integers(cfg.base_min, cfg.base_max + 1))
        done = 0
        while done < n:                    # typed in runs of 1..64 chars
            k = min(n - done, int(rng.integers(1, 65)))
            ol.add_insert(a, done, rand_text(rng, k))
            done += k
        ols.append(ol)
    return ols


def buckets_by_cap(sessions, idx: List[int], size: int) -> List[List[int]]:
    by_cap: Dict[int, List[int]] = {}
    for i in idx:
        by_cap.setdefault(sessions[i].cap, []).append(i)
    out = []
    for cap in sorted(by_cap):
        g = by_cap[cap]
        step = size if size > 0 else len(g)
        out += [g[k:k + step] for k in range(0, len(g), step)]
    return out


class Spy:
    """Stands in for `owner.<name>` inside a with-block and calls through
    to the real function, so its launch count moves as usual. Records each
    call's host seconds and, with keep=True, its arguments (fresh tensors
    that the caller never writes again) for the checks and timings after
    the phase. Calls may come from several threads: appending to a list
    is safe under the interpreter lock."""

    def __init__(self, owner, name: str, keep: bool = False) -> None:
        self.owner, self.name, self.keep = owner, name, keep
        self.seconds: List[float] = []
        self.args: List[tuple] = []

    def __enter__(self) -> "Spy":
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.owner, self.name, self.real)

    # a kernel wrapper counts its launches on its module-level name, which
    # is this stand-in while the block runs: keep the count on the real one
    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.real.launches = value

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        out = self.real(*args, **kwargs)
        self.seconds.append(time.perf_counter() - t)
        if self.keep:
            self.args.append(args)
        return out


class Hits(Spy):
    """A Spy on `arena.acquire` that counts its hits (the parked rows
    handed back) and misses (the caller gathers instead)."""

    def __init__(self, owner, name: str) -> None:
        super().__init__(owner, name)
        self.hits = self.misses = 0

    def __call__(self, *args, **kwargs):
        out = super().__call__(*args, **kwargs)
        if out is None:
            self.misses += 1
        else:
            self.hits += 1
        return out


class Stamp(Spy):
    """A Spy that also keeps, for each call, the host clock at entry and
    at return and CUDA events recorded just before and just after it. With
    sync=True it waits for the card before it returns, so the host clock
    after it starts from an idle card."""

    def __init__(self, owner, name: str, sync: bool = False) -> None:
        super().__init__(owner, name)
        self.sync = sync
        self.marks: List[tuple] = []

    def __call__(self, *args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        out = self.real(*args, **kwargs)
        ev[1].record()
        if self.sync:
            torch.cuda.synchronize()
        self.marks.append((t, time.perf_counter(), *ev))
        return out


class KeptRuns(Spy):
    """A Spy on `kernels.zone_tape_run` that keeps each launch's tape and
    clones of its carry before and after (X8 updates the carry in place),
    for the plain version after the phase."""

    def __init__(self, owner, name: str) -> None:
        super().__init__(owner, name)
        self.runs: List[tuple] = []

    def __call__(self, carry, xs, plen, cluster=None):
        from diamond_types_tpu_torch.gpu.zone_kernel import ZoneCarry
        before = ZoneCarry(*(t.clone() for t in carry))
        out = super().__call__(carry, xs, plen, cluster=cluster)
        self.runs.append((xs, plen, before,
                          ZoneCarry(*(t.clone() for t in out))))
        return out


def checkout_breakdown(docs, cap: int, device) -> dict:
    """One `checkout_batch_device` call taken apart: `pad_docs` and the
    upload of its arrays (host clock), `fugue_linearize` and K3 (CUDA
    events around each), then the download and decode (host clock, from an
    idle card: the card is synchronized right after K3)."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import merge_kernel as mk
    with Stamp(mk, "pad_docs") as pad, \
            Stamp(mk, "fugue_linearize") as lin, \
            Stamp(kernels, "materialize_runs", sync=True) as k3:
        torch.cuda.synchronize()
        t = time.perf_counter()
        mk.checkout_batch_device(docs, cap=cap, device=device)
        call_s = time.perf_counter() - t
    p0, p1, _, _ = pad.marks[0]
    l0, _, le0, le1 = lin.marks[0]
    _, k1, ke0, ke1 = k3.marks[0]
    return {"cap": cap, "docs": len(docs), "call_ms": 1e3 * call_s,
            "pad_docs_ms": 1e3 * (p1 - p0), "upload_ms": 1e3 * (l0 - p1),
            "fugue_linearize_ms": le0.elapsed_time(le1),
            "k3_ms": ke0.elapsed_time(ke1),
            "download_decode_ms": 1e3 * (t + call_s - k1)}


def run_serve(rng: np.random.Generator, device, cfg: ServeConfig,
              capture: bool):
    """Build the documents and sessions, then drive the flush windows:
    plan through `plan_tails_device` (K2), replay through
    `kernel_fused_replay` (K1). K1's and K2's launch counts are set to 0
    just before the windows and read just after them. Returns (stats, the
    oplogs, each session's frontier after window 0, each document's text
    in the first agent's merged branch after the last window)."""
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels, xform

    t0 = time.perf_counter()
    ols = build_docs(rng, cfg)
    sessions = [ff.FusedDocSession(ol, max_ins=cfg.max_ins,
                                   headroom=cfg.headroom, device=device)
                for ol in ols]
    tips = [host_branch(ol) for ol in ols]
    setup_s = time.perf_counter() - t0
    caps0 = sorted({s.cap for s in sessions})

    stats = {"windows": cfg.windows, "buckets": 0, "rows": 0, "lvs": 0,
             "fence_failures": 0, "resyncs": 0, "plan_s": 0.0,
             "replay_s": 0.0, "verify_s": 0.0, "edit_s": 0.0,
             "flush_s_per_window": [], "plan_windows": []}
    captured = []                  # (window, bucket size, K1 inputs)

    def flush(w: int) -> float:
        """Plan and replay window w; returns the seconds spent on what is
        not the flush (the host plans of window 0, captures)."""
        t = time.perf_counter()
        n_resolved, n_assembled = len(resolve.seconds), len(assemble.seconds)
        plans, pstats = xform.plan_tails_device(sessions)
        plan_s = time.perf_counter() - t
        resolve_s = sum(resolve.seconds[n_resolved:])
        stats["plan_windows"].append(dict(
            pstats, window=w, extract_ms=1e3 * (plan_s - resolve_s),
            resolve_ms=1e3 * resolve_s,
            assemble_ms=1e3 * sum(assemble.seconds[n_assembled:])))
        check(pstats["device_docs"] > 0,
              f"window {w}: no document was planned on the device")
        excluded = 0.0
        if w == 0:
            t = time.perf_counter()
            host = [s.plan_tail() for s in sessions]
            excluded = time.perf_counter() - t
            stats["host_plan_ms_window0"] = 1e3 * excluded
            for d, (h, p) in enumerate(zip(host, plans)):
                check((h.new_len, sorted(h.frontier), h.synced_to)
                      == (p.new_len, sorted(p.frontier), p.synced_to),
                      f"doc {d}: the device plan's length or frontier "
                      "differs from the host plan's")
        t = time.perf_counter()
        replay = []
        for i, (s, p) in enumerate(zip(sessions, plans)):
            if not p.fits(s.cap):
                s.resync_for(p)
                stats["resyncs"] += 1
            elif p.n_ops == 0:
                s.commit_host(p)
            else:
                replay.append(i)
        stats["plan_s"] += plan_s + time.perf_counter() - t

        wide = w == cfg.wide_window
        for bucket in buckets_by_cap(sessions, replay,
                                     0 if wide else cfg.flush_docs):
            bs = [sessions[i] for i in bucket]
            bp = [plans[i] for i in bucket]
            if capture and (wide or w == 0):
                # K1's inputs: the bucket packed as the rung packs it, kept
                # apart so the replay's own buffers are freed as usual
                t = time.perf_counter()
                captured.append((w, len(bucket), ff.pack_bucket(bs, bp)))
                excluded += time.perf_counter() - t
            t = time.perf_counter()
            ok, _fence_s = ff.kernel_fused_replay(bs, bp)
            stats["replay_s"] += time.perf_counter() - t
            stats["buckets"] += 1
            stats["rows"] += sum(p.n_ops for p in bp)
            stats["fence_failures"] += ok.count(False)
        return excluded

    frontiers0 = []                # each session's frontier after window 0
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    lin = kernels.resolve_rows     # its count: the linearize launches
    k1.launches = k2.launches = lin.launches = 0
    with Spy(xform, "resolve_positions") as resolve, \
            Spy(xform, "_assemble_plan") as assemble, \
            Spy(kernels, "resolve_rows", keep=capture) as k2_calls:
        for w in range(cfg.windows):
            t = time.perf_counter()
            lv0 = sum(len(ol) for ol in ols)
            for ol, tip in zip(ols, tips):
                b1, b2 = fork(tip), fork(tip)
                for name, br in ((f"fork{w}a", b1), (f"fork{w}b", b2)):
                    k = int(rng.integers(cfg.edits_min, cfg.edits_max + 1))
                    random_edits(rng, ol, ol.get_or_create_agent_id(name),
                                 br, k, cfg)
                tip.merge_reference(ol, ol.version)  # the first merges
                random_edits(rng, ol, ol.get_or_create_agent_id("typist"),
                             tip, 1, cfg)      # ...and edits on top
            stats["lvs"] += sum(len(ol) for ol in ols) - lv0
            stats["edit_s"] += time.perf_counter() - t

            profiling = w == cfg.profile_window
            with (torch.profiler.profile(activities=PROFILED) if profiling
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()    # the profiler's start and stop
                excluded = flush(w)        # stay outside the flush time
                stats["flush_s_per_window"].append(
                    time.perf_counter() - t - excluded)
            if profiling:
                stats["profile"] = device_share(
                    prof, stats["flush_s_per_window"][-1], w)
            if w == 0:
                frontiers0 = [list(s.frontier) for s in sessions]

            t = time.perf_counter()
            for d, (s, tip) in enumerate(zip(sessions, tips)):
                # the first agent's branch: it merged every agent and is
                # at the tip (the checkout phase holds the last window's
                # branches against fresh host checkouts)
                check(s.text() == tip.snapshot(), f"window {w}: doc {d} "
                      "text differs from the host's merge")
            stats["verify_s"] += time.perf_counter() - t
    launches, k2_launches, lin_launches = (k1.launches, k2.launches,
                                           lin.launches)

    wins = stats["plan_windows"]
    resolves = sum(x["batches"] for x in wins)
    fallbacks = sum(x["fallbacks"] for x in wins)
    check(stats["fence_failures"] == 0,
          f"{stats['fence_failures']} fence failures on the main path")
    check(fallbacks == 0, f"{fallbacks} device plans fell back to the host")
    check(launches == stats["buckets"],
          f"K1 launched {launches} times for {stats['buckets']} buckets")
    check(k2_launches == resolves == len(resolve.seconds),
          f"K2 launched {k2_launches} times for {resolves} resolves")
    check(lin_launches == resolves,
          f"the linearize kernel launched {lin_launches} times for "
          f"{resolves} resolves")
    flush_s = stats["plan_s"] + stats["replay_s"]
    stats.update({"phase": "serve", "docs": cfg.n_docs,
                  "caps_at_build": caps0,
                  "caps_at_end": sorted({s.cap for s in sessions}),
                  "launches": launches, "k2_launches": k2_launches,
                  "lin_launches": lin_launches,
                  "resolves": resolves, "fallbacks": fallbacks,
                  "device_docs": sum(x["device_docs"] for x in wins),
                  "host_docs": sum(x["host_docs"] for x in wins),
                  "setup_s": setup_s,
                  "device_plan_ms": 1e3 * stats["plan_s"],
                  "replay_ms_per_bucket": 1e3 * stats["replay_s"]
                  / max(stats["buckets"], 1),
                  "flush_lv_per_s": stats["lvs"] / flush_s,
                  "flush_rows_per_s": stats["rows"] / flush_s})
    stats["captured"] = captured
    stats["k2_args"] = k2_calls.args
    return stats, ols, frontiers0, [tip.snapshot() for tip in tips]


def device_share(prof, wall_s: float, window: int) -> dict:
    """Device time inside a profiled flush window (kernels, copies and
    sets on the card) against the window's wall time on the host clock,
    with the device events that took the most of it."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"window": window, "wall_ms": 1e3 * wall_s,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (1e3 * wall_s),
            "top": [[k[:80], ms, c] for k, ms, c in rows[:8]]}


@dataclass
class SchedulerConfig:
    shards: int = 4
    rounds: int = 6
    flush_docs: int = 8
    max_sessions_per_shard: int = 128   # >= the documents per shard
    profile_round: int = 1              # this round is traced
    fresh_checkouts: int = 16           # docs checked out anew at the end
    bench_docs: int = 64
    bench_txns: int = 8                 # rounds of the continuous feed
    bench_steady_rounds: int = 8


def round_edits(rng, ols, tips, r: int, cfg: ServeConfig,
                names: Optional[int] = None) -> list:
    """One scheduler round's edits: per document two agents fork from the
    first agent's merged tip and edit concurrently, then the first agent
    merges the tip (the host's C++ tracker, `Branch.merge_reference`) and
    edits on top. The two agents are named after round `names` (default:
    `r`): new names register new agents, which makes a zone session
    resync; a past round's names keep the agents, and the session
    continues its carry. Returns the (doc_id, n_ops) submits."""
    subs = []
    tag = r if names is None else names
    for ol, tip in zip(ols, tips):
        n_ops = 1
        for name, br in ((f"fork{tag}a", fork(tip)),
                         (f"fork{tag}b", fork(tip))):
            k = int(rng.integers(cfg.edits_min, cfg.edits_max + 1))
            random_edits(rng, ol, ol.get_or_create_agent_id(name), br, k,
                         cfg)
            n_ops += k
        tip.merge_reference(ol, ol.version)    # the first agent merges...
        random_edits(rng, ol, ol.get_or_create_agent_id("typist"), tip, 1,
                     cfg)                  # ...and edits on top
        subs.append((ol.doc_id, n_ops))
    return subs


def run_scheduler(rng: np.random.Generator, device, cfg: ServeConfig,
                  scfg: SchedulerConfig, mesh_window: bool = False) -> dict:
    """The serve layer's entry point: the serve phase's documents and
    rounds of concurrent edits (its own generator), every round through
    `MergeScheduler` - `submit` for every edited document, `pump()`,
    `drain()` - with device planning (K2) and the kernel rung (K1): on
    per-shard flush workers (the control), or with `mesh_window` through
    the flush window (one K1 launch per (cap, max_ins) class and one K2
    resolve per window). Sessions are built by a first drain. K1's and
    K2's launch counts are set to 0 just before the rounds and read just
    after them; per-doc syncs are counted by a wrapper around
    `FusedDocSession.sync`, the window arena's hits and misses by one
    around `arena.acquire`. Every K1 and K2 call of the rounds is kept and
    afterwards held exactly against the kernel's plain version on the
    same inputs. Each round's texts are checked against the host's merged
    tip branch, and after the last round the first `fresh_checkouts`
    documents' merged branches against fresh host checkouts."""
    import threading

    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels, xform
    from diamond_types_tpu_torch.parallel import arena
    from diamond_types_tpu_torch.serve import MergeScheduler
    from diamond_types_tpu_torch.serve import scheduler as sched_mod

    t0 = time.perf_counter()
    ols = build_docs(rng, cfg)
    by_id = {ol.doc_id: ol for ol in ols}
    tips = [host_branch(ol) for ol in ols]
    arena.reset_arenas()
    sched = MergeScheduler(
        scfg.shards, resolve=by_id.__getitem__, engine="device", fused=True,
        device_plan=True, flush_docs=scfg.flush_docs, flush_workers=True,
        mesh_window=mesh_window,
        max_sessions_per_shard=scfg.max_sessions_per_shard,
        fused_opts={"max_ins": cfg.max_ins, "headroom": cfg.headroom,
                    "device": device},
        sync_lock=threading.Lock())
    for ol in ols:
        sched.submit(ol.doc_id, 1)
    sched.drain()                  # builds every session
    setup_s = time.perf_counter() - t0
    m0 = sched.metrics_json()

    steps: List[int] = []          # each per-doc sync's replayed ops
    real_sync = ff.FusedDocSession.sync

    def counted_sync(sess):
        n = real_sync(sess)
        steps.append(n)
        return n

    rounds = []
    edit_s = verify_s = 0.0
    profile = None
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    lin = kernels.resolve_rows     # its count: the linearize launches
    ff.FusedDocSession.sync = counted_sync
    k1.launches = k2.launches = lin.launches = 0
    try:
        with Spy(xform, "extract_tail") as ext, \
                Spy(xform, "resolve_positions") as res, \
                Spy(xform, "_assemble_plan") as asm, \
                Spy(ff, "kernel_fused_replay") as rep, \
                Spy(sched_mod, "mesh_fused_replay") as wrep, \
                Hits(arena, "acquire") as acq, \
                Spy(ff, "apply_ops_window", keep=True) as k1_calls, \
                Spy(kernels, "resolve_rows", keep=True) as k2_calls:
            for r in range(scfg.rounds):
                t = time.perf_counter()
                lv0 = sum(len(ol) for ol in ols)
                subs = round_edits(rng, ols, tips, r, cfg)
                lvs = sum(len(ol) for ol in ols) - lv0
                edit_s += time.perf_counter() - t
                before = sched.metrics_json()
                n_steps, n_ext, n_res, n_rep = (len(steps), len(ext.seconds),
                                                len(res.seconds),
                                                len(rep.seconds))
                n_asm, n_wrep = len(asm.seconds), len(wrep.seconds)
                n_k1, n_k2 = len(k1_calls.seconds), len(k2_calls.seconds)
                hits0, misses0 = acq.hits, acq.misses
                profiling = r == scfg.profile_round
                with (torch.profiler.profile(activities=PROFILED)
                      if profiling else contextlib.nullcontext()) as prof:
                    t = time.perf_counter()
                    for doc_id, n_ops in subs:
                        check(sched.submit(doc_id, n_ops)["accepted"],
                              f"round {r}: {doc_id} was not admitted")
                    sched.pump()
                    sched.drain()
                    wall = time.perf_counter() - t
                if profiling:
                    profile = device_share(prof, wall, r)
                after = sched.metrics_json()
                delta = {k: after["totals"][k] - before["totals"][k]
                         for k in ("flushes", "flushed_docs", "fused_calls",
                                   "fused_docs", "builds", "evictions",
                                   "resyncs", "host_fallbacks")}
                xf = {k: after["transform"][k] - before["transform"][k]
                      for k in ("device_docs", "host_docs", "fallbacks",
                                "batches")}
                win = {k: after["window"][k] - before["window"][k]
                       for k in ("windows", "device_windows", "dispatches",
                                 "mesh_docs", "mesh_padded_rows",
                                 "staged_bytes")}
                check(xf["device_docs"] > 0,
                      f"round {r}: no document was planned on the device")
                ops = sum(n for _, n in subs)
                rounds.append({
                    "round": r, "wall_ms": 1e3 * wall,
                    "docs_submitted": len(subs),
                    "docs_flushed": delta["flushed_docs"],
                    "docs_per_s": delta["flushed_docs"] / wall,
                    "ops": ops, "ops_per_s": ops / wall,
                    "lvs": lvs, "lvs_per_s": lvs / wall,
                    "per_doc_syncs": len(steps) - n_steps,
                    "per_doc_replays": sum(1 for n in steps[n_steps:] if n),
                    **delta, "transform": xf, "window": win,
                    "k1_launches": len(k1_calls.seconds) - n_k1,
                    "k2_launches": len(k2_calls.seconds) - n_k2,
                    "arena_hits": acq.hits - hits0,
                    "arena_misses": acq.misses - misses0,
                    # summed over the worker threads, which overlap (the
                    # window runs on one thread); host clock: k2_s is the
                    # enqueue of the linearize kernel and K2
                    # (`resolve_rows`), the resolve's rest its packing,
                    # upload, the wait for the card and the download
                    "extract_s": sum(ext.seconds[n_ext:]),
                    "resolve_s": sum(res.seconds[n_res:]),
                    "k2_s": sum(k2_calls.seconds[n_k2:]),
                    "assemble_s": sum(asm.seconds[n_asm:]),
                    "replay_s": sum(rep.seconds[n_rep:])
                    + sum(wrep.seconds[n_wrep:])})
                t = time.perf_counter()
                for ol, tip in zip(ols, tips):
                    check(sched.text(ol.doc_id) == tip.snapshot(),
                          f"round {r}: {ol.doc_id} differs from the host's "
                          "merge")
                verify_s += time.perf_counter() - t
        sched.stop_workers()
    finally:
        ff.FusedDocSession.sync = real_sync
    launches, k2_launches, lin_launches = (k1.launches, k2.launches,
                                           lin.launches)
    m = sched.metrics_json()
    t = time.perf_counter()
    for ol, tip in zip(ols[:scfg.fresh_checkouts], tips):
        check(tip.snapshot() == host_branch(ol).snapshot(),
              f"scheduler: {ol.doc_id}'s merged branch differs from the "
              "host checkout")
    final_verify_s = time.perf_counter() - t
    # the path's own K1 and K2 calls against the plain versions (these
    # launches come after the counts were read)
    t = time.perf_counter()
    k1_err = k1_calls_err(k1_calls.args, cfg.max_ins)
    check(k1_err == 0, f"K1 differs from its plain version at a scheduler "
          f"call: max abs err {k1_err}")
    k2_worst = max(resolve_err(*a) for a in k2_calls.args)
    check(k2_worst == 0, f"K2 differs from its plain version at a "
          f"scheduler resolve: max abs err {k2_worst}")
    plain_check_s = time.perf_counter() - t
    k1_shapes = sorted({(a[0].shape[0], a[2].shape[1], a[0].shape[1])
                        for a in k1_calls.args})
    fused_calls = m["fused"]["device_calls"] - m0["fused"]["device_calls"]
    replays = sum(1 for n in steps if n)
    batches = m["transform"]["batches"] - m0["transform"]["batches"]
    w = {k: m["window"][k] - m0["window"][k]
         for k in ("windows", "device_windows", "dispatches", "mesh_docs",
                   "mesh_padded_rows", "staged_bytes")}
    check(m["totals"]["host_fallbacks"] == 0,
          f"{m['totals']['host_fallbacks']} host fallbacks in the scheduler")
    if mesh_window:
        # one card: one K1 launch per (cap, max_ins) class per window (a
        # window dispatch), one K2 resolve per window
        check(fused_calls == 0, f"{fused_calls} per-shard fused calls "
              "under the flush window")
        check(launches == w["dispatches"] + replays,
              f"K1 launched {launches} times for {w['dispatches']} window "
              f"classes and {replays} per-doc replays")
        check(k2_launches == batches <= w["windows"],
              f"K2 launched {k2_launches} times for {batches} resolves in "
              f"{w['windows']} windows")
        check(acq.hits + acq.misses == w["dispatches"],
              f"{acq.hits} arena hits + {acq.misses} misses for "
              f"{w['dispatches']} window dispatches")
    else:
        check(launches == fused_calls + replays,
              f"K1 launched {launches} times for {fused_calls} fused calls "
              f"and {replays} per-doc replays")
        check(k2_launches == batches,
              f"K2 launched {k2_launches} times for {batches} resolves")
    check(lin_launches == batches,
          f"the linearize kernel launched {lin_launches} times for "
          f"{batches} resolves")
    lat = m["latencies"]
    n_r = len(rounds)
    walls = [x["wall_ms"] for x in rounds]
    summary = {
        "docs_per_s": [x["docs_per_s"] for x in rounds],
        "ops_per_s": [x["ops_per_s"] for x in rounds],
        "round_wall_ms": walls,
        "flush_ms_p50_p99": [1e3 * lat["flush"]["p50"],
                             1e3 * lat["flush"]["p99"]],
        "queue_wait_ms_p50_p99": [1e3 * lat["queue_wait"]["p50"],
                                  1e3 * lat["queue_wait"]["p99"]],
        "k1_launches_per_round": launches / n_r,
        "k2_launches_per_round": k2_launches / n_r,
        "device_calls_per_window": m["window"]["device_calls_per_window"],
        "mesh_occupancy": m["window"]["mesh_occupancy"],
        "staged_bytes_per_window": m["window"]["staged_bytes_per_window"],
        "arena_hits": acq.hits, "arena_misses": acq.misses,
        "host_fallbacks": m["totals"]["host_fallbacks"],
        "device_busy_share": profile["device_busy_share"]
        if profile else None}
    return {"phase": "scheduler_window" if mesh_window else "scheduler",
            "mesh_window": mesh_window, "summary": summary,
            "window_totals": w, "arena_stats": arena.arena_stats(),
            "docs": cfg.n_docs, "shards": scfg.shards,
            "flush_docs": scfg.flush_docs,
            "max_sessions_per_shard": scfg.max_sessions_per_shard,
            "launches": launches, "k2_launches": k2_launches,
            "lin_launches": lin_launches,
            "fused_device_calls": fused_calls, "per_doc_replays": replays,
            "resolves": batches, "setup_s": setup_s, "edit_s": edit_s,
            "verify_s": verify_s, "final_verify_s": final_verify_s,
            "k1_calls_checked": len(k1_calls.args),
            "k1_shapes_b_n_cap": k1_shapes, "k1_max_abs_err": k1_err,
            "k2_calls_checked": len(k2_calls.args),
            "k2_max_abs_err": k2_worst, "plain_check_s": plain_check_s,
            "rounds": rounds,
            "flush_ms": {q: 1e3 * lat["flush"][q]
                         for q in ("p50", "p90", "p99", "max")},
            "flushes": lat["flush"]["count"],
            "queue_wait_ms": {q: 1e3 * lat["queue_wait"][q]
                              for q in ("p50", "p99", "max")},
            "fused_occupancy": m["fused"]["occupancy"],
            "fused_occupancy_hist": m["fused"]["occupancy_hist"],
            "flush_size_hist": m["flush_size_hist"],
            "flush_reasons": m["flush_reasons"],
            "totals": m["totals"], "transform": m["transform"],
            "profile": profile,
            "caps": sorted({s.cap for b in sched.banks
                            for s in b.sessions.values()})}


def run_serve_benches(device, scfg: SchedulerConfig, seed: int) -> dict:
    """`run_serve_bench` on the card in each mode (device planning on,
    every session resident), and in concurrent mode once more with the
    flush window: its parity gate must pass and its SLO verdict hold. The
    bench runs instrumented, as the JAX package's does (1% trace sampling,
    live telemetry, the journey, the device profiler): each run prints its
    `devprof` and `slo_ok`. With a CUDA device the bench
    takes its default placement (shard i on `cuda:(i % device_count)`)."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.serve.driver import run_serve_bench
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    lin = kernels.resolve_rows     # its count: the linearize launches
    out = []
    for mode, window in (("trace", False), ("concurrent", False),
                         ("flash", False), ("concurrent", True)):
        k1.launches = k2.launches = lin.launches = 0
        r = run_serve_bench(
            shards=scfg.shards, docs=scfg.bench_docs, mode=mode,
            txns=scfg.bench_txns, steady_rounds=scfg.bench_steady_rounds,
            max_sessions=scfg.bench_docs, device_plan=True, seed=seed,
            device=None if device.type == "cuda" else device,
            mesh_window=window)
        check(r["parity_ok"], f"serve bench {mode}: parity failed for "
              f"{r['parity_mismatches']}")
        check(k1.launches > 0, f"serve bench {mode}: K1 never launched")
        check(lin.launches == k2.launches == r["transform"]["batches"],
              f"serve bench {mode}: {lin.launches} linearize and "
              f"{k2.launches} K2 launches for {r['transform']['batches']} "
              "resolves")
        check(r["slo_ok"], f"serve bench {mode}: SLO burning: {r['slo']}")
        lat = r["metrics"]["latencies"]["flush"]
        out.append({"mode": mode, "parity_ok": r["parity_ok"],
                    "total_ops": r["total_ops"],
                    "ops_per_sec": r["ops_per_sec"],
                    "feed_wall_s": r["feed_wall_s"], "wall_s": r["wall_s"],
                    "mesh_window": window,
                    "fused_device_calls": r["fused_device_calls"],
                    "fused_occupancy": r["fused_occupancy"],
                    "device_calls_per_window":
                        r["device_calls_per_window"],
                    "staged_bytes_per_window":
                        r["staged_bytes_per_window"],
                    "flush_ms": {q: 1e3 * lat[q] for q in ("p50", "p99")},
                    "k1_launches": k1.launches, "k2_launches": k2.launches,
                    "lin_launches": lin.launches,
                    "transform": r["transform"],
                    "slo_ok": r["slo_ok"], "devprof": r["devprof"],
                    "obs": r["obs"], "config": r["config"]})
    return {"phase": "serve_bench", "runs": out}


def run_checkout(ols, frontiers0, merged: List[str], device,
                 n_merge: int = 16) -> dict:
    """The device checkout path: every document checked out on the card,
    grouped by pow2 cap, and held against the host's checkout of each
    oplog (timed: the yardstick; it must equal `merged`, the serve phase's
    merged branches), then `merge_device` of the first `n_merge` documents
    from their window-0 frontier. K3's launch count is set to 0 just
    before the device calls and read just after them."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import merge_kernel as mk
    from diamond_types_tpu_torch.gpu.flush_fuse import _pow2

    t = time.perf_counter()
    docs = [mk.prepare_doc(ol) for ol in ols]
    prepare_s = time.perf_counter() - t
    groups: Dict[int, List[int]] = {}
    for i, d in enumerate(docs):
        groups.setdefault(_pow2(max(d.total_len, 1)), []).append(i)
    t = time.perf_counter()
    want = [host_branch(ol).snapshot() for ol in ols]
    host_s = time.perf_counter() - t
    for i, text in enumerate(merged):
        check(want[i] == text, f"serve: doc {i}'s merged branch differs "
              "from the host checkout")
    k3 = kernels.materialize_runs
    k3.launches = 0
    calls = []
    merge_s = []
    with Spy(kernels, "materialize_runs", keep=True) as k3_calls:
        for cap in sorted(groups):
            idx = groups[cap]
            t = time.perf_counter()
            texts = mk.checkout_batch_device([docs[i] for i in idx],
                                             cap=cap, device=device)
            calls.append({"cap": cap, "docs": len(idx),
                          "runs": max(len(docs[i].parent) for i in idx),
                          "ms": 1e3 * (time.perf_counter() - t)})
            for i, text in zip(idx, texts):
                check(text == want[i] and
                      sorted(docs[i].frontier) == sorted(ols[i].version),
                      f"checkout: doc {i} differs from the host checkout")
        for d in range(n_merge):
            ol = ols[d]
            t = time.perf_counter()
            text, frontier = mk.merge_device(ol, frontiers0[d],
                                             device=device)
            merge_s.append(time.perf_counter() - t)
            br = host_branch(ol, frontiers0[d])
            br.merge_reference(ol, ol.version)
            check(text == br.snapshot() and
                  sorted(frontier) == sorted(br.version),
                  f"merge_device: doc {d} differs from the host branch")
    launches = k3.launches
    n_calls = len(calls) + n_merge
    check(launches == n_calls,
          f"K3 launched {launches} times for {n_calls} device checkouts")
    breakdown = [checkout_breakdown([docs[i] for i in groups[cap]], cap,
                                    device) for cap in sorted(groups)]
    return {"phase": "checkout", "docs": len(docs), "launches": launches,
            "checkout_calls": calls, "merges": n_merge,
            "prepare_ms": 1e3 * prepare_s,
            "host_checkout_ms": 1e3 * host_s,
            "merge_ms": [1e3 * s for s in merge_s],
            "breakdown_per_cap": breakdown,
            "k3_args": k3_calls.args}


def time_ms(fn, reps: int) -> float:
    """call_ms: mean milliseconds per call of `fn`, CUDA events around
    `reps` back-to-back calls after one warm-up call. Where the host work
    of a call is longer than its device work, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """device_ms: the card's own time per call of `fn`. `reps` calls are
    queued behind a sleep on the card (`torch.cuda._sleep`), so the card
    runs them back to back after the host has queued them all; CUDA events
    around them time the kernels and the card's own gaps between launches,
    not the host. The sleep must outlast the host's queueing (checked with
    events around it against the host clock); if it did not, it is
    lengthened and the calls run again. (`torch.profiler` was not used:
    on the H100 it has recorded no event at all in whole sessions.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t)
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms + 0.5:
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise SmokeFailure("the card's sleep never outlasted the host's queueing")


def timings(fn, call_reps: int, device_reps: int) -> dict:
    """call_ms and device_ms of `fn` (see `time_ms` and `device_ms`)."""
    return {"call_ms": time_ms(fn, call_reps),
            "device_ms": device_ms(fn, device_reps)}


def k1_ctas(b: int, cap: int):
    """CTAs one K1 launch uses at (b, cap) by the launcher's grid rule
    (`dt_apply_ops_window_ctas`): derived, not observed; None where the
    library has no such rule."""
    from diamond_types_tpu_torch.gpu import kernels
    fn = getattr(kernels._lib("apply_ops"), "dt_apply_ops_window_ctas", None)
    return None if fn is None else int(fn(b, cap))


def time_captured(captured, mi: int, wide_window: int) -> dict:
    """K1 at every captured main-path bucket: held exactly against its
    plain version on the same inputs (`k1_calls_err`), then its call_ms
    and device_ms; the widest bucket's plain version is timed too."""
    from diamond_types_tpu_torch.gpu import kernels
    worst = k1_calls_err([args for _, _, args in captured], mi)
    check(worst == 0, f"K1 differs from its plain version at a main-path "
          f"bucket of the serve phase: max abs err {worst}")
    per = {"flush_docs": [], "wide": []}
    widest = None
    for w, b, args in captured:
        bp, cap = args[0].shape
        n = args[2].shape[1]
        row = {"window": w, "docs": b, "b": bp, "cap": cap, "n": n,
               "bound_ms": 1e3 * window_bytes(bp, n, cap, mi)
               / HBM_BYTES_PER_S}
        row.update(timings(lambda: kernels.apply_ops_window(*args, mi), 5, 20))
        row["ms"] = row["call_ms"]
        per["wide" if w == wide_window else "flush_docs"].append(row)
        if widest is None or bp * cap > widest[0]["b"] * widest[0]["cap"]:
            widest = (row, args)
    row, args = widest
    row["plain_ms"] = time_ms(
        lambda: kernels.apply_ops_window_plain(*args, mi), 1)
    return {"per_bucket": per, "widest": row, "max_abs_err": worst,
            "buckets_checked": len(captured)}


def time_k2(calls) -> dict:
    """K2 and the linearize kernel at every main-path resolve
    (`kernels.resolve_rows` calls: a buffer and its (b, n)): each buffer
    held exactly against the plain chain, then K2 timed at the widest call
    (call_ms and device_ms) beside its plain version and the library
    yardstick `torch.cumsum(nv, 1)`, and the whole resolve's device half
    (`time_linearize`) at that call and on random trees at [8, 256],
    [8, 4,096] and [8, 8,192] (the widest in the kernel's scratch)."""
    from diamond_types_tpu_torch.gpu import kernels
    worst = max(resolve_err(*a) for a in calls)
    check(worst == 0, f"a main-path resolve differs from the plain chain: "
          f"max abs err {worst}")
    buf, b, n = max(calls, key=lambda a: a[1] * a[2])
    bn = b * n
    cols = buf[:7 * bn].view(7, b, n)
    nv, ov = buf[8 * bn:9 * bn].view(b, n), buf[9 * bn:10 * bn].view(b, n)
    out = {"max_abs_err": worst, "calls_checked": len(calls),
           "shape": {"b": b, "n": n},
           "plain_ms": time_ms(
               lambda: kernels.xform_positions_plain(nv, ov), 20),
           "library": timings(lambda: torch.cumsum(nv, 1), 50, 50),
           # nv and ov read once, pos written once, new_len and peak
           "bound_ms": 1e3 * 4 * (3 * bn + 2 * b) / HBM_BYTES_PER_S}
    out.update(timings(lambda: kernels.xform_positions(nv, ov), 50, 50))
    out["ms"] = out["call_ms"]
    out["library_ms"] = out["library"]["call_ms"]
    out["linearize"] = {"main_path": time_linearize(cols)}
    for n_ in (256, 4096, 8192):
        cols_ = torch.from_numpy(random_trees(np.random.default_rng(n_), 8,
                                              n_)).cuda()
        out["linearize"][f"b8_n{n_}"] = time_linearize(cols_)
    return out


def random_trees(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """[7, b, n] linearizer columns of b random Fugue trees of n nodes at
    shuffled indices, keys in 0..3 (ties and heterogeneous right-origin
    keys), visibility in 0..8."""
    cols = np.empty((7, b, n), np.int32)
    for r in range(b):
        label = rng.permutation(n)
        t = np.arange(n)
        up = label[(rng.random(n) * t).astype(np.int64)]
        cols[0, r, label] = np.where((t == 0) | (rng.random(n) < 0.2), n, up)
        cols[1, r, label] = rng.integers(0, 2, n)
        cols[2:5, r, label] = rng.integers(0, 4, (3, n))
        cols[5:7, r, label] = rng.integers(0, 9, (2, n))
    return cols


def time_linearize(cols: torch.Tensor) -> dict:
    """One resolve's device half, `kernels.resolve_rows` (the linearize
    kernel, then K2), on a card buffer holding the [7, b, n] columns
    `cols`: held against the plain chain on the CPU (`resolve_err`), then
    call_ms and device_ms beside the plain chain's call time on the card
    (`linearize_rows_plain`, then K2). Its bound: the columns read once;
    perm, the two doc-order columns and pos written once; the doc-order
    columns read again by K2; new_len and peak; over HBM's rate."""
    from diamond_types_tpu_torch.gpu import kernels
    _, b, n = cols.shape
    bn = b * n
    buf = torch.empty(kernels.resolve_words(b, n), dtype=torch.int32,
                      device=cols.device)
    buf[:7 * bn].copy_(cols.reshape(-1))
    path = kernels.resolve_rows(buf, b, n)
    check(path == "kernel", f"a card resolve took the {path} path")
    err = resolve_err(buf, b, n)
    check(err == 0, f"the linearize kernel and K2 differ from the plain "
          f"chain at b={b} n={n}: max abs err {err}")

    def plain():
        _perm, nv, ov = kernels.linearize_rows_plain(cols)
        return kernels.xform_positions(nv, ov)
    out = {"b": b, "n": n, "max_abs_err": err,
           "scratch_words_per_row": kernels.linearize_scratch_words(n),
           "bound_ms": 1e3 * 4 * (13 * bn + 2 * b) / HBM_BYTES_PER_S,
           "plain_ms": time_ms(plain, 20)}
    out.update(timings(lambda: kernels.resolve_rows(buf, b, n), 50, 50))
    return out


def cold_device_ms(fn, reps: int) -> float:
    """device_ms with the L2 cache cold: before each call a buffer of
    L2_FLUSH_BYTES is overwritten on the card, then a sleep on the card
    outlasts the host's queueing of the call; CUDA events around the call
    alone time it. The median of `reps` calls."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    ms = []
    for k in range(reps):
        flush.fill_(k)
        torch.cuda._sleep(1 << 22)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(ms))


def k3_ctas(b: int, cap: int):
    """CTAs of one K3 gather launch at (b, cap) by the launcher's grid rule
    (`dt_materialize_runs_ctas`): derived, not observed; None where the
    library has no such rule."""
    from diamond_types_tpu_torch.gpu import kernels
    fn = getattr(kernels._lib("materialize"), "dt_materialize_runs_ctas",
                 None)
    return None if fn is None else int(fn(b, cap))


def k3_bound_ms(vis: torch.Tensor, cap: int) -> float:
    """K3's HBM bound: the run tables read once, the visible text read
    once, the text and the totals written once."""
    b, n = vis.shape
    totals = vis.long().sum(dim=1).clamp(max=cap)
    nbytes = 4 * (3 * b * n + int(totals.sum()) + b * cap + b)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def time_k3(calls, n_batch: int) -> dict:
    """K3 at every main-path checkout (the first n_batch calls are
    `checkout_batch_device` batches, the rest `merge_device`): held
    exactly against its plain version, then each call's call_ms and
    device_ms beside its bound and its gather CTAs (derived); at the
    widest call (b * cap) also device_ms with the L2 cold and the plain
    version's call_ms."""
    from diamond_types_tpu_torch.gpu import kernels, linearize
    worst = max(k3_err(list(args[:4]), args[4]) for args in calls)
    check(worst == 0, f"K3 differs from its plain version at a main-path "
          f"checkout: max abs err {worst}")
    per = []
    for k, (perm, vis, off, arena, cap) in enumerate(calls):
        b, n = perm.shape
        row = {"call": "batch" if k < n_batch else "merge", "b": b,
               "runs": n, "cap": cap, "bound_ms": k3_bound_ms(vis, cap),
               "gather_ctas_derived": k3_ctas(b, cap)}
        row.update(timings(lambda: kernels.materialize_runs(
            perm, vis, off, arena, cap), 20, 20))
        per.append(row)
    k = max(range(len(calls)),
            key=lambda i: calls[i][0].shape[0] * calls[i][4])
    perm, vis, off, arena, cap = calls[k]
    b, n = perm.shape
    out = {"max_abs_err": worst, "calls_checked": len(calls),
           "shape": {"b": b, "runs": n, "cap": cap, "pool": arena.shape[1]},
           "plain_ms": time_ms(lambda: linearize.materialize(
               perm, vis, off, arena, cap), 5),
           "library_ms": None, "bound_ms": per[k]["bound_ms"],
           "call_ms": per[k]["call_ms"], "device_ms": per[k]["device_ms"],
           "device_ms_cold_l2": cold_device_ms(
               lambda: kernels.materialize_runs(perm, vis, off, arena, cap),
               20),
           "per_call": per}
    out["ms"] = out["call_ms"]
    return out


# ---- phases 8-10: the history, the causal graph, the merge step -------------

@dataclass
class HistoryConfig:
    lvs: int = 40_000              # ops of the full-width history
    small_lvs: int = 2_000         # the history read through source="python"
    agents: tuple = ("ann", "ben", "cat")
    turns: tuple = (4, 24)         # edits in one agent's turn
    small_turns: tuple = (2, 8)    # shorter turns: more plan entries
    merge_share: float = 0.35      # turns after which the agent merges the tip
    ins_share: float = 0.85
    ins_max: int = 16
    del_max: int = 4
    versions: int = 256            # snapshot entries of the full history
    small_versions: int = 32
    python_checks: int = 4         # versions held against the Python
                                   # checkout (all against the C++ tracker)


def build_history(rng: np.random.Generator, lvs: int, hcfg: HistoryConfig,
                  turns: tuple):
    """One document that `hcfg.agents` edit concurrently, each on its own
    branch, until the oplog holds `lvs` ops: in turns of `turns[0]` to
    `turns[1]` edits (inserts of 1-16 chars, deletes of 1-4); after a turn the agent merges
    the tip into its branch with probability `merge_share` (through the
    port's C++ tracker, `native.core.merge_to_string`: the Python engine
    would take tens of seconds at this width). Returns the oplog."""
    from diamond_types_tpu_torch import Branch, OpLog
    from diamond_types_tpu_torch.native.core import get_native_ctx
    from diamond_types_tpu_torch.utils.rope import Rope
    ol = OpLog()
    ids = [ol.get_or_create_agent_id(a) for a in hcfg.agents]
    branches = [Branch() for _ in hcfg.agents]
    while len(ol) < lvs:
        i = int(rng.integers(len(ids)))
        b = branches[i]
        for _ in range(int(rng.integers(turns[0], turns[1] + 1))):
            cur = len(b)
            if cur and rng.random() >= hcfg.ins_share:
                p = int(rng.integers(0, cur))
                b.delete(ol, ids[i], p,
                         min(cur, p + int(rng.integers(1, hcfg.del_max + 1))))
            else:
                b.insert(ol, ids[i], int(rng.integers(0, cur + 1)), rand_text(
                    rng, int(rng.integers(1, hcfg.ins_max + 1))))
        if rng.random() < hcfg.merge_share:
            doc, frontier = get_native_ctx(ol).merge_to_string(
                b.snapshot(), b.version, ol.version)
            b.content = Rope(doc)
            b.version = list(frontier)
    return ol


@contextlib.contextmanager
def python_engine():
    """`Branch.merge` on the Python engine (DT_TPU_NO_NATIVE) inside the
    block: the history phase's "Python checkout" yardstick. Outside it
    the port's default is the C++ tracker, as in the JAX package."""
    import os
    was = os.environ.get("DT_TPU_NO_NATIVE")
    os.environ["DT_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if was is None:
            del os.environ["DT_TPU_NO_NATIVE"]
        else:
            os.environ["DT_TPU_NO_NATIVE"] = was


def spread(n_entries: int, k: int) -> List[int]:
    """k snapshot entries spread over a plan of n_entries (early, middle
    and late), as the JAX package's sharded plan-tape dry run spreads
    them."""
    if k <= 1 or n_entries <= 1:
        return [n_entries - 1]
    return sorted({round(i * (n_entries - 1) / (k - 1)) for i in range(k)})


def profiled(fn) -> tuple:
    """fn() once under `torch.profiler` (device activity only): (result,
    device busy ms, device events: kernels, copies and sets)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILED) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(r[0] for r in rows), sum(r[1] for r in rows)


def wall_ms(fn) -> tuple:
    """(fn(), host milliseconds from an idle card to an idle card)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def k3_shared_bound_ms(vis: torch.Tensor, pool: int, cap: int) -> float:
    """K3's HBM bound with shared rows: perm and arena_off read once (one
    row each), the visibility table once, the one shared arena row of
    `pool` chars once (every version reads it, but it is one input), the
    text and the totals written once."""
    b, n = vis.shape
    nbytes = 4 * (2 * n + b * n + pool + b * cap + b)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def run_history(rng: np.random.Generator, device,
                hcfg: HistoryConfig) -> tuple:
    """Batched time travel (`plan_kernels.texts_at_versions`) on the card:
    the full-width history at `versions` spread entries through
    source="native", and the small one at `small_versions` through
    source="python" (`DenseExecutor`). K3's count is set to 0 just before
    the two calls and read just after: one launch per call. Then every
    version's K3 call is held against its plain version; every version
    against the C++ tracker's text at its `entry_frontier` (each timed),
    `python_checks` spread ones against the Python checkout, and every
    small version against the Python checkout. Returns (line, the full
    history's oplog)."""
    from diamond_types_tpu_torch.gpu import kernels, linearize
    from diamond_types_tpu_torch.gpu import plan_kernels as pk
    from diamond_types_tpu_torch.native.core import get_native_ctx

    t = time.perf_counter()
    ol = build_history(rng, hcfg.lvs, hcfg, hcfg.turns)
    small = build_history(rng, hcfg.small_lvs, hcfg, hcfg.small_turns)
    build_s = time.perf_counter() - t
    plan = pk.compile_plan2(ol.cg.graph, [], list(ol.version))
    splan = pk.compile_plan2(small.cg.graph, [], list(small.version))
    idx = spread(len(plan.entries), hcfg.versions)
    sidx = spread(len(splan.entries), hcfg.small_versions)
    k3 = kernels.materialize_runs
    k3.launches = 0
    stats, sstats = {}, {}
    with Spy(kernels, "materialize_runs", keep=True) as k3_calls:
        texts, call_ms = wall_ms(lambda: pk.texts_at_versions(
            ol, idx, source="native", device=device, stats=stats))
        stexts, scall_ms = wall_ms(lambda: pk.texts_at_versions(
            small, sidx, source="python", device=device, stats=sstats))
    launches = k3.launches
    check(launches == 2 == len(k3_calls.args),
          f"history: K3 launched {launches} times for 2 texts_at_versions "
          f"calls ({len(k3_calls.args)} wrapper calls)")
    check(len(texts) == len(idx) and len(stexts) == len(sidx),
          "history: a version is missing")

    # every version's K3 output against the plain version
    worst = max(k3_err(list(args[:4]), args[4]) for args in k3_calls.args)
    check(worst == 0, f"history: K3 differs from its plain version: max "
          f"abs err {worst}")
    for args in k3_calls.args:
        check(all(a.shape[0] == 1 for a in (args[0], args[2], args[3])),
              "history: K3 was not given shared rows")

    # the host's texts: the C++ tracker on every version, the Python
    # checkout on `python_checks` spread ones
    ctx = get_native_ctx(ol)
    py_picks = set(spread(len(idx), hcfg.python_checks))
    native_ms, python_ms = [], []
    for j, (k, got) in enumerate(zip(idx, texts)):
        f = pk.entry_frontier(ol.cg.graph, plan, k)
        t = time.perf_counter()
        want, _ = ctx.merge_to_string("", [], f)
        native_ms.append(1e3 * (time.perf_counter() - t))
        check(got == want,
              f"history: version {k} differs from the C++ tracker's text")
        if j in py_picks:
            t = time.perf_counter()
            with python_engine():
                want_py = ol.checkout(f).snapshot()
            python_ms.append(1e3 * (time.perf_counter() - t))
            check(got == want_py,
                  f"history: version {k} differs from the Python checkout")
    t = time.perf_counter()
    for k, got in zip(sidx, stexts):
        with python_engine():
            want = small.checkout(pk.entry_frontier(small.cg.graph, splan,
                                                    k)).snapshot()
        check(got == want, f"history: small version {k} differs from the "
              "Python checkout")
    small_python_ms = 1e3 * (time.perf_counter() - t) / len(sidx)

    # the tape on the card: device busy time and events of one replay
    _plan, _src, tape, rows = pk.snapshot_rows(ol, [], entries=idx,
                                               source="native",
                                               device=device)
    tape_args = (tape.op, tape.a, tape.b, tape.c, tape.d, tape.is_base,
                 tape.n_slots, tape.n_idx, tape.n_snaps)
    tstats = {}
    rows2, tape_busy_ms, tape_events = profiled(lambda: pk.execute_tape(
        *tape_args, device=device, stats=tstats))
    check(torch.equal(rows, rows2), "history: two tape replays differ")
    _, tape_wall_ms = wall_ms(lambda: pk.execute_tape(*tape_args,
                                                      device=device))
    _, call_busy_ms, call_events = profiled(lambda: pk.texts_at_versions(
        ol, idx, source="native", device=device))

    # K3 at the history's shape
    perm, vis, off, arena, cap = k3_calls.args[0]
    b, n = vis.shape
    k3t = timings(lambda: kernels.materialize_runs(perm, vis, off, arena,
                                                   cap), 10, 10)
    k3_line = {"b": b, "runs": n, "cap": cap, "pool": arena.shape[1],
               "shared_rows": True, **k3t, "ms": k3t["call_ms"],
               "bound_ms": k3_shared_bound_ms(vis, arena.shape[1], cap),
               "plain_ms": time_ms(lambda: linearize.materialize(
                   perm, vis, off, arena, cap), 2),
               "library_ms": None,
               "gather_ctas_derived": k3_ctas(b, cap),
               "output_mib": b * cap * 4 / 2**20}
    python_per = float(np.median(python_ms))
    line = {"phase": "history", "build_s": build_s, "lvs": len(ol),
            "final_chars": len(texts[-1]), "graph_runs": len(ol.cg.graph.starts),
            "plan_entries": len(plan.entries), "versions": len(idx),
            "launches": launches, "k3_calls": len(k3_calls.args),
            "max_abs_err": worst,
            "checked_native": len(native_ms),
            "checked_python": len(python_ms),
            "call_ms": call_ms,
            "parts_ms": {"compile_plan2": stats["compile_ms"],
                         "source_native": stats["source_ms"],
                         "pack_plan_tape": stats["pack_ms"],
                         "execute_tape_host": stats["tape"]["host_ms"],
                         "tables": stats["tables_ms"],
                         "k3_copy_decode": stats["k3_ms"]},
            "tape": {"steps": stats["steps"], "n_slots": stats["n_slots"],
                     "n_idx": stats["n_idx"], **tstats,
                     "wall_ms": tape_wall_ms, "device_busy_ms": tape_busy_ms,
                     "device_events": tape_events},
            "call_device_busy_ms": call_busy_ms,
            "call_device_events": call_events,
            "k3": k3_line,
            "host_native_ms_per_version": float(np.median(native_ms)),
            "host_native_ms_for_all_versions": float(np.sum(native_ms)),
            "host_python_ms_per_version": python_per,
            "host_python_ms_for_all_versions_extrapolated":
                python_per * len(idx),
            "small": {"lvs": len(small), "plan_entries": len(splan.entries),
                      "versions": len(sidx), "call_ms": scall_ms,
                      "parts_ms": {k: sstats[k] for k in
                                   ("compile_ms", "source_ms", "pack_ms",
                                    "tables_ms", "k3_ms")},
                      "host_python_ms_per_version": small_python_ms}}
    return line, ol


# BASELINE.json configuration 5: a 10k-replica fan-in causal graph
CONFIG5 = {"n_roots": 10_000, "run_len": 8, "chain": 2048}


def config5_graph():
    """BASELINE config 5's causal graph (`CONFIG5`): `n_roots` concurrent
    root runs of `run_len` LVs, one merge run naming every root's tip (the
    fan-in of the JAX package's multichip dry run, at full width), then
    `chain` runs after it, each forking from the LV before its predecessor's last (so
    each is a run of its own, and the graph is that many hops deep).
    Returns (Graph, the chain tip's LV)."""
    from diamond_types_tpu_torch import Graph
    n_roots, run_len, chain = (CONFIG5[k] for k in ("n_roots", "run_len",
                                                     "chain"))
    g = Graph()
    for i in range(n_roots):
        g.push([], i * run_len, (i + 1) * run_len)
    lv = n_roots * run_len
    g.push([(i + 1) * run_len - 1 for i in range(n_roots)], lv, lv + run_len)
    for _ in range(chain):
        g.push([lv + run_len - 2], lv + run_len, lv + 2 * run_len)
        lv += run_len
    return g, lv + run_len - 1


def graph_queries(rng: np.random.Generator, graph, n_frontiers: int = 64,
                  per: int = 64) -> tuple:
    """`n_frontiers` frontiers of 1-3 LVs, one of them the tip, each asked
    about `per` targets (random LVs, and -1): ([q, 3] int32 padded with
    -1, [q] int32)."""
    from diamond_types_tpu_torch.gpu import graph_kernels as gk
    n_lv = graph.ends[-1]
    frs = [[n_lv - 1]]
    while len(frs) < n_frontiers:
        w = int(rng.integers(1, 4))
        frs.append(sorted({int(x) for x in rng.integers(0, n_lv, w)}))
    fr = gk.frontier_matrix([f for f in frs for _ in range(per)])
    targets = rng.integers(-1, n_lv, len(fr)).astype(np.int32)
    return fr, targets


def graph_line(name: str, rng, graph, device) -> dict:
    """Contains over 4,096 (frontier, target) pairs and diff on two
    frontier pairs, on the card, each held against the host `Graph` on
    every query; rounds to the fixed point, flag reads (syncs), times on
    the host clock (idle card to idle card) and the device's busy time of
    one batch (profiled)."""
    from diamond_types_tpu_torch.gpu import graph_kernels as gk
    fr, targets = graph_queries(rng, graph)
    (fn, pack_ms) = wall_ms(lambda: gk.make_contains_fn(graph, device))
    got, ms = wall_ms(lambda: fn(fr, targets))
    rounds = dict(fn.stats)
    _, busy_ms, events = profiled(lambda: fn(fr, targets))
    got = got.cpu().numpy()
    t = time.perf_counter()
    want = [graph.frontier_contains_version([int(x) for x in f if x >= 0],
                                            int(x))
            for f, x in zip(fr, targets)]
    host_ms = 1e3 * (time.perf_counter() - t)
    bad = int((got != np.asarray(want)).sum())
    check(bad == 0, f"graph {name}: {bad} contains answers differ from the "
          "host Graph")
    dfn = gk.make_diff_fn(graph, device)
    n_lv = graph.ends[-1]
    pairs = [([n_lv - 1], sorted({int(x) for x in rng.integers(0, n_lv, 3)})),
             (sorted({int(x) for x in rng.integers(0, n_lv, 2)}),
              [int(rng.integers(0, n_lv))])]
    diffs = []
    for a, b in pairs:
        k = max(len(a), len(b))
        pad = [np.array(f + [-1] * (k - len(f)), np.int32) for f in (a, b)]
        (ra, rb), dms = wall_ms(lambda: dfn(*pad))
        t = time.perf_counter()
        want_d = graph.diff(a, b)
        dhost = 1e3 * (time.perf_counter() - t)
        check(gk.diff_to_spans(graph, ra, rb) == tuple(want_d),
              f"graph {name}: diff({a}, {b}) differs from the host Graph")
        diffs.append({"a": a, "b": b, "ms": dms, "host_ms": dhost,
                      "only_a_spans": len(want_d[0]),
                      "only_b_spans": len(want_d[1]), **dfn.stats})
    return {"graph": name, "runs": len(graph.starts), "lvs": n_lv,
            "edges": fn.packed["m"], "queries": len(fr),
            "true": int(got.sum()), "pack_ms": pack_ms,
            "contains_ms": ms, **rounds,
            "device_busy_ms": busy_ms, "device_events": events,
            "host_contains_ms": host_ms, "diff": diffs}


def run_graph(rng: np.random.Generator, device, history_ol) -> dict:
    """X6 on the card: config 5's graph and the history's own graph."""
    g5, _tip = config5_graph()
    return {"phase": "graph",
            "graphs": [graph_line("config5", rng, g5, device),
                       graph_line("history", rng, history_ol.cg.graph,
                                  device)]}


def example_batch(rng: np.random.Generator, b: int, n_ops: int,
                  max_ins: int):
    """The JAX package's multichip example batch generator
    (`__graft_entry__._example_batch`), from `rng`: b documents of n_ops
    random inserts (1..max_ins chars at a random position) and deletes
    (1-3 chars, once a document holds more than 4)."""
    pos = np.zeros((b, n_ops), dtype=np.int32)
    dlen = np.zeros((b, n_ops), dtype=np.int32)
    ilen = np.zeros((b, n_ops), dtype=np.int32)
    chars = np.zeros((b, n_ops, max_ins), dtype=np.int32)
    doc_len = np.zeros((b,), dtype=np.int32)
    for i in range(b):
        for j in range(n_ops):
            if doc_len[i] > 4 and rng.random() < 0.3:
                p = int(rng.integers(0, doc_len[i] - 1))
                d = int(min(rng.integers(1, 4), doc_len[i] - p))
                pos[i, j], dlen[i, j] = p, d
                doc_len[i] -= d
            else:
                p = int(rng.integers(0, doc_len[i] + 1))
                k = int(rng.integers(1, max_ins + 1))
                pos[i, j], ilen[i, j] = p, k
                chars[i, j, :k] = rng.integers(97, 123, size=k)
                doc_len[i] += k
    return pos, dlen, ilen, chars


def run_merge_step(rng: np.random.Generator, device, b: int = 256,
                   n_ops: int = 512, max_ins: int = MAX_INS,
                   cap: int = 16_384) -> dict:
    """`parallel.mesh.multichip_merge_step` on one card at full width: the
    example batch replayed from empty documents (K1, one launch per device
    slice) and config 5's reachability from the chain tip (X6 as the
    one-card X10). K1's count is set to 0 just before and read just after.
    K1's output is held against its plain version and the reach must cover
    every fan-in root."""
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import graph_kernels as gk
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.parallel import mesh as pm

    t = time.perf_counter()
    pos, dlen, ilen, chars = example_batch(rng, b, n_ops, max_ins)
    g5, tip = config5_graph()
    packed = gk.pack_graph(g5, device)
    src, plv, prun = pm.pad_edges(packed, 1)
    reach0 = np.full(packed["n"], -1, np.int32)
    reach0[-1] = tip
    setup_s = time.perf_counter() - t
    mesh = pm.make_mesh(1)
    k1 = kernels.apply_ops_window
    k1.launches = 0
    stats = {}
    with Spy(ff, "apply_ops_window", keep=True) as calls:
        (docs, lens, reach), step_ms = wall_ms(lambda: pm.multichip_merge_step(
            mesh, pos, dlen, ilen, chars, cap, packed["starts"], src, plv,
            prun, reach0, stats=stats))
    launches = k1.launches
    check(launches == len(mesh) == len(calls.args),
          f"merge_step: K1 launched {launches} times for {len(mesh)} "
          "device slices")
    args = calls.args[0]
    want_d, want_l = kernels.apply_ops_window_plain(*args[:6], max_ins)
    err = max(exact_err(docs, want_d[:b]), exact_err(lens, want_l[:b]))
    check(err == 0, f"merge_step: K1 differs from its plain version: max "
          f"abs err {err}")
    check(bool((lens >= 0).all()), "merge_step: a document was poisoned")
    n_roots, run_len = CONFIG5["n_roots"], CONFIG5["run_len"]
    covered = reach[:n_roots].cpu().numpy()
    check(bool((covered == np.arange(1, n_roots + 1) * run_len - 1).all()),
          "merge_step: sharded propagation failed to cover the fan-in roots")
    check(torch.equal(reach, gk.reach_fixed_point(
        packed, torch.from_numpy(reach0).to(device))),
          "merge_step: the sharded reach differs from X6's")
    reach_stats = {}
    _, reach_ms = wall_ms(lambda: pm.sharded_reach_fixed_point(
        mesh, packed["starts"], src, plv, prun, reach0, stats=reach_stats))
    _, reach_busy_ms, reach_events = profiled(
        lambda: pm.sharded_reach_fixed_point(mesh, packed["starts"], src,
                                             plv, prun, reach0))
    bp, n = args[2].shape
    k1t = timings(lambda: kernels.apply_ops_window(*args[:6], max_ins), 5,
                  10)
    return {"phase": "merge_step", "b": b, "n": n_ops, "max_ins": max_ins,
            "cap": cap, "setup_s": setup_s, "devices": len(mesh),
            "launches": launches, "max_abs_err": err, "step_ms": step_ms,
            "doc_chars": int(lens.sum()),
            "reach": {"runs": packed["n"], "edges": packed["m"],
                      **reach_stats, "ms": reach_ms,
                      "device_busy_ms": reach_busy_ms,
                      "device_events": reach_events},
            "k1": {"b": bp, "n": n, "cap": cap, **k1t, "ms": k1t["call_ms"],
                   "bound_ms": 1e3 * window_bytes(bp, n, cap, max_ins)
                   / HBM_BYTES_PER_S,
                   "plain_ms": time_ms(lambda: kernels.apply_ops_window_plain(
                       *args[:6], max_ins), 1),
                   "library_ms": None, "ctas_derived": k1_ctas(bp, cap)}}

# ---- phases 11-15: the zone engine (X8) --------------------------------------

@dataclass
class ZoneConfig:
    kernel_lvs: int = 2_000            # the zone_kernel phase's history
    tiny_budgets: tuple = (2, 8, 2)    # MB, MC, MD: continuation blocks and
                                       # delete spill, as the JAX tests do
    replicas: int = 8                  # B of the B-against-B-1 check
    batches: tuple = (1, 132, 1024)    # config 4: 1,024 replicas
    slice_steps: int = 128
    slice_batch: int = 132
    reps: int = 3                      # timed kernel calls
    sweep_reps: int = 2                # launches a shape in the sweep (the
                                       # least time is kept)
    sched_rounds: int = 2              # of the scheduler phase's 6
    sched_continued_rounds: int = 2    # then with the last round's agents
    sched_max_slots: int = 1 << 30     # every zone session stays resident


def zone_err(got, want) -> int:
    """Max |a - b| over all ten carry planes (int64)."""
    return max(exact_err(a, b.to(a.device)) for a, b in zip(got, want))


def zone_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def shape_name(shape) -> str:
    """A launch shape (c, smem) as "c16 shared" / "c1 global"."""
    return f"c{shape[0]} {'shared' if shape[1] else 'global'}"


def zone_shapes(kernels, B: int, W: int, n_idx: int,
                every: bool = False) -> list:
    """X8's launch shapes to run: every cluster size in both forms
    (`every`; the shared-memory ones where the slice fits), else every
    shared-memory size that fits, c 1 in global memory (the layout before
    clusters) and the rule's pick."""
    fits = [(c, True) for c in kernels.CLUSTER_SIZES
            if kernels.zone_smem_bytes(W, n_idx, c)
            <= kernels.ZONE_SMEM_BUDGET]
    if every:
        return fits + [(c, False) for c in kernels.CLUSTER_SIZES]
    out = fits + [(1, False)]
    pick = tuple(kernels.cluster_size(B, W, n_idx))
    return out if pick in out else out + [pick]


def zone_bounds(zk, tape, xs: dict, carry) -> dict:
    """X8's bounds on one replica's run of `tape`, at HBM rate.

    bound_ms: the sum over the steps of what each step must move, its
    inputs read once and its outputs written once (the next step reads
    them), plus the tape read once. An APPLY step with m placed ranks
    before it, n new chars and m' = m + n after reads the order over
    [0, m) (4m bytes) and the snapshot states of those ranks (m), writes
    the rank and the order of all m' (8m') and the new chars' keys,
    origins and state (17n), and on an entry's first sub-step copies the
    row into the snapshot (2W); a row step moves W (BEGIN), 2W (FORK) or
    3W (MAX) bytes. The integrate's range and the deletes depend on more
    than these counts and are left out, so it is a lower count.
    whole_tape_ms: the tape read once and the carry read and written once,
    a lower limit that does not see the chain."""
    op = np.asarray(tape.op, dtype=np.int64)
    W = int(tape.W)
    apply = op == zk.OP_APPLY
    n = np.where(apply, (np.asarray(tape.ch_slot) >= 0).sum(1), 0)
    m_after = int(carry.m[0]) + np.cumsum(n)
    m_before = m_after - n
    snap = apply & (np.asarray(tape.snap_flag) == 1)
    step = np.where(apply, 5 * m_before + 8 * m_after + 17 * n + 2 * W * snap,
                    np.where(op == zk.OP_BEGIN, W,
                             np.where(op == zk.OP_FORK, 2 * W, 3 * W)))
    tape_b = zone_bytes(xs.values())
    return {"bound_ms": 1e3 * (int(step.sum()) + tape_b) / HBM_BYTES_PER_S,
            "bound_step_bytes": int(step.sum()) + tape_b,
            "whole_tape_ms": 1e3 * (tape_b + 2 * zone_bytes(carry))
            / HBM_BYTES_PER_S}


# cluster barriers in an APPLY step of X8 whose snapshot did not change,
# as in the empty steps of `zone_step_us`
ZONE_APPLY_BARRIERS = 2


def zone_step_us(zk, device, W: int, n_idx: int, cluster, op: int,
                 steps: int = 1 << 12) -> float:
    """The card's time for one step of X8 that does no work, at W slots and
    n_idx rows and the launch shape `cluster`, measured with X8 itself on a
    tape of `steps` such steps over a carry with no placed rank: empty
    APPLY steps (op OP_APPLY: no block, char or delete, m 0; the step's
    cluster barriers and its block barrier) or self-FORKs of row 0 (a
    slice copy and one block barrier). Microseconds per step."""
    from diamond_types_tpu_torch.gpu import kernels
    xs = {k: torch.zeros((steps,) if k in zk.XS_KEYS[:4] else (steps, 1),
                         dtype=torch.int32, device=device)
          for k in zk.XS_KEYS}
    xs["op"].fill_(op)
    for k in ("blk_cursor", "blk_prev", "ch_slot", "ch_ol_static",
              "ch_orr_own", "del_kind"):
        xs[k].fill_(-1)
    zeros = np.zeros(W, np.int32)
    carry = zk.init_zone_carry(W, 0, n_idx, zeros, zeros, device=device)
    return 1e3 * device_ms(lambda: kernels.zone_tape_run(
        carry, xs, 0, cluster=cluster), 3) / steps


def zone_fresh(zk, tape, prep, device, batch: int = 1, seq_k=None):
    return zk.init_zone_carry(tape.W, tape.plen, tape.n_idx, prep.agent_k,
                              prep.seq_k if seq_k is None else seq_k,
                              batch=batch, device=device)


def run_zone_kernel(rng: np.random.Generator, device,
                    hcfg: HistoryConfig, zcfg: ZoneConfig) -> dict:
    """X8 (`kernels.zone_tape_run`) against its plain version on the card:
    tapes of a ~2,000-op history of three concurrent agents, packed with
    the default budgets and with tiny ones (continuation blocks, delete
    spill); all ten carry planes must be equal. Then B `replicas` in one
    launch (each replica its own seq keys) against that many B-1 runs,
    and the text against the C++ tracker's; then X8 forced to every
    cluster size in both memory forms (`zone_shapes(every=True)`), each
    against the plain version."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.listmerge.zone_np import prepare_zone
    from diamond_types_tpu_torch.native.core import get_native_ctx
    ol = build_history(rng, zcfg.kernel_lvs, hcfg, hcfg.small_turns)
    prep = prepare_zone(ol)
    want_text, _ = get_native_ctx(ol).merge_to_string("", [], ol.version)
    cases, worst = [], 0
    for name, budgets in (("default", (8, 512, 16)),
                          ("tiny", zcfg.tiny_budgets)):
        tape = zk.pack_zone_tape(prep, *budgets)
        xs = zk.tape_xs(tape, device)
        want = zk.run_zone_plain(zone_fresh(zk, tape, prep, device), xs,
                                 tape.plen)
        got = kernels.zone_tape_run(zone_fresh(zk, tape, prep, device), xs,
                                    tape.plen)
        torch.cuda.synchronize()
        err = zone_err(got, want)
        seq_b = torch.as_tensor(prep.seq_k.astype(np.int32))[None, :] + \
            torch.arange(zcfg.replicas, dtype=torch.int32)[:, None]
        many = kernels.zone_tape_run(
            zone_fresh(zk, tape, prep, device, zcfg.replicas, seq_b.numpy()),
            xs, tape.plen)
        for i in range(zcfg.replicas):
            one = kernels.zone_tape_run(
                zone_fresh(zk, tape, prep, device, 1, seq_b[i].numpy()), xs,
                tape.plen)
            err = max(err, zone_err([t[i:i + 1] for t in many], one))
        # every cluster size in both memory forms, forced
        shapes = zone_shapes(kernels, 1, tape.W, tape.n_idx, every=True)
        for shape in shapes:
            err = max(err, zone_err(kernels.zone_tape_run(
                zone_fresh(zk, tape, prep, device), xs, tape.plen,
                cluster=shape), want))
        text = zk.assemble_text(got.rank[0], got.ever[0], prep.pool)
        check(err == 0, f"zone_kernel {name}: X8 differs from its plain "
              f"version (or B {zcfg.replicas} from B 1): max abs err {err}")
        check(text == want_text, f"zone_kernel {name}: the text differs "
              "from the C++ tracker's")
        worst = max(worst, err)
        cases.append({"budgets": budgets, "T": int(tape.op.shape[0]),
                      "W": tape.W, "n_idx": tape.n_idx, "plen": tape.plen,
                      "continuation_blocks": int((tape.blk_cursor == -2)
                                                 .sum()),
                      "pick": shape_name(kernels.cluster_size(
                          1, tape.W, tape.n_idx)),
                      "clusters_checked": [shape_name(x) for x in shapes],
                      "max_abs_err": err})
    return {"phase": "zone_kernel", "lvs": len(ol),
            "plan_entries": len(prep.plan.entries), "cases": cases,
            "replicas_checked": zcfg.replicas, "max_abs_err": worst}


def run_zone(device, ol, zcfg: ZoneConfig) -> tuple:
    """`zone_checkout_device` of the history phase's oplog from [] to its
    tip on the card (a full run), then its parts taken apart: prepare,
    pack, upload, X8 (call_ms: CUDA events around back-to-back calls,
    each on a fresh carry; device_ms: calls queued behind a sleep), the
    plain version on the card, text assembly; the text and frontier
    against the C++ tracker's, timed as the host yardstick (`merge_native`
    on the same merge). X8's count is set to 0 before the full run and
    read after it. Returns (line, prep, tape)."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.listmerge.zone_np import prepare_zone
    from diamond_types_tpu_torch.native.core import merge_native
    x8 = kernels.zone_tape_run
    x8.launches = 0
    (txt, frontier), full_ms = wall_ms(
        lambda: zk.zone_checkout_device(ol, device=device))
    launches = x8.launches
    t = time.perf_counter()
    want, want_frontier = merge_native(ol, "", [], list(ol.version))
    native_ms = 1e3 * (time.perf_counter() - t)
    check(txt == want, "zone: the text differs from the C++ tracker's")
    check(sorted(frontier) == sorted(want_frontier),
          "zone: the frontier differs from the C++ tracker's")
    check(launches == 1, f"zone: X8 launched {launches} times for one "
          "checkout")

    t = time.perf_counter()
    prep = prepare_zone(ol, fetch_composed=False)
    prepare_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    tape = zk.pack_zone_tape(prep)
    pack_ms = 1e3 * (time.perf_counter() - t)
    xs, upload_ms = wall_ms(lambda: zk.tape_xs(tape, device))
    init = zone_fresh(zk, tape, prep, device)
    pick = tuple(kernels.cluster_size(1, tape.W, tape.n_idx))

    def x8_timings(cluster):
        """X8's result and timings at `cluster`, each call on a fresh
        copy of the carry (copies made before the timed calls)."""
        pool = [tuple(t.clone() for t in init)
                for _ in range(2 + zcfg.reps + 4 * zcfg.reps + 1)]

        def call():
            return x8(zk.ZoneCarry(*pool.pop()), xs, tape.plen,
                      cluster=cluster)
        got = call()
        return got, timings(call, zcfg.reps, zcfg.reps)

    got, t_k = x8_timings(None)                 # the rule's pick
    got_g, t_g = x8_timings((1, False))         # c 1, global memory
    # the serial chain: an APPLY step at least an empty APPLY step's time
    # (its cluster barriers), a row step at least a self-FORK's, both
    # measured with X8 at the pick's shape and W
    apply_steps = int((tape.op == zk.OP_APPLY).sum())
    row_steps = int(tape.op.shape[0]) - apply_steps
    apply_us = zone_step_us(zk, device, tape.W, tape.n_idx, pick,
                            zk.OP_APPLY)
    row_us = zone_step_us(zk, device, tape.W, tape.n_idx, pick, zk.OP_FORK)
    want_c, plain_ms = wall_ms(lambda: zk.run_zone_plain(init, xs,
                                                         tape.plen))
    err = max(zone_err(got, want_c), zone_err(got_g, want_c))
    check(err == 0, f"zone: X8 differs from its plain version: max abs "
          f"err {err}")
    t = time.perf_counter()
    text2 = zk.assemble_text(got.rank[0], got.ever[0], prep.pool)
    assemble_ms = 1e3 * (time.perf_counter() - t)
    check(text2 == want, "zone: the kernel's text differs")
    line = {"phase": "zone", "lvs": len(ol), "W": tape.W, "plen": tape.plen,
            "n_idx": tape.n_idx, "T": int(tape.op.shape[0]),
            "apply_steps": apply_steps,
            "plan_entries": len(prep.plan.entries), "chars": len(txt),
            "launches": launches, "max_abs_err": err,
            "full_call_ms": full_ms,
            "parts_ms": {"prepare": prepare_ms, "pack": pack_ms,
                         "upload": upload_ms, "kernel_call": t_k["call_ms"],
                         "kernel_device": t_k["device_ms"],
                         "assemble_text": assemble_ms},
            "x8": {**t_k, "ms": t_k["call_ms"], "plain_ms": plain_ms,
                   **zone_bounds(zk, tape, xs, init),
                   "cluster": pick[0],
                   "form": "shared" if pick[1] else "global",
                   "c1_global": t_g,
                   "speedup_vs_c1_global": t_g["device_ms"]
                   / t_k["device_ms"],
                   "empty_apply_step_us": apply_us,
                   "self_fork_step_us": row_us,
                   "barrier_us": apply_us / ZONE_APPLY_BARRIERS,
                   "serial_floor_ms": (apply_steps * apply_us
                                       + row_steps * row_us) / 1e3,
                   "bound_by": "bytes", "library_ms": None,
                   "tape_bytes": zone_bytes(xs.values()),
                   "carry_bytes": zone_bytes(init),
                   "device_us_per_step": 1e3 * t_k["device_ms"]
                   / int(tape.op.shape[0])},
            "host_merge_native_ms": native_ms}
    return line, prep, tape


def run_zone_batch(device, prep, tape, zcfg: ZoneConfig) -> dict:
    """BASELINE config 4's shape on the zone phase's tape: one shared tape
    for B replicas, `execute_zone_batch` (ONE X8 launch) at each of
    `batches`, every replica's rank and ever equal to B 1's; then
    every launch shape at each B (`zone_shapes`: at B 1 every cluster size
    in both forms, above it the shared-memory sizes that fit, c 1 in
    global memory and the rule's pick), each timed by CUDA events around
    one launch (the least of `sweep_reps` launches, each on a fresh
    carry), equal too; then `execute_zone_batch_sliced` at `slice_batch`
    in slices of `slice_steps` (one launch per slice), equal too. X8's
    count is set to 0 before the runs and read after them."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    x8 = kernels.zone_tape_run
    xs = zk.tape_xs(tape, device)
    per_replica = zone_bytes(zone_fresh(zk, tape, prep, device))
    x8.launches = 0
    ref = None
    runs = []
    for b in zcfg.batches:
        torch.cuda.reset_peak_memory_stats()
        (rank, ever), ms = wall_ms(lambda: zk.execute_zone_batch(
            tape, prep.agent_k, prep.seq_k, b, device=device, xs=xs))
        if ref is None:
            ref = (rank[:1].clone(), ever[:1].clone())
        same = bool((rank == ref[0]).all()) and bool((ever == ref[1]).all())
        check(same, f"zone_batch: a replica of B {b} differs from B 1")
        runs.append({"B": b, "ms": ms, "replicas_per_s": b / (ms / 1e3),
                     "carry_bytes": per_replica * b,
                     "peak_mib": torch.cuda.max_memory_allocated() / 2**20})
        del rank, ever
    # every shape that fits at each B, one launch each on a fresh carry,
    # timed by CUDA events around the launch; rank and ever against B 1
    sweep = []
    for b in zcfg.batches:
        pick = tuple(kernels.cluster_size(b, tape.W, tape.n_idx))
        row = {"B": b, "pick": shape_name(pick), "device_ms": {}}
        for shape in zone_shapes(kernels, b, tape.W, tape.n_idx,
                                 every=b == 1):
            times = []
            for _ in range(zcfg.sweep_reps):
                carry = zone_fresh(zk, tape, prep, device, b)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                ev[0].record()
                x8(carry, xs, tape.plen, cluster=shape)
                ev[1].record()
                torch.cuda.synchronize()
                check(bool((carry.rank == ref[0]).all())
                      and bool((carry.ever == ref[1]).all()),
                      f"zone_batch: a replica of B {b} at "
                      f"{shape_name(shape)} differs from B 1")
                times.append(ev[0].elapsed_time(ev[1]))
                del carry
            row["device_ms"][shape_name(shape)] = min(times)
        ms = row["device_ms"]
        row["best"] = min(ms, key=ms.get)
        row["pick_vs_c1_global"] = ms[row["pick"]] / ms["c1 global"]
        row["replicas_per_s_pick"] = b / (ms[row["pick"]] / 1e3)
        sweep.append(row)
    (rank, ever), sliced_ms = wall_ms(lambda: zk.execute_zone_batch_sliced(
        tape, prep.agent_k, prep.seq_k, zcfg.slice_batch,
        slice_steps=zcfg.slice_steps, device=device))
    check(bool((rank == ref[0]).all()) and bool((ever == ref[1]).all()),
          "zone_batch: the sliced run differs from B 1")
    n_slices = -(-int(tape.op.shape[0]) // zcfg.slice_steps)
    launches = x8.launches
    n_sweep = zcfg.sweep_reps * sum(len(r["device_ms"]) for r in sweep)
    check(launches == len(zcfg.batches) + n_sweep + n_slices,
          f"zone_batch: X8 launched {launches} times for "
          f"{len(zcfg.batches)} batches, {n_sweep} sweep launches and "
          f"{n_slices} slices")
    return {"phase": "zone_batch", "W": tape.W, "T": int(tape.op.shape[0]),
            "n_idx": tape.n_idx, "carry_bytes_per_replica": per_replica,
            "runs": runs, "sweep": sweep, "launches": launches,
            "sliced": {"B": zcfg.slice_batch, "slice_steps": zcfg.slice_steps,
                       "slices": n_slices, "ms": sliced_ms}}


ZONE_SHARDED_DEVICES = 4               # the replica form's split
ZONE_SHARDED_BATCH = 1024              # config 4: 4 launches of 256
ZONE_SHARDED_ROW_DEVICES = 3           # the row form's split
ZONE_SHARDED_ROWS = 4                  # the session's n_rows, before rounding


def run_zone_sharded(device, prep, tape) -> dict:
    """The zone engine's multi-device forms, with the one card named
    several times: the split, placement and gathers run, but no copy
    between cards takes place. The replica form: `execute_zone_batch` at
    B 1,024 over `[device] * 4` (four X8 launches of 256 replicas), every
    replica's rank and ever equal to B 1's on the zone phase's tape, and
    B 1,022 refused (ValueError) with no launch. The row form: a
    `DeviceZoneSession(devices=[device] * 3, n_rows=4)` over the device
    soak's 300-op growth history, driven through the JAX package's
    sharded-session drills (concurrent edits; n_rows_eff + 3 forks, then
    a revisit of an evicted frontier; a bulk insert just past the slot
    headroom; a new agent): after every sync the text equals the C++
    tracker's, each forced drill raises `resyncs`, n_rows_eff divides
    over the devices and the state rows rest in equal blocks. Every X8
    launch of the session is held against `run_zone_plain` on the card
    from a copy of its carry. X8's count is set to 0 after the B 1
    reference and read after the drills."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
    from diamond_types_tpu_torch.native.core import get_native_ctx
    x8 = kernels.zone_tape_run
    rank1, ever1 = zk.execute_zone_batch(tape, prep.agent_k, prep.seq_k, 1,
                                         device=device)
    x8.launches = 0
    devs = [device] * ZONE_SHARDED_DEVICES
    (rank, ever), replica_ms = wall_ms(lambda: zk.execute_zone_batch(
        tape, prep.agent_k, prep.seq_k, ZONE_SHARDED_BATCH, devices=devs))
    replica_launches = x8.launches
    check(replica_launches == ZONE_SHARDED_DEVICES,
          f"zone_sharded: X8 launched {replica_launches} times over "
          f"{ZONE_SHARDED_DEVICES} devices")
    check(tuple(rank.shape) == (ZONE_SHARDED_BATCH, tape.W)
          and bool((rank == rank1).all()) and bool((ever == ever1).all()),
          "zone_sharded: a replica of the split batch differs from B 1")
    del rank, ever
    try:
        zk.execute_zone_batch(tape, prep.agent_k, prep.seq_k,
                              ZONE_SHARDED_BATCH - 2, devices=devs)
        refused = False
    except ValueError:
        refused = True
    check(refused and x8.launches == replica_launches,
          f"zone_sharded: B {ZONE_SHARDED_BATCH - 2} over "
          f"{ZONE_SHARDED_DEVICES} devices was not refused before any "
          "launch")
    with KeptRuns(kernels, "zone_tape_run") as spy:
        hcfg = HistoryConfig()
        ol = build_history(np.random.default_rng([0, 20]), SOAK_GROWTH_LVS,
                           hcfg, hcfg.small_turns)
        a, b = (ol.get_or_create_agent_id(n) for n in ("sa", "sb"))
        lvs = len(ol)
        t = time.perf_counter()
        sess = DeviceZoneSession(ol, n_rows=ZONE_SHARDED_ROWS,
                                 devices=[device] * ZONE_SHARDED_ROW_DEVICES)
        k = ZONE_SHARDED_ROW_DEVICES
        syncs = []

        def parity(tag: str) -> None:
            sess.sync()
            want, _ = get_native_ctx(ol).merge_to_string("", [], ol.version)
            check(sess.text() == want, f"zone_sharded: the row form's text "
                  f"differs from the C++ tracker's after {tag}")
            blocks = sess.state_blocks
            check(sess.carry.state is None and sess.n_rows_eff % k == 0
                  and len(blocks) == k
                  and all(tuple(x.shape) == (1, sess.n_rows_eff // k,
                                             sess.W_cap) for x in blocks),
                  f"zone_sharded: the state rows after {tag} do not rest "
                  f"in {k} equal blocks")
            syncs.append({"after": tag, "resyncs": sess.resyncs,
                          "merges": sess.merges,
                          "n_rows_eff": sess.n_rows_eff,
                          "W_cap": sess.W_cap, "chars": len(want)})

        parity("build")
        tip = list(ol.version)
        v1 = ol.add_insert_at(a, tip, 0, "sharded! ")
        v2 = ol.add_insert_at(b, tip, 0, "concurrent! ")
        ol.add_delete_at(a, [v1, v2], 0, 4, None)
        parity("concurrent edits")
        base = sess.resyncs
        tip = list(ol.version)
        forks = [ol.add_insert_at((a, b)[i % 2], tip, 0, f"[f{i}]")
                 for i in range(sess.n_rows_eff + 3)]
        parity("row-exhaustion forks")
        ol.add_insert_at(a, [forks[0]], 0, "revisit-evicted ")
        parity("evicted-frontier revisit")
        check(sess.resyncs > base, "zone_sharded: LRU pressure forced no "
              "resync")
        base = sess.resyncs
        ol.add_insert_at(a, list(ol.version), 0,
                         "#" * (sess.W_cap - sess.W_used + 64))
        parity("slot-capacity overflow")
        check(sess.resyncs > base, "zone_sharded: the capacity overflow "
              "forced no resync")
        base = sess.resyncs
        ol.add_insert_at(ol.get_or_create_agent_id("a-fresh-agent"),
                         list(ol.version), 0, "epoch! ")
        parity("agent-epoch change")
        check(sess.resyncs > base, "zone_sharded: the new agent forced no "
              "resync")
        torch.cuda.synchronize()
        row_s = time.perf_counter() - t
        launches = x8.launches
    session_runs = len(spy.runs)
    check(launches == replica_launches + session_runs
          and session_runs == sess.resyncs + 1 + sess.merges,
          f"zone_sharded: X8 launched {launches} times for "
          f"{replica_launches} replica blocks and {session_runs} session "
          f"tape runs ({sess.resyncs} resyncs, {sess.merges} merges)")
    t = time.perf_counter()
    worst = max(zone_err(after, zk.run_zone_plain(before, xs, plen))
                for xs, plen, before, after in spy.runs)
    check(worst == 0, f"zone_sharded: an X8 launch of the row form differs "
          f"from its plain version: max abs err {worst}")
    plain_s = time.perf_counter() - t
    return {"phase": "zone_sharded",
            "one_card": f"the card named {ZONE_SHARDED_DEVICES} and "
                        f"{ZONE_SHARDED_ROW_DEVICES} times: the split, "
                        "placement and gathers run; no copy between cards "
                        "takes place",
            "launches": launches,
            "replica": {"B": ZONE_SHARDED_BATCH,
                        "devices": ZONE_SHARDED_DEVICES,
                        "launches": replica_launches, "ms": replica_ms,
                        "uneven_B_refused": ZONE_SHARDED_BATCH - 2},
            "rows": {"lvs": lvs, "devices": k,
                     "n_rows": ZONE_SHARDED_ROWS,
                     "n_rows_eff": sess.n_rows_eff,
                     "launches": session_runs, "resyncs": sess.resyncs,
                     "merges": sess.merges, "syncs": syncs,
                     "seconds": row_s},
            "max_abs_err": worst, "plain_check_s": plain_s}


def run_scheduler_zone(rng: np.random.Generator, device, cfg: ServeConfig,
                       scfg: SchedulerConfig, zcfg: ZoneConfig) -> dict:
    """The zone-session bank on the card: the scheduler phase's documents
    and edits (the same generator seed) through `MergeScheduler(fused=
    False)`, one `DeviceZoneSession` per document, every session resident
    (`sched_max_slots`). First `sched_rounds` of the scheduler phase's
    rounds, whose new agent names make every session resync; then
    `sched_continued_rounds` rounds that reuse the last round's names, so
    the sessions continue their resident carries (`sync`). Per round
    `submit`, `pump()`, `drain()`; round 1 traced by `torch.profiler`
    (device activity only). Every text must equal the host's merged tip
    after every round; 0 host fallbacks; X8 launches == the sessions'
    tape runs (one per resync, one per sync that continued); in every
    continued round some sessions continued. Each tape run keeps a copy of
    the carry before and after its launch (copies on the card, inside the
    timed rounds: they lower docs/s), and afterwards every launch is held
    exactly against
    `run_zone_plain` on the same carry and tape, on the card. X8's count is
    set to 0 just before the rounds and read just after."""
    import threading

    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
    from diamond_types_tpu_torch.serve import MergeScheduler

    t0 = time.perf_counter()
    ols = build_docs(rng, cfg)
    by_id = {ol.doc_id: ol for ol in ols}
    tips = [host_branch(ol) for ol in ols]
    sched = MergeScheduler(
        scfg.shards, resolve=by_id.__getitem__, engine="device", fused=False,
        flush_docs=scfg.flush_docs, flush_workers=True,
        max_sessions_per_shard=scfg.max_sessions_per_shard,
        max_slots_per_shard=zcfg.sched_max_slots,
        session_opts={"device": device}, sync_lock=threading.Lock())
    for ol in ols:
        sched.submit(ol.doc_id, 1)
    sched.drain()                  # builds every session
    setup_s = time.perf_counter() - t0
    x8 = kernels.zone_tape_run
    runs = []                      # (tape, carry before, carry after)
    real_run = DeviceZoneSession._run_tape

    shapes = collections.Counter()      # the rule's pick per launch

    def counted_run(sess, tape):
        before = zk.ZoneCarry(*(t.clone() for t in sess.carry))
        B, n_idx, W = sess.carry.state.shape
        shapes[shape_name(kernels.cluster_size(B, W, n_idx))] += 1
        real_run(sess, tape)
        runs.append((tape, before,
                     zk.ZoneCarry(*(t.clone() for t in sess.carry))))

    n_rounds = zcfg.sched_rounds + zcfg.sched_continued_rounds
    rounds, profile = [], None
    DeviceZoneSession._run_tape = counted_run
    x8.launches = 0
    try:
        for r in range(n_rounds):
            continued = r >= zcfg.sched_rounds
            subs = round_edits(rng, ols, tips, r, cfg,
                               names=zcfg.sched_rounds - 1 if continued
                               else None)
            before = sched.metrics_json()
            n_runs = len(runs)
            profiling = r == scfg.profile_round
            with (torch.profiler.profile(activities=PROFILED)
                  if profiling else contextlib.nullcontext()) as prof:
                t = time.perf_counter()
                for doc_id, n_ops in subs:
                    check(sched.submit(doc_id, n_ops)["accepted"],
                          f"scheduler_zone round {r}: {doc_id} was not "
                          "admitted")
                sched.pump()
                sched.drain()
                wall = time.perf_counter() - t
            if profiling:
                profile = device_share(prof, wall, r)
            after = sched.metrics_json()
            delta = {k: after["totals"][k] - before["totals"][k]
                     for k in ("flushes", "flushed_docs", "syncs", "builds",
                               "evictions", "resyncs", "host_fallbacks")}
            ops = sum(n for _, n in subs)
            n_x8 = len(runs) - n_runs
            rounds.append({"round": r, "agents": "kept" if continued
                           else "new", "wall_ms": 1e3 * wall,
                           "docs_per_s": delta["flushed_docs"] / wall,
                           "ops": ops, "ops_per_s": ops / wall,
                           "x8_launches": n_x8,
                           "continued_launches": n_x8 - delta["resyncs"],
                           "tape_steps": sum(int(x[0].op.shape[0])
                                             for x in runs[n_runs:]),
                           **delta})
            for ol, tip in zip(ols, tips):
                check(sched.text(ol.doc_id) == tip.snapshot(),
                      f"scheduler_zone round {r}: {ol.doc_id} differs from "
                      "the host's merge")
            if continued:
                check(rounds[-1]["continued_launches"] > 0,
                      f"scheduler_zone round {r}: no session continued its "
                      "carry")
        sched.stop_workers()
    finally:
        DeviceZoneSession._run_tape = real_run
    launches = x8.launches
    m = sched.metrics_json()
    check(m["totals"]["host_fallbacks"] == 0, "scheduler_zone: host "
          "fallbacks")
    check(launches == len(runs) > 0, f"scheduler_zone: X8 launched "
          f"{launches} times for {len(runs)} session tape runs")
    for ol, tip in zip(ols[:scfg.fresh_checkouts], tips):
        check(tip.snapshot() == host_branch(ol).snapshot(),
              f"scheduler_zone: {ol.doc_id}'s merged branch differs from "
              "the host checkout")
    # every launch of the rounds against the plain version
    t = time.perf_counter()
    err = 0
    while runs:
        tape, before, after = runs.pop()
        err = max(err, zone_err(after, zk.run_zone_plain(
            before, zk.tape_xs(tape, device), tape.plen)))
    plain_check_s = time.perf_counter() - t
    check(err == 0, f"scheduler_zone: an X8 launch differs from its plain "
          f"version: max abs err {err}")
    lat = m["latencies"]
    sessions = [s for b in sched.banks for s in b.sessions.values()]
    return {"phase": "scheduler_zone", "docs": cfg.n_docs,
            "shards": scfg.shards, "flush_docs": scfg.flush_docs,
            "shortened": {"rounds": f"{zcfg.sched_rounds} of the scheduler "
                          f"phase's {scfg.rounds}, then "
                          f"{zcfg.sched_continued_rounds} with its last "
                          "round's agents"},
            "setup_s": setup_s, "launches": launches,
            "cluster_hist": dict(shapes),
            "max_abs_err": err, "launches_checked": launches,
            "plain_check_s": plain_check_s,
            "summary": {
                "docs_per_s": [x["docs_per_s"] for x in rounds],
                "ops_per_s": [x["ops_per_s"] for x in rounds],
                "flush_ms_p50_p99": [1e3 * lat["flush"]["p50"],
                                     1e3 * lat["flush"]["p99"]],
                "x8_launches_per_round": launches / len(rounds),
                "continued_launches": sum(x["continued_launches"]
                                          for x in rounds),
                "builds": m["totals"]["builds"],
                "resyncs": m["totals"]["resyncs"],
                "evictions": m["totals"]["evictions"],
                "device_busy_share": profile["device_busy_share"]
                if profile else None},
            "rounds": rounds, "totals": m["totals"], "profile": profile,
            "resident_sessions": len(sessions),
            "W_cap_max": max(s.W_cap for s in sessions),
            "footprint_slots": sum(s.footprint_slots() for s in sessions)}


@dataclass
class HydratedConfig:
    warm_max: int = 64          # a quarter of the 256 documents
    workers: int = 2
    rounds: int = 4             # per-shard flush workers
    window_rounds: int = 3      # then the flush window
    wave: int = 32              # documents opened and edited together
    profile_round: int = 1      # this round is traced


def edit_script(rng, text_len: int, r: int, cfg: ServeConfig) -> list:
    """One round's edits of one document as positions and texts, so any
    oplog holding the document replays them alike whatever its LV
    numbering: `round_edits`'s shape (two agents named after round `r`
    fork the merged tip and make 8-64 edits each, the first agent merges
    and edits once on top), each op decided from its branch's length."""
    ops = []
    for name in (f"fork{r}a", f"fork{r}b"):
        cur = text_len
        for _ in range(int(rng.integers(cfg.edits_min, cfg.edits_max + 1))):
            if cur and rng.random() < 0.4:
                p = int(rng.integers(0, cur))
                end = min(cur, p + int(rng.integers(1, cfg.del_max + 1)))
                ops.append((name, "del", p, end))
                cur -= end - p
            else:
                p = int(rng.integers(0, cur + 1))
                s = rand_text(rng, int(rng.integers(1, cfg.ins_max + 1)))
                ops.append((name, "ins", p, s))
                cur += len(s)
    ops.append(("typist", "merge"))
    ops.append(("typist", "ins", 0, rand_text(rng, 1)))
    return ops


def apply_script(ol, ops, tip=None):
    """Replay `edit_script`'s ops into `ol`: the forks start from `tip`
    (a branch at `ol`'s tip; default: the C++ tracker's merge of it),
    "merge" merges the tip again. Returns the merging agent's branch,
    which ends at the new tip."""
    tip = host_branch(ol) if tip is None else tip
    brs = {name: fork(tip) for name, kind, *_ in ops if kind != "merge"}
    for name, kind, *args in ops:
        if kind == "merge":
            brs[name] = host_branch(ol)
            continue
        agent = ol.get_or_create_agent_id(name)
        if kind == "ins":
            brs[name].insert(ol, agent, *args)
        else:
            brs[name].delete(ol, agent, *args)
    return brs[ops[-1][0]]


@contextlib.contextmanager
def timed_methods(parts: Dict[str, float], targets) -> None:
    """Wrap each (owner, attribute, part) of `targets` in a function that
    adds its host seconds to `parts[part]` (summed over threads) and
    calls through; restored on exit. Unlike `Spy`, the wrapper is a plain
    function, so it binds as a method when the owner is a class."""
    saved = []
    for owner, name, part in targets:
        real = getattr(owner, name)

        def wrapper(*args, _real=real, _part=part, **kwargs):
            t = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                parts[_part] += time.perf_counter() - t
        saved.append((owner, name, real))
        setattr(owner, name, wrapper)
    try:
        yield
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def run_scheduler_hydrated(rng: np.random.Generator, device,
                           cfg: ServeConfig, scfg: SchedulerConfig,
                           hcfg: HydratedConfig) -> dict:
    """The serve layer's entry point over the residency tier: the
    scheduler phase's 256 documents (its generator), each saved to its own
    `TieredStore` home under a temporary root, served by a device-engine
    `MergeScheduler(4 shards, fused, device_plan)` whose `resolve` is a
    `Hydrator(workers=2, warm_max=64)`'s, wired in with `attach_hydrator`.
    An in-memory mirror oplog per document takes the same edits and never
    goes through the tier: it is the reference.

    Each round takes the documents in waves of half the warm tier. A wave
    is opened (`submit` of each document, `pump`, `drain`: the flush gate
    defers the cold documents once and hydrates them, the bank rebuilds
    the stale sessions on the warm oplogs), then edited: `edit_script`'s
    ops go into the warm oplog `hyd.resolve` returns, under the oplog
    guard, and into the mirror; a second flush plans the tails (K2) and
    replays them (K1). Later waves evict the wave's documents to their
    snapshots, so every round hydrates every document anew. 4 rounds on
    per-shard flush workers, then 3 rounds with `mesh_window=True`, each
    stage with its own Hydrator over the same store (so both gate sites
    run); round 1 traced. Requires every text after each wave equal to the
    mirror's tip branch (the C++ tracker's merge of the mirror and the
    merging agent's edit), after the last round a fresh `TieredStore` over
    the root loading every document to the tracker's merge of the mirror,
    0 flush leaks, quarantines and host fallbacks, the lock witness
    acyclic, K1 launches == fused calls (window dispatches) + per-doc
    replays, K2 launches == resolves, and every K1 and K2 call exactly
    equal to the kernel's plain version. The root is removed."""
    import shutil
    import tempfile

    from diamond_types_tpu_torch.analysis import witness
    from diamond_types_tpu_torch.encoding import decode, encode
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import xform
    from diamond_types_tpu_torch.serve import scheduler as sched_mod
    from diamond_types_tpu_torch.storage import tier
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.parallel import arena
    from diamond_types_tpu_torch.serve import MergeScheduler
    from diamond_types_tpu_torch.serve.bank import SessionBank
    from diamond_types_tpu_torch.serve.hydrate import Hydrator
    from diamond_types_tpu_torch.storage.tier import TieredStore

    t0 = time.perf_counter()
    mirror = build_docs(rng, cfg)
    ids = [ol.doc_id for ol in mirror]
    by_id = dict(zip(ids, mirror))
    tips = {ol.doc_id: host_branch(ol) for ol in mirror}   # mirror tips
    root = tempfile.mkdtemp(prefix="dt-smoke-hydrated-")
    witness.witness_enable()
    witness.witness_reset()
    guard = witness.make_lock("smoke.oplog", "oplog")
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    lin = kernels.resolve_rows     # its count: the linearize launches
    steps: List[int] = []
    drops: Dict[str, int] = collections.Counter()
    real_sync, real_drop = ff.FusedDocSession.sync, SessionBank._drop

    def counted_sync(sess):
        n = real_sync(sess)
        steps.append(n)
        return n

    def counted_drop(bank, doc_id, sess, why):
        drops[why] += 1
        return real_drop(bank, doc_id, sess, why)

    stages = []
    rounds = []
    profile = None
    verify_s = 0.0
    try:
        store = TieredStore(root)
        for ol in mirror:
            store.save(ol.doc_id, ol)
        setup_s = time.perf_counter() - t0
        ff.FusedDocSession.sync = counted_sync
        SessionBank._drop = counted_drop
        # host seconds by part, summed over the threads (flush workers,
        # hydration workers, the snapshot thread, this one)
        parts: Dict[str, float] = collections.defaultdict(float)
        with Spy(ff, "apply_ops_window", keep=True) as k1_calls, \
                Spy(kernels, "resolve_rows", keep=True) as k2_calls, \
                timed_methods(parts, (
                    (TieredStore, "load", "load"),
                    (tier, "decode_into", "decode"),
                    (decode, "decode_into", "decode"),
                    (TieredStore, "save", "save"),
                    (encode, "encode_oplog", "encode"),
                    (SessionBank, "_build", "session_build"),
                    (xform, "extract_tail", "extract"),
                    (xform, "resolve_positions", "resolve"),
                    (ff, "kernel_fused_replay", "replay"),
                    (sched_mod, "mesh_fused_replay", "replay"))):
            r = 0
            for mesh_window, n_rounds in ((False, hcfg.rounds),
                                          (True, hcfg.window_rounds)):
                arena.reset_arenas()
                hyd = Hydrator(store, workers=hcfg.workers,
                               warm_max=hcfg.warm_max, oplog_lock=guard,
                               seed=r)
                sched = MergeScheduler(
                    scfg.shards, resolve=hyd.resolve, engine="device",
                    fused=True, device_plan=True,
                    flush_docs=scfg.flush_docs, flush_workers=True,
                    mesh_window=mesh_window,
                    max_sessions_per_shard=scfg.max_sessions_per_shard,
                    fused_opts={"max_ins": cfg.max_ins,
                                "headroom": cfg.headroom, "device": device},
                    sync_lock=guard)
                sched.attach_hydrator(hyd)
                n_steps0 = len(steps)
                k1.launches = k2.launches = lin.launches = 0
                for _ in range(n_rounds):
                    profiling = r == hcfg.profile_round
                    before = sched.metrics_json()
                    n_k1, n_k2 = len(k1_calls.seconds), len(k2_calls.seconds)
                    parts0 = dict(parts)
                    n_ops = n_docs = 0
                    edit_s = check_s = 0.0
                    with (torch.profiler.profile(activities=PROFILED)
                          if profiling else contextlib.nullcontext()) as prof:
                        t = time.perf_counter()
                        for w in range(0, len(ids), hcfg.wave):
                            wave = ids[w:w + hcfg.wave]
                            for d in wave:          # open
                                check(sched.submit(d, 1)["accepted"],
                                      f"round {r}: {d} was not admitted")
                            sched.pump()
                            sched.drain()
                            te = time.perf_counter()
                            subs = []
                            for d in wave:          # edit
                                ops = edit_script(rng, len(tips[d]), r,
                                                  cfg)
                                n = sum(1 for op in ops
                                        if op[1] != "merge")
                                tips[d] = apply_script(by_id[d], ops,
                                                       tips[d])
                                while True:
                                    ol = hyd.resolve(d)
                                    with guard:
                                        # the pop of an eviction runs
                                        # under the guard: re-resolve if
                                        # it won the race to this oplog
                                        if hyd._warm.get(d) is ol:
                                            apply_script(ol, ops)
                                            break
                                subs.append((d, n))
                            edit_s += time.perf_counter() - te
                            for d, n in subs:
                                check(sched.submit(d, n)["accepted"],
                                      f"round {r}: {d} was not admitted")
                                n_ops += n
                            sched.pump()
                            sched.drain()
                            n_docs += len(subs)
                            tc = time.perf_counter()
                            for d in wave:
                                check(sched.text(d) == tips[d].snapshot(),
                                      f"round {r}: {d} differs from the "
                                      "mirror's merge")
                            check_s += time.perf_counter() - tc
                        wall = time.perf_counter() - t - edit_s - check_s
                    verify_s += check_s
                    if profiling:
                        profile = device_share(prof, wall, r)
                    after = sched.metrics_json()
                    delta = {k: after["totals"][k] - before["totals"][k]
                             for k in ("flushes", "flushed_docs", "builds",
                                       "evictions", "fused_calls",
                                       "host_fallbacks")}
                    hd = {k: after["hydration"][k] - before["hydration"][k]
                          for k in ("hydrations", "sync_hydrations",
                                    "deferrals", "defer_escalations",
                                    "evictions_to_snapshot", "snapshots")}
                    check(after["transform"]["device_docs"]
                          > before["transform"]["device_docs"],
                          f"round {r}: no document was planned on the "
                          "device")
                    rounds.append({
                        "round": r, "mesh_window": mesh_window,
                        "wall_ms": 1e3 * wall, "edit_ms": 1e3 * edit_s,
                        "check_ms": 1e3 * check_s,
                        "docs_edited": n_docs, "ops": n_ops,
                        "docs_per_s": n_docs / wall,
                        "k1_launches": len(k1_calls.seconds) - n_k1,
                        "k2_launches": len(k2_calls.seconds) - n_k2,
                        "host_s": {k: v - parts0.get(k, 0.0)
                                   for k, v in sorted(parts.items())},
                        **delta, "hydration": hd})
                    r += 1
                sched.stop_workers()
                launches, k2_launches, lin_launches = (
                    k1.launches, k2.launches, lin.launches)
                hyd.stop(checkpoint=True)
                m = sched.metrics_json()
                replays = sum(1 for n in steps[n_steps0:] if n)
                fused_calls = m["fused"]["device_calls"]
                batches = m["transform"]["batches"]
                hyd_c = m["hydration"]
                check(hyd_c["flush_leaks"] == 0,
                      f"{hyd_c['flush_leaks']} flush leaks")
                check(hyd_c["quarantined"] == 0 and not store.quarantined,
                      f"quarantines: {store.quarantined}")
                check(m["totals"]["host_fallbacks"] == 0,
                      f"{m['totals']['host_fallbacks']} host fallbacks")
                if mesh_window:
                    check(fused_calls == 0, f"{fused_calls} per-shard "
                          "fused calls under the flush window")
                    check(launches == m["window"]["dispatches"] + replays,
                          f"K1 launched {launches} times for "
                          f"{m['window']['dispatches']} window classes and "
                          f"{replays} per-doc replays")
                else:
                    check(launches == fused_calls + replays,
                          f"K1 launched {launches} times for {fused_calls} "
                          f"fused calls and {replays} per-doc replays")
                check(k2_launches == batches,
                      f"K2 launched {k2_launches} times for {batches} "
                      "resolves")
                check(lin_launches == batches,
                      f"the linearize kernel launched {lin_launches} times "
                      f"for {batches} resolves")
                lat = m["latencies"]
                stages.append({
                    "mesh_window": mesh_window, "rounds": n_rounds,
                    "launches": launches, "k2_launches": k2_launches,
                    "lin_launches": lin_launches,
                    "fused_calls": fused_calls, "per_doc_replays": replays,
                    "resolves": batches,
                    "window_dispatches": m["window"]["dispatches"]
                    if mesh_window else None,
                    "flush_ms": {q: 1e3 * lat["flush"][q]
                                 for q in ("p50", "p90", "p99", "max")},
                    "cold_start_ms": {
                        q: 1e3 * lat["hydration_cold_start"][q]
                        for q in ("p50", "p90", "p99", "max")},
                    "cold_starts": lat["hydration_cold_start"]["count"],
                    "hydration": hyd_c, "totals": m["totals"],
                    "transform": m["transform"]})
        t = time.perf_counter()
        fresh = TieredStore(root)
        for d in ids:
            check(host_branch(fresh.load(d)).snapshot()
                  == host_branch(by_id[d]).snapshot()
                  == tips[d].snapshot(),
                  f"{d} re-hydrated from its home differs from the mirror")
        rehydrate_s = time.perf_counter() - t
    finally:
        ff.FusedDocSession.sync = real_sync
        SessionBank._drop = real_drop
        shutil.rmtree(root, ignore_errors=True)
    wit = witness.witness_snapshot()
    check(wit["acyclic"] and wit["violation_count"] == 0,
          f"lock witness: cycles {wit['cycles']}, "
          f"violations {wit['violations'][:4]}")
    t = time.perf_counter()
    k1_err = k1_calls_err(k1_calls.args, cfg.max_ins)
    check(k1_err == 0, f"K1 differs from its plain version at a hydrated "
          f"scheduler call: max abs err {k1_err}")
    k2_worst = max(resolve_err(*a) for a in k2_calls.args)
    check(k2_worst == 0, f"K2 differs from its plain version at a "
          f"hydrated scheduler resolve: max abs err {k2_worst}")
    plain_check_s = time.perf_counter() - t
    n_r = len(rounds)
    launches = sum(s["launches"] for s in stages)
    k2_launches = sum(s["k2_launches"] for s in stages)
    lin_launches = sum(s["lin_launches"] for s in stages)
    summary = {
        "docs_per_s": [x["docs_per_s"] for x in rounds],
        "round_wall_ms": [x["wall_ms"] for x in rounds],
        "flush_ms_p50_p99": [[s["flush_ms"]["p50"], s["flush_ms"]["p99"]]
                             for s in stages],
        "cold_start_ms_p50_p99": [[s["cold_start_ms"]["p50"],
                                   s["cold_start_ms"]["p99"]]
                                  for s in stages],
        "k1_launches_per_round": launches / n_r,
        "k2_launches_per_round": k2_launches / n_r,
        "builds": sum(s["totals"]["builds"] for s in stages),
        "evictions": sum(s["totals"]["evictions"] for s in stages),
        "evictions_by_site": dict(drops),
        "stale_oplog_rebuilds": drops.get("stale-oplog", 0),
        "host_fallbacks": sum(s["totals"]["host_fallbacks"]
                              for s in stages),
        "flush_leaks": sum(s["hydration"]["flush_leaks"] for s in stages),
        "device_busy_share": profile["device_busy_share"]
        if profile else None}
    return {"phase": "scheduler_hydrated", "summary": summary,
            "docs": cfg.n_docs, "shards": scfg.shards,
            "warm_max": hcfg.warm_max, "workers": hcfg.workers,
            "wave": hcfg.wave, "launches": launches,
            "k2_launches": k2_launches, "lin_launches": lin_launches,
            "stages": stages,
            "rounds": rounds, "profile": profile, "setup_s": setup_s,
            "verify_s": verify_s, "rehydrate_check_s": rehydrate_s,
            "k1_calls_checked": len(k1_calls.args), "k1_max_abs_err": k1_err,
            "k2_calls_checked": len(k2_calls.args),
            "k2_max_abs_err": k2_worst, "plain_check_s": plain_check_s,
            "lock_witness": {k: wit[k] for k in ("acyclic", "edge_count",
                                                 "violation_count",
                                                 "acquires", "edges")}}


QOS_TENANTS = 4                     # documents named t{k}-doc{nnn}
QOS_INTERVAL_S = 0.05               # the controller's step interval
QOS_TS_WINDOW_S = 1.0               # the time series' window width
OBS_SAMPLE_RATE = 0.1               # scheduler_obs's head sampling
OBS_ROUNDS = 3                      # scheduler_obs's free rounds


@dataclass
class QosConfig:
    interactive: int = 128          # the documents of each class
    bulk: int = 80
    catchup: int = 48
    rounds: int = 5
    warning_round: Optional[int] = 3    # rounds counted from 0; None:
    burning_round: Optional[int] = 4    # no round is forced
    arrival_s: float = 1.0          # a round's submits spread over this
    profile_round: int = 0          # the first round is traced


def drive_qos_rounds(phase: str, rng: np.random.Generator, device,
                     cfg: ServeConfig, scfg: SchedulerConfig,
                     qcfg: QosConfig, attach: Callable,
                     before_round: Optional[Callable] = None,
                     after_drain: Optional[Callable] = None):
    """The device scheduler under the QoS controller, shared by
    scheduler_qos and scheduler_obs: the scheduler phase's kind of 256
    documents (the phase's own generator), named `t{k}-doc{nnn}` over 4
    tenants, each with a class fixed by the generator (128 interactive, 80
    bulk, 48 catchup), served by `MergeScheduler(4 shards, fused,
    device_plan, flush_docs=8, flush_workers)` with
    `attach_qos(QosController(interval_s=0.05))`; `attach(sched, ctl)`
    then hands the controller its telemetry. Every document is opened,
    `start_pump()` runs (the pump's and the controller's own threads run
    as in a server), and `qcfg.rounds` rounds follow. Each round every
    document's edit passes the ingress gate first (`controller.admit(cls,
    tenant_of(doc))`): a shed edit is never applied to the oplog nor to
    the host mirror (the merged tip branch); an admitted one is applied,
    then submitted with its class, the submits spread evenly over
    `arrival_s` (a synthetic arrival process, one edit per admitted
    document a round: the pump flushes the buckets whose size or
    published deadline fires, and the controller sees arrival rates), and
    the round ends with `drain()`. Round `warning_round` runs under
    `force_mesh_state("warning")`, round `burning_round` under
    `force_mesh_state("burning")`, and no bulk or catchup edit may be
    admitted then. `before_round(r)` runs just before a round's submits,
    `after_drain(r, gate)` just after its drain (`gate` counts the
    round's (class, "admitted" | "shed") decisions), and the dict it
    returns joins the round's record. Flush times and queue waits are
    the rounds' own, not the open pass's. Requires every K1 and K2 call
    equal to its plain version, the controller's `steps` growing in every
    round, every text equal to the host mirror's after every round, 0
    host and plan fallbacks, interactive's published deadline at most the
    static deadline at every controller step, the launch counts equal to
    the calls the scheduler made, and the lock witness acyclic. Returns
    the run's scheduler, controller, records and checked counts."""
    from types import SimpleNamespace

    from diamond_types_tpu_torch.analysis import witness
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.qos import QosController, tenant_of
    from diamond_types_tpu_torch.serve import MergeScheduler

    t0 = time.perf_counter()
    ols = build_docs(rng, cfg)
    for d, ol in enumerate(ols):
        ol.doc_id = f"t{d % QOS_TENANTS}-doc{d:03d}"
    names = (["interactive"] * qcfg.interactive + ["bulk"] * qcfg.bulk
             + ["catchup"] * qcfg.catchup)
    check(len(names) == len(ols), "the class counts must cover the docs")
    classes = {ol.doc_id: str(c)
               for ol, c in zip(ols, rng.permutation(names))}
    by_id = {ol.doc_id: ol for ol in ols}
    tips = [host_branch(ol) for ol in ols]
    witness.witness_enable()
    witness.witness_reset()
    guard = witness.make_lock("smoke.oplog", "oplog")
    sched = MergeScheduler(
        scfg.shards, resolve=by_id.__getitem__, engine="device", fused=True,
        device_plan=True, flush_docs=scfg.flush_docs, flush_workers=True,
        max_sessions_per_shard=scfg.max_sessions_per_shard,
        fused_opts={"max_ins": cfg.max_ins, "headroom": cfg.headroom,
                    "device": device},
        sync_lock=guard)
    ctl = QosController(interval_s=QOS_INTERVAL_S)
    sched.attach_qos(ctl)
    attach(sched, ctl)
    static_s = sched.queue.flush_deadline_s
    # every controller step's published interactive deadlines (the
    # controller's thread calls self.step())
    published: List[float] = []
    real_step = ctl.step

    def watched_step(now=None):
        out = real_step(now)
        published.extend(v for (_s, c), v in ctl._table.items()
                         if c == "interactive")
        return out

    ctl.step = watched_step
    for ol in ols:                 # open every document: build sessions
        check(sched.submit(ol.doc_id, 1, qos=classes[ol.doc_id])
              ["accepted"], f"{ol.doc_id} was not admitted at open")
    sched.drain()
    setup_s = time.perf_counter() - t0
    m0 = sched.metrics_json()
    snap0 = ctl.metrics.snapshot()

    syncs: List[int] = []          # each per-doc sync's replayed ops
    real_sync = ff.FusedDocSession.sync

    def counted_sync(sess):
        n = real_sync(sess)
        syncs.append(n)
        return n

    flush_s: List[float] = []      # each flush of a taken batch
    real_flush = sched._flush_items

    def timed_flush(shard, reason, items):
        t = time.perf_counter()
        try:
            return real_flush(shard, reason, items)
        finally:
            flush_s.append(time.perf_counter() - t)

    sched._flush_items = timed_flush
    # each queued edit's admit -> flush-start wait in the rounds (the
    # scheduler's own histogram also holds the open pass above)
    waits_s: List[float] = []
    real_wait = sched.metrics.observe_queue_wait

    def kept_wait(dur_s):
        waits_s.append(dur_s)
        real_wait(dur_s)

    sched.metrics.observe_queue_wait = kept_wait
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    lin = kernels.resolve_rows     # its count: the linearize launches
    rounds = []
    edit_s = verify_s = 0.0
    profile = None
    ff.FusedDocSession.sync = counted_sync
    k1.launches = k2.launches = lin.launches = 0
    try:
        sched.start_pump()
        with Spy(ff, "apply_ops_window", keep=True) as k1_calls, \
                Spy(kernels, "resolve_rows", keep=True) as k2_calls:
            for r in range(qcfg.rounds):
                mesh = ("warning" if r == qcfg.warning_round else
                        "burning" if r == qcfg.burning_round else None)
                ctl.force_mesh_state(mesh)
                steps0 = ctl.metrics.snapshot()["controller"]["steps"]
                c0 = ctl.metrics.snapshot()["classes"]
                before = sched.metrics_json()
                n_k1, n_k2, n_fl, n_qw = (len(k1_calls.seconds),
                                          len(k2_calls.seconds),
                                          len(flush_s), len(waits_s))
                # the ingress gate, then the admitted documents' edits
                t = time.perf_counter()
                subs, gate = [], collections.Counter()
                for ol, tip in zip(ols, tips):
                    cls = classes[ol.doc_id]
                    ok, _retry, why = ctl.admit(cls, tenant_of(ol.doc_id))
                    gate[(cls, "admitted" if ok else "shed")] += 1
                    if not ok:
                        continue
                    subs += [(d, n, cls) for d, n in round_edits(
                        rng, [ol], [tip], r, cfg)]
                edit_s += time.perf_counter() - t
                profiling = r == qcfg.profile_round
                gap = qcfg.arrival_s / max(len(subs), 1)
                if before_round is not None:
                    before_round(r)
                with (torch.profiler.profile(activities=PROFILED)
                      if profiling else contextlib.nullcontext()) as prof:
                    t = time.perf_counter()
                    for k, (doc_id, n_ops, cls) in enumerate(subs):
                        # paced arrivals: the pump's thread flushes the
                        # buckets whose size or published deadline fires
                        time.sleep(max(0.0, t + k * gap
                                       - time.perf_counter()))
                        check(sched.submit(doc_id, n_ops, qos=cls)
                              ["accepted"],
                              f"round {r}: {doc_id} was not accepted")
                    t_drain = time.perf_counter()
                    sched.drain()
                    wall = time.perf_counter() - t
                    drain_ms = 1e3 * (time.perf_counter() - t_drain)
                if profiling:
                    profile = device_share(prof, wall, r)
                extra = after_drain(r, gate) if after_drain else {}
                after = sched.metrics_json()
                t = time.perf_counter()
                for ol, tip in zip(ols, tips):
                    check(sched.text(ol.doc_id) == tip.snapshot(),
                          f"round {r}: {ol.doc_id} differs from the host "
                          "mirror's merge")
                verify_s += time.perf_counter() - t
                snap = ctl.metrics.snapshot()
                steps = snap["controller"]["steps"] - steps0
                check(steps > 0, f"round {r}: the QoS controller did not "
                      "step")
                cls_delta = {c: {k: snap["classes"][c][k] - c0[c][k]
                                 for k in ("admitted", "shed", "deferred")}
                             for c in snap["classes"]}
                if r == qcfg.burning_round:
                    check(all(cls_delta[c]["admitted"] == 0
                              and gate[(c, "admitted")] == 0
                              for c in ("bulk", "catchup")),
                          f"round {r} (burning) admitted a sheddable "
                          f"edit: {cls_delta}")
                fl = np.asarray(flush_s[n_fl:]) * 1e3
                qw = np.asarray(waits_s[n_qw:]) * 1e3
                flushed = after["totals"]["flushed_docs"] \
                    - before["totals"]["flushed_docs"]
                rounds.append({
                    "round": r, "mesh_state": mesh or "ok",
                    "wall_ms": 1e3 * wall, "drain_ms": drain_ms,
                    "docs_submitted": len(subs),
                    "docs_flushed": flushed, "docs_per_s": flushed / wall,
                    "ops": sum(n for _, n, _c in subs),
                    "flush_ms_p50_p99": ([float(np.percentile(fl, 50)),
                                          float(np.percentile(fl, 99))]
                                         if fl.size else None),
                    "flushes": int(fl.size),
                    "queue_wait_ms_p50_p99": (
                        [float(np.percentile(qw, 50)),
                         float(np.percentile(qw, 99))] if qw.size else None),
                    "k1_launches": len(k1_calls.seconds) - n_k1,
                    "k2_launches": len(k2_calls.seconds) - n_k2,
                    "controller_steps": steps,
                    "classes": cls_delta,
                    "deadline_s": {c: snap["classes"][c]["deadline_s"]
                                   for c in snap["classes"]},
                    "flush_reasons": {
                        k: after["flush_reasons"].get(k, 0)
                        - before["flush_reasons"].get(k, 0)
                        for k in after["flush_reasons"]}, **extra})
        sched.stop_pump()
    finally:
        ff.FusedDocSession.sync = real_sync
        sched._flush_items = real_flush
        sched.metrics.observe_queue_wait = real_wait
        if sched._pump_thread is not None:     # a round failed: stop the
            with contextlib.suppress(Exception):   # pump and controller
                sched.stop_pump(drain=False)
    launches, k2_launches, lin_launches = (k1.launches, k2.launches,
                                           lin.launches)
    m = sched.metrics_json()
    wit = witness.witness_snapshot()
    check(wit["acyclic"] and wit["violation_count"] == 0,
          f"lock witness: cycles {wit['cycles']}, "
          f"violations {wit['violations'][:4]}")
    check(m["totals"]["host_fallbacks"] == 0,
          f"{m['totals']['host_fallbacks']} host fallbacks in {phase}")
    check(m["transform"]["fallbacks"] == 0,
          f"{m['transform']['fallbacks']} plan fallbacks in {phase}")
    worst = max(published, default=0.0)
    check(published and worst <= static_s + 1e-12,
          f"interactive's published deadline reached {worst} s, past the "
          f"static {static_s} s")
    t = time.perf_counter()
    k1_err = k1_calls_err(k1_calls.args, cfg.max_ins)
    check(k1_err == 0, f"K1 differs from its plain version at a "
          f"{phase} call: max abs err {k1_err}")
    k2_worst = max((resolve_err(*a) for a in k2_calls.args), default=0)
    check(k2_worst == 0, f"K2 differs from its plain version at a "
          f"{phase} resolve: max abs err {k2_worst}")
    plain_check_s = time.perf_counter() - t
    fused_calls = m["fused"]["device_calls"] - m0["fused"]["device_calls"]
    replays = sum(1 for n in syncs if n)
    batches = m["transform"]["batches"] - m0["transform"]["batches"]
    check(launches == fused_calls + replays and launches > 0,
          f"K1 launched {launches} times for {fused_calls} fused calls and "
          f"{replays} per-doc replays")
    check(k2_launches == batches and k2_launches > 0,
          f"K2 launched {k2_launches} times for {batches} resolves")
    check(lin_launches == batches,
          f"the linearize kernel launched {lin_launches} times for "
          f"{batches} resolves")
    return SimpleNamespace(
        sched=sched, ctl=ctl, m=m, snap0=snap0, rounds=rounds,
        published=published, worst=worst, static_s=static_s,
        flush_s=flush_s, waits_s=waits_s, profile=profile, setup_s=setup_s,
        edit_s=edit_s, verify_s=verify_s, launches=launches,
        k2_launches=k2_launches, lin_launches=lin_launches,
        fused_calls=fused_calls, replays=replays,
        batches=batches, k1_err=k1_err, k2_worst=k2_worst,
        k1_checked=len(k1_calls.args), k2_checked=len(k2_calls.args),
        plain_check_s=plain_check_s,
        lock_witness={k: wit[k] for k in ("acyclic", "edge_count",
                                          "violation_count", "acquires",
                                          "edges")})


def run_scheduler_qos(rng: np.random.Generator, device, cfg: ServeConfig,
                      scfg: SchedulerConfig, qcfg: QosConfig) -> dict:
    """The QoS controller steering the device scheduler
    (`drive_qos_rounds`): the controller reads a `TimeSeries` (1 s
    windows) through `attach_obs`. Rounds 1-3 run free, round 4 under
    `force_mesh_state("warning")` (sheddable admits count as deferred,
    their deadlines pinned to the ceilings), round 5 under
    `force_mesh_state("burning")` (bulk and catchup shed)."""
    from types import SimpleNamespace

    from diamond_types_tpu_torch.obs.timeseries import TimeSeries

    def attach(_sched, ctl):
        ctl.attach_obs(SimpleNamespace(ts=TimeSeries(
            window_s=QOS_TS_WINDOW_S, n_windows=600)))

    run = drive_qos_rounds("scheduler_qos", rng, device, cfg, scfg, qcfg,
                           attach)
    rounds, m, profile = run.rounds, run.m, run.profile
    snap = run.ctl.metrics.snapshot()
    fl_all = np.asarray(run.flush_s) * 1e3       # the rounds' flushes only
    qw_all = np.asarray(run.waits_s) * 1e3       # and queued edits' waits
    summary = {
        "docs_per_s": [x["docs_per_s"] for x in rounds],
        "round_wall_ms": [x["wall_ms"] for x in rounds],
        "flush_ms_p50_p99": [x["flush_ms_p50_p99"] for x in rounds],
        "queue_wait_ms_p50_p99": [x["queue_wait_ms_p50_p99"]
                                  for x in rounds],
        "k1_launches": [x["k1_launches"] for x in rounds],
        "k2_launches": [x["k2_launches"] for x in rounds],
        "controller_steps": [x["controller_steps"] for x in rounds],
        "interactive_published_max_s": run.worst,
        "host_fallbacks": m["totals"]["host_fallbacks"],
        "device_busy_share": profile["device_busy_share"]
        if profile else None}
    return {"phase": "scheduler_qos", "summary": summary,
            "docs": cfg.n_docs, "shards": scfg.shards,
            "flush_docs": scfg.flush_docs,
            "class_docs": {"interactive": qcfg.interactive,
                           "bulk": qcfg.bulk, "catchup": qcfg.catchup},
            "tenants": QOS_TENANTS, "static_deadline_s": run.static_s,
            "interval_s": QOS_INTERVAL_S, "launches": run.launches,
            "k2_launches": run.k2_launches,
            "lin_launches": run.lin_launches,
            "fused_device_calls": run.fused_calls,
            "per_doc_replays": run.replays, "resolves": run.batches,
            "rounds": rounds, "qos": snap,
            "qos_since_open": {
                c: {k: snap["classes"][c][k] - run.snap0["classes"][c][k]
                    for k in ("admitted", "shed", "deferred")}
                for c in snap["classes"]},
            "controller": run.ctl.export()["controller"],
            "published_interactive_steps": len(run.published),
            "profile": profile, "setup_s": run.setup_s,
            "edit_s": run.edit_s, "verify_s": run.verify_s,
            "k1_calls_checked": run.k1_checked,
            "k1_max_abs_err": run.k1_err,
            "k2_calls_checked": run.k2_checked,
            "k2_max_abs_err": run.k2_worst,
            "plain_check_s": run.plain_check_s,
            "flush_ms": {f"p{q}": float(np.percentile(fl_all, q))
                         for q in (50, 90, 99, 100)} if fl_all.size
            else None,
            "queue_wait_ms": {f"p{q}": float(np.percentile(qw_all, q))
                              for q in (50, 90, 99, 100)} if qw_all.size
            else None,
            "flush_reasons": m["flush_reasons"], "totals": m["totals"],
            "transform": m["transform"], "lock_witness": run.lock_witness}


# the (rung, purpose) transfer tags of the JAX package's device profiler
TRANSFER_TAGS = {"session.stage", "fused.plan", "pallas.plan", "mesh.plan",
                 "mesh.stage"}


@dataclass
class ObsConfig:
    arrival_s: float = 1.0          # a round's submits spread over this
    profile_round: int = 0          # the first round is traced


def span_tree_checks(spans: List[dict]) -> dict:
    """Counts of the sampled spans by name; fails unless there is at least
    one `serve.admit`, `serve.flush` and `serve.device_sync`, and every
    device_sync's parent is a flush span of the same trace."""
    by_id = {s["span"]: s for s in spans}
    names = collections.Counter(s["name"] for s in spans)
    for name in ("serve.admit", "serve.flush", "serve.device_sync"):
        check(names[name] > 0, f"scheduler_obs: no sampled {name} span")
    for s in spans:
        if s["name"] == "serve.device_sync":
            p = by_id.get(s["parent"])
            check(p is not None and p["name"] == "serve.flush"
                  and p["trace"] == s["trace"],
                  f"scheduler_obs: a device_sync span's parent is "
                  f"{p and p['name']}, not its trace's serve.flush")
    return dict(sorted(names.items()))


def run_scheduler_obs(rng: np.random.Generator, device, cfg: ServeConfig,
                      scfg: SchedulerConfig, qcfg: QosConfig,
                      ocfg: ObsConfig) -> dict:
    """The observability bundle attached to the device scheduler:
    scheduler_qos's setup and rounds (`drive_qos_rounds`, with qcfg's
    class counts) with `attach_obs(Observability(sample_rate=0.1,
    seed=<from the generator>, incident_dir=<a temporary directory>))`,
    which also hands the controller its telemetry, and the device
    profiler (`PROFILER`) reset and enabled for this phase only. 3 free
    rounds, each round's submits spread over `ocfg.arrival_s`. Requires,
    beyond `drive_qos_rounds`' checks: no edit shed by the free gate;
    sampled `serve.admit`, `serve.flush` and `serve.device_sync` spans,
    every device_sync's parent a flush span; devprof's fused device calls
    equal to the scheduler's; devprof's device_sync_s at most its
    flush_wall_s and transfers under the JAX package's (rung, purpose)
    tags; every sampled journey `adopted`; the `serve.flush` p99 over
    30 s above 0 after every round; the SLO verdict ok under the default
    objectives; the `serve.flush` exemplars carrying sampled trace ids;
    `obs.snapshot()` JSON-serialisable and rendered by `render_metrics`
    with the scheduler's metrics."""
    import dataclasses
    import tempfile

    from diamond_types_tpu_torch.obs import Observability, render_metrics
    from diamond_types_tpu_torch.obs.devprof import PROFILER

    bundle = {}
    flush_p99_s: List[float] = []
    dp0: Dict[str, dict] = {}
    devprof_round0 = None

    def attach(sched, ctl):
        seed = bundle["seed"] = int(rng.integers(1 << 31))
        obs = bundle["obs"] = Observability(
            sample_rate=OBS_SAMPLE_RATE, seed=seed,
            incident_dir=incident_dir)
        sched.attach_obs(obs)
        check(ctl.obs is obs, "attach_obs did not hand the controller the "
              "bundle")
        PROFILER.reset()
        PROFILER.enabled = True

    def before_round(r):
        if r == ocfg.profile_round:
            dp0["snap"] = PROFILER.snapshot()

    def after_drain(r, gate):
        nonlocal devprof_round0
        shed = {c: n for (c, what), n in gate.items() if what == "shed"}
        check(not shed, f"round {r}: the free gate shed {shed}")
        if r == ocfg.profile_round:
            dp1 = PROFILER.snapshot()
            fw = dp1["flush_wall_s"] - dp0["snap"]["flush_wall_s"]
            fd = dp1["device_sync_s"] - dp0["snap"]["device_sync_s"]
            devprof_round0 = {"flush_wall_s": fw, "device_sync_s": fd,
                              "device_fraction": fd / fw if fw else 0.0}
        # the controller's input: the live serve.flush series
        p99 = bundle["obs"].ts.quantile("serve.flush", 0.99, window_s=30.0)
        flush_p99_s.append(p99)
        check(p99 > 0, f"round {r}: serve.flush p99 over 30 s is {p99}")
        return {"ts_flush_p99_30s_ms": 1e3 * p99}

    free = dataclasses.replace(
        qcfg, rounds=OBS_ROUNDS, warning_round=None, burning_round=None,
        arrival_s=ocfg.arrival_s, profile_round=ocfg.profile_round)
    with tempfile.TemporaryDirectory(prefix="dt-smoke-incidents-") \
            as incident_dir:
        try:
            run = drive_qos_rounds("scheduler_obs", rng, device, cfg, scfg,
                                   free, attach, before_round, after_drain)
        finally:
            PROFILER.enabled = False
        obs, m, rounds = bundle["obs"], run.m, run.rounds
        devprof = PROFILER.snapshot()
        spans = obs.tracer.spans()
        span_names = span_tree_checks(spans)
        sampled = {s["trace"] for s in spans}
        check(devprof["fused"]["device_calls"] == m["fused"]["device_calls"],
              f"devprof counted {devprof['fused']['device_calls']} fused "
              f"calls, the scheduler {m['fused']['device_calls']}")
        check(devprof["device_sync_s"] <= devprof["flush_wall_s"],
              f"devprof's device wait {devprof['device_sync_s']} s exceeds "
              f"its flush wall {devprof['flush_wall_s']} s")
        tags = set(devprof["transfer_detail"])
        check(devprof["transfers"] > 0 and tags and tags <= TRANSFER_TAGS,
              f"devprof transfers {devprof['transfers']} under "
              f"{sorted(tags)}")
        # every sampled journey (one edit per document a round: none
        # coalesces) is adopted
        roots = [s["trace"] for s in spans if s["name"] == "serve.admit"]
        stuck = [tr for tr in roots
                 if "adopted" not in (obs.journey.journey(tr) or
                                      {"stages": {}})["stages"]]
        check(roots and not stuck, f"{len(stuck)} of {len(roots)} sampled "
              "journeys never reached adopted")
        verdict = obs.slo.verdict()
        check(verdict["slo_ok"], f"SLO verdict under the default "
              f"objectives: {verdict}")
        ex = obs.exemplars.snapshot()["families"].get("serve.flush", [])
        check(ex and all(e["trace"] in sampled for e in ex),
              f"serve.flush exemplars {ex[:3]} do not carry sampled trace "
              "ids")
        snap = obs.snapshot()
        snap_json = json.dumps(snap)
        prom = render_metrics({"serve": m, "qos": run.ctl.export(),
                               "obs": snap})
        check("dt_flush_latency_seconds_count" in prom
              and "dt_devprof_" in prom and "dt_slo_" in prom,
              "render_metrics left out the serve, devprof or SLO families")
    profile = run.profile
    summary = {
        "docs_per_s": [x["docs_per_s"] for x in rounds],
        "flush_ms_p50_p99": [x["flush_ms_p50_p99"] for x in rounds],
        "k1_launches": [x["k1_launches"] for x in rounds],
        "k2_launches": [x["k2_launches"] for x in rounds],
        "devprof_device_fraction": devprof["device_fraction"],
        "devprof_fused_device_fraction":
            devprof["fused"]["device_fraction"],
        "transfer_bytes": {k: v["bytes"] for k, v
                           in devprof["transfer_detail"].items()},
        "slo_ok": verdict["slo_ok"],
        "incidents": snap["incidents"]["total"],
        "host_fallbacks": m["totals"]["host_fallbacks"],
        "round0_busy_share_profiler": profile["device_busy_share"]
        if profile else None,
        "round0_device_fraction_devprof":
            devprof_round0["device_fraction"] if devprof_round0 else None}
    return {"phase": "scheduler_obs", "summary": summary,
            "docs": cfg.n_docs, "shards": scfg.shards,
            "flush_docs": scfg.flush_docs, "sample_rate": OBS_SAMPLE_RATE,
            "obs_seed": bundle["seed"], "launches": run.launches,
            "k2_launches": run.k2_launches,
            "lin_launches": run.lin_launches,
            "fused_device_calls": run.fused_calls,
            "per_doc_replays": run.replays, "resolves": run.batches,
            "rounds": rounds,
            "busy_share_vs_device_fraction": {
                "note": "the profiler's share is the time the card was "
                        "busy with kernels and copies over round 0's wall; "
                        "devprof's fraction is the time the flushes spent "
                        "waiting on the fence (the length fetch, and the "
                        "per-doc syncs' synchronize) over their wall",
                "profiler": profile, "devprof": devprof_round0},
            "devprof": devprof, "trace": obs.tracer.stats(),
            "span_names": span_names, "sampled_traces": len(sampled),
            "journey": obs.journey.snapshot(),
            "journey_lag_summary": obs.journey.lag_summary(),
            "slo": verdict, "incidents": snap["incidents"],
            "exemplars_serve_flush": len(ex),
            "interactive_published_max_s": run.worst,
            "static_deadline_s": run.static_s,
            "snapshot_json_bytes": len(snap_json),
            "prom_lines": prom.count("\n"),
            "setup_s": run.setup_s, "edit_s": run.edit_s,
            "verify_s": run.verify_s, "k1_calls_checked": run.k1_checked,
            "k1_max_abs_err": run.k1_err,
            "k2_calls_checked": run.k2_checked,
            "k2_max_abs_err": run.k2_worst,
            "plain_check_s": run.plain_check_s, "totals": m["totals"],
            "transform": m["transform"], "lock_witness": run.lock_witness}


# ---- phase 19: the replication mesh on the card -----------------------------

REPL_NODES = 3                      # the standard quorum of three
REPL_DOCS = 96
REPL_SHARDS = 2                     # each server's scheduler
REPL_ROUNDS = 4                     # rounds counted from 0:
REPL_HANDOFF_ROUND = 1              # round 2 hands queued documents off,
REPL_HANDOFFS = 8
REPL_PARTITION_ROUND = 2            # round 3 partitions one node
REPL_PROFILE_ROUND = 0              # the first round is traced
REPL_EDITS = (1, 4)                 # per client, document and round
REPL_HISTORY_DOCS = 4               # history strips through the endpoint
REPL_HISTORY_N = 16                 # each strip's snapshots at most
REPL_LEASE_TTL_S = 30.0             # no takeover inside the phase
REPL_CLIENT_THREADS = 8
REPL_CONVERGE_S = 60.0              # each convergence's deadline
REPL_MIN_SESSION_DOCS = 8           # per node and round, read on the card:
                                    # half a server's 16 session slots


def client_edits(rng, client, k: int, cfg: ServeConfig) -> int:
    """`k` random edits on a `SyncClient`'s branch (inserts of 1..ins_max
    chars, deletes of 1..del_max); returns `k`."""
    for _ in range(k):
        cur = len(client.branch)
        if cur and rng.random() < 0.4:
            p = int(rng.integers(0, cur))
            client.delete(p, min(cur, p + int(rng.integers(1, cfg.del_max
                                                            + 1))))
        else:
            client.insert(int(rng.integers(0, cur + 1)), rand_text(
                rng, int(rng.integers(1, cfg.ins_max + 1))))
    return k


def fold_into(mirror, ol) -> None:
    """Merge every op of `ol` into `mirror` (a binary patch from their
    common version), as a sync client's push does."""
    from diamond_types_tpu_torch.causalgraph.summary import (
        intersect_with_summary, summarize_versions)
    from diamond_types_tpu_torch.encoding.decode import decode_into
    from diamond_types_tpu_torch.encoding.encode import (ENCODE_PATCH,
                                                         encode_oplog)
    common, _ = intersect_with_summary(ol.cg, summarize_versions(mirror.cg))
    decode_into(mirror, encode_oplog(ol, ENCODE_PATCH, from_version=common))


def remote_version(ol) -> list:
    return sorted(map(tuple, ol.cg.local_to_remote_frontier(ol.version)))


def run_replicated(rng: np.random.Generator, device,
                   cfg: ServeConfig) -> dict:
    """Three port servers (`tools.server.serve(port=0, data_dir=<its own
    temporary directory>, serve_shards=2, device=<the card>)`), each with
    its fused device scheduler (device plan: K2, then K1) and its
    observability bundle, wired into one mesh by `attach_replication`
    (lease TTL 30 s, a shared seeded `FaultInjector`), so the admit gate,
    the lease-epoch fence and the Hydrator hook are the code under test's.
    The control plane is stepped inline (probe, maintain, anti-entropy).
    96 documents of the scheduler phase's kind (2,048-12,288 chars by one
    agent) are created through `SyncClient` at their rendezvous owner;
    each then has two clients on two different nodes. 4 rounds: every
    document gets 1-4 edits from each client (pull, edit, sync; 8 client
    threads), so about two thirds of the pushes land on a non-owner and
    are proxied. Round 2 stops the pumps, runs its traffic, hands 8
    queued documents to another node with a placement override (the
    handoff's drain fences the queued merges) and restarts the pumps;
    round 3 partitions one node from both others for its traffic, heals,
    and anti-entropy reconciles. After each round: converge with a
    deadline (every node's version of every document equal to the
    mirror's, the union of the clients' oplogs), every node's text equal
    to the mirror's C++ tracker checkout (`Branch.merge_reference`),
    exactly one ACTIVE lease holder per document, that owner's scheduler
    text equal to the mirror, and each owner session caught up with its
    oplog read on the card (its rows) equal to the mirror, at least
    REPL_MIN_SESSION_DOCS a node. Then, with DT_SERVER_DEVICE set,
    POST /doc/{id}/history for 4 documents: K3 launched once per strip,
    each call equal to its plain version, and each strip's texts equal
    to the host's checkout at the same LV. Requires every K1 and K2 call
    equal to its plain version, the launch counts equal to the calls the
    schedulers made, every X8 launch (a merge the engine policy gave the
    zone engine) equal to its plain version, 0 host and plan fallbacks
    (the length fence never failed), epoch-fenced work in round 2,
    proxied writes, and the lock witness acyclic."""
    import os
    import shutil
    import tempfile
    import threading
    import urllib.request

    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.analysis import witness
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import plan_kernels as pk
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.replicate import (FaultInjector,
                                                   attach_replication)
    from diamond_types_tpu_torch.tools.server import SyncClient, serve

    t0 = time.perf_counter()
    witness.witness_enable()
    witness.witness_reset()
    root = tempfile.mkdtemp(prefix="dt_replicated_")
    faults = FaultInjector(seed=int(rng.integers(1 << 31)))
    httpds: list = []
    k1, k2, k3, x8 = (kernels.apply_ops_window, kernels.xform_positions,
                      kernels.materialize_runs, kernels.zone_tape_run)
    lin = kernels.resolve_rows     # its count: the linearize launches
    syncs: List[int] = []
    real_sync = ff.FusedDocSession.sync

    def counted_sync(sess):
        n = real_sync(sess)
        syncs.append(n)
        return n

    def get(addr: str, path: str) -> bytes:
        with urllib.request.urlopen(f"http://{addr}{path}",
                                    timeout=30) as r:
            return r.read()

    try:
        for i in range(REPL_NODES):
            httpds.append(serve(port=0, data_dir=os.path.join(root, f"n{i}"),
                                serve_shards=REPL_SHARDS, device=device))
        addrs = [f"127.0.0.1:{h.server_address[1]}" for h in httpds]
        nodes = [attach_replication(
            h, addrs[i], [a for a in addrs if a != addrs[i]],
            faults=faults, lease_ttl_s=REPL_LEASE_TTL_S,
            backoff_base_s=0.01, backoff_cap_s=0.05,
            journal_prefix=os.path.join(root, f"n{i}", "_replica"))
            for i, h in enumerate(httpds)]
        for h in httpds:
            threading.Thread(target=h.serve_forever, daemon=True).start()
        scheds = [h.store.scheduler for h in httpds]
        for n, s in zip(nodes, scheds):
            check(s.admit == n.owns and s.epoch_of == n.active_epoch,
                  "replicated: attach_replication did not wire the gate")

        def step() -> None:
            for n in nodes:
                n.table.probe_once()
                n.maintain()
            for n in nodes:
                n.antientropy.run_round()

        # the documents, each typed by one agent at its rendezvous owner
        docs = [f"rdoc{d:03d}" for d in range(REPL_DOCS)]
        owner0 = {d: addrs.index(nodes[0].desired_owner(d)) for d in docs}
        mirrors = {d: OpLog() for d in docs}
        clients: Dict[str, list] = {}
        for d in docs:
            c = SyncClient(f"http://{addrs[owner0[d]]}", d, "typist")
            n_chars = int(rng.integers(cfg.base_min, cfg.base_max + 1))
            done = 0
            while done < n_chars:
                k = min(n_chars - done, int(rng.integers(1, 65)))
                c.insert(done, rand_text(rng, k))
                done += k
            c.sync()
            fold_into(mirrors[d], c.oplog)
            a, b = rng.choice(REPL_NODES, 2, replace=False)
            clients[d] = [SyncClient(f"http://{addrs[int(i)]}", d,
                                     f"client{j}")
                          for j, i in enumerate((a, b))]
        for s in scheds:
            s.drain()
        setup_s = time.perf_counter() - t0

        def converge() -> float:
            """Step the control plane until every node holds every
            document at the mirror's version; returns the seconds."""
            want = {d: remote_version(m) for d, m in mirrors.items()}
            t = time.perf_counter()
            while True:
                step()
                behind = 0
                for h in httpds:
                    with h.store.lock:
                        behind += sum(
                            1 for d in docs if h.store.docs.get(d) is None
                            or remote_version(h.store.docs[d]) != want[d])
                if not behind:
                    return time.perf_counter() - t
                check(time.perf_counter() - t < REPL_CONVERGE_S,
                      f"replicated: {behind} (node, document) pairs still "
                      f"behind the mirror after {REPL_CONVERGE_S} s")
                time.sleep(0.02)

        def verify(r: int) -> dict:
            """Every node's text, the single lease holder and its
            scheduler's text against the mirror; each owner's resident
            session that is caught up with its oplog is read on the card
            (`sess.text()`, the device rows) and held against the mirror
            too, and every node must have at least
            REPL_MIN_SESSION_DOCS such documents. Returns the counts."""
            served = [0] * REPL_NODES
            for s in scheds:
                s.drain()
            for d in docs:
                want = host_branch(mirrors[d]).snapshot()
                for a in addrs:
                    check(get(a, f"/doc/{d}").decode("utf8") == want,
                          f"round {r}: {d} at {a} differs from the mirror")
                holders = [i for i, n in enumerate(nodes)
                           if n.leases.active_epoch(d)]
                check(len(holders) == 1, f"round {r}: {d} has ACTIVE "
                      f"leases on nodes {holders}")
                o = holders[0]
                check(scheds[o].text(d) == want,
                      f"round {r}: the owner scheduler's text of {d} "
                      "differs from the mirror")
                shard = scheds[o].router.shard_of(d)
                sess = scheds[o].banks[shard].sessions.get(d)
                with httpds[o].store.lock:
                    synced = (sess is not None and sess.synced_to
                              == len(httpds[o].store.docs[d]))
                if synced:
                    check(sess.text() == want, f"round {r}: the owner's "
                          f"device session of {d} differs from the mirror")
                    served[o] += 1
            check(min(served) >= REPL_MIN_SESSION_DOCS,
                  f"round {r}: owners read {served} documents from their "
                  f"device sessions, under {REPL_MIN_SESSION_DOCS} a node")
            return {"owner_session_served": served}

        def doc_traffic(d: str, seed) -> tuple:
            g = np.random.default_rng(seed)
            n_ops = 0
            for c in clients[d]:
                c.pull()
            for c in clients[d]:
                n_ops += client_edits(g, c, int(g.integers(
                    REPL_EDITS[0], REPL_EDITS[1] + 1)), cfg)
            for c in clients[d]:
                c.sync()
            return n_ops

        t_ph = time.perf_counter()
        ff.FusedDocSession.sync = counted_sync
        k1.launches = k2.launches = x8.launches = lin.launches = 0
        m0 = [s.metrics_json() for s in scheds]
        rounds = []
        handoff_ms: List[float] = []
        heal_s = None
        profile = None
        with Spy(ff, "apply_ops_window", keep=True) as k1_calls, \
                Spy(kernels, "resolve_rows", keep=True) as k2_calls, \
                KeptRuns(kernels, "zone_tape_run") as x8_calls, \
                ThreadPoolExecutor(REPL_CLIENT_THREADS) as pool:
            for r in range(REPL_ROUNDS):
                n_k1, n_k2 = len(k1_calls.args), len(k2_calls.args)
                before = [s.metrics_json()["totals"] for s in scheds]
                proxy0 = [n.metrics_json()["proxy"] for n in nodes]
                seeds = [[int(x) for x in rng.integers(1 << 31, size=2)]
                         for _ in docs]
                handoff = r == REPL_HANDOFF_ROUND
                partitioned = None
                if handoff:
                    for s in scheds:          # merges stay queued
                        s.stop_pump()
                if r == REPL_PARTITION_ROUND:
                    partitioned = int(rng.integers(REPL_NODES))
                    for i in range(REPL_NODES):
                        if i != partitioned:
                            faults.partition(addrs[partitioned], addrs[i])
                profiling = r == REPL_PROFILE_ROUND
                with (torch.profiler.profile(activities=PROFILED)
                      if profiling else contextlib.nullcontext()) as prof:
                    t = time.perf_counter()
                    ops = sum(pool.map(doc_traffic, docs, seeds))
                    traffic_s = time.perf_counter() - t
                    moved = []
                    if handoff:
                        picks = rng.choice(len(docs), REPL_HANDOFFS,
                                           replace=False)
                        for p in picks:
                            d = docs[int(p)]
                            src = next(n for n in nodes
                                       if n.leases.active_epoch(d))
                            dst = nodes[(nodes.index(src) + 1
                                         + int(rng.integers(2)))
                                        % REPL_NODES]
                            ver = src.overrides.set(d, dst.self_id)
                            th = time.perf_counter()
                            check(src.handoff(d, dst.self_id,
                                              override_version=ver),
                                  f"round {r}: the handoff of {d} failed")
                            handoff_ms.append(1e3 * (time.perf_counter()
                                                     - th))
                            moved.append(d)
                        for s in scheds:
                            s.start_pump()
                    for c in (clients[d][j] for d in docs for j in (0, 1)):
                        fold_into(mirrors[c.doc_id], c.oplog)
                    if partitioned is not None:
                        faults.heal()
                        heal_s = converge()
                        conv_s = heal_s
                    else:
                        conv_s = converge()
                    for s in scheds:
                        s.drain()
                    wall = time.perf_counter() - t
                if profiling:
                    profile = device_share(prof, wall, r)
                ver = verify(r)
                after = [s.metrics_json()["totals"] for s in scheds]
                delta = [{k: a[k] - b[k] for k in (
                    "submits", "denied", "fenced", "flushed_docs", "builds",
                    "evictions")} for a, b in zip(after, before)]
                fenced = sum(x["fenced"] for x in delta)
                if handoff:
                    check(fenced > 0, f"round {r}: the handoffs fenced no "
                          "queued merge")
                rounds.append({
                    "round": r,
                    "kind": ("handoff" if handoff else "partition"
                             if partitioned is not None else "free"),
                    "partitioned_node": partitioned,
                    "handed_off": len(moved),
                    "wall_ms": 1e3 * wall, "traffic_ms": 1e3 * traffic_s,
                    "converge_s": conv_s, "ops": ops,
                    "docs_per_s_per_node": [x["flushed_docs"] / wall
                                            for x in delta],
                    "per_node": delta,
                    # each client's sync pushes once; a push on a
                    # non-owner is proxied, or accepted there when the
                    # owner cannot be reached (fallback_local)
                    "pushes": 2 * len(docs),
                    **{k: sum(n.metrics_json()["proxy"][k] - p0[k]
                              for n, p0 in zip(nodes, proxy0))
                       for k in ("proxied", "fallback_local")},
                    "k1_launches": len(k1_calls.args) - n_k1,
                    "k2_launches": len(k2_calls.args) - n_k2, **ver})
        ff.FusedDocSession.sync = real_sync
        launches, k2_launches, x8_launches, lin_launches = (
            k1.launches, k2.launches, x8.launches, lin.launches)
        traffic_phase_s = time.perf_counter() - t_ph

        # the history strip through the endpoint, on the card
        hdocs = [docs[int(p)] for p in rng.choice(len(docs),
                                                  REPL_HISTORY_DOCS,
                                                  replace=False)]
        k3.launches = 0
        strips = {}
        os.environ["DT_SERVER_DEVICE"] = "1"
        try:
            with Spy(kernels, "materialize_runs", keep=True) as k3_calls:
                for d in hdocs:
                    i = next(i for i, n in enumerate(nodes)
                             if n.leases.active_epoch(d))
                    req = urllib.request.Request(
                        f"http://{addrs[i]}/doc/{d}/history",
                        data=json.dumps({"n": REPL_HISTORY_N})
                        .encode("utf8"))
                    t = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=120) as resp:
                        strips[d] = (i, json.loads(resp.read())["snapshots"],
                                     1e3 * (time.perf_counter() - t))
        finally:
            os.environ.pop("DT_SERVER_DEVICE", None)
        k3_launches = k3.launches
        check(k3_launches == len(hdocs) == len(k3_calls.args),
              f"replicated: K3 launched {k3_launches} times for "
              f"{len(hdocs)} history strips ({len(k3_calls.args)} calls)")
        k3_worst = max(k3_err(list(a[:4]), a[4]) for a in k3_calls.args)
        check(k3_worst == 0, f"replicated: K3 differs from its plain "
              f"version in a history strip: max abs err {k3_worst}")
        checked = 0
        for d, (i, snaps, _ms) in strips.items():
            ol = httpds[i].store.get(d)
            with httpds[i].store.lock:
                plan = pk.compile_plan2(ol.cg.graph, [], list(ol.version))
                check(len(plan.entries) > 0 and len(snaps) > 1,
                      f"replicated: {d}'s strip took the host path")
                for s in snaps[:-1]:
                    f = ol.cg.graph.find_dominators([s["lv"]])
                    check(s["text"] == host_branch(ol, f).snapshot(),
                          f"replicated: {d}'s strip at lv {s['lv']} "
                          "differs from the host's checkout")
                    checked += 1
            check(snaps[-1]["text"] == host_branch(mirrors[d]).snapshot(),
                  f"replicated: {d}'s strip does not end at the mirror")

        # every K1 and K2 call against its plain version
        t = time.perf_counter()
        k1_err = k1_calls_err(k1_calls.args, cfg.max_ins)
        check(k1_err == 0, f"K1 differs from its plain version at a "
              f"replicated call: max abs err {k1_err}")
        k2_worst = max((resolve_err(*a) for a in k2_calls.args),
                       default=0)
        check(k2_worst == 0, f"K2 differs from its plain version at a "
              f"replicated resolve: max abs err {k2_worst}")
        # X8 runs where `Branch.merge`'s engine policy picks the zone
        # engine for a merge (a client's pull, a server's checkout): held
        # against its plain version, on the card, from a copy of the carry
        check(x8_launches == len(x8_calls.runs),
              f"replicated: X8 launched {x8_launches} times for "
              f"{len(x8_calls.runs)} zone_tape_run calls")
        x8_worst = max((zone_err(after, zk.run_zone_plain(before, xs,
                                                          plen))
                        for xs, plen, before, after in x8_calls.runs),
                       default=0)
        check(x8_worst == 0, f"X8 differs from its plain version at a "
              f"replicated merge: max abs err {x8_worst}")
        plain_check_s = time.perf_counter() - t
        ms = [s.metrics_json() for s in scheds]
        fused_calls = sum(m["fused"]["device_calls"] - a["fused"]
                          ["device_calls"] for m, a in zip(ms, m0))
        batches = sum(m["transform"]["batches"] - a["transform"]["batches"]
                      for m, a in zip(ms, m0))
        replays = sum(1 for n in syncs if n)
        check(launches == fused_calls + replays and launches > 0,
              f"replicated: K1 launched {launches} times for {fused_calls} "
              f"fused calls and {replays} per-doc replays")
        check(k2_launches == batches and k2_launches > 0,
              f"replicated: K2 launched {k2_launches} times for {batches} "
              "resolves")
        check(lin_launches == batches,
              f"replicated: the linearize kernel launched {lin_launches} "
              f"times for {batches} resolves")
        host_fallbacks = sum(m["totals"]["host_fallbacks"] for m in ms)
        check(host_fallbacks == 0, f"replicated: {host_fallbacks} host "
              "fallbacks (length-fence failures)")
        plan_fallbacks = sum(m["transform"]["fallbacks"] for m in ms)
        check(plan_fallbacks == 0, f"replicated: {plan_fallbacks} plan "
              "fallbacks")
        repl = [n.metrics_json() for n in nodes]
        proxied = sum(m["proxy"]["proxied"] for m in repl)
        check(proxied > 0, "replicated: no write was proxied")
        prom = get(addrs[0], "/metrics?format=prom").decode("utf8")
        wit = witness.witness_snapshot()
        check(wit["acyclic"] and wit["violation_count"] == 0,
              f"lock witness: cycles {wit['cycles']}, "
              f"violations {wit['violations'][:4]}")
        per_node = []
        for i, (m, rm) in enumerate(zip(ms, repl)):
            lat = m["latencies"]
            per_node.append({
                "node": i, "owned_at_start": sum(1 for d in docs
                                                  if owner0[d] == i),
                "docs_per_s": (m["totals"]["flushed_docs"]
                               - m0[i]["totals"]["flushed_docs"])
                / traffic_phase_s,
                "flush_ms_p50_p99": [1e3 * lat["flush"]["p50"],
                                     1e3 * lat["flush"]["p99"]],
                "queue_wait_ms_p99": 1e3 * lat["queue_wait"]["p99"],
                "totals": {k: m["totals"][k] for k in (
                    "submits", "denied", "fenced", "flushes",
                    "flushed_docs", "builds", "evictions",
                    "host_fallbacks")},
                "proxy": rm["proxy"], "handoffs": rm["handoffs"],
                "antientropy": {k: rm["antientropy"][k] for k in (
                    "rounds", "docs_pulled", "docs_pushed")},
                "merge_gate": rm["merge_gate"], "wire": rm["wire"]})
        return {
            "phase": "replicated", "nodes": REPL_NODES,
            "shards_per_node": REPL_SHARDS, "docs": len(docs),
            "rounds": rounds, "per_node": per_node,
            "setup_s": setup_s, "traffic_phase_s": traffic_phase_s,
            "converge_s_per_round": [x["converge_s"] for x in rounds],
            "converge_s_after_heal": heal_s,
            "handoff_ms": handoff_ms,
            "proxied": proxied,
            "fenced": sum(m["totals"]["fenced"] for m in ms),
            "denied": sum(m["totals"]["denied"] for m in ms),
            "fence_failures": host_fallbacks,
            "launches": launches, "k2_launches": k2_launches,
            "lin_launches": lin_launches,
            "k3_launches": k3_launches, "x8_launches": x8_launches,
            "x8_max_abs_err": x8_worst,
            "fused_calls": fused_calls, "per_doc_replays": replays,
            "resolves": batches,
            "k1_checked": len(k1_calls.args),
            "k2_checked": len(k2_calls.args),
            "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_worst,
            "k3_max_abs_err": k3_worst, "plain_check_s": plain_check_s,
            "history": {"docs": len(strips),
                        "snapshots_checked": checked,
                        "call_ms": [ms_ for _i, _s, ms_ in
                                    strips.values()]},
            "dt_wire_families": sorted({ln.split()[2] for ln in
                                        prom.splitlines()
                                        if ln.startswith("# TYPE dt_wire")}),
            "device_share_round0": profile,
            "lock_witness": {k: wit[k] for k in ("acyclic", "edge_count",
                                                 "violation_count",
                                                 "acquires", "edges")}}
    finally:
        ff.FusedDocSession.sync = real_sync
        faults.heal()
        for h in httpds:
            with contextlib.suppress(Exception):
                h.shutdown()
            with contextlib.suppress(Exception):
                h.server_close()
        witness.witness_disable()
        shutil.rmtree(root, ignore_errors=True)


# ---- phases 20-22: the layer above the server --------------------------------

SCENARIO = "flash-crowd"            # workload/spec.py, registered unchanged
SCENARIO_PROFILE_TICK = 24          # the traced tick: 12.0-12.5 s, in the
                                    # third burst (12-13.5 s)
FOLLOWER_SHARDS = 2                 # each server's scheduler, in both the
SOAK_SHARDS = 2                     # read bench and the soak
SOAK_ROUNDS = 8                     # the soak's documented drill settings


class Served:
    """The kernels under the servers an entry point boots: every server
    it makes through `tools.server.serve` is kept (its scheduler with its
    metrics), per-doc replays are counted on `FusedDocSession.sync`, and
    K1, K2, X8 and K3 run under spies that keep each call's inputs, their
    launch counts set to 0 on entry and read on exit. `verify` then holds
    every call against its plain version and the launch counts against
    the calls the schedulers made."""

    def __init__(self, phase: str, need_k2: bool = True,
                 need_k1: bool = True, need_x8: bool = False) -> None:
        self.phase, self.need_k2 = phase, need_k2
        self.need_k1, self.need_x8 = need_k1, need_x8
        self.httpds: list = []
        self.syncs: List[int] = []

    def __enter__(self) -> "Served":
        from diamond_types_tpu_torch.gpu import flush_fuse as ff
        from diamond_types_tpu_torch.gpu import kernels
        from diamond_types_tpu_torch.tools import server
        self.ff, self.kernels, self.server = ff, kernels, server
        self.real_serve, self.real_sync = server.serve, ff.FusedDocSession.sync

        def serve(*args, **kw):
            httpd = self.real_serve(*args, **kw)
            self.httpds.append(httpd)
            return httpd

        def counted_sync(sess):
            n = self.real_sync(sess)
            self.syncs.append(n)
            return n

        server.serve = serve
        ff.FusedDocSession.sync = counted_sync
        self.stack = contextlib.ExitStack()
        self.k1 = self.stack.enter_context(
            Spy(ff, "apply_ops_window", keep=True))
        self.k2 = self.stack.enter_context(
            Spy(kernels, "resolve_rows", keep=True))
        self.x8 = self.stack.enter_context(KeptRuns(kernels, "zone_tape_run"))
        self.k3 = self.stack.enter_context(
            Spy(kernels, "materialize_runs", keep=True))
        for k in (kernels.apply_ops_window, kernels.xform_positions,
                  kernels.zone_tape_run, kernels.materialize_runs,
                  kernels.resolve_rows):
            k.launches = 0
        return self

    def __exit__(self, *exc) -> None:
        k = self.kernels
        self.launches = {"k1": k.apply_ops_window.launches,
                         "k2": k.xform_positions.launches,
                         "x8": k.zone_tape_run.launches,
                         "k3": k.materialize_runs.launches,
                         "lin": k.resolve_rows.launches}
        self.stack.close()
        self.server.serve = self.real_serve
        self.ff.FusedDocSession.sync = self.real_sync

    def scheds(self) -> list:
        return [h.store.scheduler for h in self.httpds
                if h.store.scheduler is not None]

    def metrics(self) -> list:
        """The metrics of every scheduler the run booted."""
        return [s.metrics_json() for s in self.scheds()]

    def faults(self) -> list:
        return [repr(s.fault) for s in self.scheds() if s.fault is not None]

    def verify(self) -> dict:
        """Every K1, K2, X8 and K3 call of the run against its plain
        version; K1 launches == fused calls + per-doc replays, K2 ==
        resolves, X8 and K3 == their calls, over every scheduler the run
        booted (crashed and rebooted ones too); 0 host fallbacks (the
        length fence never failed), 0 plan fallbacks, no scheduler fault."""
        from diamond_types_tpu_torch.gpu import zone_kernel as zk
        phase, n = self.phase, self.launches
        ms = self.metrics()
        faults = self.faults()
        check(not faults, f"{phase}: scheduler faults {faults}")
        fused = sum(m["fused"]["device_calls"] for m in ms)
        resolves = sum(m["transform"]["batches"] for m in ms)
        planned = {k: sum(m["transform"][k] for m in ms)
                   for k in ("device_docs", "host_docs")}
        replays = sum(1 for k in self.syncs if k)
        check(n["k1"] == fused + replays == len(self.k1.args)
              and (n["k1"] > 0 or not self.need_k1),
              f"{phase}: K1 launched {n['k1']} times for {fused} fused "
              f"calls and {replays} per-doc replays "
              f"({len(self.k1.args)} calls)")
        check(n["k2"] == resolves == len(self.k2.args)
              and (n["k2"] > 0 or not self.need_k2),
              f"{phase}: K2 launched {n['k2']} times for {resolves} "
              f"resolves ({len(self.k2.args)} calls)")
        check(n["lin"] == resolves,
              f"{phase}: the linearize kernel launched {n['lin']} times "
              f"for {resolves} resolves")
        check(n["x8"] == len(self.x8.runs)
              and (n["x8"] > 0 or not self.need_x8),
              f"{phase}: X8 launched {n['x8']} times for "
              f"{len(self.x8.runs)} zone_tape_run calls")
        check(n["k3"] == len(self.k3.args),
              f"{phase}: K3 launched {n['k3']} times for "
              f"{len(self.k3.args)} calls")
        host = sum(m["totals"]["host_fallbacks"] for m in ms)
        plan = sum(m["transform"]["fallbacks"] for m in ms)
        check(host == 0 and plan == 0, f"{phase}: {host} host fallbacks "
              f"(length-fence failures), {plan} plan fallbacks")
        t = time.perf_counter()
        by_mi: Dict[int, list] = {}
        for a in self.k1.args:          # (docs, lens, pos, dlen, ilen,
            by_mi.setdefault(int(a[6]), []).append(a)   # chars, max_ins)
        k1_err = max((k1_calls_err(calls, mi)
                      for mi, calls in by_mi.items()), default=0)
        k2_worst = max((resolve_err(*a) for a in self.k2.args),
                       default=0)
        x8_worst = max((zone_err(after, zk.run_zone_plain(before, xs,
                                                          plen))
                        for xs, plen, before, after in self.x8.runs),
                       default=0)
        k3_worst = max((k3_err(list(a[:4]), a[4]) for a in self.k3.args),
                       default=0)
        for name, err in (("K1", k1_err), ("K2", k2_worst),
                          ("X8", x8_worst), ("K3", k3_worst)):
            check(err == 0, f"{name} differs from its plain version at a "
                  f"{phase} call: max abs err {err}")
        return {"launches": n["k1"], "k2_launches": n["k2"],
                "lin_launches": n["lin"],
                "x8_launches": n["x8"], "k3_launches": n["k3"],
                "fused_calls": fused, "per_doc_replays": replays,
                "resolves": resolves, "planned_docs": planned,
                "host_fallbacks": host,
                "plan_fallbacks": plan, "schedulers": len(ms),
                "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_worst,
                "x8_max_abs_err": x8_worst, "k3_max_abs_err": k3_worst,
                "plain_check_s": time.perf_counter() - t}


def node_flush(served: Served, wall_s: float) -> list:
    """Per server the run booted: flush p50/p99 (ms) and docs/s over the
    run's wall time."""
    out = []
    for h in served.httpds:
        if h.store.scheduler is None:
            continue
        m = h.store.scheduler.metrics_json()
        lat = m["latencies"]["flush"]
        out.append({"flush_ms_p50_p99": [1e3 * lat["p50"],
                                         1e3 * lat["p99"]],
                    "flushes": m["totals"]["flushes"],
                    "flushed_docs": m["totals"]["flushed_docs"],
                    "docs_per_s": m["totals"]["flushed_docs"] / wall_s})
    return out


def run_scenario_phase(device) -> dict:
    """`workload.run_scenario(get_scenario("flash-crowd"), qos=True,
    device=<the card>)`: the scenario as `workload/spec.py` registers it
    (3 servers of 2 serve shards with follower reads, 2 tenants x 8
    documents, 20 virtual seconds at ticks of 0.5 s, bursty arrivals at
    12/s with x8 bursts of 1.5 s every 6 s on a rotating hot set of 2
    documents at weight 0.85, 20 reads per write, session churn every
    4 s), the QoS controller on every server, over real HTTP. The runner
    steps the mesh's control plane each tick and reconciles at the end.
    Every `ReadPath.read` is recorded (its budget, source and staleness),
    and one tick (SCENARIO_PROFILE_TICK) is traced by `torch.profiler` for
    the card's busy share. Requires the scorecard's byte-identical
    convergence and ok, no read served locally past a `max_staleness`
    budget it carried (the runner's GETs carry none, so every local read
    is within its budget by the contract; the follower_reads phase sends
    budgets), and `Served.verify`: every K1, K2 and X8 launch equal to its
    plain version, the launch counts equal to the calls, 0 host and plan
    fallbacks, no scheduler fault."""
    from diamond_types_tpu_torch.read import path as rpath
    from diamond_types_tpu_torch.workload import get_scenario, run_scenario
    from diamond_types_tpu_torch.workload import runner

    reads: List[tuple] = []
    real_read = rpath.ReadPath.read

    def read(self, doc_id, kind="text", max_staleness=None,
             min_version=None, forced_local=False, trace=None):
        res = real_read(self, doc_id, kind, max_staleness, min_version,
                        forced_local, trace)
        st = res.headers.get(rpath.STALENESS_HEADER)
        reads.append((max_staleness, res.status, res.source,
                      None if st is None else float(st)))
        return res

    real_publish = runner.publish_scenario
    prof_box: dict = {}

    def publish(state):
        tick = state.get("tick")
        if state.get("phase") == "traffic":
            if tick == SCENARIO_PROFILE_TICK:
                prof_box["prof"] = torch.profiler.profile(
                    activities=PROFILED)
                prof_box["prof"].__enter__()
                prof_box["t"] = time.perf_counter()
            elif tick == SCENARIO_PROFILE_TICK + 1 and "prof" in prof_box:
                torch.cuda.synchronize()
                prof_box["wall"] = time.perf_counter() - prof_box["t"]
                prof_box["prof"].__exit__(None, None, None)
        return real_publish(state)

    sc = get_scenario(SCENARIO)
    rpath.ReadPath.read = read
    runner.publish_scenario = publish
    try:
        with Served("scenario") as served:
            t = time.perf_counter()
            card = run_scenario(sc, qos=True, device=device)
            wall = time.perf_counter() - t
    finally:
        rpath.ReadPath.read = real_read
        runner.publish_scenario = real_publish
        if "prof" in prof_box and "wall" not in prof_box:
            prof_box["prof"].__exit__(None, None, None)
    kern = served.verify()
    check(card["convergence"]["converged"], "scenario: the servers did not "
          "converge byte-identically after the reconcile")
    check(card["ok"], f"scenario: the scorecard is not ok: slo "
          f"{card['slo']}, errors {card['totals']['errors']}")
    over = [r for r in reads if r[0] is not None and r[2] == "local"
            and (r[3] is None or r[3] > r[0])]
    check(not over, f"scenario: {len(over)} reads served past their "
          f"max_staleness budget, e.g. {over[:3]}")
    check(len(served.httpds) == sc.servers,
          f"scenario: {len(served.httpds)} servers booted")
    rm = [h.store.reads.metrics.snapshot()["counters"]
          for h in served.httpds]
    counters = {k: sum(c[k] for c in rm) for k in (
        "reads", "local", "catchup_waits", "proxied_staleness",
        "proxied_min_version", "proxied_steered", "proxied_forced",
        "refused", "cache_hits", "cache_misses", "cache_coalesced",
        "flush_invalidations", "ae_invalidations", "adverts",
        "reconciles")}
    stale = [r[3] for r in reads if r[2] == "local" and r[3] is not None]
    tot = card["totals"]
    tape = runner._build_events(sc)
    rl = card["latencies"]["read"]
    return {
        "phase": "scenario", "scenario": sc.to_dict(), "qos": True,
        "wall_s": wall,
        "scorecard": {k: card[k] for k in (
            "wall_s", "virtual_s", "throughput", "latency_p99_s",
            "bytes_per_op", "slo", "burn_minutes", "burn_minutes_total",
            "ok", "qos", "serve", "hydration") if k in card},
        "convergence": {k: card["convergence"][k]
                        for k in ("converged", "reconcile_rounds")},
        "writes": {"attempted": sum(1 for e in tape if e[1] == "write"),
                   "succeeded": tot["writes"], "refused": tot["sheds"],
                   "errors": tot["errors"]},
        "reads": {"attempted": sum(1 for e in tape if e[1] == "read"),
                  "succeeded": tot["reads"],
                  "refused": tot["read_refusals"],
                  "with_budget": sum(1 for r in reads if r[0] is not None),
                  "by_source": dict(collections.Counter(
                      r[2] for r in reads)),
                  "read_path": counters},
        "staleness_s_p50_p99": [float(np.percentile(stale, 50)),
                                float(np.percentile(stale, 99))]
        if stale else None,
        "read_latency_ms_p50_p99": [1e3 * rl["p50"], 1e3 * rl["p99"]],
        "per_node": node_flush(served, wall),
        "incidents": {"count": card["incidents"]["count"],
                      "by_kind": card["incidents"]["by_kind"],
                      "series": dict(collections.Counter(
                          r["series"] for r in
                          card["incidents"]["timeline"]))},
        "device_share_tick": device_share(
            prof_box["prof"], prof_box["wall"], SCENARIO_PROFILE_TICK)
        if "wall" in prof_box else None,
        **kern}


def run_follower_reads(device) -> dict:
    """`read.bench.run_read_bench` at its defaults (2 servers with
    follower reads, 3 documents of 16 KiB, one writer a document, 6 reader
    threads x 120 Zipf-1.2 reads a phase, a min-version token every 4th
    read; the control phase reads with max_staleness 0, so every
    follower read proxies to the owner, the follower phase with 2 s) with
    `serve_shards=2, device=<the card>`. Every response's staleness and
    read-your-writes token is checked client-side by the bench. Requires
    the bench's own pass (settled, 0 violations, 0 errors) and
    `Served.verify`. Each document has one writer appending, so its tails
    are linear and planned on the host: K2 may not launch here."""
    from diamond_types_tpu_torch.read.bench import run_read_bench
    with Served("follower_reads", need_k2=False) as served:
        t = time.perf_counter()
        rep = run_read_bench(serve_shards=FOLLOWER_SHARDS, device=device)
        wall = time.perf_counter() - t
    kern = served.verify()
    check(rep["ok"], f"follower_reads: the read bench failed: settled "
          f"{rep['settled']}, violations {rep['violations']}, errors "
          f"{rep['errors']}")
    phases = {p: {k: rep[p][k] for k in (
        "max_staleness_s", "reads", "reads_per_s", "local", "proxied",
        "refused", "staleness_violations", "ryw_violations",
        "max_observed_staleness_s", "latency_s")}
        for p in ("control", "follower")}
    return {"phase": "follower_reads", "config": rep["config"],
            "wall_s": wall, "ok": rep["ok"], "settled": rep["settled"],
            "speedup": rep["speedup"], "violations": rep["violations"],
            "errors": rep["errors"], "writes": rep["writes"],
            "proxied_latency_s": phases["control"]["latency_s"],
            "local_latency_s": phases["follower"]["latency_s"],
            "phases": phases, "per_node": node_flush(served, wall),
            **kern}


def run_replicate_soak_phase(device) -> dict:
    """`replicate.soak.run_replicate_soak(servers=3, rounds=8, crash=True,
    asym=True, churn=True, serve_shards=2, device=<the card>)`: the
    drill's documented settings (seed 7, 4 documents, drops 15%, one-way
    partitions, two crash-restarts on their journals, a join then a
    leave), its servers' data under a temporary directory. Requires the
    soak's own verdict (byte-identical convergence, zero split-brain, the
    lock witness acyclic) and `Served.verify` over every server
    incarnation's scheduler."""
    import shutil
    import tempfile

    from diamond_types_tpu_torch.replicate.soak import run_replicate_soak
    root = tempfile.mkdtemp(prefix="dt_soak_")
    try:
        with Served("replicate_soak") as served:
            t = time.perf_counter()
            rep = run_replicate_soak(servers=3, rounds=SOAK_ROUNDS,
                                     crash=True, asym=True, churn=True,
                                     serve_shards=SOAK_SHARDS,
                                     data_dir=root, device=device)
            wall = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kern = served.verify()
    wit = rep.get("lock_witness", {})
    check(rep["converged"] and rep["zero_split_brain"]
          and wit.get("acyclic"),
          f"replicate_soak: converged {rep['converged']}, split brain "
          f"{rep['split_brain']}, witness cycles {wit.get('cycles')}")
    return {"phase": "replicate_soak", "config": rep["config"],
            "wall_s": wall,
            **{k: rep[k] for k in ("converged", "zero_split_brain",
                                   "crashes", "edits_applied", "fencing",
                                   "quorum", "multi_merger_docs",
                                   "converged_after_reconcile_rounds")},
            "lock_witness": {k: wit.get(k) for k in (
                "acyclic", "edge_count", "violation_count", "acquires")},
            "server_incarnations": len(served.httpds),
            "per_node": node_flush(served, wall), **kern}


class Benched(Served):
    """`Served` for an entry point that builds its scheduler inside itself
    (the CLI's serve bench): the schedulers' metrics are the `metrics`
    blocks of the JSON reports the run wrote (`add_report`), and a
    scheduler fault would have raised out of the run."""

    def __init__(self, phase: str, **need) -> None:
        super().__init__(phase, **need)
        self.reports: List[dict] = []

    def add_report(self, report: dict) -> None:
        self.reports.append(report)

    def metrics(self) -> list:
        return [r["metrics"] for r in self.reports]

    def faults(self) -> list:
        return []


# the CLI phase's serve benches: the fused flush (K2 plans, K1 replays),
# then the zone-session bank (X8 per sync), at the CLI's own widths
CLI_BENCHES = (("fused", ["--docs", "64"], dict(need_x8=False)),
               ("zone_sessions", ["--docs", "16", "--no-fused"],
                dict(need_k1=False, need_k2=False, need_x8=True)))


def run_cli_phase(device: Optional[str] = None) -> dict:
    """`tools.cli.main` in-process, as a user types it: `serve-bench
    --shards 4 --docs 64 --mode concurrent --device-plan --json
    --metrics-out <tmp>` (the schedulers on the CLI's default device, the
    card), then the same at `--docs 16 --no-fused`, the zone-session bank.
    Each must exit 0 (parity and SLO), its printed report must equal the
    one it wrote, and `Benched.verify` must hold: K1 launches == fused
    calls + per-doc replays, K2 == resolves, X8 == its calls, every K1, K2
    and X8 call equal to its plain version, 0 host and plan fallbacks.
    `device` is for a check of this phase on the CPU (`--device cpu`)."""
    import io
    import tempfile

    from diamond_types_tpu_torch.tools import cli
    runs, totals = [], collections.Counter()
    errs: Dict[str, int] = collections.defaultdict(int)
    for name, flags, need in CLI_BENCHES:
        with tempfile.TemporaryDirectory(prefix="dt_cli_") as tmp:
            out = f"{tmp}/report.json"
            argv = ["serve-bench", "--shards", "4", "--mode", "concurrent",
                    "--device-plan", "--json", "--metrics-out", out, *flags]
            if device is not None:
                argv += ["--device", device]
            printed = io.StringIO()
            with Benched(f"cli {name}", **need) as bench:
                t = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    rc = cli.main(argv)
                wall = time.perf_counter() - t
                with open(out) as f:
                    report = json.load(f)
                bench.add_report(report)
        check(rc == 0, f"cli {name}: serve-bench exited {rc}: parity "
              f"{report['parity_ok']} ({report['parity_mismatches']}), "
              f"slo {report['slo']}")
        check(json.loads(printed.getvalue().strip().splitlines()[-1])
              == report, f"cli {name}: the printed report is not the one "
              f"written to --metrics-out")
        kern = bench.verify()
        lat = report["metrics"]["latencies"]["flush"]
        runs.append({"bench": name,
                     "argv": [a if a != out else "<tmp>" for a in argv],
                     "rc": rc, "wall_s": wall,
                     "parity_ok": report["parity_ok"],
                     "slo_ok": report["slo_ok"],
                     "total_ops": report["total_ops"],
                     "ops_per_sec": report["ops_per_sec"],
                     "flush_ms": {q: 1e3 * lat[q] for q in ("p50", "p99")},
                     "config": report["config"], **kern})
        for key in ("launches", "k2_launches", "lin_launches", "x8_launches",
                    "k3_launches"):
            totals[key] += kern[key]
        for key in ("k1_max_abs_err", "k2_max_abs_err", "x8_max_abs_err",
                    "k3_max_abs_err"):
            errs[key] = max(errs[key], kern[key])
    return {"phase": "cli", "runs": runs, **dict(totals), **dict(errs)}


# the device soak: its documented command over the history phase's oplog,
# then over a short history whose small zone the soak's growth outgrows
SOAK_HOURS = 0.006                  # ~22 s of merge-per-edit traffic
SOAK_GROWTH_LVS = 300               # the growth run's history, in ops
SOAK_GROWTH_HOURS = 0.0015          # ~5 s


class SoakRuns(Spy):
    """A Spy on `kernels.zone_tape_run` for the device soak. Each launch is
    a resync (the session's build, or a rebuild: `DeviceZoneSession.resync`
    is on the stack, flagged by `resync_hook`) or a continuation (a sync's
    micro-tape). Keeps the tape and clones of the carry before and after
    (X8 updates it in place) of every continuation launch and of the first
    `keep_resyncs` resync launches, for the plain version after the run."""

    def __init__(self, owner, name: str, keep_resyncs: int) -> None:
        super().__init__(owner, name)
        self.keep_resyncs = keep_resyncs
        self.in_resync = 0
        self.counts = collections.Counter()
        self.runs: List[tuple] = []

    @contextlib.contextmanager
    def resync_hook(self, cls):
        real = cls.resync
        spy = self

        def resync(sess):
            spy.in_resync += 1
            try:
                return real(sess)
            finally:
                spy.in_resync -= 1

        cls.resync = resync
        try:
            yield
        finally:
            cls.resync = real

    def __call__(self, carry, xs, plen, cluster=None):
        from diamond_types_tpu_torch.gpu.zone_kernel import ZoneCarry
        kind = "resync" if self.in_resync else "continuation"
        keep = kind == "continuation" or \
            self.counts["resync"] < self.keep_resyncs
        self.counts[kind] += 1
        before = ZoneCarry(*(t.clone() for t in carry)) if keep else None
        out = super().__call__(carry, xs, plen, cluster=cluster)
        if keep:
            self.runs.append((kind, xs, plen, before,
                              ZoneCarry(*(t.clone() for t in out))))
        return out

    def check(self, what: str) -> dict:
        """Every kept launch against the plain version, on the launch's
        device; frees each as it goes."""
        from diamond_types_tpu_torch.gpu import zone_kernel as zk
        t = time.perf_counter()
        worst = collections.Counter()
        held = collections.Counter()
        while self.runs:
            kind, xs, plen, before, after = self.runs.pop(0)
            err = zone_err(after, zk.run_zone_plain(before, xs, plen))
            worst[kind] = max(worst[kind], err)
            held[kind] += 1
        for kind, err in worst.items():
            check(err == 0, f"{what}: an X8 {kind} launch differs from its "
                  f"plain version: max abs err {err}")
        return {"x8_launches_by_kind": dict(self.counts),
                "x8_held_by_kind": dict(held),
                "x8_max_abs_err": max(worst.values(), default=0),
                "plain_check_s": time.perf_counter() - t}


def drive_device_soak(ol, hours: float, keep_resyncs: int, what: str,
                      device: str = "cuda") -> dict:
    """`tools.device_soak.main(["--corpus", <ol as a .dt file>, "--hours",
    hours, "--log", <tmp>, "--device", device])` with X8 under a
    `SoakRuns` spy (its launch count set to 0 just before and read just
    after). Requires exit 0, the log's soak_start, session_built and
    soak_end, no PARITY_MISMATCH and no device_crash, syncs > 0, X8
    launches == its calls and every kept launch equal to its plain
    version. Returns the soak's end event, the launches and the checks."""
    import tempfile

    from diamond_types_tpu_torch.encoding.encode import (ENCODE_FULL,
                                                         encode_oplog)
    from diamond_types_tpu_torch.gpu import kernels, zone_session
    from diamond_types_tpu_torch.tools import device_soak
    with tempfile.TemporaryDirectory(prefix="dt_dsoak_") as tmp:
        path, log = f"{tmp}/history.dt", f"{tmp}/soak.jsonl"
        with open(path, "wb") as f:
            f.write(encode_oplog(ol, ENCODE_FULL))
        with SoakRuns(kernels, "zone_tape_run", keep_resyncs) as spy, \
                spy.resync_hook(zone_session.DeviceZoneSession):
            kernels.zone_tape_run.launches = 0
            t = time.perf_counter()
            rc = device_soak.main(["--corpus", path, "--hours", str(hours),
                                   "--log", log, "--device", device])
            wall = time.perf_counter() - t
            launches = kernels.zone_tape_run.launches
        with open(log) as f:
            events = [json.loads(line) for line in f]
    kinds = [e["event"] for e in events]
    end = events[-1] if kinds and kinds[-1] == "soak_end" else {}
    check(rc == 0 and {"soak_start", "session_built", "soak_end"}
          <= set(kinds) and "PARITY_MISMATCH" not in kinds
          and "device_crash" not in kinds,
          f"{what}: device soak exited {rc} with events {kinds[-4:]}")
    check(end.get("syncs", 0) > 0, f"{what}: no sync in {hours} h")
    n_calls = sum(spy.counts.values())
    check(launches == n_calls and launches > 0,
          f"{what}: X8 launched {launches} times for {n_calls} calls")
    built = next(e for e in events if e["event"] == "session_built")
    out = {"wall_s": wall, "events": kinds, "build_s": built["build_s"],
           "n_ops_start": events[0]["n_ops_start"],
           **{k: end[k] for k in ("syncs", "edits", "resyncs", "crashes",
                                  "n_ops_end")},
           "syncs_per_s": end["syncs"] / wall, "x8_launches": launches}
    out.update(spy.check(what))
    return out


def run_device_soak_phase(history_ol, device: str = "cuda") -> dict:
    """`tools.device_soak` as documented, on the card: the history phase's
    ~40k-op oplog written to a `.dt` file and soaked for SOAK_HOURS (~22
    s) of 2-agent merge-per-edit traffic, the session's text checked
    against the C++ tracker after every sync by the soak itself. Every
    continuation X8 launch is held against its plain version here; of the
    resync launches only the first (the session's build over the whole
    zone: the plain version takes seconds there); the soak's own tracker
    check at every sync holds the rest. Then the same command over a
    SOAK_GROWTH_LVS-op history of the same generator for SOAK_GROWTH_HOURS:
    its small zone's capacity is outgrown within seconds, so the soak's
    growth forces resyncs, each held against its plain version. Requires
    both soaks' checks (`drive_device_soak`) and resyncs >= 1 in the
    growth run."""
    main_run = drive_device_soak(history_ol, SOAK_HOURS, 1, "device_soak",
                                 device)
    hcfg = HistoryConfig()
    small = build_history(np.random.default_rng([0, 20]), SOAK_GROWTH_LVS,
                          hcfg, hcfg.small_turns)
    growth = drive_device_soak(small, SOAK_GROWTH_HOURS, 1 << 30,
                               "device_soak growth", device)
    check(growth["resyncs"] >= 1, f"device_soak growth: the soak's growth "
          f"forced no resync in {growth['syncs']} syncs")
    return {"phase": "device_soak",
            "held": "history: every continuation X8 launch and the first "
                    "resync launch (the build) against the plain version; "
                    "the soak's tracker check at every sync holds the "
                    "rest. growth: every X8 launch",
            "history": main_run, "growth": growth,
            "x8_launches": main_run["x8_launches"]
            + growth["x8_launches"],
            "x8_max_abs_err": max(main_run["x8_max_abs_err"],
                                  growth["x8_max_abs_err"])}


def replay_batch_inputs(rng: np.random.Generator, b: int, n: int, cap: int,
                        mi: int, device) -> List[torch.Tensor]:
    """In-contract whole-trace replays for `replay_batch_kernel`: per row
    n ops from an empty document, each an insert of 1..mi chars at a
    position within the row's text or a delete of 1..mi chars inside it,
    the text kept within cap."""
    pos = np.zeros((b, n), np.int32)
    dlen = np.zeros((b, n), np.int32)
    ilen = np.zeros((b, n), np.int32)
    chars = rng.integers(1, 0x10FFFF, (b, n, mi)).astype(np.int32)
    length = np.zeros(b, np.int64)
    for k in range(n):
        dele = (rng.random(b) < 0.3) & (length > 0)
        d = np.minimum(rng.integers(1, mi + 1, b), length)
        i = np.where(length + mi <= cap, rng.integers(1, mi + 1, b), 0)
        p = (rng.random(b) * (length - np.where(dele, d, 0) + 1)).astype(
            np.int64)
        dlen[:, k] = np.where(dele, d, 0)
        ilen[:, k] = np.where(dele, 0, i)
        pos[:, k] = p
        length += ilen[:, k] - dlen[:, k]
    return [torch.from_numpy(a).to(device) for a in (pos, dlen, ilen, chars)]


def run_replay_batch(rng: np.random.Generator, device, b: int = 128,
                     n: int = 64, cap: int = 4096,
                     mi: int = MAX_INS) -> dict:
    """`replay_batch_kernel` (the counterpart of `replay_batch_pallas`: one
    K1 launch over a whole [b, n] op sequence from empty rows) against its
    plain version on the card at one shape; its call_ms, device_ms, the
    plain version's ms and its HBM bound (the op tape read once, the rows
    and lengths written once). It is on no serve path: its launch count is
    this check's."""
    from diamond_types_tpu_torch.gpu import kernels
    args = replay_batch_inputs(rng, b, n, cap, mi, device)
    fn = kernels.replay_batch_kernel
    kernels.apply_ops_window.launches = 0
    got_d, got_l = fn(*args, cap=cap)
    torch.cuda.synchronize()
    launches = kernels.apply_ops_window.launches     # K1's, at its launch
    want_d, want_l = kernels.replay_batch_plain(*args, cap=cap)
    err = max(exact_err(got_d, want_d), exact_err(got_l, want_l))
    check(err == 0 and launches == 1,
          f"replay_batch_kernel differs from its plain version (max abs err "
          f"{err}) or launched {launches} times")
    check(bool((got_l >= 0).all()), "an in-contract replay was poisoned")
    out = {"phase": "replay_batch", "shape": {"b": b, "n": n, "cap": cap,
                                              "max_ins": mi},
           "launches": launches, "max_abs_err": err,
           "bound_ms": 1e3 * 4 * (b * n * (3 + mi) + b * cap + b)
           / HBM_BYTES_PER_S,
           "plain_ms": time_ms(lambda: kernels.replay_batch_plain(
               *args, cap=cap), 3)}
    out.update(timings(lambda: fn(*args, cap=cap), 20, 50))
    out["ms"] = out["call_ms"]
    return out


def run_storage_soak_phase() -> dict:
    """`run_storage_soak(churn=True, crash=True, slow=True)` at its
    defaults (120 documents, 12 warm, 8 rounds, the host engine, seed 0):
    crash-restart, compaction killed at each fsync point, torn tails,
    corrupt homes and slow loads. Fails unless its verdict is ok."""
    from diamond_types_tpu_torch.storage.soak import run_storage_soak
    rep = run_storage_soak(churn=True, crash=True, slow=True)
    check(rep["ok"], f"storage soak failed: "
          f"{rep.get('error', '')} byte mismatches "
          f"{rep['byte_mismatches']}, quarantine match "
          f"{rep['quarantine_match']}, leaks {rep['quarantine_leaks']}, "
          f"p99 ok {rep['p99_ok']}, witness {rep['lock_witness']}")
    return {"phase": "storage_soak", **rep}


def run_kernel_phases(rng, device) -> tuple:
    """The three kernel-against-plain phases, each line with its seconds."""
    out = []
    for phase, fn in ((1, phase_kernel_vs_plain), (2, phase_k2_vs_plain),
                      (3, phase_k3_vs_plain)):
        t = time.perf_counter()
        line = fn(rng(phase), device)
        line["seconds"] = time.perf_counter() - t
        out.append(line)
    return tuple(out)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every random input (documents, edits, "
                         "kernel windows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from diamond_types_tpu_torch.gpu import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    def rng(phase: int) -> np.random.Generator:
        return np.random.default_rng([args.seed, phase])

    device = torch.device("cuda")
    try:
        with ThreadPoolExecutor(1) as pool:
            build, native = phase_build(pool)
            build.update({"torch": torch.__version__,
                          "cuda": torch.version.cuda})
            kvp, k2p, k3p = run_kernel_phases(rng, device)
            t = time.perf_counter()
            native_path, native_s = native.result()
            build.update({"native_seconds": native_s,
                          "native_library": native_path.name,
                          "native_wait_s": time.perf_counter() - t})
        emit(build)
        for line in (kvp, k2p, k3p):
            emit(line)
        cfg = ServeConfig()
        t = time.perf_counter()
        serve, ols, frontiers0, merged = run_serve(rng(4), device, cfg,
                                                   capture=True)
        t_k = time.perf_counter()
        timing = time_captured(serve.pop("captured"), cfg.max_ins,
                               cfg.wide_window)
        k2 = time_k2(serve.pop("k2_args"))
        serve["kernel_timing_s"] = time.perf_counter() - t_k
        per = timing["per_bucket"]
        serve["k1_flush_docs_buckets"] = [
            {k: r[k] for k in ("window", "docs", "cap", "n", "call_ms",
                               "device_ms")}
            for r in per["flush_docs"]]
        serve["k1_wide_buckets"] = per["wide"]
        serve["plain_ms_widest"] = timing["widest"]["plain_ms"]
        serve["buckets_checked_against_plain"] = timing["buckets_checked"]
        widest = timing["widest"]
        serve["k1_ctas_derived"] = {
            "rule": "b * ceil(cap / 512), the launcher's grid",
            "b8_cap32768": k1_ctas(8, 32768),
            "widest": k1_ctas(widest["b"], widest["cap"])}
        # K1's device time as a share of the window's flush wall time
        # (plan + replay + fence), for the two windows whose buckets were
        # all captured and timed
        flush_s = serve["flush_s_per_window"]
        serve["k1_share_of_flush"] = {
            "window0": sum(r["device_ms"] for r in per["flush_docs"])
            / (1e3 * flush_s[0]),
            "wide_window": sum(r["device_ms"] for r in per["wide"])
            / (1e3 * flush_s[cfg.wide_window])}
        serve["seconds"] = time.perf_counter() - t
        emit(serve)
        # the same documents and edits (one generator seed) twice: the
        # per-shard control, then the flush window
        t = time.perf_counter()
        sched = run_scheduler(rng(5), device, cfg, SchedulerConfig())
        sched["seconds"] = time.perf_counter() - t
        emit(sched)
        t = time.perf_counter()
        sched_w = run_scheduler(rng(5), device, cfg, SchedulerConfig(),
                                mesh_window=True)
        sched_w["seconds"] = time.perf_counter() - t
        emit(sched_w)
        t = time.perf_counter()
        benches = run_serve_benches(device, SchedulerConfig(), args.seed)
        benches["seconds"] = time.perf_counter() - t
        emit(benches)
        t = time.perf_counter()
        checkout = run_checkout(ols, frontiers0, merged, device)
        k3 = time_k3(checkout.pop("k3_args"),
                     len(checkout["checkout_calls"]))
        checkout["k3_per_call"] = k3.pop("per_call")
        checkout["k3_gather_ctas_rule"] = (
            "b * ceil(cap / 512), the launcher's grid; derived, not observed")
        checkout["seconds"] = time.perf_counter() - t
        emit(checkout)
        t = time.perf_counter()
        history, history_ol = run_history(rng(8), device, HistoryConfig())
        history["seconds"] = time.perf_counter() - t
        emit(history)
        t = time.perf_counter()
        graph = run_graph(rng(9), device, history_ol)
        graph["seconds"] = time.perf_counter() - t
        emit(graph)
        t = time.perf_counter()
        step = run_merge_step(rng(10), device)
        step["seconds"] = time.perf_counter() - t
        emit(step)
        zcfg = ZoneConfig()
        t = time.perf_counter()
        zkern = run_zone_kernel(rng(11), device, HistoryConfig(), zcfg)
        zkern["seconds"] = time.perf_counter() - t
        emit(zkern)
        t = time.perf_counter()
        zone, zprep, ztape = run_zone(device, history_ol, zcfg)
        zone["seconds"] = time.perf_counter() - t
        emit(zone)
        t = time.perf_counter()
        zbatch = run_zone_batch(device, zprep, ztape, zcfg)
        zbatch["seconds"] = time.perf_counter() - t
        emit(zbatch)
        t = time.perf_counter()
        zshard = run_zone_sharded(device, zprep, ztape)
        zshard["seconds"] = time.perf_counter() - t
        emit(zshard)
        # the scheduler phase's documents and edits (its generator seed)
        t = time.perf_counter()
        zsched = run_scheduler_zone(rng(5), device, cfg, SchedulerConfig(),
                                    zcfg)
        zsched["seconds"] = time.perf_counter() - t
        emit(zsched)
        # the scheduler phase's documents and edits again, over the
        # residency tier
        t = time.perf_counter()
        hsched = run_scheduler_hydrated(rng(5), device, cfg,
                                        SchedulerConfig(), HydratedConfig())
        hsched["seconds"] = time.perf_counter() - t
        emit(hsched)
        t = time.perf_counter()
        soak = run_storage_soak_phase()
        soak["seconds"] = time.perf_counter() - t
        emit(soak)
        t = time.perf_counter()
        qsched = run_scheduler_qos(rng(16), device, cfg, SchedulerConfig(),
                                   QosConfig())
        qsched["seconds"] = time.perf_counter() - t
        emit(qsched)
        t = time.perf_counter()
        osched = run_scheduler_obs(rng(18), device, cfg, SchedulerConfig(),
                                   QosConfig(), ObsConfig())
        osched["seconds"] = time.perf_counter() - t
        emit(osched)
        t = time.perf_counter()
        rsched = run_replicated(rng(19), device, cfg)
        rsched["seconds"] = time.perf_counter() - t
        emit(rsched)
        t = time.perf_counter()
        scen = run_scenario_phase(device)
        scen["seconds"] = time.perf_counter() - t
        emit(scen)
        t = time.perf_counter()
        freads = run_follower_reads(device)
        freads["seconds"] = time.perf_counter() - t
        emit(freads)
        t = time.perf_counter()
        rsoak = run_replicate_soak_phase(device)
        rsoak["seconds"] = time.perf_counter() - t
        emit(rsoak)
        t = time.perf_counter()
        clip = run_cli_phase()
        clip["seconds"] = time.perf_counter() - t
        emit(clip)
        t = time.perf_counter()
        dsoak = run_device_soak_phase(history_ol)
        dsoak["seconds"] = time.perf_counter() - t
        emit(dsoak)
        above = (("scenario", scen), ("follower_reads", freads),
                 ("replicate_soak", rsoak), ("cli", clip))
        t = time.perf_counter()
        replay = run_replay_batch(rng(17), device)
        replay["seconds"] = time.perf_counter() - t
        emit(replay)
        timed = ("ms", "call_ms", "device_ms", "plain_ms", "bound_ms",
                 "library_ms")
        kerns = [
            {"name": "apply_ops_window", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/apply_ops.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:99",
             "launches": serve["launches"],
             "launches_by_path": {"serve": serve["launches"],
                                  "scheduler": sched["launches"],
                                  "window": sched_w["launches"],
                                  "merge_step": step["launches"],
                                  "scheduler_hydrated": hsched["launches"],
                                  "scheduler_qos": qsched["launches"],
                                  "scheduler_obs": osched["launches"],
                                  "replicated": rsched["launches"],
                                  **{p: r["launches"] for p, r in above}},
             "max_abs_err": max(kvp["max_abs_err"], timing["max_abs_err"],
                                sched["k1_max_abs_err"],
                                sched_w["k1_max_abs_err"],
                                step["max_abs_err"],
                                hsched["k1_max_abs_err"],
                                qsched["k1_max_abs_err"],
                                osched["k1_max_abs_err"],
                                rsched["k1_max_abs_err"],
                                *(r["k1_max_abs_err"] for _p, r in above)),
             "bound_by": "bytes", "library_ms": None,
             **{k: widest[k] for k in timed if k in widest},
             "shape": {k: widest[k] for k in ("b", "cap", "n")},
             "flush_docs_device_ms": [r["device_ms"]
                                      for r in per["flush_docs"]],
             "merge_step": step["k1"]},
            {"name": "xform_positions", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/xform_positions.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:315",
             "launches": serve["k2_launches"],
             "launches_by_path": {"serve": serve["k2_launches"],
                                  "scheduler": sched["k2_launches"],
                                  "window": sched_w["k2_launches"],
                                  "scheduler_hydrated":
                                      hsched["k2_launches"],
                                  "scheduler_qos": qsched["k2_launches"],
                                  "scheduler_obs": osched["k2_launches"],
                                  "replicated": rsched["k2_launches"],
                                  **{p: r["k2_launches"] for p, r in above}},
             "max_abs_err": max(k2p["max_abs_err"], k2["max_abs_err"],
                                sched["k2_max_abs_err"],
                                sched_w["k2_max_abs_err"],
                                hsched["k2_max_abs_err"],
                                qsched["k2_max_abs_err"],
                                osched["k2_max_abs_err"],
                                rsched["k2_max_abs_err"],
                                *(r["k2_max_abs_err"] for _p, r in above)),
             "bound_by": "bytes", **{k: k2[k] for k in timed},
             "shape": k2["shape"],
             "library": {"call": "torch.cumsum(nv, 1)", **k2["library"]}},
            {"name": "linearize_rows", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/linearize.cu",
             "replaces": "none: diamond_types_tpu/tpu/linearize.py "
                         "fugue_linearize_jax is XLA ops",
             "launched_by": "kernels.resolve_rows, one launch a resolve "
                            "(K2 after it)",
             "launches": serve["lin_launches"],
             "launches_by_path": {"serve": serve["lin_launches"],
                                  "scheduler": sched["lin_launches"],
                                  "window": sched_w["lin_launches"],
                                  "scheduler_hydrated":
                                      hsched["lin_launches"],
                                  "scheduler_qos": qsched["lin_launches"],
                                  "scheduler_obs": osched["lin_launches"],
                                  "replicated": rsched["lin_launches"],
                                  **{p: r["lin_launches"] for p, r in above}},
             "max_abs_err": max(k2["max_abs_err"],
                                *(r["max_abs_err"]
                                  for r in k2["linearize"].values())),
             "bound_by": "launch and barriers (bytes bound below)",
             **k2["linearize"]},
            {"name": "materialize_runs", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/materialize.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:211",
             "launches": checkout["launches"],
             "launches_by_path": {"checkout": checkout["launches"],
                                  "history": history["launches"],
                                  "replicated": rsched["k3_launches"],
                                  **{p: r["k3_launches"] for p, r in above
                                     if r["k3_launches"]}},
             "max_abs_err": max(k3p["max_abs_err"], k3["max_abs_err"],
                                history["max_abs_err"],
                                rsched["k3_max_abs_err"],
                                *(r["k3_max_abs_err"] for _p, r in above)),
             "bound_by": "bytes", **{k: k3[k] for k in timed},
             "device_ms_cold_l2": k3["device_ms_cold_l2"],
             "shape": k3["shape"],
             "merge_device_ms": [r["device_ms"]
                                 for r in checkout["k3_per_call"]
                                 if r["call"] == "merge"],
             "history": history["k3"]},
            {"name": "zone_tape", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/zone_tape.cu",
             "replaces": "diamond_types_tpu/tpu/zone_kernel.py:480",
             "launches": zone["launches"],
             "launches_by_path": {"zone": zone["launches"],
                                  "zone_batch": zbatch["launches"],
                                  "zone_sharded": zshard["launches"],
                                  "scheduler_zone": zsched["launches"],
                                  "replicated": rsched["x8_launches"],
                                  **{p: r["x8_launches"] for p, r in above},
                                  "device_soak": dsoak["x8_launches"]},
             "max_abs_err": max(zkern["max_abs_err"], zone["max_abs_err"],
                                zshard["max_abs_err"], zsched["max_abs_err"],
                                rsched["x8_max_abs_err"],
                                *(r["x8_max_abs_err"] for _p, r in above),
                                dsoak["x8_max_abs_err"]),
             **{k: zone["x8"][k] for k in timed},
             "bound_by": "bytes",
             **{k: zone["x8"][k] for k in ("bound_step_bytes",
                                           "whole_tape_ms",
                                           "cluster", "form", "c1_global",
                                           "speedup_vs_c1_global",
                                           "empty_apply_step_us",
                                           "self_fork_step_us", "barrier_us",
                                           "serial_floor_ms",
                                           "device_us_per_step")},
             "shape": {k: zone[k] for k in ("W", "T", "n_idx", "plen")}},
            {"name": "replay_batch_kernel", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/apply_ops.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:352",
             "on_main_path": False,
             "launches": replay["launches"],
             "launches_by_path": {"replay_batch": replay["launches"]},
             "max_abs_err": replay["max_abs_err"],
             "bound_by": "bytes", "library_ms": None,
             **{k: replay[k] for k in timed if k in replay},
             "shape": replay["shape"]}]
        card = nvidia_smi_line()
        emit({"kernels": kerns})
        print(card, flush=True)
    except Exception as e:     # every phase fails loudly, and the run too
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
