#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
kernel against its plain PyTorch version, run TPC-H q1 at SF1 and TPC-DS
q3 (both forms) through ``TorchSparkSession`` from memory, a user
repartition, then q1 and q3 from Parquet, TPC-H q12 and q1's double
form, an expression battery, TPC-H q19 and q12 in its optimizer form
and a skewed join, TPC-DS q98, q51's store half and a q86-shaped rollup
over windows, a union and a range, the Yahoo Streaming Benchmark's
windowed count and Stack Overflow tag queries over nested columns,
ClickBench Q10 and Q9 (mixed DISTINCT over a cached child), q1 over a
cached Parquet read and pandas UDFs, TPC-H q13 and TPC-DS q28 with
their joins on the host and q1 with its aggregate on the host (the
per-operator CPU fallback), q1 from delimited text, under each reader
strategy and from a partitioned tree, q3 from ORC and YSB from JSON
lines (the readers and writers), q1 and q3 over a mesh of 4 chips
emulated on the card (the all-to-all exchange, the mesh scan, chip
failures, the external shuffle), and check the rows against exact
references, then time the queries, the upload and each kernel.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; kernels build into ``build/kernels/``
at the repo root. Exits non-zero, printing no result, when CUDA is
absent or any phase fails. Output, one line per phase:

  1. the card (nvidia-smi name, power limit), torch and CUDA versions,
     whether ``pyarrow``, ``pandas``, ``cloudpickle`` and ``scipy``
     import;
  2. the nvcc build seconds, the probe launch, and each kernel's
     ``-Xptxas -v`` lines (registers, spills, static shared memory) as
     ptxas printed them, keyed by mangled name;
  3. kernel parity on the card: murmur3 at 1M rows over a type battery,
     at q1's exchange shapes, on 16 key columns (``MAX_COLS``: bool,
     byte and short in their own widths, strings at char caps 8, 16 and
     64) and with ``n_parts`` (the partition id in the same launch) at
     q1's exchange shape and on the 16 columns (all exact), groupbyHash
     at q1's partial shapes and on a many-groups case (786,432 rows, 700
     keys in 1,024 slots, 21 add + 1 min + 1 max lanes), each exact and
     timed beside its byte bound, and an overflow case flagged by both
     versions;
  4. q1 at SF1 (6,001,215 rows, 8 partitions) against an exact
     reference computed here with numpy and Python ints, with the
     executed plan all ``Torch*``, groupbyHash launched, no murmur3
     (one card coalesces the planner's exchanges to one partition, as
     the JAX package does) and no overflow re-run;
  5. q1 wall (one warm run, mean of two) and rows/s; per-kernel
     device time, launches per q1, bound and plain-version time, with
     the CUDA kernels of each murmur3 case and of one ``partition_ids``
     call at q1's exchange shape counted in torch.profiler's device trace
     (one each, or the run fails);
  6. TPC-DS q3 at 2,000,000 store_sales rows (bench.py's generator,
     seed 20260731; 8/4/4 partitions): joinProbe against its plain
     version at q3's shapes, on a K=2 case with duplicate build keys and
     on builds at the 8,192-row cap with K=1 and K=3 (exact); groupbyHash at the pushed form's partial-aggregate batch
     (exact, timed beside its byte bound); bench.py's text (sort-based
     FK join route, no joinProbe)
     and the form with the dimension predicates pushed into the joins
     (every join through joinProbe), each against an exact reference
     computed here, with its wall (one warm run, mean of two) and
     rows/s; joinProbe's device time at q3's per-chunk shapes beside
     its byte bound and the plain version's time, its CUDA kernels (one,
     or the run fails) and the time of the join's whole kernel route
     (``probe_inputs`` + ``build_probe``);
  7. Parquet (needs ``pyarrow``; data written under ``build/data/`` at
     first use through ``DataFrame.write.parquet``, as bench.py writes
     it): decodeFused against its plain version on the card, exactly,
     over a decode corpus (every page class and column kind), one q1
     row group and the ten row groups of q3's files; q1 at SF1 from 8 files (one row group each) through
     ``read.parquet`` against the exact reference, with 8 decodeFused
     launches and no host-decoded column or unit; bench.py's q3 text
     from Parquet (store_sales in 8 files, item and date_dim in one
     each) against its reference; walls (one warm run, mean of two)
     and decodeFused's device time beside its byte bound and the plain
     version's time at q1's row group, at a 250,000-row q3 store_sales
     row group and at the corpus's ``dict`` case (nulls and strings: the
     3-launch scan path), with the CUDA kernels each case ran, counted in
     torch.profiler's device trace;
  8. the user repartition path: q3's store_sales through
     ``.repartition(8, "ss_item_sk").groupBy("ss_item_sk").agg(sum,
     count)``, 20,000 groups against an exact reference, with 8 murmur3
     launches (one per 250,000-row input batch), and murmur3 held
     against its plain version and timed at that shape;
  9. the upload split of q1 from memory (``upload_split``): string
     encoding by this port's route and by the JAX package's, the rest
     of the packing, the write into one host buffer and the copy to the
     card (on pageable and on pinned memory), and the decode;
  10. the upload ring (``ring_phases``): q1 from memory and from Parquet,
     both q3 forms and the repartition path at ``maxInFlight`` 0 and 2,
     each exact, with walls, and for q1 the device's idle share and the
     ring's counters (``uploadAheadBatches`` above 0 at depth 2, every
     upload copied from a pinned slot on the copy stream); the
     repartition path run by run at both depths (``ring_runs``); the
     main q1 phases check the ring's choice with its key unset (from
     memory synchronous, from Parquet running ahead);
  11. whole-stage fusion (``stage_fusion_phase``): q1 from memory and from
     Parquet and both q3 forms with ``spark.rapids.sql.stageFusion.
     enabled`` off and on in turns (off, on), each exact, with
     capture seconds, walls, graph replays against the stages'
     ``dispatchCount``, kernel and graph launch calls and their host
     microseconds, device kernels, busy time and idle share from
     torch.profiler (8 groupbyHash kernels per q1 in the device trace),
     and ``memory_reserved``; then 8 stage outputs of one partition held
     together and read back exact (``held_outputs_check``);
  12. the memory phase (``memory_phase``): q1 and q3 under injected
     faults, out of core, through the spill tiers and under a real OOM;
  13. the expression and aggregate phases: the numeric capability
     probes' answers on the card (``capabilities``); TPC-H q12 at SF1
     (6,001,215 lineitem rows, 1,500,000 orders) from memory and from
     Parquet (``q12_memory``, ``q12_parquet``), rows exact against a
     numpy reference, the plan all ``Torch*``, each kernel's launches,
     the join's route, the wall and the device's idle share; q1 at SF1
     in its double form (``q1_double``), sums and averages within 1e-12
     of a ``math.fsum`` reference; and every expression family over
     500,000 seeded rows with nulls (``exprs_card``), each held
     against the same port code on the CPU, the filter/project and
     aggregate families as fused stages captured as CUDA graphs;
  14. residual join conditions and adaptive execution (``joins_phases``):
     TPC-H q12 in its optimizer form (``Q12_PUSHED``: lineitem's
     predicates in a subquery below the join, so a shuffled join demoted
     to a broadcast at run time, orders' exchange dropped) and TPC-H q19
     (``Q19``: its OR in the join condition, evaluated in the port's
     join) at SF1 from memory and from Parquet (``q12_pushed_memory``,
     ``q12_pushed_parquet``, ``q19_memory``, ``q19_parquet``), rows
     exact against numpy references; and the skew leg (``aqe_skew``):
     q3's store_sales with 60% of its rows on one item, joined inner and
     left to item at 4 device partitions, a skew split and the
     aggregate's exchange coalesced. Each leg prints the plan (all
     ``Torch*``), its joins (type, route, residual, children), the
     adaptive counters, the row counts the demotion read and how many of
     them synchronised, each kernel's launches, the wall, the same query
     with adaptive execution off (same rows, no adaptive counter; walls
     in turns with the adaptive runs) and the idle share of one profiled
     warm run; then murmur3 and groupbyHash at the legs' shapes
     (``joins_kernel_shapes``: each hash exchange's first batch and the
     partial aggregate's, q12 pushed and the skew leg), exact against
     their plain versions, timed beside their bounds;
  15. range, union, expand and window (``windows_phases``), over
     bench's q3 tables with TPC-DS columns added (``windows_tables``:
     2,000,000 store_sales rows, seed 20260736 for the new columns):
     TPC-DS q98 in its pushed double form (``Q98_PUSHED``: a
     whole-partition window sum over the aggregate, joinProbe on both
     joins), q51's store half in its double form (``Q51_STORE``: a
     running window per item, also key-batched at ``batchSizeRows``
     131,072 over two device partitions, its rows equal to the default
     run's), a q86-shaped rollup with a rank (``q86_frame``: expand,
     groupbyHash with a decimal sum lane, a rank over a decimal order
     key), the same over the union of two store_sales views, and
     ``range(0, 6001215)`` under a group-by; q98, q51 and q86 also from
     Parquet. Each leg's rows against a numpy reference (doubles within
     1e-12 relative, everything else exact), the plan all ``Torch*``
     with its window, expand, union or range node, each kernel's
     launches, the window's ``dispatchCount`` and the CUDA kernels of
     one window batch, the wall (one warm run, mean of two) and the
     idle share of one profiled warm run; then joinProbe at q98's two
     joins and groupbyHash at the rollup's and the range's first partial
     batch (``windows_kernel_shapes``), exact against their plain
     versions, timed beside their bounds;
  16. nested device columns (``nested_phases``): the Yahoo Streaming
     Benchmark's windowed campaign count (``ysb_tables``: 6,000,000
     events over 600 s, 1,000 ads of 100 campaigns, seed 20260737;
     ``YSB_SQL``: a ``window(event_time, '10 seconds')`` struct group
     key on the sort path after the broadcast ad join, joinProbe) from
     memory, from Parquet and at ``shuffle.devicePartitions`` 8 (the
     exchange hashes the struct key through murmur3), and three Stack
     Overflow tag queries (``tags_tables``: 2,000,000 questions, 1-5
     of 65,000 Zipf-popular tags each, seed 20260738; ``TAGS_SQL``:
     explode, array_contains, element_at, size, groupbyHash on the tag
     with its overflow re-runs) from memory and from Parquet (the array
     column host-decoded, counted in ``deviceFallbackColumns``). Each
     leg exact against its numpy reference, the plan all ``Torch*``,
     each kernel's launches, the wall (one warm run, mean of two),
     the idle share of one profiled warm run; then joinProbe at the ad
     join, murmur3 on the struct key and groupbyHash on a tags batch
     (``nested_kernel_shapes``), exact against their plain versions,
     timed beside their bounds;
  17. the cache, mixed DISTINCT and Python UDFs (``cache_udf_phases``):
     ClickBench Q10 (``hits_tables``: 10,000,000 rows, seed 20260739,
     the generator's parameters in ``HITS_*``; two aggregates over the
     planner's cached child joined on ``RegionID <=> _mdk0``) from
     memory and from Parquet, every group also without ORDER BY and
     LIMIT, with Q9 timed in turns beside it; TPC-H q1 over
     ``read.parquet(q1_dir).cache()`` (the first collect materialises:
     8 decodeFused; the reads: 0 decodeFused, 8 groupbyHash), timed in
     turns with q1 from Parquet uncached; the pandas UDFs ``plus_one``
     and ``cdf`` and a ``mapInPandas`` filter over Databricks' pandas
     UDF table (``pudf_tables``: 10,000,000 rows, 1,000 ids, seed
     20260740), each followed by a group-by, where pandas imports; a
     compiled ``F.udf`` inside a fused stage. Each leg against its numpy
     reference (doubles within 1e-12 relative, the rest exact), the
     plan all ``Torch*``, launches, the wall, the idle share; every
     collect leaves no store handle and no permit held, and no worker
     process outlives its session; then groupbyHash at Q10's distinct
     partial and q1's cached partial batch
     (``cache_udf_kernel_shapes``);
  18. the per-operator CPU fallback (``fallback_phases``): TPC-H q13 at
     SF1 (``q13_tables``: 150,000 customers, 1,500,000 orders, seed
     20260741; ``Q13``: the conditional left outer join on the host
     between downloads of two device exchanges, both aggregates on the
     card) and TPC-DS q28 (``q28_tables``: 2,000,000 ``store_sales``
     rows, seed 20260742; ``Q28``: six global mixed DISTINCT blocks over
     six cached children, 11 nested-loop joins on the host) from memory
     and from Parquet, and q1 from phase 7's files with
     ``spark.rapids.sql.exec.HashAggregateExec=false``
     (``q1_cpu_aggregate``: 8 decodeFused, 0 groupbyHash). Each leg
     exact against its numpy reference, with its plan and host
     operators, the explain lines under ``spark.rapids.sql.explain=ALL``,
     each kernel's launches, the seconds in the host operators and in
     each upload and download around them (``host_seconds``), the wall
     (one warm run, mean of two) and the idle share; every collect
     leaves no store handle and no permit held. Then groupbyHash at q13's
     and q28's partial batches (``fallback_kernel_shapes``) and the cost
     model's two constants on this card (``cbo_constants``);
  19. readers and writers (``formats_phases``), every file written first
     by the port's writers: q1 at SF1 from dbgen-style ``|``-delimited
     text (8 files, ``read.csv`` with a decimal(15,2) schema) under the
     PERFILE and MULTITHREADED readers in turns (``q1_tbl_*``: no
     decodeFused, a groupbyHash launch per upload); q1 from phase 7's 8
     Parquet files under PERFILE, MULTITHREADED and COALESCING in turns
     (``q1_readers_*``: 8, 8 and 0 decodeFused) and ``input_file_name()``
     with its count per file under COALESCING, read as PERFILE, against
     the footers' row counts; q1 over lineitem written with
     ``partitionBy("l_returnflag", "l_linestatus")`` (``q1_partitioned``:
     6 directories, a decodeFused launch per file); TPC-DS q3's pushed
     form from ORC at 2,000,000 store_sales rows (``q3_orc``: 16
     joinProbe); the YSB windowed count over 1,000,000 events in JSON
     lines (``ysb_json``). Each exact against its numpy reference, with
     its launches, the first run, two timed runs in turns, the idle
     share of a profiled run and that run's scan ``decodeTime`` and
     ``convertTime`` and upload ``packBatchTime`` and
     ``copyToDeviceTime``;
  20. the query server (``serve_phases``): q1 at SF1 from phase 7's
     Parquet at three shipdate bounds and TPC-DS q3's pushed form at
     three bindings (store_sales from phase 4's Parquet, the two
     dimensions again in 4 files each) served by ``QueryServer`` on the
     card to four tenants at the JAX package's defaults, every response
     decoded from Arrow IPC and exact: ``serve_mixed`` (p50/p99 a
     tenant, queries a second, plan-cache hits on every repeat,
     semaphoreWaitTime, a profiled served q1's idle share against the
     same query in a plain session), ``serve_fusion`` (eight q1 in one
     batch and one admission slot), ``serve_lifecycle`` (deadline, an
     injected site:cancel stop, the cancel verb, a disconnect: each
     leaves no permit, store handle or ledger byte; shutdown drains),
     ``serve_result_cache`` (a hit launches nothing, a touched file
     re-executes), ``serve_concurrency`` (four q1 requests at
     maxConcurrentQueries 1 and 4 in turns: walls, process CPU over
     wall, each execution's wall, semaphore wait and host timers) and
     ``serve_launches`` (the global launch counters equal the executed
     plans' own counts; the executions' streams, the graphs captured
     and replayed, the allocator's bytes after each leg);
  21. observability (``observe_phases``): q1 at SF1 and q3 pushed from
     Parquet with a file trace, a profile, the event log, the query
     history and ``metrics.level=DEBUG`` (``observe_traced``: rows exact,
     every span and instant kind catalogued, and per kernel the
     ``LAUNCHES`` delta equal to the plan's ``kernelDispatchCount.*``, to
     the trace's kernelDispatch spans plus its replays' recorded kernels
     and to the profile's kernel summary; one event-log line and one
     history record a query; groupbyHash, decodeFused and joinProbe held
     against their plain versions at these runs' shapes), q1 with
     tracing off, in file mode and in ring mode in turns
     (``observe_overhead``: two timed runs each), a ``QueryServer`` with
     the ring recorder and a 1 ms slow-query trigger
     (``observe_server``: the bundle and its ring dump load, the dump's
     launches, the ``metrics`` verb's and a loopback scrape's
     kernel-dispatch counters equal the launch delta; a second server
     over the same history after a reset of the lifecycle layer
     warm-starts and its first q1 is a plan-cache hit) and q1's metric
     names at ESSENTIAL and DEBUG (``observe_levels``);
  22. tooling (``tools_phases``): q1 from phase 7's Parquet with the
     kernel autotuner on over a fresh table (``tools_autotune``: the
     sweeps of groupbyHash and decodeFused at q1's buckets, each
     candidate's oracle outcome and card ms, the winners with
     ``applied``; after a restart of the autotuner, zero sweeps, rows
     exact and the launches of phase 21's q1), two broken candidates
     rejected and never recorded (``tools_broken_candidate``), q1 on the
     tuned table and on defaults in turns (``tools_walls``), every
     candidate at q1's shapes exact against the plain versions and timed
     (``tools_knobs``), phase 14's skew leg on defaults, swept and with
     ``slotsMult`` 2 pinned (``tools_skew_slots``: its overflow re-runs
     each way), and the CLI (``tools_cli``: ``tools qualify`` in
     a subprocess, ``profile``, ``trace``, ``hotspots``, ``docs`` and
     ``lint`` in process, each exit 0, the docs identical to
     docs/torch/);
  23. the sync audit (``sync_audit_phases``): TPC-H q1 from phase 7's
     Parquet and TPC-DS q3's pushed form from phase 20's files, each run
     once warm and once under ``torch.cuda.set_sync_debug_mode("warn")``
     (``sync_audit``: rows exact, the launches, every sync PyTorch
     reports attributed to the innermost function of the package on its
     thread's stack, counted per function, per calling function and per
     line; the run fails when one falls in a function of the linter's
     ``hot_scope`` that ``sync_allowlist`` does not cover, or when a
     query records none), after ``sync_probe`` (where this build puts a
     sync's warning, and which explicit ``synchronize()`` calls warn);
  24. multi-chip execution (``multichip_phases``) over 4 chips emulated
     on the card (``parallel.mesh.emulate_chips``): q1 at SF1 from phase
     7's Parquet and q3's pushed form from phase 20's files under
     ``spark.rapids.shuffle.mode=ici`` (``multichip_q1``,
     ``multichip_q3``: rows exact, the plan all ``Torch*``,
     ``numIciExchanges``, every chip's ``meshScanUnits`` and
     ``dispatchCount``, ``meshPadWaste``, each kernel's launches equal
     to the plan's own counts, the mesh exchange's murmur3 launch held
     against its plain version on chip 0's slot), q1 with chip 1 and
     then chips 0, 1 and 2 failing (``multichip_degrade``), q1 under
     ``shuffle.mode=external`` (``multichip_external``),
     ``sum_count_step`` over the 4 chips against a host reduction
     (``multichip_step``) and q1's wall under ``ici`` and ``inprocess``
     in turns (``multichip_walls``; emulated chips share one card, so no
     scaling claim);
  25. concurrent execution (``task_parallel_phases``): pushed q3 at 4
     tasks from an empty stage cache (``task_parallel_cold``: one graph
     capture a key), q1 from Parquet and pushed q3 at 1, 2 and 4
     ``taskParallelism`` task threads (``task_parallel``: rows exact,
     launches equal to the plans' own counts, each exchange materialized
     once, each broadcast built once), their walls in turns
     (``task_parallel_walls``), the 4-task legs under the sync audit
     (``task_parallel_audit``), q1 over 4 emulated chips at 1 and 4
     tasks (``task_parallel_mesh``) and a two-card leg that skips on
     one card (``task_parallel_two_cards``);
  every profiled run above traces the device's activity only
  (``profile_collect``; phase 11's ``stage_profile`` also the launch
  calls), read from the profiler's raw events;
  with ``--breakdown``, q1 (from
  memory and from Parquet) and each q3 form under torch.profiler (device
  busy time, idle share, top kernels and host ops; full tables in
  ``*_profile.txt`` files, see ``profile_collect``);
  with ``--walls``, only the query walls (``walls_only``), to compare two
  checkouts in one call; with ``--fusion``, only the build and phase 11
  (``fusion_only``); with ``--exprs``, only the build and phase 13
  (``exprs_only``); with ``--joins``, only the build and phase 14
  (``joins_only``); with ``--windows``, only the build and phase 15
  (``windows_only``); with ``--nested``, only the build and phase 16
  (``nested_only``); with ``--cache-udf``, only the build and phase 17
  (``cache_udf_only``); with ``--fallback``, only the build and phase 18
  (``fallback_only``); with ``--formats``, only the build and phase 19
  (``formats_only``); with ``--serve``, only the build and phase 20
  (``serve_only``); with ``--observe``, only the build and phase 21
  (``observe_only``); with ``--tools``, only the build and phase 22
  (``tools_only``); with ``--sync-audit``, only the build and phase 23
  (``sync_audit_only``); with ``--multichip``, only the build and phase
  24 (``multichip_only``); with ``--tasks``, only the build and phase 25
  with the mesh gap's profile at 1 and 4 tasks (``tasks_only``);
  with ``--ab DIR``, the joinProbe and murmur3 of the checkout at DIR
  (``ParentKernels``) are held against this tree's on the same inputs and
  timed beside them in turns (``ab_join_probe``, ``ab_murmur3``);
  then a ``total`` line with the script's seconds, a ``{"kernels":
  [...]}`` line (each kernel also with its launches on q12's two legs
  and on phase 14's, 15's, 16's, 17's, 18's, 19's, 20's, 21's, 22's,
  23's, 24's and 25's legs, and those phases' shapes among its cases;
  groupbyHash and
  decodeFused also with their tuned knobs a bucket and each autotune
  candidate's card ms at q1's shapes)
  and, last, the contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import decimal
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SF1_ROWS = 6_001_215
N_PARTITIONS = 8
SEED = 20260730
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

Q1 = """
SELECT
    l_returnflag,
    l_linestatus,
    sum(l_quantity) AS sum_qty,
    sum(l_extendedprice) AS sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    avg(l_quantity) AS avg_qty,
    avg(l_extendedprice) AS avg_price,
    avg(l_discount) AS avg_disc,
    count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


Q3_SALES_ROWS = 2_000_000
Q3_SEED = 20260731
Q3_PARTITIONS = {"store_sales": 8, "item": 4, "date_dim": 4}

# TPC-DS q3 as bench.py writes it: the dimension predicates sit above
# both joins, so the build sides are the whole dimension tables
Q3_BENCH = """
SELECT d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) sum_agg
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON ss_item_sk = i_item_sk
WHERE i_manufact_id = 128 AND d_moy = 11
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, brand_id
LIMIT 100
"""

# the same query with the dimension predicates pushed into the joined
# subqueries, where Spark's optimizer puts them: the broadcast build
# sides compact to the matching rows
Q3_PUSHED = """
SELECT d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) sum_agg
FROM store_sales
JOIN (SELECT d_date_sk, d_year FROM date_dim WHERE d_moy = 11) dt
  ON d_date_sk = ss_sold_date_sk
JOIN (SELECT i_item_sk, i_brand_id, i_brand FROM item
      WHERE i_manufact_id = 128) it
  ON ss_item_sk = i_item_sk
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, brand_id
LIMIT 100
"""


def q3_tables(n_sales: int = Q3_SALES_ROWS, seed: int = Q3_SEED):
    """bench.py's TPC-DS q3 star-schema generator: {table: [(column,
    kind, array)]}, kind in long/int/str/dec72 (decimal(7,2) as unscaled
    int64)."""
    rng = np.random.default_rng(seed)
    n_item = 20_000
    item = [("i_item_sk", "long", np.arange(1, n_item + 1)),
            ("i_brand_id", "int",
             rng.integers(1, 1000, n_item).astype(np.int32)),
            ("i_brand", "str", np.array(
                [f"brand#{i % 997:03d}" for i in range(n_item)],
                dtype=object)),
            ("i_manufact_id", "int",
             rng.integers(1, 1001, n_item).astype(np.int32))]
    n_date = 73_049
    days = np.arange(n_date)
    date_dim = [("d_date_sk", "long", np.arange(1, n_date + 1)),
                ("d_year", "int",
                 (1998 + (days // 365) % 7).astype(np.int32)),
                ("d_moy", "int", (1 + (days // 30) % 12).astype(np.int32))]
    store_sales = [
        ("ss_sold_date_sk", "long", rng.integers(1, n_date + 1, n_sales)),
        ("ss_item_sk", "long", rng.integers(1, n_item + 1, n_sales)),
        ("ss_ext_sales_price", "dec72",
         rng.integers(100, 1_000_000, n_sales))]
    return {"item": item, "date_dim": date_dim, "store_sales": store_sales}


def q3_reference(tables, manufact: int = 128, moy: int = 11):
    """Exact q3 rows, independent of any engine: each join by key arrays
    (searchsorted over the sorted dimension keys), the filter, the group
    sums of the unscaled decimals as Python ints, then ORDER BY d_year,
    sum_agg DESC, brand_id and LIMIT 100. Rows are (d_year, brand_id,
    brand, Decimal sum_agg at scale 2). ``manufact`` and ``moy`` are the
    query's bindings (``q3_text``); computed once for a given ``tables``
    object and binding."""
    return _memo("q3", tables, (manufact, moy), lambda: q3_references(
        tables, [(manufact, moy)])[(manufact, moy)])


def q3_references(tables, bindings) -> dict:
    """``{(manufact, moy): q3_reference(tables, manufact, moy)}``, the
    joins' key lookups made once for every binding."""
    col = {t: {name: a for name, _k, a in cols}
           for t, cols in tables.items()}
    ss, dd, it = col["store_sales"], col["date_dim"], col["item"]

    def lookup(dim_keys, fact_keys):
        order = np.argsort(dim_keys, kind="stable")
        pos = np.searchsorted(dim_keys[order], fact_keys)
        pos = np.minimum(pos, len(order) - 1)
        hit = dim_keys[order][pos] == fact_keys
        return order[pos], hit

    drow, dhit = lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    irow, ihit = lookup(it["i_item_sk"], ss["ss_item_sk"])
    moys, manufacts = dd["d_moy"][drow], it["i_manufact_id"][irow]
    out = {}
    for manufact, moy in bindings:
        keep = dhit & ihit & (moys == moy) & (manufacts == manufact)
        groups: dict = {}
        for y, b, s, p in zip(dd["d_year"][drow][keep],
                              it["i_brand_id"][irow][keep],
                              it["i_brand"][irow][keep],
                              ss["ss_ext_sales_price"][keep]):
            k = (int(y), int(b), s)
            groups[k] = groups.get(k, 0) + int(p)
        rows = sorted(((y, b, s, v) for (y, b, s), v in groups.items()),
                      key=lambda r: (r[0], -r[3], r[1]))
        out[(manufact, moy)] = [(y, b, s, decimal.Decimal(v).scaleb(-2))
                                for y, b, s, v in rows[:100]]
    return out


def check_q3_rows(got, want, what: str) -> None:
    """Ordered equality on the sort key; rows that tie on the whole sort
    key (d_year, sum_agg, brand_id) may come in either order."""
    got = [tuple(r) for r in got]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")

    def key(r):
        return (r[0], r[3], r[1])
    if [key(r) for r in got] != [key(r) for r in want]:
        raise AssertionError(f"{what}: order or values differ: "
                             f"{got[:3]} vs {want[:3]}")
    for g, w in zip(sorted(got, key=repr), sorted(want, key=repr)):
        if g != w or g[3].as_tuple().exponent != -2:
            raise AssertionError(f"{what}: row {g} != {w}")


# TPC-H q12 (spec 2.4.12, validation parameters MAIL, SHIP, 1994-01-01)
# as both packages' parsers take it: the join written out, the year's end
# as a literal
Q12 = """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT'
                  OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END)
         AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT'
                 AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
         AS low_line_count
FROM orders JOIN lineitem ON o_orderkey = l_orderkey
WHERE l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate
  AND l_shipdate < l_commitdate
  AND l_receiptdate >= date '1994-01-01'
  AND l_receiptdate < date '1995-01-01'
GROUP BY l_shipmode
ORDER BY l_shipmode
"""
Q12_SEED = 20260732
Q12_ORDERS = 1_500_000
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


def q12_tables(n_lineitem: int = SF1_ROWS, n_orders: int = Q12_ORDERS,
               seed: int = SEED, q12_seed: int = Q12_SEED):
    """lineitem with q1's seven columns (``lineitem_arrays``, byte for
    byte) and q12's four from a second seed, and orders, with the TPC-H
    4.2.3 domains: dbgen's sparse order keys (the first 8 of every 32),
    o_orderpriority uniform over the 5 priorities, l_orderkey drawn among
    the order keys, l_shipmode uniform over the 7 modes, l_commitdate =
    o_orderdate + U[30,90] with o_orderdate = l_shipdate - U[1,121],
    l_receiptdate = l_shipdate + U[1,30]. Returns ``{table: [(column,
    kind, array)]}``, kind in long/str/date/dec."""
    q1 = lineitem_arrays(n_lineitem, seed)
    rng = np.random.default_rng(q12_seed)
    okey = np.arange(n_orders, dtype=np.int64)
    okey = (okey // 8) * 32 + okey % 8 + 1
    prio = np.array(PRIORITIES, dtype=object)[
        rng.integers(0, len(PRIORITIES), n_orders)]
    l_okey = okey[rng.integers(0, n_orders, n_lineitem)]
    mode = np.array(SHIPMODES, dtype=object)[
        rng.integers(0, len(SHIPMODES), n_lineitem)]
    ship = q1[6]
    orderdate = ship - rng.integers(1, 122, n_lineitem)
    commit = (orderdate + rng.integers(30, 91, n_lineitem)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n_lineitem)).astype(np.int32)
    names = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
             "l_returnflag", "l_linestatus", "l_shipdate")
    kinds = ("dec", "dec", "dec", "dec", "str", "str", "date")
    lineitem = [(n, k, a) for n, k, a in zip(names, kinds, q1)] + [
        ("l_orderkey", "long", l_okey), ("l_shipmode", "str", mode),
        ("l_commitdate", "date", commit), ("l_receiptdate", "date", receipt)]
    orders = [("o_orderkey", "long", okey), ("o_orderpriority", "str", prio)]
    return {"lineitem": lineitem, "orders": orders}


def q12_fields(cols):
    """(name, port DataType) and arrays of one ``q12_tables`` table."""
    from spark_rapids_tpu_torch.sql import types as T
    kind = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
            "date": T.DateT, "dec": T.DecimalType(15, 2)}
    return [(n, kind[k]) for n, k, _a in cols], [a for _n, _k, a in cols]


def q12_reference(tables):
    """Exact q12 rows, independent of any engine: the join by a
    searchsorted over the order keys, the filter as masks, counts per
    l_shipmode. Rows are (l_shipmode, high_line_count, low_line_count)."""
    li = {n: a for n, _k, a in tables["lineitem"]}
    od = {n: a for n, _k, a in tables["orders"]}
    order = np.argsort(od["o_orderkey"], kind="stable")
    keys = od["o_orderkey"][order]
    pos = np.minimum(np.searchsorted(keys, li["l_orderkey"]), len(keys) - 1)
    hit = keys[pos] == li["l_orderkey"]
    prio = od["o_orderpriority"][order][pos]
    lo = (np.datetime64("1994-01-01") - np.datetime64("1970-01-01")).astype(
        int)
    hi = (np.datetime64("1995-01-01") - np.datetime64("1970-01-01")).astype(
        int)
    mode = li["l_shipmode"]
    keep = hit & ((mode == "MAIL") | (mode == "SHIP")) \
        & (li["l_commitdate"] < li["l_receiptdate"]) \
        & (li["l_shipdate"] < li["l_commitdate"]) \
        & (li["l_receiptdate"] >= lo) & (li["l_receiptdate"] < hi)
    high = (prio == "1-URGENT") | (prio == "2-HIGH")
    rows = []
    for m in ("MAIL", "SHIP"):
        sel = keep & (mode == m)
        if sel.any():
            rows.append((m, int((sel & high).sum()),
                         int((sel & ~high).sum())))
    return rows


# q12 in the form Spark's optimizer gives it: the lineitem predicates
# pushed into a subquery below the join, so the join's build side is the
# filtered lineitem (about 0.5% of its rows) and adaptive execution
# demotes the shuffled join to a broadcast at run time
Q12_PUSHED = """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT'
                  OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END)
         AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT'
                 AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
         AS low_line_count
FROM orders
JOIN (SELECT l_orderkey, l_shipmode FROM lineitem
      WHERE l_shipmode IN ('MAIL', 'SHIP')
        AND l_commitdate < l_receiptdate
        AND l_shipdate < l_commitdate
        AND l_receiptdate >= date '1994-01-01'
        AND l_receiptdate < date '1995-01-01') l
  ON o_orderkey = l_orderkey
GROUP BY l_shipmode
ORDER BY l_shipmode
"""

# TPC-H q19 (spec 2.4.19, validation parameters Brand#12/23/34, quantities
# 1/10/20) with the join written out and its OR in the join condition,
# where Spark's optimizer puts cross-side predicates: an equi-join on the
# part key with a residual condition. The spec's 'AIR REG' never matches
# the domain's 'REG AIR', as in the spec.
Q19 = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem JOIN part ON p_partkey = l_partkey AND (
     (p_brand = 'Brand#12'
      AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
      AND l_quantity >= 1 AND l_quantity <= 1 + 10
      AND p_size BETWEEN 1 AND 5
      AND l_shipmode IN ('AIR', 'AIR REG')
      AND l_shipinstruct = 'DELIVER IN PERSON')
  OR (p_brand = 'Brand#23'
      AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
      AND l_quantity >= 10 AND l_quantity <= 10 + 10
      AND p_size BETWEEN 1 AND 10
      AND l_shipmode IN ('AIR', 'AIR REG')
      AND l_shipinstruct = 'DELIVER IN PERSON')
  OR (p_brand = 'Brand#34'
      AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
      AND l_quantity >= 20 AND l_quantity <= 20 + 10
      AND p_size BETWEEN 1 AND 15
      AND l_shipmode IN ('AIR', 'AIR REG')
      AND l_shipinstruct = 'DELIVER IN PERSON'))
"""
Q19_SEED = 20260734
Q19_PARTS = 200_000
SHIPINSTRUCTS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
# (brand, containers, lowest quantity, largest size) of q19's three
# branches
Q19_BRANCHES = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))


def q19_tables(n_lineitem: int = SF1_ROWS, n_part: int = Q19_PARTS,
               n_orders: int = Q12_ORDERS, seed: int = Q19_SEED):
    """``q12_tables`` with q19's columns: lineitem gains l_partkey
    (U[1, n_part]) and l_shipinstruct (the 4 values of TPC-H 4.2.3), and
    part has n_part rows: p_partkey 1..n_part, p_brand 'Brand#MN' with
    M, N in [1, 5], p_size in [1, 50], p_container one of the 40
    combinations of 4.2.3's two syllables, all drawn from ``seed``.
    Returns ``{table: [(column, kind, array)]}`` with lineitem, orders
    and part."""
    tables = q12_tables(n_lineitem, n_orders)
    rng = np.random.default_rng(seed)
    tables["lineitem"] = tables["lineitem"] + [
        ("l_partkey", "long", rng.integers(1, n_part + 1, n_lineitem)),
        ("l_shipinstruct", "str", np.array(SHIPINSTRUCTS, dtype=object)[
            rng.integers(0, len(SHIPINSTRUCTS), n_lineitem)])]
    brand = np.array([f"Brand#{m}{n}" for m in range(1, 6)
                      for n in range(1, 6)], dtype=object)
    tables["part"] = [
        ("p_partkey", "long", np.arange(1, n_part + 1, dtype=np.int64)),
        ("p_brand", "str", brand[rng.integers(0, len(brand), n_part)]),
        ("p_size", "int", rng.integers(1, 51, n_part).astype(np.int32)),
        ("p_container", "str", np.array(CONTAINERS, dtype=object)[
            rng.integers(0, len(CONTAINERS), n_part)])]
    return tables


def q19_reference(tables):
    """Exact q19 revenue, independent of any engine: the join by index
    (p_partkey = row + 1), each branch as masks over the unscaled
    integers, the revenue summed in Python ints at scale 4. Returns
    ``[(Decimal or None,)]`` and the count of joined rows kept."""
    li = {n: a for n, _k, a in tables["lineitem"]}
    pt = {n: a for n, _k, a in tables["part"]}
    idx = li["l_partkey"] - 1
    brand, size = pt["p_brand"][idx], pt["p_size"][idx]
    container = pt["p_container"][idx]
    qty = li["l_quantity"]
    common = np.isin(li["l_shipmode"], ("AIR", "AIR REG")) \
        & (li["l_shipinstruct"] == "DELIVER IN PERSON")
    keep = np.zeros(len(qty), dtype=bool)
    for b, conts, lo, smax in Q19_BRANCHES:
        keep |= common & (brand == b) & np.isin(container, conts) \
            & (qty >= lo * 100) & (qty <= (lo + 10) * 100) \
            & (size >= 1) & (size <= smax)
    price = li["l_extendedprice"][keep]
    disc = li["l_discount"][keep]
    if not keep.any():
        return [(None,)], 0
    total = sum(int(p) * (100 - int(d)) for p, d in zip(price, disc))
    return [(decimal.Decimal(total).scaleb(-4),)], int(keep.sum())


def lineitem_double_arrays(arrays):
    """q1's lineitem in its double form (TPCHTables(useDoubleForDecimal
    = true) in databricks/spark-sql-perf): the money and quantity
    columns as doubles, the decimal form's unscaled integers / 100."""
    return [a.astype(np.float64) / 100.0 for a in arrays[:4]] + \
        list(arrays[4:])


def lineitem_double_fields():
    from spark_rapids_tpu_torch.sql import types as T
    return [(n, T.DoubleT if i < 4 else dt)
            for i, (n, dt) in enumerate(lineitem_fields())]


def q1_double_reference(darrays):
    """q1 over the double columns: per group, ``math.fsum`` of each
    per-row value computed with numpy in the query's operation order
    (the correctly rounded sum of those doubles), the averages as that
    sum over the count. Rows are (rf, ls, 7 floats, count) sorted."""
    import math
    qty, price, disc, tax, rf, ls, ship = darrays
    cutoff = (np.datetime64("1998-09-02")
              - np.datetime64("1970-01-01")).astype(int)
    keep = ship <= cutoff
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    rows = []
    for f in ("A", "N", "R"):
        for s in ("F", "O"):
            m = keep & (rf == f) & (ls == s)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            sums = [math.fsum(a[m].tolist())
                    for a in (qty, price, disc_price, charge, disc)]
            rows.append((f, s, sums[0], sums[1], sums[2], sums[3],
                         sums[0] / cnt, sums[1] / cnt, sums[4] / cnt, cnt))
    return rows


def check_q1_double_rows(got, want, rel_tol: float = 1e-12) -> float:
    """Keys and counts exact, every sum and average within ``rel_tol``;
    returns the largest relative error seen."""
    import math
    if len(got) != len(want):
        raise AssertionError(f"q1 double: {len(got)} rows, want {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        g = tuple(g)
        if g[:2] != w[:2] or g[9] != w[9]:
            raise AssertionError(f"q1 double row {g} != {w}")
        for v, e in zip(g[2:9], w[2:9]):
            if not isinstance(v, float) or not math.isclose(
                    v, e, rel_tol=rel_tol):
                raise AssertionError(f"q1 double row {g}: {v!r} vs {e!r}")
            worst = max(worst, abs(v - e) / abs(e))
    return worst


BATTERY_ROWS = 1_000_000
BATTERY_SEED = 20260733


def battery_batch(n: int = BATTERY_ROWS, seed: int = BATTERY_SEED):
    """The expression battery's seeded table: ints, longs and doubles
    (NaN, infinities, -0.0 sprinkled in), strings from a pool of ASCII
    words and cast inputs, dates from 1900 to 2100, timestamps, a small
    int, a boolean and a decimal(10,2); every column about 10% null.
    Returns ``(fields, arrays, validities)`` for
    ``interop.host_batch_from_numpy``."""
    from spark_rapids_tpu_torch.sql import types as T
    rng = np.random.default_rng(seed)
    i = rng.integers(-1000, 1001, n).astype(np.int32)
    i[rng.integers(0, n, 8)] = np.iinfo(np.int32).min
    lg = rng.integers(-(1 << 62), 1 << 62, n)
    lg[rng.integers(0, n, n // 4)] = rng.integers(-100, 100, n // 4)
    d = rng.normal(0.0, 1000.0, n)
    for v in (np.nan, np.inf, -np.inf, -0.0, 0.0):
        d[rng.integers(0, n, 50)] = v
    p = rng.uniform(-1.0, 1.0, n)
    words = ["", " ", "a", "abc", "ab c", "  pad  ", "xyzzy", "Hello World",
             "bab", "aabbcc", "caba", "MAIL", "SHIP", "b a b"]
    letters = np.array(list("abcxyz AB"))
    pool = np.array(words + ["".join(rng.choice(letters, k))
                             for k in rng.integers(0, 13, 2000)],
                    dtype=object)
    s = pool[rng.integers(0, len(pool), n)]
    s2 = pool[rng.integers(0, len(pool), n)]
    casts = np.array(["12", "-7", "+5", " 42 ", "99999999999999999999",
                      "12.5", "abc", "", "9223372036854775807", "0012",
                      "true", "FALSE", "t", "no", "2021-03-05",
                      "1999-12-31", "2020-02-29", "2019-02-29", "2021-3-5",
                      " 2021-03-05 ", "0001-01-01"], dtype=object)
    ns = casts[rng.integers(0, len(casts), n)]
    lo, hi = -25567, 47482  # 1900-01-01, 2099-12-31
    dt = rng.integers(lo, hi + 1, n).astype(np.int32)
    dt2 = rng.integers(lo, hi + 1, n).astype(np.int32)
    ts = dt.astype(np.int64) * 86_400_000_000 + rng.integers(
        0, 86_400_000_000, n)
    secs = rng.integers(-2_000_000_000, 4_000_000_000, n)
    small = rng.integers(-3, 70, n).astype(np.int32)
    b = rng.random(n) < 0.5
    m = rng.integers(-10**9, 10**9, n)
    fields = [("i", T.IntegerT), ("l", T.LongT), ("d", T.DoubleT),
              ("p", T.DoubleT), ("s", T.StringT), ("s2", T.StringT),
              ("ns", T.StringT), ("dt", T.DateT), ("dt2", T.DateT),
              ("ts", T.TimestampT), ("secs", T.LongT), ("n", T.IntegerT),
              ("b", T.BooleanT), ("m", T.DecimalType(10, 2))]
    arrays = [i, lg, d, p, s, s2, ns, dt, dt2, ts, secs, small, b, m]
    valid = [rng.random(n) >= 0.1 for _ in arrays]
    return fields, arrays, valid


def battery_frames(session):
    """``{family: (DataFrame, approx)}`` over the view ``bt``: each
    family's expressions as one projection behind a filter (so the chain
    fuses into one stage program, a CUDA graph on the card), the
    partition-id expressions as an unfused projection, and the
    aggregates behind a filter (a fused partial-aggregate stage).
    ``approx`` marks the families with transcendentals or float sums."""
    from spark_rapids_tpu_torch.sql import expressions as E
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql import types as T
    df = session.table("bt")

    def c(name):
        return F.col(name).expr

    def X(cls, *args):
        return F.Column(cls(*args))

    def lit(v):
        return E.Literal(v)

    keep = (F.col("n") % 7) != 3
    fam = {
        "arith": ([F.col("d") / F.col("p"),
                   X(E.IntegralDivide, c("l"), c("i")),
                   F.col("l") % F.col("i"), F.col("d") % F.col("p"),
                   X(E.Pmod, c("i"), c("n")), X(E.Pmod, c("d"), c("p")),
                   -F.col("l"), F.abs(F.col("i")), F.abs(F.col("d")),
                   F.col("m") / F.col("m"), -F.col("m"),
                   F.col("m") * F.col("m") + F.col("m")], False),
        "conditional": ([F.col("i").eqNullSafe(F.col("n")),
                         F.col("i").isin(1, 2, 3, -5),
                         F.col("s").isin("abc", "MAIL", ""),
                         F.isnan(F.col("d")),
                         X(E.If, c("b"), c("l"), E.UnaryMinus(c("l"))),
                         F.Column(E.CaseWhen(
                             [(E.GreaterThan(c("i"), lit(100)), c("s")),
                              (E.LessThan(c("i"), lit(-100)), c("s2"))],
                             lit("mid"))),
                         F.coalesce(F.col("i"), F.col("n"), F.lit(0)),
                         F.greatest(F.col("d"), F.col("p"), F.lit(0.5)),
                         F.least(F.col("i"), F.col("n")),
                         (F.col("b") | F.col("i").isNull())
                         & ~(F.col("s") == F.col("s2"))], False),
        "math": ([X(cls, c("d")) for cls in (
                     E.Sqrt, E.Exp, E.Sin, E.Cos, E.Tan, E.Atan, E.Sinh,
                     E.Cosh, E.Tanh, E.Signum, E.Log, E.Log10, E.Log2,
                     E.Log1p, E.Floor, E.Ceil, E.Cbrt, E.Rint,
                     E.ToDegrees, E.ToRadians)]
                 + [X(E.Asin, c("p")), X(E.Acos, c("p")),
                    X(E.Expm1, E.Divide(c("d"), lit(1000.0))),
                    F.pow(F.col("p"), F.col("d") / 1000.0),
                    F.round(F.col("d"), 2), F.round(F.col("d")),
                    F.round(F.col("i"), -1), F.round(F.col("d"), -2),
                    X(E.Atan2, c("d"), c("p")), X(E.Hypot, c("d"), c("p"))],
                 True),
        "bitwise": ([F.col("l").bitwiseAND(F.col("i")),
                     F.col("l").bitwiseOR(F.col("i")),
                     F.col("i").bitwiseXOR(F.col("n")),
                     F.bitwise_not(F.col("i")),
                     F.shiftleft(F.col("l"), F.col("n")),
                     F.shiftright(F.col("i"), F.col("n")),
                     F.shiftrightunsigned(F.col("l"), F.col("n")),
                     F.shiftrightunsigned(F.col("i"), F.col("n"))], False),
        "strings": ([F.length(F.col("s")), F.upper(F.col("s")),
                     F.lower(F.col("s")), F.trim(F.col("s")),
                     F.ltrim(F.col("s")), F.rtrim(F.col("s")),
                     F.concat(F.col("s"), F.lit("_x"), F.col("s2")),
                     F.substring(F.col("s"), 2, 3),
                     F.col("s").startswith("a"), F.col("s").endswith("c"),
                     F.col("s").contains("ab"), F.col("s").like("%ab%"),
                     F.col("s").like("a%c"), F.col("s").like("abc"),
                     F.instr(F.col("s"), "b"),
                     F.locate("b", F.col("s"), 2)], False),
        "strings_build": ([F.concat_ws("-", F.col("s"), F.col("s2")),
                           F.repeat(F.col("s"), 2),
                           F.lpad(F.col("s"), 8, "xy"),
                           F.rpad(F.col("s"), 8, "xy"),
                           F.translate(F.col("s"), "abc", "XY"),
                           F.replace(F.col("s"), F.lit("a"), F.lit("zz")),
                           F.initcap(F.col("s")), F.reverse(F.col("s")),
                           F.ascii(F.col("s")), F.chr(F.col("n"))], False),
        "dates": ([F.year(F.col("dt")), F.month(F.col("dt")),
                   F.dayofmonth(F.col("dt")), F.hour(F.col("ts")),
                   F.minute(F.col("ts")), F.second(F.col("ts")),
                   F.date_add(F.col("dt"), F.col("n")),
                   F.date_sub(F.col("dt"), F.col("n")),
                   F.datediff(F.col("dt"), F.col("dt2")),
                   F.quarter(F.col("dt")), F.dayofweek(F.col("dt")),
                   F.weekday(F.col("dt")), F.dayofyear(F.col("dt")),
                   F.weekofyear(F.col("dt")), F.last_day(F.col("dt")),
                   F.add_months(F.col("dt"), F.col("n")),
                   F.months_between(F.col("ts"), F.col("dt2")),
                   F.trunc(F.col("dt"), "month"),
                   F.trunc(F.col("dt"), "week"),
                   F.date_format(F.col("ts"), "yyyy-MM-dd HH:mm:ss"),
                   F.from_unixtime(F.col("secs")),
                   F.unix_timestamp(F.col("ts")),
                   F.to_date(F.date_format(F.col("dt"), "yyyy-MM-dd"),
                             "yyyy-MM-dd"),
                   F.to_timestamp(F.col("ns"), "yyyy-MM-dd")], True),
        "hashes": ([F.hash(F.col("i"), F.col("l"), F.col("d"),
                           F.col("s"), F.col("dt")),
                    F.hash(F.col("b"), F.col("m")),
                    F.xxhash64(F.col("i"), F.col("l"), F.col("d"),
                               F.col("s"), F.col("dt"), F.col("m"))],
                   False),
        "casts": ([F.col("ns").cast(t) for t in (
                       T.IntegerT, T.LongT, T.ShortT, T.BooleanT, T.DateT)]
                  + [F.col(n).cast(T.StringT)
                     for n in ("i", "l", "b", "dt")]
                  + [F.col("d").cast(t)
                     for t in (T.IntegerT, T.LongT, T.ByteT, T.FloatT)]
                  + [F.col("l").cast(T.DoubleT), F.col("m").cast(T.DoubleT),
                     F.col("i").cast(T.DecimalType(12, 2)),
                     F.col("m").cast(T.IntegerT),
                     F.col("dt").cast(T.TimestampT),
                     F.col("ts").cast(T.DateT)], False),
    }
    out = {name: (df.filter(keep).select(
        *[e.alias(f"c{j}") for j, e in enumerate(cols)]), approx)
        for name, (cols, approx) in fam.items()}
    out["ids"] = (df.select(
        F.col("i"), F.monotonically_increasing_id().alias("id"),
        F.spark_partition_id().alias("pid")), False)
    out["aggregates"] = (df.filter(keep).groupBy(
        (F.col("i") % 97).alias("k")).agg(
        F.sum("d").alias("sd"), F.avg("d").alias("ad"),
        F.stddev_samp("p").alias("sp"), F.var_pop("p").alias("vp"),
        F.first("l").alias("fl"), F.last("s", True).alias("ls"),
        F.first("s2", True).alias("fs"), F.min("d").alias("mn"),
        F.max("d").alias("mx"), F.count("*").alias("c"))
        .orderBy("k"), True)
    return out


def battery_session(device):
    """A session over the battery table on ``device``: incompatibleOps
    (the byte-level string operators) and variableFloatAgg on."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    s = TorchSparkSession({"spark.rapids.sql.incompatibleOps.enabled":
                           "true",
                           "spark.rapids.sql.variableFloatAgg.enabled":
                           "true"}, device=device)
    return s, host_batch_from_numpy


def compare_host_batches(got, want, approx: bool, rel_tol: float = 1e-12):
    """Column by column: validity equal, values equal where valid (NaN
    equal to NaN, -0.0 distinct from 0.0), floats within ``rel_tol``
    where ``approx``. Returns the largest relative float error; raises
    on any mismatch."""
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{got.num_rows} rows, want {want.num_rows}")
    worst = 0.0
    for j, (g, w) in enumerate(zip(got.columns, want.columns)):
        if not np.array_equal(g.validity, w.validity):
            raise AssertionError(f"column {j}: validity differs")
        v = w.validity
        gd, wd = np.asarray(g.data)[v], np.asarray(w.data)[v]
        if gd.dtype.kind == "f":
            both_nan = np.isnan(gd) & np.isnan(wd)
            same = (gd == wd) & (np.signbit(gd) == np.signbit(wd))
            if approx:
                with np.errstate(invalid="ignore", divide="ignore"):
                    diff = np.abs(gd - wd)
                    scale = np.maximum(np.abs(wd), 1e-300)
                    rel = np.where(both_nan | (gd == wd), 0.0,
                                   diff / scale)
                worst = max(worst, float(np.max(rel, initial=0.0)))
                same = same | (rel <= rel_tol)
            if not np.all(same | both_nan):
                bad = np.nonzero(~(same | both_nan))[0][:3]
                raise AssertionError(
                    f"column {j}: {gd[bad]} vs {wd[bad]}")
        elif not np.array_equal(gd, wd):
            bad = np.nonzero(gd != wd)[0][:3]
            raise AssertionError(f"column {j}: {gd[bad]} vs {wd[bad]}")
    return worst


T_START = time.perf_counter()


PHASE_LOG = {"path": os.path.join("chiprun_out", "phases.jsonl"),
             "mode": "w"}  # the run's first line starts the file anew


def phase(name: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started;
    also written to ``chiprun_out/phases.jsonl``, where no output tail
    cuts it (the file holds this run's lines only)."""
    line = json.dumps({"phase": name, **fields,
                       "elapsed_s": round(time.perf_counter() - T_START, 1)})
    print(line, flush=True)
    os.makedirs(os.path.dirname(PHASE_LOG["path"]), exist_ok=True)
    with open(PHASE_LOG["path"], PHASE_LOG["mode"]) as f:
        f.write(line + "\n")
    PHASE_LOG["mode"] = "a"


def lineitem_arrays(n: int = SF1_ROWS, seed: int = SEED):
    """The seeded SF1 lineitem of bench.py's generator: decimal(15,2)
    money columns as unscaled int64, dates as days since the epoch."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n) * 100
    extendedprice = rng.integers(90100, 10494951, n)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    returnflag = np.array(["A", "N", "R"], dtype=object)[
        rng.integers(0, 3, n)]
    linestatus = np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)]
    lo = (np.datetime64("1992-01-02") - np.datetime64("1970-01-01")).astype(
        int)
    hi = (np.datetime64("1998-12-01") - np.datetime64("1970-01-01")).astype(
        int)
    shipdate = rng.integers(lo, hi + 1, n).astype(np.int32)
    return [quantity, extendedprice, discount, tax, returnflag, linestatus,
            shipdate]


def lineitem_fields():
    """(name, port DataType) of the arrays ``lineitem_arrays`` makes."""
    from spark_rapids_tpu_torch.sql import types as T
    dec = T.DecimalType(15, 2)
    return [("l_quantity", dec), ("l_extendedprice", dec),
            ("l_discount", dec), ("l_tax", dec),
            ("l_returnflag", T.StringT), ("l_linestatus", T.StringT),
            ("l_shipdate", T.DateT)]


def decode_corpus(root: str, q1_rows: int = 20_000) -> dict:
    """One Parquet file per device-decode case, written with pyarrow
    under ``root`` (the cases of tests/test_device_decode.py): PLAIN,
    dictionary, nulls at 512-byte page boundaries, integer and string
    dictionary overflow into PLAIN mid-chunk, decimal128 FLBA,
    DELTA_BINARY_PACKED with nulls, DELTA_LENGTH_BYTE_ARRAY,
    BYTE_STREAM_SPLIT float/int/double, data page v2, booleans and
    timestamp micros, PLAIN strings with empties and nulls, narrow ints
    and binary, a DELTA_BYTE_ARRAY column (host-decoded) beside a device
    column, and a q1 ``lineitem`` row group of ``q1_rows`` rows. Returns
    {case: path}."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow

    def nulls_every(vals, k, phase=0):
        return [None if i % k == phase else v for i, v in enumerate(vals)]

    def mixed(n, seed, with_nulls):
        rng = np.random.default_rng(seed)
        k = 7 if with_nulls else n + 1
        return pa.table({
            "i64": pa.array(nulls_every(rng.integers(
                -(1 << 40), 1 << 40, n).tolist(), k), type=pa.int64()),
            "i32": pa.array(nulls_every(rng.integers(
                -(1 << 30), 1 << 30, n).tolist(), k), type=pa.int32()),
            "f32": pa.array(nulls_every(rng.standard_normal(n).astype(
                "float32").tolist(), k), type=pa.float32()),
            "f64": pa.array(nulls_every(rng.standard_normal(n).tolist(),
                                        k, 2), type=pa.float64()),
            "dec": pa.array(nulls_every(rng.integers(
                -10**9, 10**9, n).tolist(), k), type=pa.decimal128(15, 2)),
            "s": pa.array(nulls_every([f"word{i % 11}" for i in range(n)],
                                      k, 3)),
            "d": pa.array(nulls_every(rng.integers(
                -1000, 20000, n).astype("int32").tolist(), k),
                type=pa.date32()),
            "b": pa.array(nulls_every((rng.integers(0, 2, n) > 0)
                                      .tolist(), k), type=pa.bool_()),
        })

    rng = np.random.default_rng(7)
    n = 6000
    page_nulls = pa.table({
        "v": pa.array([None if (i // 50) % 2 == 0 else i * 3
                       for i in range(n)], type=pa.int64()),
        "s": pa.array([None if (i // 37) % 3 == 1 else f"s{i % 5}"
                       for i in range(n)])})
    big = [None if i % 11 == 0 else
           int(rng.integers(-10**9, 10**9)) * 10**10 + i for i in range(2000)]
    dl_vals = ["" if i % 13 == 0 else None if i % 17 == 0
               else f"dl-{i % 97}-{'y' * (i % 9)}" for i in range(5000)]
    plain_str = [None if (i // 37) % 3 == 1 else "" if i % 11 == 0
                 else "x" * (i % 23) + f"#{i}" for i in range(6000)]
    cases = {
        "plain": (mixed(4000, 0, False), {"use_dictionary": False}),
        "dict": (mixed(4000, 1, True), {}),
        "page_nulls": (page_nulls, {"data_page_size": 512}),
        "int_dict_overflow": (pa.table({"x": pa.array(
            rng.integers(0, 1 << 40, 30_000), type=pa.int64())}),
            {"dictionary_pagesize_limit": 20_000, "data_page_size": 4096}),
        "str_dict_overflow": (pa.table({"s": pa.array(
            [f"prefix-{int(v)}-suffix" for v in
             rng.integers(0, 6000, 12_000)])}),
            {"dictionary_pagesize_limit": 8_000, "data_page_size": 4096}),
        "dec128_flba": (pa.table({"d": pa.array(
            big, type=pa.decimal128(25, 2))}), {}),
        "delta_nulls": (pa.table({
            "v": pa.array([None if (i // 41) % 3 == 0 else
                           (i * 7919) % (1 << 40) - 17 for i in range(9000)],
                          type=pa.int64()),
            "w": pa.array(rng.integers(-(1 << 62), 1 << 62, 9000),
                          type=pa.int64()),
            "i32": pa.array(rng.integers(-(1 << 30), 1 << 30, 9000)
                            .astype("int32"), type=pa.int32())}),
            {"use_dictionary": False,
             "column_encoding": "DELTA_BINARY_PACKED",
             "data_page_size": 1024}),
        "delta_length": (pa.table({
            "s": pa.array(dl_vals),
            "i": pa.array(np.arange(5000), type=pa.int64())}),
            {"use_dictionary": False,
             "column_encoding": {"s": "DELTA_LENGTH_BYTE_ARRAY",
                                 "i": "PLAIN"},
             "data_page_size": 2048}),
        "bss": (pa.table({
            "f": pa.array(rng.standard_normal(4000).astype("float32"),
                          type=pa.float32()),
            "d": pa.array(rng.standard_normal(4000), type=pa.float64()),
            "i64": pa.array(rng.integers(-(1 << 50), 1 << 50, 4000),
                            type=pa.int64()),
            "i32": pa.array(rng.integers(-(1 << 30), 1 << 30, 4000)
                            .astype("int32"), type=pa.int32())}),
            {"use_dictionary": False,
             "column_encoding": "BYTE_STREAM_SPLIT",
             "data_page_size": 4096}),
        "page_v2": (mixed(3000, 18, True),
                    {"data_page_version": "2.0", "data_page_size": 2048}),
        "bool_ts": (pa.table({
            "b": pa.array(nulls_every((rng.integers(0, 2, 5000) > 0)
                                      .tolist(), 9), type=pa.bool_()),
            "ts": pa.array(nulls_every(rng.integers(
                0, 2_000_000_000_000_000, 5000).tolist(), 13),
                type=pa.timestamp("us"))}),
            {"use_dictionary": False, "data_page_size": 1024}),
        "plain_strings": (pa.table({"s": pa.array(plain_str)}),
                          {"use_dictionary": False,
                           "data_page_size": 512}),
        "narrow_ints_binary": (pa.table({
            "i8": pa.array(nulls_every(rng.integers(-128, 128, 3000)
                                       .tolist(), 5), type=pa.int8()),
            "i16": pa.array(rng.integers(-32768, 32768, 3000),
                            type=pa.int16()),
            "bin": pa.array([rng.bytes(int(rng.integers(0, 19)))
                             for _ in range(3000)], type=pa.binary())}),
            {"use_dictionary": ["i8"], "data_page_size": 2048}),
        "delta_byte_array_mixed": (pa.table({
            "dba": pa.array([f"prefix-common-{i}" for i in range(3000)]),
            "ok": pa.array(np.arange(3000), type=pa.int64())}),
            {"use_dictionary": False,
             "column_encoding": {"dba": "DELTA_BYTE_ARRAY",
                                 "ok": "PLAIN"}}),
        "q1_row_group": (host_batch_to_arrow(host_batch_from_numpy(
            lineitem_fields(), lineitem_arrays(q1_rows))), {}),
    }
    os.makedirs(root, exist_ok=True)
    out = {}
    for name, (tbl, kw) in cases.items():
        out[name] = os.path.join(root, f"{name}.parquet")
        pq.write_table(tbl, out[name], **kw)
    return out


def _half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return -q if num < 0 else q


# the references of the arrays and tables this run made, by identity: every
# phase that checks q1 or q3 over the same data reads one computation
_REFERENCES: dict = {}


def _memo(kind: str, data, key, compute):
    hit = _REFERENCES.get((kind, id(data), key))
    if hit is None or hit[0] is not data:
        while len(_REFERENCES) >= 8:  # the newest few: they hold their data
            del _REFERENCES[next(iter(_REFERENCES))]
        hit = _REFERENCES[(kind, id(data), key)] = (data, compute())
    return hit[1]


def q1_reference(arrays, shipdate: str = "1998-09-02"):
    """Exact q1 rows: unscaled sums as Python ints, the products at scale
    4 and 6, avg as HALF_UP at scale 6 (Spark's avg(decimal(15,2)) is
    decimal(19,6)). Returns [(rf, ls, (value, scale)...)] sorted.
    ``shipdate`` is the query's bound (``q1_text``); computed once for a
    given ``arrays`` object and bound."""
    return _memo("q1", arrays, shipdate,
                 lambda: _q1_reference(arrays, shipdate))


def _q1_reference(arrays, shipdate: str):
    qty, price, disc, tax, rf, ls, ship = arrays
    cutoff = (np.datetime64(shipdate)
              - np.datetime64("1970-01-01")).astype(int)
    keep = ship <= cutoff
    disc_price = price * (100 - disc)                # scale 4
    charge = disc_price * (100 + tax)                # scale 6
    rows = []
    for f in ("A", "N", "R"):
        for s in ("F", "O"):
            m = keep & (rf == f) & (ls == s)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            sq = int(qty[m].sum(dtype=np.int64))
            sp = int(price[m].sum(dtype=np.int64))
            sd = int(disc_price[m].sum(dtype=np.int64))
            sc = int(charge[m].sum(dtype=np.int64))
            sdisc = int(disc[m].sum(dtype=np.int64))
            rows.append((f, s, (sq, 2), (sp, 2), (sd, 4), (sc, 6),
                         (_half_up_div(sq * 10**4, cnt), 6),
                         (_half_up_div(sp * 10**4, cnt), 6),
                         (_half_up_div(sdisc * 10**4, cnt), 6), cnt))
    return rows


def check_q1_rows(got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"q1: {len(got)} rows, want {len(want)}")
    for g, w in zip(got, want):
        g = tuple(g)
        if g[:2] != w[:2] or g[9] != w[9]:
            raise AssertionError(f"q1 row {g} != {w}")
        for v, (unscaled, scale) in zip(g[2:9], w[2:9]):
            exp = decimal.Decimal(unscaled).scaleb(-scale)
            if not isinstance(v, decimal.Decimal) or v != exp \
                    or v.as_tuple().exponent != -scale:
                raise AssertionError(f"q1 row {g}: {v!r} != {exp}")


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: a spin kernel holds the
    stream while the host enqueues all calls, so the events time the
    launches back to back rather than the host's enqueue rate. A call
    whose enqueue outlasts the spin (many launches a call) is timed again
    behind a spin long enough to cover it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = 100_000_000  # cycles, about 50 ms at the H100's clocks
    for _ in range(2):
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s < 0.025:
            break
        spin = int(spin * enqueue_s / 0.02)
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


def find_exec(plan, pred):
    """The first node of ``plan`` (fused-stage constituents included)
    that ``pred`` accepts."""
    for node in [plan] + list(getattr(plan, "fused_ops", [])):
        if pred(node):
            return node
    for c in plan.children:
        hit = find_exec(c, pred)
        if hit is not None:
            return hit
    return None


def plan_nodes_of(plan):
    out = [plan]
    for c in plan.children:
        out += plan_nodes_of(c)
    return out


def plan_names(plan):
    return [type(p).__name__ for p in plan_nodes_of(plan)]


def r2c_metrics(plan) -> dict:
    """The summed metrics of every row-to-columnar transition of an
    executed plan."""
    from spark_rapids_tpu_torch.exec.base import TorchRowToColumnarExec
    out: dict = {}
    for p in plan_nodes_of(plan):
        if isinstance(p, TorchRowToColumnarExec):
            for k, v in p.metrics.snapshot().items():
                out[k] = out.get(k, 0) + v
    return out


def check_default_ring(plan, want_ahead: bool, what: str) -> dict:
    """With the ring's key unset, the upload runs ahead over a file scan
    of several units a partition and not over data in host memory;
    every upload is copied from a pinned slot on the ring's copy
    stream either way. Returns the R2C's counters."""
    m = r2c_metrics(plan)
    ahead = m.get("uploadAheadBatches", 0)
    pinned = m.get("pinnedStreamCopies", 0)
    if (ahead > 0) != want_ahead or pinned != m["numOutputBatches"]:
        raise AssertionError(
            f"{what} with the ring's key unset: uploadAheadBatches "
            f"{ahead}, pinnedStreamCopies {pinned} of "
            f"{m['numOutputBatches']} uploads")
    return {"upload_ahead_batches": ahead, "pinned_stream_copies": pinned,
            "r2c_batches": m["numOutputBatches"]}


def table_rows(owner, add, mn, mx):
    """{first row: (add lanes, min lanes, max lanes)} of the used slots."""
    owner = owner.cpu().numpy()
    add, mn, mx = add.cpu().numpy(), mn.cpu().numpy(), mx.cpu().numpy()
    return {int(owner[s]): (add[s], mn[s], mx[s])
            for s in np.nonzero(owner >= 0)[0]}


def compare_tables(got, want) -> int:
    """Max |difference| over every lane of matching groups; raises when
    the group sets differ."""
    if set(got) != set(want):
        raise AssertionError(f"groupbyHash: groups {sorted(got)[:8]} != "
                             f"{sorted(want)[:8]}")
    err = 0
    for k, lanes in got.items():
        for a, b in zip(lanes, want[k]):
            d = np.abs(a.astype(object) - b.astype(object))
            err = max(err, int(d.max()) if d.size else 0)
    return err


def lane_count(t, rows: int) -> int:
    """Lanes in a groupbyHash lane matrix of ``rows`` rows."""
    return t.numel() // rows if rows else 0


def groupby_case(ins, slots: int, reps: int = 20,
                 overflow_ok: bool = False, ref_slots: int = 0,
                 plain_reps: int = 3) -> dict:
    """groupbyHash against its plain version on ``ins`` (exact, no
    overflow in either), then its device time beside its byte bound: the
    inputs read once and the ``slots``-row tables written once.

    With ``overflow_ok`` an overflow flag is a result, as in the exec,
    which discards an overflowed table and re-runs its batch on the
    sort-based partial aggregate: the flags are reported, and a table
    the kernel completed is held exactly against the plain version's at
    the least doubled table size at which the plain version completes
    (a group's lanes do not depend on its slot), doubling from
    ``ref_slots`` where given. ``plain_reps`` 0 reports the plain
    version's time from its one checked call (a batch it takes seconds
    on)."""
    import torch
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    k_out = KG.groupby_table(*ins, slots)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = KG.groupby_table_plain(*ins, slots)
    torch.cuda.synchronize()
    checked_plain_ms = (time.perf_counter() - t0) * 1e3
    k_ovf, p_ovf = int(k_out[4].item()), int(p_out[4].item())
    if (k_ovf or p_ovf) and not overflow_ok:
        raise AssertionError(f"groupbyHash overflowed: kernel {k_ovf}, "
                             f"plain {p_ovf}")
    if p_ovf and ref_slots > slots:
        p_out = KG.groupby_table_plain(*ins, ref_slots)
    ref_slots = max(slots, ref_slots) if p_ovf else slots
    while int(p_out[4].item()):
        ref_slots *= 2
        p_out = KG.groupby_table_plain(*ins, ref_slots)
    err = 0 if k_ovf else compare_tables(table_rows(*k_out[:4]),
                                         table_rows(*p_out[:4]))
    if err:
        raise AssertionError(f"groupbyHash != plain: {err}")
    kw, _h, valid, add, mn, mx = ins
    rows, valid_rows = int(kw.shape[0]), int(valid.sum())
    lanes = [lane_count(t, rows) for t in (add, mn, mx)]
    tables = slots * 4 + 4 + slots * 8 * sum(lanes)
    # what this batch needs: every validity byte, and the key words, hash
    # and lanes of the valid rows only (an invalid row's are never read)
    nbytes = rows + valid_rows * 8 * (int(kw.shape[1]) + 1 + sum(lanes)) \
        + tables
    all_rows = sum(t.numel() * t.element_size() for t in ins) + tables
    return {"rows": rows, "valid_rows": valid_rows,
            "key_words": int(kw.shape[1]), "slots": slots,
            "lanes_add_min_max": lanes,
            "groups": int((k_out[0] >= 0).sum()), "max_abs_err": err,
            "overflow": {"kernel": k_ovf, "plain": p_ovf,
                         "plain_complete_at_slots": ref_slots},
            "ms": cuda_ms(lambda: KG.groupby_table(*ins, slots), reps),
            "plain_ms": wall_ms(lambda: KG.groupby_table_plain(*ins, slots),
                                plain_reps) if plain_reps
            else checked_plain_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes_all_rows": all_rows,
            "bound_all_rows_ms": all_rows / HBM_BYTES_PER_S * 1e3,
            "kernel_us": device_kernels(
                lambda: KG.groupby_table(*ins, slots))["kernel_us"]}


def many_groups_inputs(device, rows: int = 786_432, keys: int = 700,
                       seed: int = 13):
    """groupbyHash inputs with many groups: ``rows`` rows over ``keys``
    distinct two-word keys (hashed as the engine hashes them), 2% of rows
    invalid, q1's 21 add lanes plus one min and one max lane."""
    import torch
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.ops import groupby as G
    rng = np.random.default_rng(seed)
    base = rng.integers(-2**62, 2**62, (keys, 2))
    kw = torch.from_numpy(base[rng.integers(0, keys, rows)]).to(device)
    h = G.hash_subkey_words([kw[:, 0], kw[:, 1]])
    valid = torch.from_numpy(rng.random(rows) > 0.02).to(device)

    def lanes(n):
        return KG._lane_matrix(
            [torch.from_numpy(rng.integers(-2**40, 2**40, rows)).to(device)
             for _ in range(n)], rows, device)
    return kw, h, valid, lanes(21), lanes(1), lanes(1)


def decode_case(path: str, device, reps: int = 20) -> dict:
    """decodeFused's device time on the first row group of ``path``
    beside its byte bound (``kernel_input_bytes`` in, each output's n
    rows out) and the plain version's time."""
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.kernels import decode_fused as DF
    layout, cap, n, w, ex, in_bytes = staged_on_card(path, device)
    active, outs = DF.decode_fused(layout, cap, n, w, ex)
    out_bytes = sum(o.numel() * o.element_size() // cap * n
                    for o in (active,) + tuple(outs))
    kern = device_kernels(lambda: DF.decode_fused(layout, cap, n, w, ex))
    return {"rows": n, "cap": cap,
            "device_columns": sum(e[0] == "dev" for e in layout),
            "bytes_in": in_bytes, "bytes_out": out_bytes,
            "ms": cuda_ms(lambda: DF.decode_fused(layout, cap, n, w, ex),
                          reps),
            "plain_ms": wall_ms(lambda: X._encoded_decode_body(
                layout, cap, w, n, ex), 3),
            "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            "cuda_launches": kern["launches"],
            "kernel_us": kern["kernel_us"]}


def ptxas_report() -> dict:
    """Each kernel's ``-Xptxas -v`` lines (registers, spills, shared
    memory) as ptxas printed them, keyed by the kernel's mangled name,
    from the reports kept beside the libraries of this build."""
    import re
    from spark_rapids_tpu_torch import kernels as KR
    out: dict = {}
    for name in KR.SOURCES:
        path = KR._lib_path(name).with_suffix(".ptxas")
        if not path.exists():
            continue
        fn = None
        for line in path.read_text(errors="replace").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = f"{name}:{m.group(1)}"
            elif fn and ("Used" in line or "spill" in line):
                out.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return out


def device_kernels(fn, calls: int = 7) -> dict:
    """The CUDA kernels the device ran for one call of ``fn``, from
    torch.profiler's device trace of ``calls`` calls (after a warm call):
    ``{"launches": kernels a call, "kernel_us": {name: median device
    microseconds}, "busy_us": device time a call, "span_us": first
    kernel's start to last kernel's end, "gaps_us": the idle time between
    consecutive kernels of a call}``, the last three medians over the
    calls whose count is ``launches``. Calls are 5 ms apart, so each
    call's kernels form one cluster in the trace; the trace can miss an
    event at its start or end, so a call's count is the median
    cluster's. Copies and memsets are not kernels."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            time.sleep(0.005)
    events = sorted(
        (e.start_ns(), e.duration_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and not e.name().startswith(("Memcpy", "Memset")))
    clusters, last_end, times = [], None, {}
    for start, dur, name in events:
        if last_end is None or start - last_end > 2_500_000:
            clusters.append([])
        clusters[-1].append((start, dur))
        last_end = start + dur
        m = re.search(r"(\w+(?:<[^>]*>)?)\(", name)
        times.setdefault(m.group(1) if m else name, []).append(dur / 1e3)
    n = statistics.median_low([len(c) for c in clusters]) if clusters else 0
    full = [c for c in clusters if len(c) == n] if n else []

    def med(vals):
        return statistics.median(vals) if vals else None
    return {"launches": n,
            "kernel_us": {k: statistics.median(v) for k, v in times.items()},
            "busy_us": med([sum(d for _s, d in c) / 1e3 for c in full]),
            "span_us": med([(c[-1][0] + c[-1][1] - c[0][0]) / 1e3
                            for c in full]),
            "gaps_us": [med([(c[i + 1][0] - c[i][0] - c[i][1]) / 1e3
                             for c in full]) for i in range(n - 1)]}


def murmur3_battery(n: int, seed: int):
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    rng = np.random.default_rng(seed)
    pool = np.array(["", "a", "abcd", "abcde", "\x00", "x\x00y", "éä",
                     "ÿþ", "0123456789abcdef", "tailé", "A", "N", "R"],
                    dtype=object)
    fields = [("b", T.BooleanT), ("i", T.IntegerT), ("l", T.LongT),
              ("f", T.FloatT), ("d", T.DoubleT), ("dt", T.DateT),
              ("dec", T.DecimalType(15, 2)), ("s", T.StringT)]
    arrays = [rng.integers(0, 2, n).astype(bool),
              rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(
                  np.int32),
              rng.integers(-2**62, 2**62, n),
              np.where(rng.random(n) < 0.1, -0.0,
                       rng.standard_normal(n)).astype(np.float32),
              np.where(rng.random(n) < 0.1, -0.0, rng.standard_normal(n)),
              rng.integers(-11000, 47000, n).astype(np.int32),
              rng.integers(-10**10, 10**10, n),
              pool[rng.integers(0, len(pool), n)]]
    valid = [rng.random(n) > 0.15 for _ in arrays]
    return host_batch_from_numpy(fields, arrays, valid)


def murmur3_wide_batch(n: int, seed: int):
    """murmur3's widest request: 16 key columns (``MAX_COLS``) of every
    kind the kernel reads, bool, byte and short in their own widths, and
    strings at char caps 8, 16 and 64 with every length up to the cap."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789\x00"
                             "\x7f") + ["é", "ÿ"], dtype=object)

    def strings(cap):
        lens = rng.integers(0, cap + 1, n)
        chars = alphabet[rng.integers(0, len(alphabet), (n, cap))]
        # é and ÿ take two bytes: cut each string back to ``cap`` bytes
        return np.array([("".join(chars[i, :lens[i]]).encode()[:cap]
                          .decode(errors="ignore")) for i in range(n)],
                        dtype=object)
    fields = [("b", T.BooleanT), ("y", T.ByteT), ("h", T.ShortT),
              ("i", T.IntegerT), ("l", T.LongT), ("f", T.FloatT),
              ("d", T.DoubleT), ("dt", T.DateT), ("ts", T.TimestampT),
              ("dec", T.DecimalType(18, 4)), ("s8", T.StringT),
              ("s16", T.StringT), ("s64", T.StringT), ("y2", T.ByteT),
              ("h2", T.ShortT), ("s8b", T.StringT)]
    arrays = [rng.integers(0, 2, n).astype(bool),
              rng.integers(-128, 128, n).astype(np.int8),
              rng.integers(-2**15, 2**15, n).astype(np.int16),
              rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(
                  np.int32),
              rng.integers(-2**62, 2**62, n),
              np.where(rng.random(n) < 0.1, -0.0,
                       rng.standard_normal(n)).astype(np.float32),
              np.where(rng.random(n) < 0.1, -0.0, rng.standard_normal(n)),
              rng.integers(-11000, 47000, n).astype(np.int32),
              rng.integers(-10**15, 10**15, n),
              rng.integers(-10**17, 10**17, n),
              strings(8), strings(16), strings(64),
              rng.integers(-128, 128, n).astype(np.int8),
              rng.integers(-2**15, 2**15, n).astype(np.int16),
              strings(8)]
    valid = [rng.random(n) > 0.15 for _ in arrays]
    return host_batch_from_numpy(fields, arrays, valid)


def profile_collect(df, name: str, card: str, warm: bool = True,
                    host_ops: bool = False) -> dict:
    """One warm ``df.collect()`` under torch.profiler (after a warm-up
    collect unless the caller's runs warmed it): wall, device-busy
    time (sum of device-side event time), idle share and the top device
    kernels; the table goes to ``<name>_profile.txt`` beside the phase
    log. Only the device's activity is traced, read from the profiler's
    raw events: building the per-event objects that ``key_averages``
    needs costs seconds on a run of tens of thousands of events, and
    tracing the host's ops slows the run it measures. With ``host_ops``
    (the ``--breakdown`` runs) the host's ops are traced too, and the
    tables (``key_averages``) also give the top host ops."""
    if warm:
        df.collect()
    return profile_call(df.collect, name, card, host_ops)


def profile_call(run, name: str, card: str,
                 host_ops: bool = False) -> dict:
    """``profile_collect``'s measurement around any call ``run`` (a
    served query's round trip, phase 20): one run under torch.profiler,
    the device traced whichever thread launched its work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not host_ops:
        dev = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                n, ns = dev.get(e.name(), (0, 0))
                dev[e.name()] = (n + 1, ns + e.duration_ns())
        busy_s = sum(ns for _n, ns in dev.values()) / 1e9
        top = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)
        out_dir = os.path.dirname(PHASE_LOG["path"])
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
            f.write(card + "\ndevice us, calls, name\n")
            f.writelines(f"{ns / 1e3:.3f} {n} {k}\n"
                         for k, (n, ns) in top[:40])
        return {"profiled_wall_s": wall, "device_busy_s": busy_s,
                "device_idle_share": 1.0 - busy_s / wall,
                "device_events": sum(n for n, _ns in dev.values()),
                "top_device_us": {k[:60]: ns / 1e3
                                  for k, (_n, ns) in top[:10]}}
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    on_device = [e for e in events
                 if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_device)
    top_dev = sorted(on_device, key=dev_us, reverse=True)[:10]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:10]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"{name}_profile.txt"), "w") as f:
        f.write(card + "\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_device_us": {e.key[:60]: dev_us(e) for e in top_dev},
            "top_host_self_us": {e.key[:60]: e.self_cpu_time_total
                                 for e in top_cpu}}


def breakdown(df, card) -> None:
    """``--breakdown``: where one warm q1 spends its wall, under the
    profiler (``profile_collect``); the upload alone is ``upload_split``."""
    phase("q1_breakdown", card=card,
          **profile_collect(df, "q1", card, host_ops=True))


def repartition_reference(tables) -> dict:
    """Exact rows of the repartition query, independent of any engine:
    ss_item_sk -> (sum of the unscaled ss_ext_sales_price as a Python
    int, row count)."""
    col = {name: a for name, _k, a in tables["store_sales"]}
    keys, inv = np.unique(col["ss_item_sk"], return_inverse=True)
    counts = np.bincount(inv)
    # unscaled prices stay below 1e6 and a group below 1e4 rows, so the
    # int64 sums are exact
    sums = np.zeros(len(keys), dtype=np.int64)
    np.add.at(sums, inv, col["ss_ext_sales_price"])
    return {int(k): (int(v), int(c)) for k, v, c in zip(keys, sums, counts)}


def repartition_df(spark, tables):
    """The repartition query over q3's store_sales (8 partitions)."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql import types as T
    types = {"long": T.LongT, "dec72": T.DecimalType(7, 2)}
    cols = tables["store_sales"]
    sales = spark.createDataFrame(
        host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                              [a for _c, _k, a in cols]),
        num_partitions=Q3_PARTITIONS["store_sales"])
    return sales.repartition(N_PARTITIONS, "ss_item_sk") \
        .groupBy("ss_item_sk") \
        .agg(F.sum("ss_ext_sales_price").alias("s"),
             F.count("*").alias("c"))


def check_repartition_rows(rows, want: dict) -> int:
    got = {}
    for r in rows:
        k, v, c = tuple(r)
        if not isinstance(v, decimal.Decimal) or \
                v.as_tuple().exponent != -2:
            raise AssertionError(f"repartition: sum {v!r} is not a "
                                 "scale-2 Decimal")
        got[int(k)] = (int(v.scaleb(2)), int(c))
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]][:3]
        raise AssertionError(f"repartition: {len(got)} groups, want "
                             f"{len(want)}; first differences at {bad}")
    return len(got)


def repartition_phase(device, card, tables) -> dict:
    """The user repartition path: q3's store_sales (2,000,000 rows in 8
    partitions) through ``.repartition(8, "ss_item_sk")`` (a user's
    exchange keeps its 8 partitions: one murmur3 launch an input batch),
    then ``groupBy("ss_item_sk").agg(sum, count)``, against the exact
    reference; murmur3 held against its plain version at the exchange's
    shape and timed there. Returns the kernel line's murmur3 numbers."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    want = repartition_reference(tables)
    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    df = repartition_df(spark, tables)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    groups = check_repartition_rows(rows, want)
    exchanges = [p.partitioning.num_partitions
                 for p in plan_nodes_of(spark.last_plan)
                 if isinstance(p, TorchShuffleExchangeExec)]
    if launches["murmur3"] != N_PARTITIONS or \
            launches["groupbyHash"] <= 0 or exchanges != [1, N_PARTITIONS]:
        raise AssertionError(f"repartition route: launches {launches}, "
                             f"exchange partitions {exchanges}")
    walls = timed_collects(df)
    phase("repartition", card=card, rows_in=Q3_SALES_ROWS,
          partitions_in=Q3_PARTITIONS["store_sales"],
          repartition=N_PARTITIONS, groups=groups, reference="exact",
          plan=plan_names(spark.last_plan),
          exchange_partitions=exchanges, launches=launches,
          first_run_s=round(first_s, 4),
          rows_per_s=Q3_SALES_ROWS / walls["median_s"], **walls)

    # murmur3 at the exchange's shape: one 250,000-row input batch's
    # key column, with the partition id in the same launch
    keys = next(iter(find_exec(spark.last_plan, lambda p: isinstance(
        p, TorchShuffleExchangeExec) and p.partitioning.num_partitions
        == N_PARTITIONS).child.device_partitions()[0]()))
    key_cols = [keys.columns[1]]
    cap = keys.capacity
    k_out = KM.murmur3_columns(key_cols, cap, 42, n_parts=N_PARTITIONS)
    p_out = torch.remainder(H.murmur3_columns(key_cols, cap, 42)
                            .to(torch.int64), N_PARTITIONS).to(torch.int32)
    torch.cuda.synchronize()
    err = int((k_out.long() - p_out.long()).abs().max())
    if err != 0:
        raise AssertionError(f"murmur3 != plain at the repartition: {err}")
    # the key column and its validity read once, the partition ids
    # written once, for the batch's real rows
    n = keys.row_count()
    nbytes = n * (8 + 1 + 4)
    ms = cuda_ms(lambda: KM.murmur3_columns(key_cols, cap, 42,
                                            n_parts=N_PARTITIONS), 50)
    plain_ms = wall_ms(lambda: torch.remainder(H.murmur3_columns(
        key_cols, cap, 42).to(torch.int64), N_PARTITIONS), 5)
    kern = device_kernels(lambda: KM.murmur3_columns(
        key_cols, cap, 42, n_parts=N_PARTITIONS))
    case = {"rows": n, "cap": cap, "n_parts": N_PARTITIONS, "ms": ms,
            "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "cuda_launches": kern["launches"],
            "kernel_us": kern["kernel_us"], "max_abs_err": err}
    phase("repartition_murmur3", card=card, tolerance="exact", **case)
    return {"launches": launches["murmur3"], "case": case}


def upload_split(fields, arrays, device, card) -> None:
    """Where q1's upload from memory spends its time, over the 8
    partitions of 750,152 rows (summed): the string encoding by this
    port's ``"".join`` route and, beside it, by the JAX package's
    code-point route that it replaced; the rest of the packing (null
    normalisation and narrowing); writing the staged buffers into one
    host buffer; the host-to-device copy; the decode on the card. The
    write and the copy are taken on pageable memory (a fresh buffer, as
    ``upload_batch`` does) and on pinned memory (a slot allocated
    before, as the upload ring reuses it). Then the whole upload of the
    8 partitions through ``DeviceBatch.from_host``
    (``upload_8_partitions_s``)."""
    import torch
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        bucket_capacity,
                                                        is_string_like)
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    whole = host_batch_from_numpy(fields, arrays)
    per = (whole.num_rows + N_PARTITIONS - 1) // N_PARTITIONS
    parts = [whole.slice(i * per, (i + 1) * per)
             for i in range(N_PARTITIONS)]
    acc = {k: 0.0 for k in (
        "strings_join_s", "strings_codepoints_s", "pack_s",
        "pageable_write_s", "pageable_h2d_s", "pinned_alloc_s",
        "pinned_write_s", "pinned_h2d_s", "decode_s")}
    staged_bytes = 0
    for p in parts:
        n = p.num_rows
        for f, c in zip(p.schema.fields, p.columns):
            if is_string_like(f.data_type):
                v = np.ascontiguousarray(c.validity[:n])
                t0 = time.perf_counter()
                a = X._ascii_join(c.data, v, n)
                acc["strings_join_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                b = X._ascii_codepoints(c.data, v, n)
                acc["strings_codepoints_s"] += time.perf_counter() - t0
                if a is None or b is None or a[0].tobytes() != \
                        b[0].tobytes() or a[1].tobytes() != b[1].tobytes():
                    raise AssertionError("string routes differ")
        t0 = time.perf_counter()
        staged = X.prepare_upload(p, bucket_capacity(n))
        acc["pack_s"] += time.perf_counter() - t0
        wires, offsets, total = X.wire_layout(staged)
        staged_bytes += total
        t0 = time.perf_counter()
        pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        acc["pinned_alloc_s"] += time.perf_counter() - t0
        for mem, host in (("pageable", None), ("pinned", pinned)):
            t0 = time.perf_counter()
            if host is None:
                host = torch.empty(total, dtype=torch.uint8)
            X.write_wires(wires, offsets, host.numpy())
            acc[f"{mem}_write_s"] += time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = torch.empty(total, dtype=torch.uint8, device=device)
            dev.copy_(host, non_blocking=True)
            torch.cuda.synchronize()
            acc[f"{mem}_h2d_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        X.decode_staged(staged, dev, offsets)
        torch.cuda.synchronize()
        acc["decode_s"] += time.perf_counter() - t0
    acc["normalise_narrow_s"] = acc["pack_s"] - acc["strings_join_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in parts:
        DeviceBatch.from_host(p, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    phase("upload_split", card=card, partitions=N_PARTITIONS,
          rows=whole.num_rows, staged_bytes=staged_bytes,
          pageable_gb_per_s=staged_bytes / acc["pageable_h2d_s"] / 1e9,
          pinned_gb_per_s=staged_bytes / acc["pinned_h2d_s"] / 1e9,
          upload_8_partitions_s=upload_s, **acc)


def ring_phases(card, fields, arrays, q1_dir, tables) -> None:
    """The main paths with the upload ring off (``maxInFlight`` 0) and at
    its default depth 2, in turns (0, 2). q1 at SF1 from memory and from
    Parquet: rows
    exact, the walls (one warm run, mean of two), the device's idle
    share from one profiled run, and the ring's counters
    (``uploadAheadBatches`` must be 0 at depth 0 and above 0 at depth
    2; ``pinnedStreamCopies`` must count every upload at both). Both q3
    forms and the repartition path: rows exact and the walls. Then
    ``ring_runs``: the repartition path run by run at both depths."""
    import torch
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    want = q1_reference(arrays)
    want_q3 = q3_reference(tables)
    want_rp = repartition_reference(tables)
    batch = host_batch_from_numpy(fields, arrays)
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    for turn, depth in enumerate((0, 2)):
        spark = TorchSparkSession({
            "spark.sql.shuffle.partitions": str(N_PARTITIONS),
            "spark.rapids.sql.format.parquet.deviceDecode.maxInFlight":
                str(depth)})
        spark.createDataFrame(batch, num_partitions=N_PARTITIONS) \
            .createOrReplaceTempView("lineitem")
        spark.read.parquet(q1_dir).createOrReplaceTempView("lineitem_pq")
        for name, cols in tables.items():
            spark.createDataFrame(
                host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                                      [a for _c, _k, a in cols]),
                num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
        for source, sql in (("memory", Q1), ("parquet", Q1.replace(
                "FROM lineitem", "FROM lineitem_pq"))):
            df = spark.sql(sql)
            check_q1_rows(df.collect(), want)
            torch.cuda.synchronize()
            m = r2c_metrics(spark.last_plan)
            ahead = m.get("uploadAheadBatches", 0)
            pinned = m.get("pinnedStreamCopies", 0)
            if (depth == 0) != (ahead == 0) or \
                    pinned != m["numOutputBatches"]:
                raise AssertionError(
                    f"depth {depth}: uploadAheadBatches {ahead}, "
                    f"pinnedStreamCopies {pinned} of "
                    f"{m['numOutputBatches']} uploads")
            walls = timed_collects(df)
            # (the timed runs warmed it)
            prof = profile_collect(
                df, f"q1_{source}_depth{depth}_turn{turn}", card,
                warm=False)
            phase("upload_ring", card=card, query="q1", source=source,
                  max_in_flight=depth, turn=turn, reference="exact",
                  upload_ahead_batches=ahead, pinned_stream_copies=pinned,
                  r2c_batches=m["numOutputBatches"],
                  copy_to_device_s=m.get("copyToDeviceTime", 0) / 1e9,
                  pack_s=m.get("packBatchTime", 0) / 1e9,
                  prefetch_s=m.get("scanPrefetchTime", 0) / 1e9,
                  **walls, **{k: prof[k] for k in (
                      "profiled_wall_s", "device_busy_s",
                      "device_idle_share")})
        for query, df in (("q3_bench", spark.sql(Q3_BENCH)),
                          ("q3_pushed", spark.sql(Q3_PUSHED)),
                          ("repartition", repartition_df(spark, tables))):
            rows = df.collect()
            torch.cuda.synchronize()
            if query == "repartition":
                check_repartition_rows(rows, want_rp)
            else:
                check_q3_rows(rows, want_q3, f"{query} at depth {depth}")
            m = r2c_metrics(spark.last_plan)
            if m.get("pinnedStreamCopies", 0) != m["numOutputBatches"]:
                raise AssertionError(f"{query} at depth {depth}: {m}")
            phase("upload_ring", card=card, query=query, source="memory",
                  max_in_flight=depth, turn=turn, reference="exact",
                  upload_ahead_batches=m.get("uploadAheadBatches", 0),
                  pinned_stream_copies=m["pinnedStreamCopies"],
                  **timed_collects(df))
    ring_runs(card, tables, want_rp)


def ring_runs(card, tables, want, pairs: int = 3) -> None:
    """The repartition path at ``maxInFlight`` 0 and 2 in alternate runs,
    each run with its wall and what could make one run slow: the R2C's
    host times, the garbage collector's passes and seconds, and the
    device and pinned-host allocations the caching allocators made. Then
    ``drain_runs``: the same plan drained to its host batches without
    building the result's ``Row`` objects, which tells the collector's
    passes that ``collect`` makes from those the plan makes."""
    import gc
    import torch
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    gc_s = [0.0]
    t_gc = [0.0]

    def on_gc(ev, _info):
        if ev == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]

    def alloc_counts() -> dict:
        d = torch.cuda.memory_stats()
        h = torch.cuda.host_memory_stats() \
            if hasattr(torch.cuda, "host_memory_stats") else {}
        return {"device_allocs": d.get("num_device_alloc", 0),
                "device_frees": d.get("num_device_free", 0),
                "alloc_retries": d.get("num_alloc_retries", 0),
                "host_allocs": h.get("num_host_alloc", 0),
                "host_frees": h.get("num_host_free", 0)}

    dfs = {}
    for depth in (0, 2):
        spark = TorchSparkSession({
            "spark.sql.shuffle.partitions": str(N_PARTITIONS),
            "spark.rapids.sql.format.parquet.deviceDecode.maxInFlight":
                str(depth)})
        dfs[depth] = (spark, repartition_df(spark, tables))
        dfs[depth][1].collect()  # warm
    runs = []
    gc.callbacks.append(on_gc)
    try:
        for i in range(2 * pairs):
            depth = (0, 2)[i % 2]
            spark, df = dfs[depth]
            before, gcs = alloc_counts(), [g["collections"]
                                           for g in gc.get_stats()]
            gc_s[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_repartition_rows(rows, want)
            after = alloc_counts()
            m = r2c_metrics(spark.last_plan)
            runs.append(dict(
                depth=depth, wall_s=wall,
                pack_s=m.get("packBatchTime", 0) / 1e9,
                copy_to_device_s=m.get("copyToDeviceTime", 0) / 1e9,
                prefetch_s=m.get("scanPrefetchTime", 0) / 1e9,
                gc_passes=[g["collections"] - c for g, c in
                           zip(gc.get_stats(), gcs)],
                gc_s=gc_s[0],
                **{k: after[k] - before[k] for k in after}))
        drains = []
        for i in range(2 * pairs):
            depth = (0, 2)[i % 2]
            spark, df = dfs[depth]
            plan = spark.plan_physical(df.plan)
            gcs = [g["collections"] for g in gc.get_stats()]
            gc_s[0] = 0.0
            t0 = time.perf_counter()
            n = sum(b.num_rows for t in plan.partitions() for b in t())
            torch.cuda.synchronize()
            drains.append(dict(
                depth=depth, wall_s=time.perf_counter() - t0, rows=n,
                gc_passes=[g["collections"] - c for g, c in
                           zip(gc.get_stats(), gcs)], gc_s=gc_s[0]))
            if n != len(want):
                raise AssertionError(f"drained {n} rows, want {len(want)}")
    finally:
        gc.callbacks.remove(on_gc)
    phase("ring_runs", card=card, query="repartition", reference="exact",
          runs=runs, drain_runs=drains,
          gc_tracked_objects=len(gc.get_objects()), **{f"median_depth{d}_s": statistics.median(
              r["wall_s"] for r in runs if r["depth"] == d)
              for d in (0, 2)})


def probe_case(device, n_r: int, n_l: int, K: int, keys: int,
               seed: int):
    """joinProbe inputs ``(kw_r, valid_r, kw_l, valid_l)``: ``n_r`` build
    rows over ``keys`` distinct K-word keys (so duplicates where
    ``keys`` < ``n_r``), half the stream rows drawn from those keys,
    10% of the rows invalid on both sides."""
    import torch
    rng = np.random.default_rng(seed)
    base = rng.integers(-2**62, 2**62, (keys, K))
    kw_r = torch.from_numpy(base[rng.permutation(n_r) % keys]).to(device)
    pick = rng.integers(0, 2 * keys, n_l)
    kw_l = torch.from_numpy(np.where(
        (pick < keys)[:, None], base[np.minimum(pick, keys - 1)],
        rng.integers(-2**62, 2**62, (n_l, K)))).to(device)
    valid_r = torch.from_numpy(rng.random(n_r) > 0.1).to(device)
    valid_l = torch.from_numpy(rng.random(n_l) > 0.1).to(device)
    return kw_r, valid_r, kw_l, valid_l


class ParentKernels:
    """The parent tree's joinProbe and murmur3, for timing beside this
    tree's in one process: ``csrc/join_probe.cu`` and ``csrc/murmur3.cu``
    of the checkout at ``root`` built with this tree's nvcc flags into
    ``build/kernels-parent/``, and called as that tree's wrappers called
    them. That tree's joinProbe takes each side's ``hash_subkey_words``
    and runs three kernels on an owner table in device memory; its
    murmur3 widens bool/byte/short columns to int32 first and has no
    ``n_parts``. ``route`` and ``partition_ids`` repeat that tree's
    ``ops/join.py`` ``probe_inputs`` and ``ops/hashing.py``
    ``partition_ids``."""

    def __init__(self, root: str):
        import ctypes
        from spark_rapids_tpu_torch import kernels as KR
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "kernels-parent")
        os.makedirs(out, exist_ok=True)
        procs = {}
        for name in ("join_probe", "murmur3"):
            src = os.path.join(root, "spark_rapids_tpu_torch", "csrc",
                               f"{name}.cu")
            lib = os.path.join(out, f"lib{name}.so")
            procs[name] = (lib, subprocess.Popen(
                [KR._nvcc()] + KR.NVCC_FLAGS + ["-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        self.libs, self.ptxas = {}, {}
        for name, (lib, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"parent {name}.cu: {log.decode()}")
            self.ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in
                                log.decode(errors="replace").splitlines()
                                if "Used" in ln or "spill" in ln]
            self.libs[name] = ctypes.CDLL(lib)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = self.libs["join_probe"].join_probe_launch
        fn.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp,
                       vp]
        fn.restype = ci
        fn = self.libs["murmur3"].murmur3_launch
        fn.argtypes = [vp, ci, ci, ci, vp, vp]
        fn.restype = ci

    def build_probe(self, kw_r, h_r, valid_r, kw_l, h_l, valid_l):
        import torch
        from spark_rapids_tpu_torch import kernels as KR
        from spark_rapids_tpu_torch.kernels.join_probe import \
            probe_table_slots
        n_r, K = kw_r.shape
        n_l = kw_l.shape[0]
        slots = probe_table_slots(n_r)
        dev = kw_l.device
        owner = torch.empty(slots, dtype=torch.int32, device=dev)
        matched = torch.empty(n_l, dtype=torch.bool, device=dev)
        first_row = torch.empty(n_l, dtype=torch.int32, device=dev)
        KR.check(self.libs["join_probe"].join_probe_launch(
            kw_r.data_ptr(), h_r.data_ptr(), valid_r.data_ptr(), n_r,
            kw_l.data_ptr(), h_l.data_ptr(), valid_l.data_ptr(), n_l, K,
            slots, owner.data_ptr(), matched.data_ptr(),
            first_row.data_ptr(), KR.stream_handle(dev)), "parent joinProbe")
        return matched, first_row

    @staticmethod
    def hashed(ins):
        """This tree's probe inputs with the parent's hash vectors."""
        from spark_rapids_tpu_torch.ops import groupby as G
        kw_r, valid_r, kw_l, valid_l = ins
        h_r = G.hash_subkey_words([kw_r[:, i] for i in range(kw_r.shape[1])])
        h_l = G.hash_subkey_words([kw_l[:, i] for i in range(kw_l.shape[1])])
        return kw_r, h_r, valid_r, kw_l, h_l, valid_l

    def route(self, lkeys, rkeys, null_safe, left, right):
        from spark_rapids_tpu_torch.kernels.groupby_hash import \
            pack_words_i64
        from spark_rapids_tpu_torch.ops import groupby as G
        from spark_rapids_tpu_torch.ops import join as J
        kl, kr, valid_l, valid_r = J._eval_keys(lkeys, rkeys, left, right,
                                                null_safe)
        kl, kr = J._align_string_caps(kl, kr)
        wl = J._key_words(kl, null_safe)
        wr = J._key_words(kr, null_safe)
        return self.build_probe(
            pack_words_i64(wr), G.hash_subkey_words(wr),
            valid_r.contiguous(), pack_words_i64(wl),
            G.hash_subkey_words(wl), valid_l.contiguous())

    def murmur3(self, cols, capacity: int, seed: int = 42):
        import torch
        from spark_rapids_tpu_torch import kernels as KR
        from spark_rapids_tpu_torch.kernels import murmur3 as KM
        words = np.zeros((len(cols), 5), dtype=np.int64)
        keep = []
        for i, c in enumerate(cols):
            kind, ts, width = KM._col_desc(c)
            if kind in ("int8", "int16") or (kind == "int"
                                             and ts[0].dtype != torch.int32):
                kind, ts = "int", (ts[0].to(torch.int32), ts[1])
            keep.append(ts)
            words[i] = [KM._KIND[kind], width, ts[0].data_ptr(),
                        ts[1].data_ptr(),
                        ts[2].data_ptr() if kind == "bytes" else 0]
        dev = cols[0].validity.device
        out = torch.empty(capacity, dtype=torch.int32, device=dev)
        KR.check(self.libs["murmur3"].murmur3_launch(
            words.ctypes.data, len(cols), capacity, seed, out.data_ptr(),
            KR.stream_handle(dev)), "parent murmur3")
        return out

    def partition_ids(self, cols, capacity: int, n_parts: int):
        import torch
        hv = self.murmur3(cols, capacity, 42)
        return torch.remainder(hv.to(torch.int64), n_parts).to(torch.int32)


def ab_case(parent_fn, change_fn, reps: int) -> dict:
    """The parent's and this tree's version of one call, timed in turns
    (parent, change, change, parent) with ``cuda_ms``, and each traced
    once (``device_kernels``)."""
    p1 = cuda_ms(parent_fn, reps)
    c1 = cuda_ms(change_fn, reps)
    c2 = cuda_ms(change_fn, reps)
    p2 = cuda_ms(parent_fn, reps)
    pk, ck = device_kernels(parent_fn), device_kernels(change_fn)
    return {"parent_ms": [p1, p2], "change_ms": [c1, c2],
            "parent_mean_ms": (p1 + p2) / 2, "change_mean_ms": (c1 + c2) / 2,
            "parent_cuda_launches": pk["launches"],
            "change_cuda_launches": ck["launches"],
            "parent_kernel_us": pk["kernel_us"],
            "change_kernel_us": ck["kernel_us"],
            "parent_busy_us": pk["busy_us"], "change_busy_us": ck["busy_us"]}


def q3_phases(device, card, profiled: bool = False,
              parent: "ParentKernels | None" = None) -> dict:
    """TPC-DS q3 at 2,000,000 store_sales rows in both forms: joinProbe
    parity at q3's shapes, each form against the exact reference, the
    walls, and joinProbe's time (with ``profiled``, also each form under
    the profiler); returns the kernel line's numbers."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.exec.join import TorchBroadcastHashJoinExec
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.kernels import join_probe as KJ
    from spark_rapids_tpu_torch.ops import join as J
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    t0 = time.perf_counter()
    tables = q3_tables()
    want = q3_reference(tables)
    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    for name, cols in tables.items():
        spark.createDataFrame(
            host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                                  [a for _c, _k, a in cols]),
            num_partitions=Q3_PARTITIONS[name]).createOrReplaceTempView(name)
    gen_s = time.perf_counter() - t0

    # joinProbe's inputs at q3's shapes, from a pushed-form plan: the
    # date_dim join (about 6,090 valid build rows at capacity 6,144
    # against one 250,000-row stream partition) and the item join
    df = spark.sql(Q3_PUSHED)
    joins = [p for p in plan_nodes_of(spark.plan_physical(df.plan))
             if isinstance(p, TorchBroadcastHashJoinExec)]
    shapes, join_args = {}, {}
    for j in joins:
        lk, rk = j._bound_keys()
        right = next(iter(j.right.device_partitions()[0]()))
        left = next(iter(j.left.device_partitions()[0]()))
        which = "date_dim" if right.capacity > 64 else "item"
        join_args[which] = (lk, rk, j.null_safe, left, right)
        shapes[which] = J.probe_inputs(*join_args[which])
    if set(shapes) != {"date_dim", "item"}:
        raise AssertionError(f"q3 join shapes: {sorted(shapes)}")
    # beside q3's two shapes: K=2 with duplicate build keys, and builds
    # at the 8,192-row cap (16,384 slots) with K=1 (owners and key words
    # in shared memory) and K=3 (key words too wide for it: read from
    # device memory)
    cases = dict(shapes,
                 k2_duplicates=probe_case(device, 5000, 100_000, 2, 700, 12),
                 cap_8192_k1=probe_case(device, 8192, 262_144, 1, 7000, 14),
                 cap_8192_k3=probe_case(device, 8192, 262_144, 3, 3000, 15))
    parity = {}
    for name, ins in cases.items():
        km, kf = KJ.build_probe(*ins)
        pm, pf = KJ.build_probe_plain(*ins)
        torch.cuda.synchronize()
        err = max(int((km.long() - pm.long()).abs().max()),
                  int((kf.long() - pf.long()).abs().max()))
        if err != 0:
            raise AssertionError(f"joinProbe != plain on {name}: {err}")
        parity[name] = {"build_cap": int(ins[0].shape[0]),
                        "build_valid": int(ins[1].sum()),
                        "stream_cap": int(ins[2].shape[0]),
                        "stream_valid": int(ins[3].sum()),
                        "key_words": int(ins[0].shape[1]),
                        "slots": KJ.probe_table_slots(int(ins[0].shape[0])),
                        "matched": int(km.sum()), "max_abs_err": err}
    probe_err = max(c["max_abs_err"] for c in parity.values())
    phase("q3_join_probe_parity", cases=parity, tolerance="exact")

    # groupbyHash at q3's partial-aggregate shape: the first batch the
    # pushed form's partial aggregate takes, as its own kernel inputs
    agg = find_exec(spark.plan_physical(df.plan), lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    batch = next(iter(agg.child.device_partitions()[0]()))
    key_cols, vals, prims, active = agg.update_inputs(batch)
    kw, h, add, mn, mx, _decode = KG.table_inputs(
        key_cols, [(v, p, dt) for v, (p, dt) in zip(vals, prims)], active)
    gb_q3 = groupby_case((kw, h, active, add, mn, mx),
                         KR.table_slots(spark.conf_obj, batch.capacity))
    phase("q3_groupby_hash", card=card, tolerance="exact", **gb_q3)

    if profiled:
        from spark_rapids_tpu_torch.columnar.device import DeviceBatch
        fact = tables["store_sales"]
        whole = host_batch_from_numpy([(c, types[k]) for c, k, _a in fact],
                                      [a for _c, _k, a in fact])
        per = (whole.num_rows + N_PARTITIONS - 1) // N_PARTITIONS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_PARTITIONS):
            DeviceBatch.from_host(whole.slice(i * per, (i + 1) * per),
                                  device)
        torch.cuda.synchronize()
        phase("q3_upload", card=card,
              upload_8_store_sales_partitions_s=time.perf_counter() - t0)

    # both forms at 2,000,000 rows against the exact reference
    forms = {}
    for form, sql in (("bench", Q3_BENCH), ("pushed", Q3_PUSHED)):
        df = spark.sql(sql)
        KR.reset_launches()
        t0 = time.perf_counter()
        rows = df.collect()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(KR.LAUNCHES)
        check_q3_rows(rows, want, f"q3 {form}")
        names = plan_names(spark.last_plan)
        bad = [n for i, n in enumerate(names)
               if not n.startswith("Torch") and not (
                   n == "CpuLocalScanExec"
                   and names[i - 1] == "TorchRowToColumnarExec")]
        if names[0] != "TorchColumnarToRowExec" or bad:
            raise AssertionError(f"q3 {form} plan is not all Torch*: {names}")
        routes = {"joinProbe": 0, "fkFastPathJoins": 0}
        for p in plan_nodes_of(spark.last_plan):
            for k, v in getattr(p, "route_counts", {}).items():
                routes[k] += v
        if form == "pushed" and (launches["joinProbe"] <= 0
                                 or routes["joinProbe"] <= 0):
            raise AssertionError(f"q3 pushed: no joinProbe launch: "
                                 f"{launches} {routes}")
        if form == "bench" and (launches["joinProbe"] != 0
                                or routes["fkFastPathJoins"] != 2):
            raise AssertionError(f"q3 bench: not the sort-based route: "
                                 f"{launches} {routes}")
        df.collect()  # warm
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            df.collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        forms[form] = launches
        phase(f"q3_{form}", card=card, rows_in=Q3_SALES_ROWS,
              partitions=Q3_PARTITIONS, rows_out=len(rows),
              reference="exact", plan=names, launches=launches,
              routes=routes, first_run_s=round(first_s, 4),
              warm_runs=1, timed_runs=walls, median_s=wall,
              rows_per_s=Q3_SALES_ROWS / wall,
              generate_s=round(gen_s, 3))
        if profiled:
            phase(f"q3_{form}_breakdown", card=card,
                  **profile_collect(df, f"q3_{form}", card,
                                    host_ops=True))

    # joinProbe at q3's per-chunk shapes, alone and with the key
    # evaluation that feeds it (the join's kernel route: probe_inputs +
    # build_probe); the bound reads the key words and validity of both
    # sides once and writes 5 bytes a stream row
    times = {}
    for name in ("date_dim", "item"):
        ins, args = shapes[name], join_args[name]
        nbytes = sum(t.numel() * t.element_size() for t in ins) \
            + ins[2].shape[0] * 5
        kern = device_kernels(lambda ins=ins: KJ.build_probe(*ins))
        route = device_kernels(
            lambda a=args: KJ.build_probe(*J.probe_inputs(*a)))
        times[name] = {
            "ms": cuda_ms(lambda ins=ins: KJ.build_probe(*ins), 50),
            "plain_ms": wall_ms(lambda ins=ins: KJ.build_probe_plain(*ins),
                                5),
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "cuda_launches": kern["launches"],
            "kernel_us": kern["kernel_us"], "gaps_us": kern["gaps_us"],
            "span_us": kern["span_us"],
            "route_ms": cuda_ms(
                lambda a=args: KJ.build_probe(*J.probe_inputs(*a)), 50),
            "route_cuda_launches": route["launches"],
            "route_busy_us": route["busy_us"],
            "route_span_us": route["span_us"]}
        if kern["launches"] != 1:
            raise AssertionError(f"joinProbe ran {kern['launches']} CUDA "
                                 f"kernels at the {name} shape, not 1")
    ab = {}
    if parent is not None:
        for name in ("date_dim", "item", "cap_8192_k1"):
            ins = cases[name]
            old = ParentKernels.hashed(ins)
            pm, pf = parent.build_probe(*old)
            km, kf = KJ.build_probe(*ins)
            if not (torch.equal(pm, km) and torch.equal(pf, kf)):
                raise AssertionError(f"parent joinProbe differs on {name}")
            ab[name] = ab_case(lambda o=old: parent.build_probe(*o),
                               lambda i=ins: KJ.build_probe(*i), 50)
        for name in ("date_dim", "item"):
            args = join_args[name]
            ab[f"{name}_route"] = ab_case(
                lambda a=args: parent.route(*a),
                lambda a=args: KJ.build_probe(*J.probe_inputs(*a)), 50)
        phase("ab_join_probe", card=card, cases=ab,
              parent_ptxas=parent.ptxas["join_probe"])
    launches = forms["pushed"]["joinProbe"]
    phase("q3_join_probe_times", card=card, launches_per_q3=launches,
          shapes=times, library_ms=None,
          library="none: no single PyTorch call builds and probes a hash "
                  "table")
    d = times["date_dim"]
    return {"launches": launches, "max_abs_err": probe_err, "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "groupby_q3": gb_q3,
            "cases": {k: {f: t[f] for f in ("ms", "plain_ms", "bound_ms",
                                             "route_ms")}
                      for k, t in times.items()}}


DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "data")


def data_key(**params) -> str:
    """What the data under ``build/data/`` was written from: ``params``
    (seed, rows, partitions), the writer's sources and the pyarrow
    version. Data whose marker holds another key is written anew."""
    import hashlib

    import pyarrow
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    h.update(pyarrow.__version__.encode())
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "spark_rapids_tpu_torch")
    for src in ("io/writers.py", "io/arrow_convert.py",
                "sql/dataframe.py"):
        with open(os.path.join(pkg, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def write_once(directory: str, write, key: str) -> float:
    """Run ``write(directory)`` unless the marker of an earlier run holds
    ``key``; returns the seconds spent (0 when the data was reused)."""
    import shutil
    marker = os.path.join(directory, "_SUCCESS.smoke")
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == key:
                return 0.0
    if os.path.exists(directory):
        shutil.rmtree(directory)
    t0 = time.perf_counter()
    write(directory)
    with open(marker, "w") as f:
        f.write(key + "\n")
    return time.perf_counter() - t0


def kernel_input_bytes(enc) -> int:
    """The bytes decodeFused must read for an EncodedBatch, unpadded: the
    packed page words, each device column's page table (dense start,
    plain byte, page class, delta first value), its run tables (33 bytes
    a run), its dense string lengths and its dictionaries. Host-decoded
    columns do not pass through the kernel."""
    total = len(enc.words) * 4
    for plan in enc.plans.values():
        pages = len(plan.pg_enc)
        total += (pages + 1) * 8 + pages * (8 + 4)
        if plan.has_delta:
            total += pages * 8
        total += sum(len(rt) * 33 for rt in (plan.dl, plan.vr, plan.dr)
                     if rt is not None)
        if plan.str_lens is not None:
            total += plan.str_lens.nbytes
        total += sum(da.nbytes for da in plan.dict_arrays)
    return total


def staged_on_card(path: str, device):
    """The first row group of a Parquet file staged as the scan stages it
    and uploaded: (layout, cap, n, words, extras) on ``device``, and the
    bytes the kernel must read (``kernel_input_bytes``)."""
    import pyarrow.parquet as pq
    import torch
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    from spark_rapids_tpu_torch.io import device_decode as DD
    from spark_rapids_tpu_torch.io import readers as RD
    from spark_rapids_tpu_torch.io.arrow_convert import arrow_schema_to_sql
    unit = RD.plan_scan_units("parquet", [(path, {})])[0]
    enc = DD.plan_unit_encoded(
        unit, arrow_schema_to_sql(pq.ParquetFile(path).schema_arrow))
    if enc is None:
        raise AssertionError(f"{path}: no device-decoded column")
    cap = bucket_capacity(enc.num_rows)
    _t, _s, n, cap, words, extras, layout, _spec = \
        X.prepare_encoded_upload(enc, cap)
    return (layout, cap, n, torch.from_numpy(words).to(device),
            [torch.from_numpy(np.ascontiguousarray(e)).to(device)
             for e in extras], kernel_input_bytes(enc))


def max_abs_diff(a, b) -> float:
    """0 when two outputs are equal bit for bit, else their largest
    |difference| (floats as values, everything else as integers)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"outputs differ in shape or type: "
                             f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    if a.dtype.is_floating_point:
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        if torch.equal(a.view(bits), b.view(bits)):
            return 0
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


def scan_counts(plan) -> dict:
    """The summed counters of every Parquet scan in an executed plan."""
    from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
    out: dict = {}
    for p in plan_nodes_of(plan):
        if isinstance(p, CpuFileScanExec):
            for k, v in p.metrics.snapshot().items():
                out[k] = out.get(k, 0) + v
    return out


def scan_walls(plan) -> dict:
    """Seconds to drain the executed plan's Parquet scan alone: on the
    host (footers, page reads, decompression and header parsing into
    EncodedBatches), then through its upload and ``decodeFused``."""
    import torch
    from spark_rapids_tpu_torch.exec.base import TorchRowToColumnarExec
    r2c = next(p for p in plan_nodes_of(plan)
               if isinstance(p, TorchRowToColumnarExec))
    scan = r2c.child
    t0 = time.perf_counter()
    batches = sum(1 for t in scan.partitions() for _b in t())
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in r2c.device_partitions():
        for _b in t():
            pass
    torch.cuda.synchronize()
    return {"scan_batches": batches, "scan_host_s": host_s,
            "scan_upload_decode_s": time.perf_counter() - t0}


def timed_collects(df) -> dict:
    """One warm ``collect`` then two timed ones: the walls and their
    median (their mean)."""
    import torch
    df.collect()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"warm_runs": 1, "timed_runs": walls,
            "median_s": statistics.median(walls)}


Q3_PARQUET_PARTS = {"item": 1, "date_dim": 1, "store_sales": N_PARTITIONS}


def write_q3_parquet(spark, tables, parts=None, name="tpcds_q3"):
    """bench's q3 tables written once under ``build/data/<name>/``, a
    table a directory, each from ``parts[table]`` partitions (a file
    each): ``(directory, seconds spent writing)``."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    parts = parts or Q3_PARQUET_PARTS
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    q3_dir = os.path.join(DATA_DIR, name)

    def write_q3(d):
        for table, n in parts.items():
            cols = tables[table]
            spark.createDataFrame(host_batch_from_numpy(
                [(c, types[k]) for c, k, _a in cols],
                [a for _c, _k, a in cols]), num_partitions=n).write \
                .mode("overwrite").parquet(os.path.join(d, table))
    return q3_dir, write_once(q3_dir, write_q3, data_key(
        seed=Q3_SEED, rows=Q3_SALES_ROWS, partitions=parts))


def write_q1_parquet(spark, arrays):
    """q1's lineitem written once under ``build/data/`` from 8 partitions
    (8 files of one row group): ``(directory, seconds spent writing)``."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    q1_dir = os.path.join(DATA_DIR, "tpch_sf1_lineitem")
    write_s = write_once(q1_dir, lambda d: spark.createDataFrame(
        host_batch_from_numpy(lineitem_fields(), arrays),
        num_partitions=N_PARTITIONS).write.mode("overwrite").parquet(d),
        data_key(seed=SEED, rows=SF1_ROWS, partitions=N_PARTITIONS))
    return q1_dir, write_s


def parquet_phases(device, card, arrays, profiled: bool = False) -> dict:
    """q1 at SF1 and bench.py's q3 from Parquet through ``read.parquet``,
    with ``decodeFused`` held against its plain version first (the decode
    corpus, one q1 row group and q3's row groups), then timed at q1's
    row-group shape;
    returns the kernel line's numbers."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.kernels import decode_fused as DF
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        raise RuntimeError("the Parquet phases need pyarrow, which does "
                           f"not import here: {e}") from e
    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    q1_dir, write_s = write_q1_parquet(spark, arrays)
    q1_files = sorted(f for f in os.listdir(q1_dir)
                      if f.endswith(".parquet"))

    tables = q3_tables()
    q3_dir, q3_write_s = write_q3_parquet(spark, tables)
    q3_parts = Q3_PARQUET_PARTS

    # -- decodeFused against its plain version on the card ---------------
    # the corpus (every page class and kind), one q1 row group, and every
    # row group that q3 from Parquet decodes (250,000-row store_sales
    # groups with 4-byte FLBA decimals, item's strings, date_dim)
    corpus = decode_corpus(os.path.join(DATA_DIR, "decode_corpus"))
    corpus["q1_sf1_row_group"] = os.path.join(q1_dir, q1_files[0])
    for name in q3_parts:
        tdir = os.path.join(q3_dir, name)
        for i, f in enumerate(sorted(f for f in os.listdir(tdir)
                                     if f.endswith(".parquet"))):
            corpus[f"q3_{name}_{i}"] = os.path.join(tdir, f)
    parity = {}
    for name, path in corpus.items():
        layout, cap, n, w, ex, _in_bytes = staged_on_card(path, device)
        k_active, k_outs = DF.decode_fused(layout, cap, n, w, ex)
        p_active, p_outs = X._encoded_decode_body(layout, cap, w, n, ex)
        torch.cuda.synchronize()
        errs = [max_abs_diff(a, b) for a, b in
                zip((k_active,) + tuple(k_outs), (p_active,) + tuple(p_outs))]
        if len(k_outs) != len(p_outs) or any(errs):
            raise AssertionError(f"decodeFused != plain on {name}: {errs}")
        parity[name] = {"rows": n, "cap": cap, "outputs": len(errs),
                        "device_columns": sum(e[0] == "dev" for e in layout),
                        "max_abs_err": max(errs)}
    df_err = max(c["max_abs_err"] for c in parity.values())
    phase("decode_fused_parity", cases=parity, tolerance="exact")

    # -- q1 at SF1 from Parquet --------------------------------------------
    spark.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
    df = spark.sql(Q1)
    want_rows = q1_reference(arrays)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    check_q1_rows(rows, want_rows)
    names = plan_names(spark.last_plan)
    scan_at = names.index("CpuFileScanExec")
    if names[0] != "TorchColumnarToRowExec" or scan_at != len(names) - 1 \
            or not all(n.startswith("Torch") for n in names[:scan_at]):
        raise AssertionError(f"q1 parquet plan is not all Torch*: {names}")
    counts = scan_counts(spark.last_plan)
    if launches["decodeFused"] != 8 or counts.get(
            "deviceDecodedBatches") != 8 or counts.get(
            "deviceFallbackColumns", 0) or counts.get(
            "deviceFallbackUnits", 0):
        raise AssertionError(f"q1 parquet scan route: {launches} {counts}")
    # one card: the planner's exchanges coalesce to one partition, so q1
    # hashes no partition ids (as in the JAX package)
    if launches["groupbyHash"] <= 0 or launches["murmur3"] != 0:
        raise AssertionError(f"q1 parquet kernels: {launches}")
    ring = check_default_ring(spark.last_plan, True, "q1 from Parquet")
    walls = timed_collects(df)
    phase("q1_sf1_parquet", card=card, rows_in=SF1_ROWS, files=len(q1_files),
          rows_out=len(rows), reference="exact", plan=names,
          launches=launches, scan=counts, ring=ring,
          first_run_s=round(first_s, 4),
          write_s=round(write_s, 3),
          rows_per_s=SF1_ROWS / walls["median_s"], **walls)
    if profiled:
        phase("q1_parquet_breakdown", card=card,
              **scan_walls(spark.last_plan),
              **profile_collect(df, "q1_parquet", card, host_ops=True))

    # -- bench.py's q3 from Parquet ------------------------------------------
    for name in tables:
        spark.read.parquet(os.path.join(q3_dir, name)) \
            .createOrReplaceTempView(name)
    q3 = spark.sql(Q3_BENCH)
    KR.reset_launches()
    t0 = time.perf_counter()
    q3_rows = q3.collect()
    torch.cuda.synchronize()
    q3_first_s = time.perf_counter() - t0
    q3_launches = dict(KR.LAUNCHES)
    check_q3_rows(q3_rows, q3_reference(tables), "q3 from parquet")
    q3_counts = scan_counts(spark.last_plan)
    routes = {"joinProbe": 0, "fkFastPathJoins": 0}
    for p in plan_nodes_of(spark.last_plan):
        for k, v in getattr(p, "route_counts", {}).items():
            routes[k] += v
    if q3_launches["decodeFused"] != q3_counts.get("deviceDecodedBatches"):
        raise AssertionError(f"q3 parquet: {q3_launches} {q3_counts}")
    q3_walls = timed_collects(q3)
    phase("q3_bench_parquet", card=card, rows_in=Q3_SALES_ROWS,
          rows_out=len(q3_rows), reference="exact",
          plan=plan_names(spark.last_plan), launches=q3_launches,
          scan=q3_counts, routes=routes, first_run_s=round(q3_first_s, 4),
          write_s=round(q3_write_s, 3),
          rows_per_s=Q3_SALES_ROWS / q3_walls["median_s"], **q3_walls)

    # -- decodeFused times ---------------------------------------------------
    # at q1's row-group shape, at one 250,000-row q3 store_sales row group
    # (4-byte FLBA) and at a corpus case with nulls, strings and
    # decimals, which takes the 3-launch scan path; each bound counts the
    # bytes the row group needs: its unpadded inputs and each output's n
    # rows (not the padding to cap)
    cases = {"q1_row_group": decode_case(
                 os.path.join(q1_dir, q1_files[0]), device),
             "q3_store_sales_row_group": decode_case(
                 corpus["q3_store_sales_0"], device),
             "corpus_dict_scan_path": decode_case(corpus["dict"], device)}
    # the corpus case takes the two scan launches before the decode; the
    # row groups need no prefix sum
    got = {k: c["cuda_launches"] for k, c in cases.items()}
    if got != {"q1_row_group": 1, "q3_store_sales_row_group": 1,
               "corpus_dict_scan_path": 3}:
        raise AssertionError(f"decodeFused CUDA launches per batch: {got}")
    q1c = cases["q1_row_group"]
    phase("decode_fused_times", card=card,
          launches_per_q1=launches["decodeFused"],
          launches_per_q3=q3_launches["decodeFused"], cases=cases,
          library_ms=None,
          library="none: no single PyTorch call decodes Parquet pages")
    return {"q1_dir": q1_dir,
            "launches": launches["decodeFused"], "max_abs_err": df_err,
            "ms": q1c["ms"], "plain_ms": q1c["plain_ms"],
            "bound_ms": q1c["bound_ms"], "cases": cases}


def stage_profile(df) -> dict:
    """One warm ``df.collect()`` under torch.profiler, read for what
    stage fusion changes: the host's kernel-launch and graph-launch
    calls (count and host microseconds), the device's kernels (count,
    busy time, idle share of the wall, time in device-to-device copies)
    and groupbyHash's own kernels (``groupby_kernel``) in the device
    trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # read from the profiler's raw events: the runtime's launch calls
    # have no children, so a call's duration is its self time
    raw = prof.profiler.kineto_results.events()
    host = {}
    for e in raw:
        if e.name().startswith(("cudaLaunchKernel", "cudaGraphLaunch")):
            k = "graph" if e.name().startswith("cudaGraphLaunch") \
                else "kernel"
            n, us = host.get(k, (0, 0.0))
            host[k] = (n + 1, us + e.duration_ns() / 1e3)
    on_device = [e for e in raw if e.device_type() == DeviceType.CUDA]
    kernels = [e for e in on_device
               if not e.name().startswith(("Memcpy", "Memset"))]
    busy_ns = sum(e.duration_ns() for e in on_device)
    # device-to-device copies: fused, these hold each replay's copies
    # into the graph's static inputs and out of its memory pool
    d2d_ns = sum(e.duration_ns() for e in on_device
                 if e.name().startswith("Memcpy DtoD"))
    return {"wall_s": wall, "device_d2d_copy_s": d2d_ns / 1e9,
            "launch_kernel_calls": host.get("kernel", (0, 0.0))[0],
            "launch_kernel_host_us": host.get("kernel", (0, 0.0))[1],
            "graph_launch_calls": host.get("graph", (0, 0.0))[0],
            "graph_launch_host_us": host.get("graph", (0, 0.0))[1],
            "device_kernels": len(kernels),
            "device_busy_s": busy_ns / 1e9,
            "device_idle_share": 1.0 - busy_ns / 1e9 / wall,
            "groupby_kernels": sum("groupby_kernel" in e.name()
                                   for e in kernels)}


def stage_metrics(plan) -> dict:
    """The fused stages' counters of an executed plan (each stage node
    with its constituents) and the number of stages."""
    from spark_rapids_tpu_torch.exec.fused import TorchFusedStageExec
    out = {"stages": 0, "dispatchCount": 0, "stageCompileTime": 0,
           "compileCacheMisses": 0, "compileCacheHits": 0}
    for p in plan_nodes_of(plan):
        if isinstance(p, TorchFusedStageExec):
            out["stages"] += 1
            for node in [p] + p.fused_ops:
                m = node.metrics.snapshot()
                for k in out:
                    out[k] += m.get(k, 0)
    return out


def held_outputs_check(spark, q1_dir: str) -> dict:
    """A filter/project stage over q1's lineitem from Parquet (8 row
    groups in one scan partition): every stage output of the partition
    is held until the last has been produced, then each is read back
    and the rows are held against the unfused plan's. A replay that
    overwrote an earlier batch's buffers would show here."""
    import torch
    from spark_rapids_tpu_torch.exec.fused import TorchFusedStageExec
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    sql = ("SELECT l_returnflag, l_linestatus, "
           "l_extendedprice * (1 - l_discount) AS disc_price, l_quantity "
           "FROM lineitem_pq WHERE l_shipdate <= date '1998-09-02'")
    plan = spark.plan_physical(spark.sql(sql).plan)
    stage = find_exec(plan, lambda p: isinstance(p, TorchFusedStageExec))
    if stage is None or stage.sink_agg is not None:
        raise AssertionError(f"held-outputs query: no filter/project "
                             f"stage in {plan_names(plan)}")
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    (thunk,) = stage.device_partitions()
    held = list(thunk())
    torch.cuda.synchronize()
    got = HostBatch.concat([b.to_host() for b in held])
    plain = TorchSparkSession({"spark.rapids.sql.stageFusion.enabled":
                               "false"})
    plain.read.parquet(q1_dir).createOrReplaceTempView("lineitem_pq")
    want = plain.sql(sql)._execute()
    equal = got.num_rows == want.num_rows and all(
        np.array_equal(g, w) for g, w in zip(sorted_row_arrays(got),
                                             sorted_row_arrays(want)))
    if len(held) != 8 or not equal:
        raise AssertionError(f"held stage outputs: {len(held)} batches, "
                             f"{got.num_rows} rows vs {want.num_rows} "
                             f"unfused, equal={equal}")
    return {"batches_held": len(held), "rows": got.num_rows,
            "reference": "the unfused plan, exact"}


def sorted_row_arrays(hb) -> list:
    """A host batch's rows in sorted order as numpy arrays, one per
    value word (a string column as text, a two-limb decimal as two
    words) and one per validity: two batches hold the same rows exactly
    when these arrays are equal."""
    keys = []
    for c in hb.columns:
        d = np.asarray(c.data)
        if d.dtype == object:
            d = d.astype(str)
        keys.extend([d[:, i] for i in range(d.shape[1])] if d.ndim == 2
                    else [d])
        keys.append(np.asarray(c.validity))
    order = np.lexsort(keys[::-1])
    return [k[order] for k in keys]


def stage_fusion_phase(card, fields, arrays, q1_dir, tables) -> None:
    """Whole-stage fusion off and on, in turns (off, on): q1 from
    memory and from Parquet and both q3 forms, each exact. Per query and
    turn: the first run (every turn starts with an empty stage cache,
    so a fused turn captures: ``stageCompileTime``, captures), the walls
    (one warm run,
    mean of two), a counted run (graph replays against the stages'
    ``dispatchCount``, kernel launches, the host time of the replay calls
    without the profiler), a profiled run
    (``stage_profile``), and ``torch.cuda.memory_reserved()`` after the
    query and after ``empty_cache`` (what the cached graphs' pools and
    live tensors keep). Fused, every stage program runs as a graph
    replay (replays equal ``dispatchCount`` in a warm run, and q1's
    trace shows one graph launch per partial-aggregate batch); unfused,
    no graph runs. Every turn: 8 groupbyHash kernels per q1 in the
    device trace, no murmur3, every upload from a pinned slot. Then
    ``held_outputs_check``."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.exec import fused as F
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    want_q1 = q1_reference(arrays)
    want_q3 = q3_reference(tables)
    batch = host_batch_from_numpy(fields, arrays)
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    q3_batches = {name: host_batch_from_numpy(
        [(c, types[k]) for c, k, _a in cols], [a for _c, _k, a in cols])
        for name, cols in tables.items()}
    spark = None
    # off first: the held-outputs check below needs the fused session
    for turn, fused in enumerate((False, True)):
        # each turn starts with no cached graph, so the fused turn
        # captures and the memory of the turns compares like with like
        F.STAGE_CACHE.clear()
        torch.cuda.empty_cache()
        spark = TorchSparkSession({
            "spark.sql.shuffle.partitions": str(N_PARTITIONS),
            "spark.rapids.sql.stageFusion.enabled": str(fused).lower()})
        spark.createDataFrame(batch, num_partitions=N_PARTITIONS) \
            .createOrReplaceTempView("lineitem")
        spark.read.parquet(q1_dir).createOrReplaceTempView("lineitem_pq")
        for name, b in q3_batches.items():
            spark.createDataFrame(b, num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
        for query, df in (
                ("q1_memory", spark.sql(Q1)),
                ("q1_parquet", spark.sql(Q1.replace("FROM lineitem",
                                                    "FROM lineitem_pq"))),
                ("q3_bench", spark.sql(Q3_BENCH)),
                ("q3_pushed", spark.sql(Q3_PUSHED))):
            F.reset_graph_counts()
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            first = stage_metrics(spark.last_plan)
            captures = F.GRAPH_COUNTS["captures"]
            if query.startswith("q1"):
                check_q1_rows(rows, want_q1)
            else:
                check_q3_rows(rows, want_q3, f"{query} fused={fused}")
            walls = timed_collects(df)
            KR.reset_launches()
            F.reset_graph_counts()
            rows = df.collect()
            torch.cuda.synchronize()
            launches = dict(KR.LAUNCHES)
            counted = stage_metrics(spark.last_plan)
            replays = F.GRAPH_COUNTS["replays"]
            replay_host_ns = F.GRAPH_COUNTS["replay_host_ns"]
            m = r2c_metrics(spark.last_plan)
            prof = stage_profile(df)
            reserved = torch.cuda.memory_reserved()
            torch.cuda.empty_cache()
            reserved_kept = torch.cuda.memory_reserved()
            partial = find_exec(spark.last_plan, lambda p: isinstance(
                p, TorchHashAggregateExec) and p.mode == "partial")
            agg_programs = partial.metrics.value("dispatchCount")
            fields_out = {
                "first_run_s": first_s, "captures": captures,
                "capture_s": first["stageCompileTime"] / 1e9,
                "stages": counted["stages"],
                "dispatch_count": counted["dispatchCount"],
                "graph_replays": replays,
                # host time of the replay calls, without the profiler
                "replay_host_us": replay_host_ns / 1e3,
                "partial_agg_programs": agg_programs,
                "launches": launches, **walls, **prof,
                "memory_reserved": reserved,
                "memory_reserved_after_empty_cache": reserved_kept}
            bad = []
            if fused:
                if counted["stages"] == 0 or \
                        replays != counted["dispatchCount"] or \
                        F.GRAPH_COUNTS["captures"]:
                    bad.append("stage programs are not all graph replays")
                if query.startswith("q1") and \
                        prof["graph_launch_calls"] != agg_programs:
                    bad.append("q1: not one graph launch per "
                               "partial-aggregate program")
            elif counted["stages"] or replays or \
                    prof["graph_launch_calls"]:
                bad.append("a graph ran with fusion off")
            if query.startswith("q1") and (
                    prof["groupby_kernels"] != N_PARTITIONS
                    or launches["groupbyHash"] != N_PARTITIONS):
                bad.append("q1: groupbyHash launches "
                           f"{launches['groupbyHash']}, trace "
                           f"{prof['groupby_kernels']}")
            if launches["murmur3"] or \
                    m.get("pinnedStreamCopies", 0) != m["numOutputBatches"]:
                bad.append(f"murmur3 or pinned uploads: {launches} {m}")
            phase("stage_fusion", card=card, query=query, fused=fused,
                  turn=turn, reference="exact", **fields_out)
            if bad:
                raise AssertionError(f"{query} fused={fused}: {bad}")
    held = held_outputs_check(spark, q1_dir)
    phase("stage_fusion_held_outputs", card=card, **held)


# ---------------------------------------------------------------------------
# The memory phase: spill, retry and planned out-of-core (slice 8)
# ---------------------------------------------------------------------------

# the counters the retry protocol bumps; without an injector, a budget or
# a pool they must stay 0 on every collect (``gate_protocol``)
PROTOCOL_COUNTERS = ("retryCount", "splitRetryCount",
                     "deviceDecodeOomFallbacks")
PRESSURE_KEYS = ("spark.rapids.sql.test.injectOOM",
                 "spark.rapids.sql.test.injectIOError",
                 "spark.rapids.sql.memory.deviceBudgetBytes",
                 "spark.rapids.memory.tpu.poolSize",
                 "spark.rapids.memory.host.spillStorageSize")
GATE = {"collects": 0, "skipped": 0, "off": False, "strict": False}
MEMORY_COUNTERS = PROTOCOL_COUNTERS + (
    "ioRetryCount", "spillBytesOnRetry", "retryBlockTime",
    "plannedPartitions", "plannedOutOfCoreEscalations",
    "budgetPressurePeak", "spillBytes", "kernelDispatchCount.murmur3",
    "kernelDispatchCount.decodeFused")


def protocol_counts(plan) -> dict:
    """The retry protocol's counters of an executed plan, summed over its
    operators (host integers: reading them never waits for the card)."""
    out = dict.fromkeys(PROTOCOL_COUNTERS, 0)

    def walk(p):
        for node in [p] + list(getattr(p, "fused_ops", [])):
            reg = getattr(node, "metrics", None)
            for k in PROTOCOL_COUNTERS:
                m = getattr(reg, "metrics", {}).get(k)
                if m is not None:
                    out[k] += m.value
        for c in p.children:
            walk(c)
    walk(plan)
    return out


def gate_protocol() -> None:
    """From here on, every collect of a session that arms no injector and
    sets no budget, pool or host spill size must leave ``retryCount``,
    ``splitRetryCount`` and ``deviceDecodeOomFallbacks`` at 0: the
    protocol never runs silently on a normal run. While ``GATE["strict"]``
    is set (phase 17), each such collect must also leave no store handle
    and no device permit held (``held_after_collect``). It wraps
    ``TorchSparkSession.execute_plan``, the entry every collect takes."""
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    plain = TorchSparkSession.execute_plan

    def checked(self, plan):
        out = plain(self, plan)
        if GATE["off"] or any(self.conf_obj.settings.get(k)
                              for k in PRESSURE_KEYS):
            GATE["skipped"] += 1
            return out
        # this thread's plan: a server runs several queries on one session
        bad = {k: v for k, v in protocol_counts(
            self.thread_last_plan() or self.last_plan).items() if v}
        if bad:
            raise AssertionError(
                f"retry protocol ran on a run without pressure: {bad}")
        if GATE["strict"]:
            held = held_after_collect(self.conf_obj)
            if any(held.values()):
                raise AssertionError(f"a collect left {held} held")
            GATE["strict_collects"] = GATE.get("strict_collects", 0) + 1
        GATE["collects"] += 1
        return out
    TorchSparkSession.execute_plan = checked


def held_after_collect(conf) -> dict:
    """Store handles and device permits still held once a collect has
    returned (both must be 0)."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.resource import get_semaphore
    store = memory._STORE
    return {"store_handles": 0 if store is None
            else store.stats()["liveHandles"],
            "permits": get_semaphore(conf).in_use}


def stage_buckets() -> list:
    """The capacity buckets of the cached stage programs (a program's key
    holds its inputs' shapes; the first is the batch's capacity)."""
    from spark_rapids_tpu_torch.exec import fused as F
    return sorted({sig[1][0][0] for _key, sig in F.STAGE_CACHE.keys()})


def memory_counters(plan) -> dict:
    from spark_rapids_tpu_torch.metrics import plan_metrics
    m = plan_metrics(plan)
    return {k: m.get(k, 0) for k in MEMORY_COUNTERS}


def murmur3_case(cols, cap: int, n_parts: int, reps: int = 50) -> dict:
    """murmur3 with the partition id in the same launch, against its plain
    version (exact), and its device time beside its byte bound (the key
    tensors read once, the ids written once)."""
    import torch
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    from spark_rapids_tpu_torch.ops import hashing as H

    def plain():
        return torch.remainder(H.murmur3_columns(cols, cap, 42).long(),
                               n_parts).to(torch.int32)
    got = KM.murmur3_columns(cols, cap, 42, n_parts=n_parts)
    want = plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"murmur3 != plain at {cap} rows: {err}")
    nbytes = cap * 4 + sum(t.numel() * t.element_size() for c in cols
                           for t in c.arrays())
    return {"rows": cap, "columns": len(cols), "n_parts": n_parts,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: KM.murmur3_columns(cols, cap, 42,
                                                     n_parts=n_parts), reps),
            "plain_ms": wall_ms(plain, 5), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def key_columns(exprs, batch):
    """Evaluated key columns of one batch, as ``hash_partition_ids``
    evaluates them."""
    from spark_rapids_tpu_torch.ops import exprs as X
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    return [X.dev_eval(e, ctx) for e in exprs]


def memory_phase(card, fields, arrays, q1_dir, tables, device=None) -> dict:
    """Spill, the retry protocol and planned out-of-core at full width:
    q1 at SF1 and q3 at bench's scale, every case exact.

    1. injected faults: q1 from memory under ``injectOOM`` 3, 2:2 and
       split:4 (``retryCount`` or ``splitRetryCount`` above 0, the stage
       graphs' buckets after the splits), q1 from Parquet under
       ``injectIOError=3`` (``ioRetryCount``), ``site:upload:2:2`` (the
       ring shrinks, the retries absorb every fault, all 8 row groups
       decode with ``decodeFused``) and ``site:upload:2:5`` (on the card
       the row group's OOM propagates: the query fails with every permit
       and store handle back and no host decode, and the next query is
       exact; on the CPU the row group takes its host decode);
    2. planned out-of-core: an unpressured run records what the planned
       operators estimate (``plannedWorkingSetBytes``); then
       ``deviceBudgetBytes`` at 1/8 of it: q1 and q3's shuffled form
       (``autoBroadcastJoinThreshold=-1``; at most 16 planned partitions
       and one level of re-planning) with ``plannedPartitions`` above 0,
       no retry, murmur3 launched on q1;
    3. spill tiers: q3's shuffled form under a 1 MiB pool
       (``spillCount`` above 0), then with a 64 KiB host tier (disk files
       written; none live after the store closes);
    4. on the card only, a real CUDA OOM: q1's peaks at full and at half
       batches, the allocator capped between them
       (``set_per_process_memory_fraction``, stepped down until a full
       batch fails), q1 again with no injector (exact, ``retryCount``
       and ``splitRetryCount`` at least 1); then a
       stage program whose capture hits a real OOM (no cache entry, the
       reserved bytes back after release, the next batch runs);
       groupbyHash at the split buckets and murmur3 at the out-of-core
       shapes against their plain versions;
    5. the store's cost on an unpressured q1: the default pool against a
       pool too large to spill, in turns.

    Returns the new kernel cases for the ``kernels`` line."""
    import glob

    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import memory as MEM
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.exec import fused as F
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    cuda = device is None or device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    want_q1 = q1_reference(arrays)
    want_q3 = q3_reference(tables)
    batch = host_batch_from_numpy(fields, arrays)
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    q3_batches = {name: host_batch_from_numpy(
        [(c, types[k]) for c, k, _a in cols], [a for _c, _k, a in cols])
        for name, cols in tables.items()}
    spill_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "spill")
    no_bcast = {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"}
    q1_pq = Q1.replace("FROM lineitem", "FROM lineitem_pq")

    def session(extra=None, q1_parts=N_PARTITIONS):
        s = TorchSparkSession({
            "spark.sql.shuffle.partitions": str(N_PARTITIONS),
            "spark.rapids.memory.spillDirectory": spill_dir,
            **(extra or {})}, device=device)
        s.createDataFrame(batch, num_partitions=q1_parts) \
            .createOrReplaceTempView("lineitem")
        s.read.parquet(q1_dir).createOrReplaceTempView("lineitem_pq")
        for name, b in q3_batches.items():
            s.createDataFrame(b, num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
        return s

    def run(s, sql: str) -> dict:
        R.reset_fault_injection()
        KR.reset_launches()
        F.reset_graph_counts()
        t0 = time.perf_counter()
        rows = s.sql(sql).collect()
        sync()
        wall = time.perf_counter() - t0
        if "l_returnflag" in sql:
            check_q1_rows(rows, want_q1)
        else:
            check_q3_rows(rows, want_q3, "q3 (memory phase)")
        return {"reference": "exact", "wall_s": wall,
                "counters": memory_counters(s.last_plan),
                "launches": dict(KR.LAUNCHES),
                "graph": {k: F.GRAPH_COUNTS[k]
                          for k in ("captures", "replays")},
                "stage_buckets": stage_buckets()}

    def require(what: str, ok: bool, out: dict) -> None:
        if not ok:
            raise AssertionError(f"memory phase, {what}: {out}")

    def launched(out: dict, kernel: str) -> int:
        """Launches on the card; on the CPU, where the plain versions run,
        the operators' dispatch counts."""
        if cuda:
            return out["launches"][kernel]
        return out["counters"][f"kernelDispatchCount.{kernel}"]

    # -- 1. injected faults ------------------------------------------------
    for sched in ("3", "2:2", "split:4"):
        # an empty stage cache: the split buckets capture in this run
        F.STAGE_CACHE.clear()
        out = run(session({"spark.rapids.sql.test.injectOOM": sched}), Q1)
        need = "splitRetryCount" if sched.startswith("split") \
            else "retryCount"
        phase("memory_inject", card=card, query="q1_memory",
              injectOOM=sched, **out)
        require(f"injectOOM={sched}", out["counters"][need] > 0, out)
    out = run(session({"spark.rapids.sql.test.injectIOError": "3"}), q1_pq)
    phase("memory_inject", card=card, query="q1_parquet", injectIOError="3",
          **out)
    require("injectIOError=3", out["counters"]["ioRetryCount"] > 0
            and launched(out, "decodeFused") > 0, out)
    # every 2nd copy to the card fails twice: the retries absorb it, and
    # each of the 8 row groups is decoded by decodeFused, none on the host
    out = run(session({"spark.rapids.sql.test.injectOOM":
                       "site:upload:2:2"}), q1_pq)
    phase("memory_inject", card=card, query="q1_parquet",
          injectOOM="site:upload:2:2", **out)
    require("site:upload:2:2",
            out["counters"]["deviceDecodeOomFallbacks"] == 0
            and out["counters"]["retryCount"] > 0
            and launched(out, "decodeFused") == N_PARTITIONS, out)
    # a streak longer than the retries: on the card the row group's OOM
    # propagates (its decode never moves to the host); the query fails
    # with every permit and store handle back, and the next query runs
    s = session({"spark.rapids.sql.test.injectOOM": "site:upload:2:5"})
    if cuda:
        R.reset_fault_injection()
        try:
            s.sql(q1_pq).collect()
            raised = None
        except R.TorchRetryOOM as e:
            raised = str(e)
        from spark_rapids_tpu_torch.resource import get_semaphore
        left = {"raised": raised,
                "permits_in_use": get_semaphore(s.conf_obj).in_use,
                "live_handles": MEM.get_device_store(s.conf_obj)
                .stats()["liveHandles"],
                "deviceDecodeOomFallbacks": memory_counters(s.last_plan)[
                    "deviceDecodeOomFallbacks"]}
        out = run(session(), q1_pq)
        phase("memory_inject", card=card, query="q1_parquet",
              injectOOM="site:upload:2:5", exhausted=left,
              next_query=out)
        require("site:upload:2:5", raised is not None
                and left["permits_in_use"] == 0
                and left["live_handles"] == 0
                and left["deviceDecodeOomFallbacks"] == 0
                and launched(out, "decodeFused") == N_PARTITIONS, left)
    else:
        out = run(s, q1_pq)
        phase("memory_inject", card=card, query="q1_parquet",
              injectOOM="site:upload:2:5", **out)
        require("site:upload:2:5",
                out["counters"]["deviceDecodeOomFallbacks"] > 0, out)

    # -- 2. planned out-of-core ---------------------------------------------
    ooc = {}
    # q3's shuffled joins hold both sides in the store, so at this budget
    # the headroom is 0 and every bucket re-plans: 16 partitions and one
    # level of recursion bound the buckets to 32 a join (the CPU tests
    # run the defaults)
    q3_bounds = {"spark.rapids.sql.outOfCore.maxPartitions": "16",
                 "spark.rapids.sql.outOfCore.maxRecursion": "1"}
    for query, sql, extra in (("q1_memory", Q1, {}),
                              ("q3_shuffled", Q3_BENCH,
                               {**no_bcast, **q3_bounds})):
        s = session(extra)
        run(s, sql)
        estimates = {}
        for i, p in enumerate(plan_nodes_of(s.last_plan)):
            reg = getattr(p, "metrics", None)
            v = reg.value("plannedWorkingSetBytes") if reg else 0
            if v:
                estimates[f"{type(p).__name__}#{i}"] = v
        estimate = max(estimates.values())
        budget = max(1, estimate // 8)
        s = session({**extra, "spark.rapids.sql.memory.deviceBudgetBytes":
                     str(budget)})
        out = run(s, sql)
        phase("memory_out_of_core", card=card, query=query,
              estimates_bytes=estimates, estimate_bytes=estimate,
              budget_bytes=budget, **out)
        c = out["counters"]
        require(f"{query} out of core", c["plannedPartitions"] > 0
                and c["retryCount"] == 0 and c["splitRetryCount"] == 0
                and (query != "q1_memory"
                     or launched(out, "murmur3") > 0), out)
        ooc[query] = s

    # -- 3. spill tiers -----------------------------------------------------
    # q3's shuffled form: its exchanges and joins hold store_sales
    pool = {**no_bcast, "spark.rapids.memory.tpu.poolSize": str(1 << 20)}
    s = session(pool)
    out = run(s, Q3_BENCH)
    stats = MEM.get_device_store(s.conf_obj).stats()
    phase("memory_spill", card=card, query="q3_shuffled",
          pool_bytes=1 << 20, store=stats, **out)
    require("pool spill", stats["spillCount"] > 0, stats)
    disk_dir = os.path.join(spill_dir, "disk_tier")
    s = session({**pool, "spark.rapids.memory.host.spillStorageSize":
                 str(64 << 10),
                 "spark.rapids.memory.spillDirectory": disk_dir})
    out = run(s, Q3_BENCH)
    store = MEM.get_device_store(s.conf_obj)
    used = store.stats()
    store.close()
    closed = store.stats()
    left = glob.glob(os.path.join(disk_dir, "spill-*.bin"))
    phase("memory_spill", card=card, query="q3_shuffled",
          pool_bytes=1 << 20, host_spill_bytes=64 << 10, store=used,
          after_close=closed,
          disk_files_left=len(left), **out)
    require("disk tier", used["diskSpillCount"] > 0
            and closed["diskFilesLive"] == 0 and not left, used)

    cases = {}
    if cuda:
        cases = oom_cases(card, session, run, require, ooc)

    # -- 5. the store's cost on an unpressured q1 ---------------------------
    walls = []
    for turn, pool_size in enumerate((None, 1 << 40)):
        extra = {} if pool_size is None else {
            "spark.rapids.memory.tpu.poolSize": str(pool_size)}
        s = session(extra)
        # the store is per process and conf: count this turn's spills only
        spills = MEM.get_device_store(s.conf_obj).stats()["spillCount"]
        df = s.sql(Q1)
        check_q1_rows(df.collect(), want_q1)
        w = timed_collects(df) if cuda else {}
        spills = MEM.get_device_store(s.conf_obj).stats()["spillCount"] \
            - spills
        walls.append({"turn": turn, "pool": pool_size or "default",
                      "spills": spills, **w})
        require("unpressured q1 spilled", spills == 0, walls[-1])
    phase("memory_store_cost", card=card, turns=walls)
    return cases


def oom_cases(card, session, run, require, ooc) -> dict:
    """Case 4 of ``memory_phase`` (the card only): a real CUDA OOM, a
    capture that runs out of memory, and the kernels at the new shapes."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.exec import fused as F
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.exec.join import TorchShuffledHashJoinExec
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.metrics import MetricRegistry

    def fresh():
        F.STAGE_CACHE.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def peak(parts: int) -> dict:
        fresh()
        s = session(q1_parts=parts)
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out = run(s, Q1)
        return {"partitions": parts, "stage_buckets": out["stage_buckets"],
                "peak_allocated": torch.cuda.max_memory_allocated() - a0,
                "peak_reserved": torch.cuda.max_memory_reserved() - r0,
                "wall_s": out["wall_s"]}

    full, half = peak(N_PARTITIONS), peak(2 * N_PARTITIONS)
    require("peaks", full["peak_reserved"] > half["peak_reserved"],
            {"full": full, "half": half})
    fresh()
    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_reserved()
    # the allocator's cap bounds its reserved bytes, and how much a batch
    # needs under it depends on fragmentation: step the cap down from
    # three quarters of the way between the half batches' reserved peak
    # and the full batches' until a full batch fails and splits (its
    # halves, with the full batch still alive, need about half's peak
    # plus one batch)
    levels = []
    for f in (0.75, 0.6, 0.45, 0.3):
        cap = base + half["peak_reserved"] + int(
            f * (full["peak_reserved"] - half["peak_reserved"]))
        fresh()
        GATE["off"] = True
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            out = run(session(), Q1)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            GATE["off"] = False
        levels.append({"between": f, "cap_bytes": cap,
                       "fraction": cap / total,
                       "retryCount": out["counters"]["retryCount"],
                       "splitRetryCount": out["counters"]["splitRetryCount"],
                       "wall_s": out["wall_s"]})
        if out["counters"]["splitRetryCount"]:
            break
    phase("memory_real_oom", card=card, query="q1_memory", injector=None,
          full=full, half=half, base_reserved=base, total_bytes=total,
          levels=levels, cap_bytes=cap, fraction=cap / total, **out)
    require("real OOM", out["counters"]["retryCount"] >= 1
            and out["counters"]["splitRetryCount"] >= 1, out)

    # a stage program whose capture runs out of memory for real: the
    # allocator cannot give 1 TiB, inside the capture only
    fresh()
    dev = torch.device("cuda", 0)
    metrics = MetricRegistry()
    flat = [torch.arange(1 << 20, dtype=torch.int64, device=dev)]
    key = ("memory-phase-capture-oom",)
    fail = [True]

    def fn(x):
        if fail[0] and torch.cuda.is_current_stream_capturing():
            torch.empty(1 << 40, dtype=torch.uint8, device=dev)
        return [x[0] * 2], None

    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    raised = None
    try:
        F.run_program(key, fn, flat, metrics)
    except torch.OutOfMemoryError as e:
        raised = type(e).__name__
    full_key = (key, F.input_signature(flat))
    cached_after_fail = full_key in F.STAGE_CACHE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after_fail = torch.cuda.memory_reserved()
    fail[0] = False
    outs, _m = F.run_program(key, fn, flat, metrics)  # builds, captures
    nxt = [flat[0] + 1]
    outs2, _m = F.run_program(key, fn, nxt, metrics)  # the next batch
    ok = bool(torch.equal(outs[0], flat[0] * 2)
              and torch.equal(outs2[0], nxt[0] * 2))
    with_entry = torch.cuda.memory_reserved()
    del outs, outs2, nxt
    F.release_stage_programs(everything=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    released = torch.cuda.memory_reserved()
    cap_case = {"raised": raised, "cache_entry_after_failure":
                cached_after_fail, "reserved_before": before,
                "reserved_after_failure": after_fail,
                "reserved_with_entry": with_entry,
                "reserved_after_release": released, "next_batch_exact": ok}
    phase("memory_capture_oom", card=card, **cap_case)
    require("capture OOM", raised == "OutOfMemoryError"
            and not cached_after_fail and after_fail == before
            and released == before and ok, cap_case)

    # groupbyHash at the split buckets: q1's first batch, halved, then
    # halved again, each half through the partial aggregate's inputs
    s = session()
    plan = s.plan_physical(s.sql(Q1).plan)
    agg = find_exec(plan, lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    b = next(iter(agg.child.device_partitions()[0]()))
    cases = {"groupbyHash": {}, "murmur3": {}}
    for name in ("q1_split_half", "q1_split_quarter"):
        b = R.split_device_batch(b)[0]
        key_cols, vals, prims, active = agg.update_inputs(b)
        kw, h, add, mn, mx, _d = KG.table_inputs(
            key_cols, [(v, p, dt) for v, (p, dt) in zip(vals, prims)],
            active)
        cases["groupbyHash"][name] = groupby_case(
            (kw, h, active, add, mn, mx),
            KR.table_slots(s.conf_obj, b.capacity))
    # murmur3 at the out-of-core splits: q1's final-aggregate input (the
    # partial results) and q3's date_dim join, both sides
    s1 = ooc["q1_memory"]
    final = find_exec(s1.plan_physical(s1.sql(Q1).plan), lambda p:
                      isinstance(p, TorchHashAggregateExec)
                      and p.mode == "final")
    b = next(iter(final.child.device_partitions()[0]()))
    cases["murmur3"]["ooc_agg_q1"] = murmur3_case(
        b.columns[:len(final.grouping)], b.capacity, 64)
    s3 = ooc["q3_shuffled"]
    plan3 = s3.plan_physical(s3.sql(Q3_BENCH).plan)
    joins = [p for p in plan_nodes_of(plan3)
             if isinstance(p, TorchShuffledHashJoinExec)]
    join = next((p for p in joins if any(
        getattr(k, "name", "") == "d_date_sk" for k in p.right_keys)),
        joins[0])
    lk, rk = join._bound_keys()
    left = next(iter(join.left.device_partitions()[0]()))
    right = next(iter(join.right.device_partitions()[0]()))
    side = [getattr(k, "name", repr(k)) for k in join.right_keys]
    cases["murmur3"]["ooc_join_q3_stream"] = dict(murmur3_case(
        key_columns(lk, left), left.capacity, 64), build_keys=side)
    cases["murmur3"]["ooc_join_q3_build"] = dict(murmur3_case(
        key_columns(rk, right), right.capacity, 64), build_keys=side)
    phase("memory_kernel_shapes", card=card, tolerance="exact", **cases)
    return cases


def all_torch(names, what: str) -> None:
    """Every node between the transitions is a Torch* operator (host
    sources under their upload excepted)."""
    bad = [n for n in names if not n.startswith("Torch")
           and n not in ("CpuLocalScanExec", "CpuFileScanExec",
                         "CpuCachedScanExec")]
    if names[0] != "TorchColumnarToRowExec" or bad:
        raise AssertionError(f"{what} plan is not all Torch*: {names}")


def capability_phase(device) -> dict:
    """The numeric capability probes' answers on the card (the tagger
    refuses float arithmetic, division and transcendentals on a device
    that is not exact)."""
    from spark_rapids_tpu_torch import device_caps
    caps = device_caps.capabilities(device)
    phase("capabilities", device=str(device), **caps)
    if not all(caps.values()):
        raise AssertionError(f"capability probes not exact: {caps}")
    return caps


def q12_run(spark, card: str, what: str, want, profile_name: str) -> dict:
    """One q12 leg: the first collect (launches per query counted), rows
    exact, the plan all Torch*, the join's route, then the wall (one
    warm run, mean of two) and one profiled warm run."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    df = spark.sql(Q12)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = [tuple(r) for r in df.collect()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    if rows != want:
        raise AssertionError(f"{what}: {rows} != {want}")
    names = plan_names(spark.last_plan)
    all_torch(names, what)
    joins = {type(p).__name__: dict(p.route_counts)
             for p in plan_nodes_of(spark.last_plan)
             if hasattr(p, "route_counts")}
    if launches["groupbyHash"] <= 0:
        raise AssertionError(f"{what}: no groupbyHash launch: {launches}")
    walls = timed_collects(df)
    prof = profile_collect(df, profile_name, card, warm=False)
    return {"rows": rows, "reference": "exact", "plan": names,
            "join_route": joins, "launches": launches,
            "first_run_s": first_s, "wall": walls,
            "device_idle_share": prof["device_idle_share"],
            "device_busy_s": prof["device_busy_s"],
            "profiled_wall_s": prof["profiled_wall_s"],
            "top_device_us": prof["top_device_us"]}


def q12_phases(device, card: str, n_lineitem: int = SF1_ROWS,
               n_orders: int = Q12_ORDERS) -> dict:
    """TPC-H q12 at SF1 (6,001,215 lineitem rows, 1,500,000 orders) from
    memory and from Parquet; returns the launches of each leg."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    t0 = time.perf_counter()
    tables = q12_tables(n_lineitem, n_orders)
    want = q12_reference(tables)
    gen_s = time.perf_counter() - t0
    parts = {"lineitem": N_PARTITIONS, "orders": N_PARTITIONS}
    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    for name, cols in tables.items():
        spark.createDataFrame(host_batch_from_numpy(*q12_fields(cols)),
                              num_partitions=parts[name]) \
            .createOrReplaceTempView(name)
    mem = q12_run(spark, card, "q12_memory", want, "q12_memory")
    phase("q12_memory", card=card, rows_in={"lineitem": n_lineitem,
                                            "orders": n_orders},
          generate_s=gen_s, **mem)
    dirs, write_s = {}, 0.0
    for name, cols in tables.items():
        dirs[name] = os.path.join(DATA_DIR, f"tpch_sf1_q12_{name}")
        write_s += write_once(dirs[name], lambda d, c=cols, n=name:
                              spark.createDataFrame(
                                  host_batch_from_numpy(*q12_fields(c)),
                                  num_partitions=parts[n])
                              .write.mode("overwrite").parquet(d),
                              data_key(seed=[SEED, Q12_SEED], table=name,
                                       rows=len(cols[0][2]),
                                       partitions=parts[name]))
    pq = TorchSparkSession({"spark.sql.shuffle.partitions":
                            str(N_PARTITIONS)})
    for name, d in dirs.items():
        pq.read.parquet(d).createOrReplaceTempView(name)
    par = q12_run(pq, card, "q12_parquet", want, "q12_parquet")
    scans = scan_counts(pq.last_plan)
    if par["launches"]["decodeFused"] <= 0 or scans.get(
            "deviceFallbackColumns", 0):
        raise AssertionError(f"q12_parquet: decode {par['launches']} "
                             f"{scans}")
    phase("q12_parquet", card=card, files=sum(
        len([f for f in os.listdir(d) if f.endswith(".parquet")])
        for d in dirs.values()), write_s=write_s,
        scan={k: v for k, v in scans.items()
              if k.startswith("device")}, **par)
    return {"memory": mem["launches"], "parquet": par["launches"]}


def q1_double_phase(card: str, arrays) -> dict:
    """TPC-H q1 at SF1 in its double form with variableFloatAgg: sums and
    averages through the segmented scan, within 1e-12 of the fsum
    reference; keys and counts exact; the wall and one profiled warm
    run."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    darrays = lineitem_double_arrays(arrays)
    want = q1_double_reference(darrays)
    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS),
                               "spark.rapids.sql.variableFloatAgg.enabled":
                               "true"})
    spark.createDataFrame(host_batch_from_numpy(lineitem_double_fields(),
                                                darrays),
                          num_partitions=N_PARTITIONS) \
        .createOrReplaceTempView("lineitem")
    df = spark.sql(Q1)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    worst = check_q1_double_rows(rows, want)
    names = plan_names(spark.last_plan)
    all_torch(names, "q1_double")
    walls = timed_collects(df)
    prof = profile_collect(df, "q1_double", card, warm=False)
    phase("q1_double", card=card, rows_in=len(arrays[0]),
          rows_out=len(rows),
          reference="math.fsum", rel_tol=1e-12, max_rel_err=worst,
          plan=names, launches=launches, first_run_s=first_s, wall=walls,
          rows_per_s=len(arrays[0]) / walls["median_s"],
          device_idle_share=prof["device_idle_share"],
          device_busy_s=prof["device_busy_s"],
          top_device_us=prof["top_device_us"])
    return launches


# rows of phase 13's expression battery on the card (half of
# BATTERY_ROWS since phase 22 joined the script: the CPU reference run
# of each family is most of the phase's time)
EXPRS_CARD_ROWS = 500_000


def exprs_card_phase(device, card: str, n: int = EXPRS_CARD_ROWS) -> dict:
    """Every expression family of the battery over ``n`` seeded rows on
    the card, held against the same port code on the CPU; each
    filter/project family runs as a fused stage captured as a CUDA graph
    (a handler that synchronised with the host would fail its
    capture)."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.exec import fused as FU
    fields, arrays, valid = battery_batch(n)
    sessions = {}
    for dev in (device, "cpu"):
        s, hb = battery_session(dev)
        s.createDataFrame(hb(fields, arrays, valid),
                          num_partitions=2).createOrReplaceTempView("bt")
        sessions[str(dev)] = s
    card_frames = battery_frames(sessions[str(device)])
    cpu_frames = battery_frames(sessions["cpu"])
    out = {}
    m3 = 0
    for name, (df, approx) in card_frames.items():
        FU.reset_graph_counts()
        KR.reset_launches()
        t0 = time.perf_counter()
        got = df._execute()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        graphs = dict(FU.GRAPH_COUNTS)
        launches = dict(KR.LAUNCHES)
        plan = sessions[str(device)].last_plan
        names = plan_names(plan)
        all_torch(names, f"exprs {name}")
        fused = any(n == "TorchFusedStageExec" for n in names)
        if name != "ids" and (not fused or graphs["captures"] <= 0):
            raise AssertionError(f"exprs {name}: no captured stage "
                                 f"({names}, {graphs})")
        t0 = time.perf_counter()
        want = cpu_frames[name][0]._execute()
        cpu_s = time.perf_counter() - t0
        err = compare_host_batches(got, want, approx)
        m3 += launches["murmur3"]
        out[name] = {"rows_out": got.num_rows,
                     "columns": len(got.columns),
                     "tolerance": "rel 1e-12" if approx else "exact",
                     "max_rel_err": err, "card_s": card_s,
                     "cpu_s": cpu_s, "graph_captures": graphs["captures"],
                     "graph_replays": graphs["replays"],
                     "launches": {k: v for k, v in launches.items() if v}}
    if out["hashes"]["launches"].get("murmur3", 0) <= 0:
        raise AssertionError("exprs hashes: hash() did not launch murmur3")
    phase("exprs_card", card=card, rows_in=n, families=out)
    return {"murmur3": m3}


# -- 14. residual conditions and adaptive execution -------------------------

AQE_COUNTERS = ("aqeBroadcastFlip", "aqeReplans", "aqeSkewSplits",
                "aqeCoalescedPartitions", "retryCount", "splitRetryCount")
ADAPTIVE_OFF = "spark.rapids.sql.adaptive.enabled"
SKEW_SEED = 20260735
SKEW_SHARE = 0.6
# the skew leg: one hot item, a shuffled join at 4 device partitions,
# grouped by brand so that the output stays small
Q_SKEW = """
SELECT i_brand_id, count(*) AS n, sum(ss_ext_sales_price) AS sales
FROM store_sales {jt} JOIN item ON ss_item_sk = i_item_sk
GROUP BY i_brand_id
ORDER BY i_brand_id
"""


def skew_tables(seed: int = SKEW_SEED, share: float = SKEW_SHARE):
    """q3's ``store_sales`` and ``item`` (``q3_tables``) with ``share`` of
    the store_sales rows' ``ss_item_sk`` set to one item, both drawn
    from ``seed``."""
    tables = q3_tables()
    rng = np.random.default_rng(seed)
    ss = {n: (k, a) for n, k, a in tables["store_sales"]}
    items = ss["ss_item_sk"][1].copy()
    hot = int(rng.integers(1, 20_001))
    items[rng.random(len(items)) < share] = hot
    tables["store_sales"] = [(n, k, items if n == "ss_item_sk" else a)
                             for n, (k, a) in ss.items()]
    return tables, hot


def skew_reference(tables):
    """Exact rows of ``Q_SKEW`` (every ss_item_sk is an item, so the
    inner and the left join agree): (i_brand_id, count, Decimal sum at
    scale 2) per brand, in brand order."""
    ss = {n: a for n, _k, a in tables["store_sales"]}
    it = {n: a for n, _k, a in tables["item"]}
    brand = it["i_brand_id"][ss["ss_item_sk"] - 1]
    ids, inv = np.unique(brand, return_inverse=True)
    counts = np.bincount(inv)
    sums = np.zeros(len(ids), dtype=object)
    np.add.at(sums, inv, ss["ss_ext_sales_price"].astype(object))
    return [(int(b), int(c), decimal.Decimal(int(v)).scaleb(-2))
            for b, c, v in zip(ids, counts, sums)]


def join_nodes(plan) -> list:
    """Each join of an executed plan: its kind, type, route counts,
    whether it holds a residual condition, and its children's kinds."""
    return [{"exec": type(p).__name__, "join_type": p.join_type,
             "route": dict(p.route_counts),
             "residual": p.condition is not None,
             "left": type(p.left).__name__,
             "right": type(p.right).__name__}
            for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]


@contextlib.contextmanager
def counted_demotion_reads():
    """Count the row counts the join's broadcast demotion reads, and how
    many of them were unknown (each such read synchronises): wraps
    ``_aqe_try_broadcast`` and, inside it only, ``SpillableBatch.rows``,
    for the ``with`` block only."""
    from spark_rapids_tpu_torch.exec.join import TorchShuffledHashJoinExec
    from spark_rapids_tpu_torch.memory import SpillableBatch
    counts = {"reads": 0, "syncs": 0}
    plain_try = TorchShuffledHashJoinExec._aqe_try_broadcast
    plain_rows = SpillableBatch.rows

    def rows(self):
        counts["reads"] += 1
        counts["syncs"] += self._state.rows is None
        return plain_rows.fget(self)

    def wrapped(self):
        SpillableBatch.rows = property(rows)
        try:
            return plain_try(self)
        finally:
            SpillableBatch.rows = plain_rows
    TorchShuffledHashJoinExec._aqe_try_broadcast = wrapped
    try:
        yield counts
    finally:
        TorchShuffledHashJoinExec._aqe_try_broadcast = plain_try


def first_batch(thunks, what: str):
    """The first batch of the first partition that yields one."""
    for thunk in thunks:
        for b in thunk():
            return b
    raise AssertionError(f"{what}: no batch")


def join_kernel_shapes(spark, query: str, what: str) -> dict:
    """murmur3 and groupbyHash at the shapes a phase-14 leg gives them,
    each against its plain version (exact): from a fresh plan of
    ``query``, the first batch each hash exchange hashes (at the
    exchange's partition count) and the first batch the partial
    aggregate updates with (after its absorbed prelude, at the slots the
    aggregate sizes)."""
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    from spark_rapids_tpu_torch.sql import physical as P
    plan = spark.plan_physical(spark.sql(query).plan)
    cases = {"groupbyHash": {}, "murmur3": {}}
    for ex in plan_nodes_of(plan):
        p = getattr(ex, "partitioning", None)
        if not isinstance(ex, TorchShuffleExchangeExec) or not isinstance(
                p, P.HashPartitioning) or p.num_partitions == 1:
            continue
        keys = [getattr(e, "name", repr(e)) for e in p.exprs]
        b = first_batch(ex.child.device_partitions(), what)
        cols = key_columns(P.bind_list(p.exprs, ex.child.output), b)
        cases["murmur3"][f"{what}_{'_'.join(keys)}"] = dict(
            murmur3_case(cols, b.capacity, p.num_partitions), keys=keys)
    cases["groupbyHash"] = partial_groupby_cases(spark, plan, what)
    return cases


def partial_groupby_cases(spark, plan, what: str, pick=None,
                          plain_reps: int = 3) -> dict:
    """groupbyHash on the first batch a plan's keyed partial aggregate
    (the first that ``pick`` accepts, where given) updates with (after
    its absorbed prelude, at the slots the aggregate sizes), exact
    against the plain version; a batch that overflows the table (the
    path re-ran it sorted) is held again at a table size that holds
    it."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    cases = {}
    agg = find_exec(plan, lambda n: isinstance(n, TorchHashAggregateExec)
                    and n.mode == "partial" and bool(n.grouping)
                    and (pick is None or pick(n)))
    if agg is not None:
        b = first_batch(agg.child.device_partitions(), what)
        key_cols, vals, prims, active = agg.update_inputs(b)
        kw, h, add, mn, mx, _d = KG.table_inputs(
            key_cols, [(v, p, dt) for v, (p, dt) in zip(vals, prims)],
            active)
        ins = (kw, h, active, add, mn, mx)
        slots = KR.table_slots(spark.conf_obj, b.capacity)
        # the plain reference's table: twice the batch's distinct keys
        groups = int(torch.unique(kw[active], dim=0).shape[0])
        ref = 64
        while ref < 2 * groups:
            ref <<= 1
        case = groupby_case(ins, slots, overflow_ok=True, ref_slots=ref,
                            plain_reps=plain_reps)
        cases[f"{what}_partial"] = case
        if case["overflow"]["kernel"]:
            fit = case["overflow"]["plain_complete_at_slots"]
            if fit == slots:
                fit *= 2
            cases[f"{what}_partial_{fit}_slots"] = groupby_case(
                ins, fit, plain_reps=plain_reps)
    return cases


def joins_leg(spark, card: str, what: str, query: str, want, check,
              reads: dict) -> dict:
    """One leg of phase 14: the first collect (launches counted, the
    demotion's row-count reads counted), rows exact, the plan all
    Torch*, the joins and the adaptive counters, ``check(plan, counters,
    launches)`` for the leg's own conditions; the same query with
    adaptive execution off (the same rows, no adaptive counter); the
    walls of both, one timed run each in turns (on, off) after their
    first runs; one profiled warm run."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.metrics import plan_metrics
    df = spark.sql(query)

    def collect(adaptive: bool):
        if not adaptive:
            spark.conf.set(ADAPTIVE_OFF, "false")
        try:
            t0 = time.perf_counter()
            out = [tuple(r) for r in df.collect()]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            spark.conf.unset(ADAPTIVE_OFF)

    KR.reset_launches()
    reads.update(reads=0, syncs=0)
    rows, first_s = collect(True)
    launches = dict(KR.LAUNCHES)
    demotion_reads = dict(reads)
    if rows != want:
        raise AssertionError(f"{what}: {rows[:5]} != {want[:5]}")
    plan = spark.last_plan
    names = plan_names(plan)
    all_torch(names, what)
    m = plan_metrics(plan)
    counters = {k: m.get(k, 0) for k in AQE_COUNTERS}
    joins = join_nodes(plan)
    # batches whose groupbyHash table overflowed and re-ran sorted
    reruns = sum(getattr(n, "overflow_reruns", 0)
                 for p in plan_nodes_of(plan)
                 for n in [p] + list(getattr(p, "fused_ops", [])))
    check(plan, counters, launches)
    off_rows, off_first_s = collect(False)
    m_off = plan_metrics(spark.last_plan)
    off_counters = {k: m_off.get(k, 0) for k in AQE_COUNTERS}
    if off_rows != rows or any(off_counters[k] for k in AQE_COUNTERS[:4]):
        raise AssertionError(f"{what} adaptive off: {off_counters}, rows "
                             f"equal: {off_rows == rows}")
    off_joins = join_nodes(spark.last_plan)
    walls = {True: [], False: []}
    for _ in range(1):
        for adaptive in (True, False):
            walls[adaptive].append(collect(adaptive)[1])
    prof = profile_collect(df, what, card, warm=False)

    def wall(runs):
        return {"warm_runs": 1, "timed_runs": runs,
                "median_s": statistics.median(runs)}
    return {"rows_out": len(rows), "reference": "exact", "plan": names,
            "joins": joins, "aqe": counters,
            "demotion_row_reads": demotion_reads,
            "exchange_total_bytes": m.get("exchangeTotalBytes", 0),
            "launches": launches, "groupby_overflow_reruns": reruns,
            "first_run_s": first_s,
            "wall": wall(walls[True]), "turns": "on, off",
            "device_idle_share": prof["device_idle_share"],
            "device_busy_s": prof["device_busy_s"],
            "profiled_wall_s": prof["profiled_wall_s"],
            "top_device_us": prof["top_device_us"],
            "adaptive_off": {"rows": "equal", "aqe": off_counters,
                             "joins": off_joins,
                             "first_run_s": off_first_s,
                             "wall": wall(walls[False])}}


def joins_phases(device, card: str) -> tuple:
    """Phase 14: TPC-H q12 in its optimizer form and q19 at SF1 from
    memory and from Parquet, and the skew leg; returns each leg's kernel
    launches and the murmur3 and groupbyHash cases at the legs' shapes
    (``join_kernel_shapes``)."""
    with counted_demotion_reads() as reads:
        return joins_legs(device, card, reads)


def joins_legs(device, card: str, reads: dict) -> tuple:
    """``joins_phases``' legs, with the demotion's row reads counted in
    ``reads``."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    t0 = time.perf_counter()
    tables = q19_tables()
    want12 = q12_reference(tables)
    want19, kept19 = q19_reference(tables)
    gen_s = time.perf_counter() - t0
    sizes = {n: len(cols[0][2]) for n, cols in tables.items()}
    conf = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}

    def q12_check(plan, c, launches):
        (join,) = join_nodes(plan)
        # the planner's shuffled join, demoted at run time: orders'
        # exchange is gone from the executed plan
        if c["aqeBroadcastFlip"] != 1 or \
                join["exec"] != "TorchShuffledHashJoinExec" or \
                join["left"] == "TorchShuffleExchangeExec":
            raise AssertionError(f"q12 pushed not demoted: {c} {join}")
        if launches["groupbyHash"] <= 0:
            raise AssertionError(f"q12 pushed: no groupbyHash: {launches}")

    def q19_check(plan, c, launches):
        (join,) = join_nodes(plan)
        if not join["residual"] or join["join_type"] != "inner":
            raise AssertionError(f"q19 join without its residual: {join}")

    legs = {}
    hbs = {n: host_batch_from_numpy(*q12_fields(cols))
           for n, cols in tables.items()}
    mem = TorchSparkSession(dict(conf))
    for name, hb in hbs.items():
        mem.createDataFrame(hb, num_partitions=N_PARTITIONS) \
            .createOrReplaceTempView(name)
    for leg, query, want, check in (
            ("q12_pushed_memory", Q12_PUSHED, want12, q12_check),
            ("q19_memory", Q19, want19, q19_check)):
        out = joins_leg(mem, card, leg, query, want, check, reads)
        phase(leg, card=card, rows_in=sizes, generate_s=gen_s, **out)
        legs[leg] = out["launches"]
    shapes = {"groupbyHash": {}, "murmur3": {}}

    def add_shapes(cases):
        for kernel, named in cases.items():
            shapes[kernel].update(named)
    add_shapes(join_kernel_shapes(mem, Q12_PUSHED, "q12_pushed"))
    del mem, hbs
    dirs, write_s = {}, 0.0
    for name, cols in tables.items():
        dirs[name] = os.path.join(DATA_DIR, f"tpch_sf1_q19_{name}")
        write_s += write_once(
            dirs[name], lambda d, c=cols: TorchSparkSession(dict(conf))
            .createDataFrame(host_batch_from_numpy(*q12_fields(c)),
                             num_partitions=N_PARTITIONS)
            .write.mode("overwrite").parquet(d),
            data_key(seed=[SEED, Q12_SEED, Q19_SEED], table=name,
                     rows=len(cols[0][2]), partitions=N_PARTITIONS))
    pq = TorchSparkSession(dict(conf))
    for name, d in dirs.items():
        pq.read.parquet(d).createOrReplaceTempView(name)
    for leg, query, want, check in (
            ("q12_pushed_parquet", Q12_PUSHED, want12, q12_check),
            ("q19_parquet", Q19, want19, q19_check)):
        out = joins_leg(pq, card, leg, query, want, check, reads)
        scans = scan_counts(pq.last_plan)
        if out["launches"]["decodeFused"] <= 0 or scans.get(
                "deviceFallbackColumns", 0):
            raise AssertionError(f"{leg}: decode {out['launches']} {scans}")
        phase(leg, card=card, write_s=write_s, q19_rows_kept=kept19,
              scan={k: v for k, v in scans.items()
                    if k.startswith("device")}, **out)
        legs[leg] = out["launches"]
    del pq, tables

    # the skew leg: q3's store_sales with one hot item
    t0 = time.perf_counter()
    stables, hot = skew_tables()
    want_skew = skew_reference(stables)
    sgen_s = time.perf_counter() - t0
    from spark_rapids_tpu_torch.sql import types as T
    kinds = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    skew = TorchSparkSession(dict(conf, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": "-1",
        "spark.rapids.sql.shuffle.devicePartitions": "4"}))
    for name in ("store_sales", "item"):
        cols = stables[name]
        skew.createDataFrame(host_batch_from_numpy(
            [(c, kinds[k]) for c, k, _a in cols],
            [a for _c, _k, a in cols]),
            num_partitions=Q3_PARTITIONS[name]) \
            .createOrReplaceTempView(name)

    def skew_check(plan, c, launches):
        if c["aqeSkewSplits"] < 1 or c["aqeCoalescedPartitions"] < 1 \
                or c["retryCount"] or launches["murmur3"] <= 0:
            raise AssertionError(f"skew leg: {c} {launches}")

    for jt in ("inner", "left"):
        leg = f"aqe_skew_{jt}"
        out = joins_leg(skew, card, leg,
                        Q_SKEW.format(jt="LEFT" if jt == "left" else ""),
                        want_skew, skew_check, reads)
        phase("aqe_skew", card=card, join_type=jt, hot_item=hot,
              hot_share=SKEW_SHARE, device_partitions=4,
              rows_in={"store_sales": Q3_SALES_ROWS, "item": 20_000},
              generate_s=sgen_s, **out)
        legs[leg] = out["launches"]
    add_shapes(join_kernel_shapes(skew, Q_SKEW.format(jt=""), "skew"))
    phase("joins_kernel_shapes", card=card, tolerance="exact", **shapes)
    return legs, shapes


# -- phase 15: range, union, expand and window (TPC-DS q98, q51, q86) ------

WINDOWS_SEED = 20260736
TPCDS_CATEGORIES = ("Books", "Children", "Electronics", "Home", "Jewelry",
                    "Men", "Music", "Shoes", "Sports", "Women")
CLASSES_PER_CATEGORY = 16
# d_date of d_date_sk 1, and the five store years the sales fall in
WINDOWS_FIRST_DAY = 10_228  # 1998-01-02, days since 1970-01-01
WINDOWS_DAYS = 1_826
DESC_WORDS = ("able", "about", "across", "actual", "again", "almost",
              "always", "areas", "become", "before", "better", "black",
              "blue", "bright", "carefully", "central", "certain", "clear",
              "common", "current", "different", "early", "easy", "english",
              "final", "free", "full", "general", "good", "great", "green",
              "happy", "high", "important", "large", "little", "local",
              "major", "modern", "national", "new", "old", "open", "other",
              "political", "possible", "public", "real", "red", "right",
              "simple", "small", "social", "special", "strong", "true",
              "white", "whole", "young")

# TPC-DS q98 (class revenue ratios) in its double form: the aggregate in
# a subquery, the window over it, and item's and date_dim's predicates
# pushed into the joined subqueries, as q3's pushed form has them
Q98_PUSHED = """
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue,
       itemrevenue * 100 / sum(itemrevenue) OVER (PARTITION BY i_class)
         AS revenueratio
FROM (SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
             sum(ss_ext_sales_price) AS itemrevenue
      FROM store_sales
      JOIN (SELECT i_item_sk, i_item_id, i_item_desc, i_category, i_class,
                   i_current_price
            FROM item WHERE i_category IN ('Sports', 'Books', 'Home')) it
        ON ss_item_sk = i_item_sk
      JOIN (SELECT d_date_sk FROM date_dim
            WHERE d_date BETWEEN date '1999-02-22' AND date '1999-03-24') dt
        ON ss_sold_date_sk = d_date_sk
      GROUP BY i_item_id, i_item_desc, i_category, i_class,
               i_current_price) x
ORDER BY i_category, i_class, i_item_id, i_item_desc, revenueratio
"""

# TPC-DS q51's store_v1 half (running store sales per item), double form
Q51_STORE = """
SELECT item_sk, d_date,
       sum(sales) OVER (PARTITION BY item_sk ORDER BY d_date
                        ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
         AS cume_sales
FROM (SELECT ss_item_sk AS item_sk, d_date, sum(ss_sales_price) AS sales
      FROM store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk
      WHERE d_month_seq BETWEEN 1200 AND 1211 AND ss_item_sk IS NOT NULL
      GROUP BY ss_item_sk, d_date) x
"""

# q86's three-way join (over store_sales; q86 reads web_sales), which
# the rollup and the rank take as a DataFrame (neither parser has ROLLUP
# or grouping())
Q86_JOIN = """
SELECT i_category, i_class, ss_ext_sales_price
FROM {store_sales}
JOIN (SELECT d_date_sk FROM date_dim
      WHERE d_month_seq BETWEEN 1200 AND 1211) dt
  ON ss_sold_date_sk = d_date_sk
JOIN item ON ss_item_sk = i_item_sk
"""

Q_RANGE = """
SELECT k, count(*) AS cnt, sum(id) AS total
FROM (SELECT id % 1000 AS k, id FROM r) t
GROUP BY k ORDER BY k
"""
RANGE_ROWS = SF1_ROWS


def q86_frame(spark, F, store_sales: str = "store_sales"):
    """q86's rollup and rank: ``rollup(i_category, i_class)`` over the
    three-way join with the decimal sum, ``rank()`` over the category by
    the total descending, ordered by category, rank and class. ``F`` is
    the session's package's ``functions`` module."""
    j = spark.sql(Q86_JOIN.format(store_sales=store_sales))
    r = j.rollup("i_category", "i_class").agg(
        F.sum("ss_ext_sales_price").alias("total"))
    w = F.Window.partitionBy("i_category").orderBy(F.col("total").desc())
    return r.select("i_category", "i_class", "total",
                    F.rank().over(w).alias("rank_within_parent")) \
        .orderBy("i_category", "rank_within_parent", "i_class")


def windows_tables(n_sales: int = Q3_SALES_ROWS, seed: int = Q3_SEED,
                   extra_seed: int = WINDOWS_SEED):
    """Phase 15's tables: ``q3_tables`` (bench.py's generator, its columns
    byte for byte) with TPC-DS columns added from ``extra_seed``, in
    TPC-DS's domains: item's ``i_item_id`` (16 characters, one per item),
    ``i_item_desc`` (3-12 words), ``i_category`` (the 10 categories,
    uniform), ``i_class`` (16 per category) and ``i_current_price``
    (decimal(7,2), 0.09-99.99); date_dim's ``d_date`` (1998-01-02 +
    ((d_date_sk - 1) mod 1,826) days, so the sales fall in TPC-DS's five
    store years and a 30-day range keeps about 1.6% of them) and
    ``d_month_seq`` ((year - 1900) * 12 + month - 1); store_sales'
    ``ss_sales_price`` (decimal(7,2), U[0.00, 200.00]). Kinds as
    ``q3_tables``' plus ``date`` (int32 days). No scale cut against
    bench's q3 (2,000,000 store_sales rows, 20,000 items, 73,049 dates);
    TPC-DS SF1 has 2,880,404 store_sales rows and 18,000 items, and
    bench's sizes keep phase 15 beside phases 3-5. The double form
    (``windows_fields(..., double=True)``) carries the three price
    columns as doubles with the same values."""
    tables = q3_tables(n_sales, seed)
    rng = np.random.default_rng(extra_seed)
    n_item = len(tables["item"][0][2])
    sk = tables["item"][0][2]
    letters = np.array(list("ABCDEFGHIJKLMNOP"))
    digits = (sk[:, None] >> (4 * np.arange(7, -1, -1))) & 15
    item_id = np.array(["AAAAAAAA" + "".join(row)
                        for row in letters[digits]], dtype=object)
    words = np.array(DESC_WORDS, dtype=object)
    lens = rng.integers(3, 13, n_item)
    picks = rng.integers(0, len(words), (n_item, 12))
    desc = np.array([" ".join(words[picks[i, :lens[i]]]).capitalize()
                     for i in range(n_item)], dtype=object)
    cat_i = rng.integers(0, len(TPCDS_CATEGORIES), n_item)
    cls_i = rng.integers(1, CLASSES_PER_CATEGORY + 1, n_item)
    cats = np.array(TPCDS_CATEGORIES, dtype=object)[cat_i]
    classes = np.array([f"{c.lower()}{k:02d}" for c, k in zip(cats, cls_i)],
                       dtype=object)
    tables["item"] += [
        ("i_item_id", "str", item_id), ("i_item_desc", "str", desc),
        ("i_category", "str", cats), ("i_class", "str", classes),
        ("i_current_price", "dec72", rng.integers(9, 10_000, n_item))]
    dsk = tables["date_dim"][0][2]
    d_date = (WINDOWS_FIRST_DAY + (dsk - 1) % WINDOWS_DAYS).astype(np.int32)
    ymd = d_date.astype("datetime64[D]")
    year = ymd.astype("datetime64[Y]").astype(np.int64) + 1970
    month = ymd.astype("datetime64[M]").astype(np.int64) % 12 + 1
    tables["date_dim"] += [
        ("d_date", "date", d_date),
        ("d_month_seq", "int", ((year - 1900) * 12 + month - 1)
         .astype(np.int32))]
    n = len(tables["store_sales"][0][2])
    tables["store_sales"] += [
        ("ss_sales_price", "dec72", rng.integers(0, 20_001, n))]
    return tables


WINDOWS_PRICES = ("ss_ext_sales_price", "ss_sales_price", "i_current_price")


def windows_fields(cols, double: bool = False):
    """``(fields, arrays)`` of one table for ``host_batch_from_numpy``;
    ``double`` gives the price columns as doubles of the same values (the
    ``useDoubleForDecimal`` form, databricks/spark-sql-perf)."""
    from spark_rapids_tpu_torch.sql import types as T
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2), "date": T.DateT,
             "dbl": T.DoubleT}
    fields, arrays = [], []
    for name, kind, a in cols:
        if double and name in WINDOWS_PRICES:
            kind, a = "dbl", a / 100.0
        fields.append((name, types[kind]))
        arrays.append(a)
    return fields, arrays


def _cols(tables):
    return {t: {name: a for name, _k, a in cols}
            for t, cols in tables.items()}


def _dim_rows(dim_keys, fact_keys):
    """Row of the dimension table for each fact key (keys are 1..n)."""
    return fact_keys - dim_keys[0]


def q98_reference(tables):
    """q98's rows from integer cents: ``(i_item_id, i_item_desc,
    i_category, i_class, i_current_price, itemrevenue, revenueratio)``
    in the query's order, the doubles the exact values rounded once."""
    c = _cols(tables)
    ss, it, dd = c["store_sales"], c["item"], c["date_dim"]
    irow = _dim_rows(it["i_item_sk"], ss["ss_item_sk"])
    drow = _dim_rows(dd["d_date_sk"], ss["ss_sold_date_sk"])
    lo = (np.datetime64("1999-02-22") - np.datetime64("1970-01-01")) \
        .astype(np.int64)
    hi = (np.datetime64("1999-03-24") - np.datetime64("1970-01-01")) \
        .astype(np.int64)
    keep = np.isin(it["i_category"][irow], ["Sports", "Books", "Home"]) \
        & (dd["d_date"][drow] >= lo) & (dd["d_date"][drow] <= hi)
    cents = np.zeros(len(it["i_item_sk"]), dtype=np.int64)
    np.add.at(cents, irow[keep], ss["ss_ext_sales_price"][keep])
    items = np.unique(irow[keep])
    by_class: dict = {}
    for i in items:
        by_class[it["i_class"][i]] = by_class.get(it["i_class"][i], 0) \
            + int(cents[i])
    from fractions import Fraction
    rows = []
    for i in items:
        rows.append((it["i_item_id"][i], it["i_item_desc"][i],
                     it["i_category"][i], it["i_class"][i],
                     int(it["i_current_price"][i]) / 100.0,
                     int(cents[i]) / 100.0,
                     float(Fraction(int(cents[i]) * 100,
                                    by_class[it["i_class"][i]]))))
    rows.sort(key=lambda r: (r[2], r[3], r[0], r[1], r[6]))
    return rows


def q51_reference(tables):
    """q51's store half from integer cents: ``{(item_sk, d_date): cume
    sales}`` (a date as days since 1970-01-01), the running sum of each
    item's daily sums in date order, rounded once to a double."""
    c = _cols(tables)
    ss, dd = c["store_sales"], c["date_dim"]
    drow = _dim_rows(dd["d_date_sk"], ss["ss_sold_date_sk"])
    seq = dd["d_month_seq"][drow]
    keep = (seq >= 1200) & (seq <= 1211)
    item = ss["ss_item_sk"][keep].astype(np.int64)
    day = dd["d_date"][drow][keep].astype(np.int64)
    cents = ss["ss_sales_price"][keep]
    key = item * 100_000 + day
    uk, inv = np.unique(key, return_inverse=True)
    daily = np.zeros(len(uk), dtype=np.int64)
    np.add.at(daily, inv, cents)
    items = uk // 100_000
    first = np.r_[True, items[1:] != items[:-1]]
    run = np.cumsum(daily)
    start = np.maximum.accumulate(np.where(first, np.arange(len(uk)), 0))
    base = np.where(start > 0, run[np.maximum(start - 1, 0)], 0)
    cume = run - base
    return {(int(k // 100_000), int(k % 100_000)): int(v) / 100.0
            for k, v in zip(uk, cume)}


def q86_reference(tables):
    """q86's rollup and rank over store_sales from integer cents:
    ``(i_category, i_class, total Decimal, rank)`` in the query's order
    (category, rank, class; nulls first)."""
    c = _cols(tables)
    ss, it, dd = c["store_sales"], c["item"], c["date_dim"]
    drow = _dim_rows(dd["d_date_sk"], ss["ss_sold_date_sk"])
    irow = _dim_rows(it["i_item_sk"], ss["ss_item_sk"])
    seq = dd["d_month_seq"][drow]
    keep = (seq >= 1200) & (seq <= 1211)
    cat = it["i_category"][irow][keep]
    cls = it["i_class"][irow][keep]
    cents = ss["ss_ext_sales_price"][keep]
    sums: dict = {}
    for ca, cl, v in zip(cat, cls, cents):
        for key in ((ca, cl), (ca, None), (None, None)):
            sums[key] = sums.get(key, 0) + int(v)
    rows = []
    for (ca, cl), v in sums.items():
        part = [t for (a, _b), t in sums.items() if a == ca]
        rank = 1 + sum(1 for t in part if t > v)
        rows.append((ca, cl, decimal.Decimal(v).scaleb(-2), rank))

    def key(r):
        return (r[0] is not None, r[0] or "", r[3], r[1] is not None,
                r[1] or "")
    return sorted(rows, key=key)


def range_reference(n: int = RANGE_ROWS):
    """``(k, count, sum of id)`` for ``id % 1000`` over ``range(n)``."""
    ids = np.arange(n, dtype=np.int64)
    k = ids % 1000
    cnt = np.bincount(k, minlength=1000)
    tot = np.zeros(1000, dtype=np.int64)
    np.add.at(tot, k, ids)
    return [(int(i), int(cnt[i]), int(tot[i])) for i in range(1000)
            if cnt[i]]


def check_close_rows(got, want, what: str, float_cols, rel_tol=1e-12):
    """Ordered rows equal: the columns in ``float_cols`` within
    ``rel_tol`` relative, every other column exactly. Returns the largest
    relative error seen."""
    import math
    got = [tuple(r) for r in got]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        for j, (a, b) in enumerate(zip(g, w)):
            if j in float_cols:
                err = abs(a - b) / max(abs(b), 1e-300) if b else abs(a)
                worst = max(worst, err)
                if not math.isclose(a, b, rel_tol=rel_tol, abs_tol=0.0) \
                        and a != b:
                    raise AssertionError(f"{what}: {g} != {w}")
            elif a != b:
                raise AssertionError(f"{what}: {g} != {w}")
    return worst


def check_q51_rows(got, want: dict, what: str, rel_tol=1e-12) -> float:
    """Every (item, date) once, its running sum within ``rel_tol``."""
    import datetime
    import math
    epoch = datetime.date(1970, 1, 1)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    worst = 0.0
    seen = set()
    for item, d, v in got:
        key = (int(item), (d - epoch).days)
        w = want.get(key)
        if w is None or key in seen:
            raise AssertionError(f"{what}: unexpected row {item, d, v}")
        seen.add(key)
        if not math.isclose(v, w, rel_tol=rel_tol, abs_tol=0.0) and v != w:
            raise AssertionError(f"{what}: {item, d}: {v} != {w}")
        if w:
            worst = max(worst, abs(v - w) / abs(w))
    return worst


WINDOWS_CONF = {"spark.sql.shuffle.partitions": str(N_PARTITIONS),
                "spark.rapids.sql.variableFloatAgg.enabled": "true"}
# leg b's key-batched run: at one device partition the window takes the
# aggregate's one output batch and windows it whole (in both packages,
# whatever batchSizeRows is); at two, the window's input holds a batch
# from each partition of the aggregate, over 131,072 rows in all, so it
# is key-batched
WINDOWS_BATCHED = {"spark.rapids.sql.batchSizeRows": "131072",
                   "spark.rapids.sql.shuffle.devicePartitions": "2"}


def window_execs(plan) -> list:
    from spark_rapids_tpu_torch.exec.window import TorchWindowExec
    return [p for p in plan_nodes_of(plan) if isinstance(p, TorchWindowExec)]


def window_batch_kernels(spark, df, what: str) -> dict:
    """The CUDA kernels of one window batch at the leg's shape: from a
    fresh plan of ``df``, the window's first input partition
    concatenated (as the exec concatenates it), then ``_run_batch`` under
    torch.profiler (``device_kernels``)."""
    from spark_rapids_tpu_torch.columnar.device import concat_device
    from spark_rapids_tpu_torch.memory import release_plan_handles
    plan = spark.plan_physical(df.plan)
    try:
        (w,) = window_execs(plan)
        parts = [[b for b in t()] for t in w.child.device_partitions()]
        whole = concat_device(next(p for p in parts if p))
        planned = w._plan_items()
        k = device_kernels(lambda: w._run_batch(whole, planned), calls=3)
        return {"rows": whole.row_count(), "capacity": whole.capacity,
                "cuda_kernels": k["launches"], "busy_us": k["busy_us"],
                "span_us": k["span_us"],
                "ms": cuda_ms(lambda: w._run_batch(whole, planned), 3),
                "top_kernel_us": dict(sorted(
                    k["kernel_us"].items(), key=lambda kv: -kv[1])[:5])}
    finally:
        release_plan_handles(plan)


def windows_leg(spark, card: str, what: str, make_df, check,
                node: str) -> dict:
    """One leg of phase 15: the first collect (launches counted), its
    rows through ``check(rows)`` (which raises unless they are right and
    returns the largest relative error), the plan all Torch* with
    ``node`` in it, the window's ``dispatchCount``, one warm run and the
    mean of two timed, and one profiled warm run."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    df = make_df()
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = [tuple(r) for r in df.collect()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    err = check(rows)
    plan = spark.last_plan
    names = plan_names(plan)
    all_torch(names, what)
    if node not in names:
        raise AssertionError(f"{what}: no {node} in {names}")
    windows = [w.metrics.snapshot().get("dispatchCount", 0)
               for w in window_execs(plan)]
    df.collect()  # warm
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profile_collect(df, what, card, warm=False)
    return {"rows": rows, "out": {
        "rows_out": len(rows), "max_rel_err": err, "plan": names,
        "launches": launches, "window_dispatch_count": windows,
        "first_run_s": first_s, "warm_runs": 1, "timed_runs": walls,
        "median_s": statistics.median(walls),
        "device_idle_share": prof["device_idle_share"],
        "device_busy_s": prof["device_busy_s"],
        "profiled_wall_s": prof["profiled_wall_s"],
        "top_device_us": prof["top_device_us"]}}


def join_probe_case(j, what: str) -> dict:
    """joinProbe at one broadcast join's shape: its build side against
    its first stream batch, exact against the plain version, timed beside
    its byte bound."""
    import torch
    from spark_rapids_tpu_torch.kernels import join_probe as KJ
    from spark_rapids_tpu_torch.ops import join as J
    lk, rk = j._bound_keys()
    right = first_batch(j.right.device_partitions(), f"{what} build")
    left = first_batch(j.left.device_partitions(), f"{what} stream")
    ins = J.probe_inputs(lk, rk, j.null_safe, left, right)
    km, kf = KJ.build_probe(*ins)
    pm, pf = KJ.build_probe_plain(*ins)
    torch.cuda.synchronize()
    err = max(int((km.long() - pm.long()).abs().max()),
              int((kf.long() - pf.long()).abs().max()))
    if err != 0:
        raise AssertionError(f"joinProbe != plain on {what}")
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + ins[2].shape[0] * 5
    return {"rows": int(ins[2].shape[0]), "build_cap": int(ins[0].shape[0]),
            "build_valid": int(ins[1].sum()),
            "key_words": int(ins[0].shape[1]),
            "stream_valid": int(ins[3].sum()), "matched": int(km.sum()),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: KJ.build_probe(*ins), 50),
            "plain_ms": wall_ms(lambda: KJ.build_probe_plain(*ins), 5),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "cuda_launches": device_kernels(
                lambda: KJ.build_probe(*ins))["launches"]}


def broadcast_joins(spark, df, what: str) -> dict:
    """``join_probe_case`` at every broadcast join of a fresh plan of
    ``df``, keyed by ``what(join)``."""
    from spark_rapids_tpu_torch.exec.join import TorchBroadcastHashJoinExec
    from spark_rapids_tpu_torch.memory import release_plan_handles
    plan = spark.plan_physical(df.plan)
    try:
        return {what(j): join_probe_case(j, what(j))
                for j in plan_nodes_of(plan)
                if isinstance(j, TorchBroadcastHashJoinExec)}
    finally:
        release_plan_handles(plan)


def q98_join_probe_cases(spark, df) -> dict:
    """joinProbe at leg a's two joins (item's and date_dim's pushed
    build sides against the first store_sales batch)."""
    cases = broadcast_joins(
        spark, df, lambda j: "q98_date_dim" if "d_date_sk" in
        [a.name for a in j.right.output] else "q98_item")
    if set(cases) != {"q98_item", "q98_date_dim"}:
        raise AssertionError(f"q98 join shapes: {sorted(cases)}")
    return cases


def windows_phases(device, card: str) -> tuple:
    """Phase 15: TPC-DS q98 (pushed, double form), q51's store half
    (double form; also key-batched), a q86-shaped rollup with a rank, the
    same over a union of two store_sales views, and a range under a
    group-by, at bench's q3 scale from memory and (q98, q51, q86) from
    Parquet; each leg's rows against its numpy reference, then joinProbe
    and groupbyHash at the legs' shapes (``windows_kernel_shapes``).
    Returns each leg's kernel launches and the shapes' cases."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    t0 = time.perf_counter()
    tables = windows_tables()
    want98 = q98_reference(tables)
    want51 = q51_reference(tables)
    want86 = q86_reference(tables)
    want_range = range_reference()
    gen_s = time.perf_counter() - t0
    sizes = {n: len(cols[0][2]) for n, cols in tables.items()}
    legs, shapes = {}, {"groupbyHash": {}, "joinProbe": {}}
    got51 = {}

    def check98(rows):
        return check_close_rows(rows, want98, "q98", {4, 5, 6})

    def check51(rows):
        return check_q51_rows(rows, want51, "q51")

    def check86(rows):
        if rows != want86:
            raise AssertionError(f"q86: {rows[:3]} != {want86[:3]}")
        return 0.0

    def check_range(rows):
        if rows != want_range:
            raise AssertionError(f"range: {rows[:3]} != {want_range[:3]}")
        return 0.0

    def run(spark, leg, make_df, check, node, **extra):
        out = windows_leg(spark, card, leg, make_df, check, node)
        launches = out["out"]["launches"]
        if leg.endswith("parquet") and launches["decodeFused"] <= 0:
            raise AssertionError(f"{leg}: no decodeFused: {launches}")
        if leg.startswith("q98") and launches["joinProbe"] <= 0:
            raise AssertionError(f"{leg}: no joinProbe: {launches}")
        if leg.startswith(("q86", "range")) and launches["groupbyHash"] <= 0:
            raise AssertionError(f"{leg}: no groupbyHash: {launches}")
        if node == "TorchWindowExec" and leg != "q51_store_batched":
            extra["window_batch"] = window_batch_kernels(spark, make_df(),
                                                         leg)
        phase(leg, card=card, rows_in=sizes, generate_s=gen_s, **extra,
              **out["out"])
        legs[leg] = launches
        return out

    def views(spark, double: bool, dirs=None):
        for name, cols in tables.items():
            if dirs is None:
                spark.createDataFrame(
                    host_batch_from_numpy(*windows_fields(cols, double)),
                    num_partitions=Q3_PARTITIONS[name]) \
                    .createOrReplaceTempView(name)
            else:
                spark.read.parquet(dirs[name, double]) \
                    .createOrReplaceTempView(name)
        return spark

    mem_d = views(TorchSparkSession(dict(WINDOWS_CONF)), True)
    run(mem_d, "q98_pushed_memory", lambda: mem_d.sql(Q98_PUSHED), check98,
        "TorchWindowExec", tolerance="1e-12 relative (doubles)")
    shapes["joinProbe"].update(q98_join_probe_cases(mem_d,
                                                    mem_d.sql(Q98_PUSHED)))
    got51["default"] = run(mem_d, "q51_store_memory",
                           lambda: mem_d.sql(Q51_STORE), check51,
                           "TorchWindowExec",
                           tolerance="1e-12 relative (running sums)")["rows"]
    del mem_d
    batched = views(TorchSparkSession(dict(WINDOWS_CONF,
                                           **WINDOWS_BATCHED)), True)
    out = run(batched, "q51_store_batched", lambda: batched.sql(Q51_STORE),
              check51, "TorchWindowExec", conf=WINDOWS_BATCHED,
              tolerance="1e-12 relative (running sums)")
    got51["batched"] = out["rows"]
    window_batches = sum(out["out"]["window_dispatch_count"])
    if window_batches <= 1:
        raise AssertionError(f"q51 batched: {window_batches} window batch")
    del batched, out
    a, b = sorted(got51["default"]), sorted(got51["batched"])
    same_keys = [r[:2] for r in a] == [r[:2] for r in b]
    bits = sum(x[2] == y[2] for x, y in zip(a, b))
    close = all(abs(x[2] - y[2]) <= 1e-12 * abs(x[2]) for x, y in zip(a, b))
    if not (same_keys and close):
        raise AssertionError("q51 key-batched rows differ from the default")
    phase("q51_store_batched_equal", card=card, rows=len(a),
          window_batches=window_batches, keys_equal=same_keys,
          values_within_1e_12=close, bit_identical_values=bits)

    mem = views(TorchSparkSession(dict(WINDOWS_CONF)), False)
    got86 = run(mem, "q86_rollup_memory", lambda: q86_frame(mem, F),
                check86, "TorchExpandExec", tolerance="exact")["rows"]
    shapes["groupbyHash"].update(partial_groupby_cases(
        mem, mem.plan_physical(q86_frame(mem, F).plan), "q86_rollup"))
    ss = tables["store_sales"]
    fields, arrays = windows_fields(ss)
    half = len(arrays[0]) // 2
    hb = host_batch_from_numpy(fields, arrays)
    mem.createDataFrame(hb.slice(0, half), num_partitions=4) \
        .createOrReplaceTempView("ss_a")
    mem.createDataFrame(hb.slice(half, hb.num_rows), num_partitions=4) \
        .createOrReplaceTempView("ss_b")
    mem.table("ss_a").union(mem.table("ss_b")) \
        .createOrReplaceTempView("store_sales_u")
    got_u = run(mem, "union_rollup",
                lambda: q86_frame(mem, F, "store_sales_u"), check86,
                "TorchUnionExec", tolerance="exact")["rows"]
    if got_u != got86:
        raise AssertionError("union rollup rows differ from q86's")
    mem.range(0, RANGE_ROWS, 1, N_PARTITIONS).createOrReplaceTempView("r")
    run(mem, "range_agg", lambda: mem.sql(Q_RANGE), check_range,
        "TorchRangeExec", tolerance="exact", range_rows=RANGE_ROWS)
    shapes["groupbyHash"].update(partial_groupby_cases(
        mem, mem.plan_physical(mem.sql(Q_RANGE).plan), "range_agg"))
    del mem, hb

    dirs, write_s = {}, 0.0
    for name, cols in tables.items():
        for double in (False, True):
            d = os.path.join(DATA_DIR, f"tpcds_windows_{name}_"
                             f"{'double' if double else 'decimal'}")
            dirs[name, double] = d
            write_s += write_once(
                d, lambda d, c=cols, dbl=double: TorchSparkSession(
                    dict(WINDOWS_CONF)).createDataFrame(
                    host_batch_from_numpy(*windows_fields(c, dbl)),
                    num_partitions=Q3_PARTITIONS[name])
                .write.mode("overwrite").parquet(d),
                data_key(seed=[Q3_SEED, WINDOWS_SEED], table=name,
                         rows=len(cols[0][2]), double=double,
                         partitions=Q3_PARTITIONS[name]))
    pq_d = views(TorchSparkSession(dict(WINDOWS_CONF)), True, dirs)
    run(pq_d, "q98_pushed_parquet", lambda: pq_d.sql(Q98_PUSHED), check98,
        "TorchWindowExec", write_s=write_s,
        tolerance="1e-12 relative (doubles)")
    run(pq_d, "q51_store_parquet", lambda: pq_d.sql(Q51_STORE), check51,
        "TorchWindowExec", tolerance="1e-12 relative (running sums)")
    del pq_d
    pq = views(TorchSparkSession(dict(WINDOWS_CONF)), False, dirs)
    run(pq, "q86_rollup_parquet", lambda: q86_frame(pq, F), check86,
        "TorchExpandExec", tolerance="exact")
    del pq
    phase("windows_kernel_shapes", card=card, tolerance="exact", **shapes)
    return legs, shapes


# -- phase 16: nested device columns ------------------------------------
#
# (a) The Yahoo Streaming Benchmark's windowed campaign count
# (yahoo/streaming-benchmarks, data/src/setup/core.clj): 100 campaigns of
# 10 ads, events {user_id, page_id, ad_id, ad_type, event_type,
# event_time, ip_address} with UUID ids, the query in the form
# Databricks ran it on Structured Streaming (views joined to the static
# ad -> campaign table, counted per campaign and 10-second window). The
# stream is bounded to 600 s of event time at 10,000 events/s.
# (b) Stack Overflow tag analytics over posts(id, score, tags
# array<string>) shaped like the data dump's question rows: 1-5 distinct
# tags a question, 65,000 tag names with Zipf(1.0) popularity.

YSB_SEED = 20260737
YSB_EVENTS = 6_000_000
YSB_CAMPAIGNS = 100
YSB_ADS_PER_CAMPAIGN = 10
YSB_SPAN_S = 600
YSB_WINDOW_US = 10_000_000
YSB_T0_US = 1_714_521_600_000_000  # 2024-05-01 00:00:00 UTC
YSB_AD_TYPES = ("banner", "modal", "sponsored-search", "mail", "mobile")
YSB_EVENT_TYPES = ("view", "click", "purchase")
# the GROUP BY of a window expression repeated in the select list fails
# in both packages' planners (ROADMAP C); the same query with the window
# named in a subquery runs in both
YSB_SQL = """
SELECT campaign_id, w.start AS window_start, w.end AS window_end, views
FROM (SELECT campaign_id, w, count(*) AS views
      FROM (SELECT a.campaign_id, window(e.event_time, '10 seconds') AS w
            FROM events e JOIN ads a ON e.ad_id = a.ad_id
            WHERE e.event_type = 'view') v
      GROUP BY campaign_id, w) g
"""
YSB_SHUFFLED = {"spark.rapids.sql.shuffle.devicePartitions": "8"}

TAGS_SEED = 20260738
TAGS_POSTS = 2_000_000
TAGS_NAMES = 65_000
TAGS_TOP = ("javascript", "python", "java", "c#", "php", "android", "html",
            "jquery", "c++", "css")
TAGS_PER_POST_P = (0.12, 0.24, 0.30, 0.20, 0.14)  # 1..5 tags, mean 3.0
TAGS_SQL = {
    "top": """
SELECT tag, count(*) AS n FROM (SELECT explode(tags) AS tag FROM posts) t
GROUP BY tag ORDER BY n DESC, tag LIMIT 10""",
    "related": """
SELECT tag, count(*) AS n FROM (SELECT explode(tags) AS tag FROM posts
  WHERE array_contains(tags, 'python')) t
WHERE tag <> 'python' GROUP BY tag ORDER BY n DESC, tag LIMIT 10""",
    # element_at and size in a subquery: grouping by the expression
    # itself fails in both packages' planners (ROADMAP C)
    "primary": """
SELECT primary_tag, count(*) AS questions, sum(n_tags) AS tag_uses
FROM (SELECT element_at(tags, 1) AS primary_tag, size(tags) AS n_tags
      FROM posts) p
GROUP BY primary_tag ORDER BY questions DESC, primary_tag LIMIT 20""",
}
# each tag query without its ORDER BY and LIMIT: every group's row
TAGS_ALL_SQL = {q: sql.split("ORDER BY")[0] for q, sql in TAGS_SQL.items()}


def _uuids(rng, n: int) -> np.ndarray:
    """``n`` random version-4 UUID strings (an object array of str)."""
    raw = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40
    raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80
    hexd = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    nib = np.stack([raw >> 4, raw & 0x0F], axis=2).reshape(n, 32)
    chars = hexd[nib]
    out = np.full((n, 36), ord("-"), dtype=np.uint8)
    for a, b, o in ((0, 8, 0), (8, 12, 9), (12, 16, 14), (16, 20, 19),
                    (20, 32, 24)):
        out[:, o:o + b - a] = chars[:, a:b]
    return np.array([r.tobytes().decode("ascii") for r in out],
                    dtype=object)


def pooled_strings(pool: np.ndarray, idx: np.ndarray):
    """A string column drawn from ``pool`` by ``idx``: the object array
    (references into the pool) and its compact UTF-8 bytes and lengths
    (``HostColumn.varbytes``), built with numpy."""
    enc = [v.encode("utf-8") for v in pool]
    plen = np.array([len(b) for b in enc], dtype=np.int32)
    width = max(1, int(plen.max(initial=1)))
    mat = np.zeros((len(pool), width), dtype=np.uint8)
    for i, b in enumerate(enc):
        mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    lengths = plen[idx]
    bts = mat[idx][np.arange(width) < lengths[:, None]]
    return pool[idx], (bts, lengths)


def ysb_tables(n_events: int = YSB_EVENTS, seed: int = YSB_SEED) -> dict:
    """The YSB events and ads, as index arrays into their string pools:
    {"pools": {...}, "events": {...}, "ads": {...}}."""
    rng = np.random.default_rng(seed)
    n_ads = YSB_CAMPAIGNS * YSB_ADS_PER_CAMPAIGN
    pools = {"campaign": _uuids(rng, YSB_CAMPAIGNS),
             "ad": _uuids(rng, n_ads), "user": _uuids(rng, 100),
             "page": _uuids(rng, 100),
             "ad_type": np.array(YSB_AD_TYPES, dtype=object),
             "event_type": np.array(YSB_EVENT_TYPES, dtype=object),
             "ip": np.array(["1.2.3.4"], dtype=object)}
    ads = {"ad": np.arange(n_ads),
           "campaign": np.repeat(np.arange(YSB_CAMPAIGNS),
                                 YSB_ADS_PER_CAMPAIGN)}
    events = {
        "user": rng.integers(0, 100, n_events),
        "page": rng.integers(0, 100, n_events),
        "ad": rng.integers(0, n_ads, n_events),
        "ad_type": rng.integers(0, len(YSB_AD_TYPES), n_events),
        "event_type": rng.integers(0, len(YSB_EVENT_TYPES), n_events),
        "event_time": YSB_T0_US + rng.integers(
            0, YSB_SPAN_S * 1_000_000, n_events, dtype=np.int64),
        "ip": np.zeros(n_events, dtype=np.int64)}
    return {"pools": pools, "events": events, "ads": ads}


def ysb_batches(tables) -> dict:
    """The port's HostBatches of the YSB tables (strings with their
    compact bytes, as Arrow would hand them over)."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.sql import types as T
    pools = tables["pools"]

    def strings(pool, idx):
        data, vb = pooled_strings(pools[pool], idx)
        return HostColumn(T.StringT, data, np.ones(len(idx), bool), vb)

    def batch(cols):
        schema = T.StructType([T.StructField(n, c.dtype) for n, c in cols])
        return HostBatch(schema, [c for _n, c in cols], len(cols[0][1]))
    ev = tables["events"]
    ts = HostColumn(T.TimestampT, ev["event_time"],
                    np.ones(len(ev["event_time"]), bool))
    events = batch([("user_id", strings("user", ev["user"])),
                    ("page_id", strings("page", ev["page"])),
                    ("ad_id", strings("ad", ev["ad"])),
                    ("ad_type", strings("ad_type", ev["ad_type"])),
                    ("event_type", strings("event_type",
                                           ev["event_type"])),
                    ("event_time", ts),
                    ("ip_address", strings("ip", ev["ip"]))])
    ads = batch([("ad_id", strings("ad", tables["ads"]["ad"])),
                 ("campaign_id", strings("campaign",
                                         tables["ads"]["campaign"]))])
    return {"events": events, "ads": ads}


def ysb_reference(tables) -> list:
    """(campaign_id, window_start, window_end, views) of every campaign
    and window, sorted, from the index arrays with numpy."""
    import datetime
    ev = tables["events"]
    views = ev["event_type"] == YSB_EVENT_TYPES.index("view")
    camp = tables["ads"]["campaign"][ev["ad"][views]]
    ts = ev["event_time"][views]
    start = ts - np.mod(ts, YSB_WINDOW_US)
    key = camp.astype(np.int64) * (1 << 40) + (start // YSB_WINDOW_US)
    uk, counts = np.unique(key, return_counts=True)
    epoch = datetime.datetime(1970, 1, 1)
    names = tables["pools"]["campaign"]
    out = []
    for k, c in zip(uk.tolist(), counts.tolist()):
        w0 = (k & ((1 << 40) - 1)) * YSB_WINDOW_US
        out.append((names[k >> 40],
                    epoch + datetime.timedelta(microseconds=w0),
                    epoch + datetime.timedelta(
                        microseconds=w0 + YSB_WINDOW_US), c))
    return sorted(out)


def _tag_names(rng, n: int = TAGS_NAMES) -> np.ndarray:
    """``n`` distinct tag names in popularity rank order: the ten
    busiest of Stack Overflow first, then a random lowercase stem and a
    base-26 suffix unique to the rank (1-35 characters)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    stems = rng.integers(0, 26, (n, 24))
    stem_len = rng.integers(0, 20, n)
    names = list(TAGS_TOP)
    for i in range(len(TAGS_TOP), n):
        k, suf = i, ""
        while True:
            suf = letters[k % 26] + suf
            k //= 26
            if k == 0:
                break
        stem = "".join(letters[c] for c in stems[i, :stem_len[i]])
        names.append(f"{stem}-{suf}" if stem else suf)
    return np.array(names, dtype=object)


def tags_tables(n_posts: int = TAGS_POSTS, seed: int = TAGS_SEED) -> dict:
    """posts as arrays: ``id``, ``score``, each question's tag ranks
    (``lengths`` a row, ``ranks`` flat, in draw order: the first is the
    primary tag) and the ``names`` pool. Each question draws 8 Zipf(1.0)
    ranks and keeps its first 1-5 distinct ones."""
    rng = np.random.default_rng(seed)
    names = _tag_names(rng)
    w = 1.0 / np.arange(1, len(names) + 1)
    cdf = np.cumsum(w) / w.sum()
    want = rng.choice(5, n_posts, p=TAGS_PER_POST_P) + 1
    draws = 8
    cand = np.minimum(np.searchsorted(cdf, rng.random((n_posts, draws))),
                      len(names) - 1)
    order = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, order, axis=1)
    first_sorted = np.concatenate(
        [np.ones((n_posts, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    first = np.zeros_like(first_sorted)
    np.put_along_axis(first, order, first_sorted, axis=1)
    take = first & (np.cumsum(first, axis=1) <= want[:, None])
    return {"id": np.arange(1, n_posts + 1, dtype=np.int64),
            "score": rng.integers(-5, 200, n_posts).astype(np.int32),
            "lengths": take.sum(axis=1).astype(np.int32),
            "ranks": cand[take], "names": names}


def tags_batch(tables):
    """The port's HostBatch of posts: the tags column in its compact
    form (lengths and the element column with its bytes; the rows'
    tuples are made when first read)."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.interop import array_column
    from spark_rapids_tpu_torch.sql import types as T
    n = len(tables["id"])
    ones = np.ones(n, bool)
    edata, vb = pooled_strings(tables["names"], tables["ranks"])
    tags = array_column(T.StringT, tables["lengths"], edata, varbytes=vb)
    schema = T.StructType([T.StructField("id", T.LongT),
                           T.StructField("score", T.IntegerT),
                           T.StructField("tags", tags.dtype)])
    return HostBatch(schema, [
        HostColumn(T.LongT, tables["id"], ones),
        HostColumn(T.IntegerT, tables["score"], ones), tags], n)


def tags_reference(tables) -> dict:
    """Each tag query's rows, from the rank arrays with numpy: under
    ``q`` the rows of ``TAGS_SQL[q]``, under ``q + "_all"`` every
    group's row (``TAGS_ALL_SQL[q]``), sorted."""
    names = tables["names"]
    lengths = tables["lengths"]
    ranks = tables["ranks"]
    row = np.repeat(np.arange(len(lengths)), lengths)
    n_names = len(names)

    def groups(counts, exclude=None):
        return sorted((names[r], int(counts[r]))
                      for r in np.flatnonzero(counts) if r != exclude)

    def top(rows, k):
        return sorted(rows, key=lambda r: (-r[1], r[0]))[:k]
    py = TAGS_TOP.index("python")
    with_py = np.zeros(len(lengths), bool)
    with_py[row[ranks == py]] = True
    firsts = ranks[np.cumsum(lengths) - lengths]
    q = np.bincount(firsts, minlength=n_names)
    uses = np.bincount(firsts, weights=lengths, minlength=n_names)
    out = {"top_all": groups(np.bincount(ranks, minlength=n_names)),
           "related_all": groups(np.bincount(ranks[with_py[row]],
                                             minlength=n_names), py),
           "primary_all": sorted((names[r], int(q[r]), int(uses[r]))
                                 for r in np.flatnonzero(q))}
    out["top"] = top(out["top_all"], 10)
    out["related"] = top(out["related_all"], 10)
    out["primary"] = top(out["primary_all"], 20)
    return out


NESTED_CONF = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}


def partial_aggs(plan) -> list:
    """Every partial aggregate of a plan, fused-stage sinks included."""
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    out = []
    for p in plan_nodes_of(plan):
        for n in [p] + list(getattr(p, "fused_ops", [])):
            if isinstance(n, TorchHashAggregateExec) and \
                    n.mode == "partial" and n not in out:
                out.append(n)
    return out


def ysb_murmur3_case(spark, df) -> dict:
    """murmur3 on the shuffled YSB leg's struct key: the first batch the
    group-by's exchange hashes, ``(campaign_id, window)`` with the
    window's fields as key columns (``ops.hashing.struct_key_fields``),
    against the plain struct fold of ``hash_device_column``."""
    import torch
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    from spark_rapids_tpu_torch.memory import release_plan_handles
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.sql import physical as P
    from spark_rapids_tpu_torch.sql import types as T
    plan = spark.plan_physical(df.plan)
    try:
        (ex,) = [p for p in plan_nodes_of(plan)
                 if isinstance(p, TorchShuffleExchangeExec)
                 and isinstance(p.partitioning, P.HashPartitioning)
                 and any(isinstance(e.data_type, T.StructType)
                         for e in p.partitioning.exprs)]
        part = ex.partitioning
        b = first_batch(ex.child.device_partitions(), "ysb exchange")
        cols = key_columns(P.bind_list(part.exprs, ex.child.output), b)
        flat = H.struct_key_fields(cols)
        case = murmur3_case(flat, b.capacity, part.num_partitions)
        # the struct fold of the plain version, on the struct itself
        want = torch.remainder(H.murmur3_columns(cols, b.capacity,
                                                 42).long(),
                               part.num_partitions).to(torch.int32)
        got = H.partition_ids(cols, b.capacity, part.num_partitions)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"struct partition ids != fold: {err}")
        case["struct_fold_max_abs_err"] = err
        case["keys"] = [getattr(e, "name", repr(e)) for e in part.exprs]
        return case
    finally:
        release_plan_handles(plan)


def nested_phases(device, card: str) -> tuple:
    """Phase 16: the YSB windowed campaign count and the Stack Overflow
    tag queries over nested columns (see the module docstring), each leg
    against its numpy reference; then joinProbe at the ad join, murmur3
    on the struct key and groupbyHash on a tags batch. Returns each
    leg's kernel launches and the shapes' cases."""
    from spark_rapids_tpu_torch.metrics import plan_metrics
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    t0 = time.perf_counter()
    ysb = ysb_tables()
    yb = ysb_batches(ysb)
    want_ysb = ysb_reference(ysb)
    tags = tags_tables()
    tb = tags_batch(tags)
    want_tags = tags_reference(tags)
    gen_s = time.perf_counter() - t0
    legs, shapes = {}, {"groupbyHash": {}, "joinProbe": {}, "murmur3": {}}

    def check_ysb(rows):
        if sorted(rows) != want_ysb:
            raise AssertionError(f"ysb: {len(rows)} rows, "
                                 f"{sorted(rows)[:2]} != {want_ysb[:2]}")
        return 0.0

    def check_tags(q):
        def check(rows):
            if rows != want_tags[q]:
                raise AssertionError(f"tags {q}: {rows[:3]} != "
                                     f"{want_tags[q][:3]}")
            return 0.0
        return check

    def all_groups(spark, q, leg):
        """Every group of tag query ``q`` (one untimed collect of
        ``TAGS_ALL_SQL[q]``), exact against the reference: the generated
        names and the long tail that the LIMIT rows never reach."""
        rows = sorted(tuple(r) for r in spark.sql(TAGS_ALL_SQL[q])
                      .collect())
        want = want_tags[q + "_all"]
        if rows != want:
            bad = next((g, w) for g, w in itertools.zip_longest(rows, want)
                       if g != w)
            raise AssertionError(f"{leg} all groups: {len(rows)} rows "
                                 f"!= {len(want)}, first {bad}")
        phase(f"{leg}_all_groups", card=card, tolerance="exact",
              groups=len(rows), count_sum=sum(r[1] for r in rows))

    def run(spark, leg, make_df, check, node, **extra):
        out = windows_leg(spark, card, leg, make_df, check, node)
        launches = out["out"]["launches"]
        plan = spark.last_plan
        m = plan_metrics(plan)
        reruns = [a.overflow_reruns for a in partial_aggs(plan)]
        if leg.endswith("parquet") and launches["decodeFused"] <= 0:
            raise AssertionError(f"{leg}: no decodeFused: {launches}")
        if leg.startswith("ysb") and launches["joinProbe"] <= 0:
            raise AssertionError(f"{leg}: no joinProbe: {launches}")
        if leg.startswith("ysb_shuffled") and launches["murmur3"] <= 0:
            raise AssertionError(f"{leg}: no murmur3: {launches}")
        if leg.startswith("tags") and launches["groupbyHash"] <= 0:
            raise AssertionError(f"{leg}: no groupbyHash: {launches}")
        upload = {k: v for k, v in r2c_metrics(plan).items()
                  if k.endswith("Time") or k in ("numInputRows",
                                                 "pinnedStreamCopies")}
        scan = {k: v for k, v in m.items() if k.startswith("device")}
        phase(leg, card=card, generate_s=gen_s,
              groupby_overflow_reruns=reruns, upload=upload, scan=scan,
              **extra, **{k: v for k, v in out["out"].items()
                          if k != "window_dispatch_count"})
        legs[leg] = launches
        return out

    def ysb_views(spark, dirs=None):
        for name, b in yb.items():
            parts = N_PARTITIONS if name == "events" else 1
            if dirs is None:
                spark.createDataFrame(b, num_partitions=parts) \
                    .createOrReplaceTempView(name)
            else:
                spark.read.parquet(dirs[name]).createOrReplaceTempView(name)
        return spark

    def tags_views(spark, path=None):
        if path is None:
            spark.createDataFrame(tb, num_partitions=N_PARTITIONS) \
                .createOrReplaceTempView("posts")
        else:
            spark.read.parquet(path).createOrReplaceTempView("posts")
        return spark

    mem = ysb_views(TorchSparkSession(dict(NESTED_CONF)))
    run(mem, "ysb_memory", lambda: mem.sql(YSB_SQL), check_ysb,
        "TorchBroadcastHashJoinExec", tolerance="exact",
        rows_in={"events": YSB_EVENTS, "ads": len(ysb["ads"]["ad"])})
    # the ad join: a 1,000-row build of 36-character UUID keys
    shapes["joinProbe"].update(broadcast_joins(
        mem, mem.sql(YSB_SQL), lambda j: "ysb_ad_join"))
    del mem
    shuf = ysb_views(TorchSparkSession(dict(NESTED_CONF, **YSB_SHUFFLED)))
    run(shuf, "ysb_shuffled_memory", lambda: shuf.sql(YSB_SQL), check_ysb,
        "TorchShuffleExchangeExec", tolerance="exact", conf=YSB_SHUFFLED)
    shapes["murmur3"]["ysb_struct_key"] = ysb_murmur3_case(
        shuf, shuf.sql(YSB_SQL))
    del shuf
    mem_t = tags_views(TorchSparkSession(dict(NESTED_CONF)))
    for q in TAGS_SQL:
        run(mem_t, f"tags_{q}_memory", lambda q=q: mem_t.sql(TAGS_SQL[q]),
            check_tags(q), "TorchGenerateExec" if q != "primary"
            else "TorchFusedStageExec", tolerance="exact",
            rows_in=TAGS_POSTS, exploded=int(tags["lengths"].sum()))
        all_groups(mem_t, q, f"tags_{q}_memory")
    shapes["groupbyHash"].update(partial_groupby_cases(
        mem_t, mem_t.plan_physical(mem_t.sql(TAGS_SQL["top"]).plan),
        "tags_top"))
    del mem_t

    write_s = 0.0
    dirs = {}
    for name, b in yb.items():
        parts = N_PARTITIONS if name == "events" else 1
        dirs[name] = os.path.join(DATA_DIR, f"ysb_{name}")
        write_s += write_once(
            dirs[name], lambda d, b=b, parts=parts: TorchSparkSession(
                dict(NESTED_CONF)).createDataFrame(b, num_partitions=parts)
            .write.mode("overwrite").parquet(d),
            data_key(seed=YSB_SEED, table=name, rows=b.num_rows,
                     partitions=parts))
    posts_dir = os.path.join(DATA_DIR, "so_posts")
    write_s += write_once(
        posts_dir, lambda d: TorchSparkSession(dict(NESTED_CONF))
        .createDataFrame(tb, num_partitions=N_PARTITIONS)
        .write.mode("overwrite").parquet(d),
        data_key(seed=TAGS_SEED, table="posts", rows=tb.num_rows,
                 partitions=N_PARTITIONS))
    pq = ysb_views(TorchSparkSession(dict(NESTED_CONF)), dirs)
    run(pq, "ysb_parquet", lambda: pq.sql(YSB_SQL), check_ysb,
        "TorchBroadcastHashJoinExec", tolerance="exact", write_s=write_s)
    del pq
    pq_t = tags_views(TorchSparkSession(dict(NESTED_CONF)), posts_dir)
    for q in TAGS_SQL:
        out = run(pq_t, f"tags_{q}_parquet",
                  lambda q=q: pq_t.sql(TAGS_SQL[q]), check_tags(q),
                  "TorchGenerateExec" if q != "primary"
                  else "TorchFusedStageExec", tolerance="exact")
        del out
        all_groups(pq_t, q, f"tags_{q}_parquet")
    del pq_t
    phase("nested_kernel_shapes", card=card, tolerance="exact", **shapes)
    return legs, shapes


# -- phase 17: the cache, mixed DISTINCT and Python UDFs -------------------

# (a) ClickBench (ClickHouse/ClickBench): Q9 and Q10 of queries.sql over
# the four columns of ``hits`` they read, with create.sql's types.
# ``reduced``: 10,000,000 rows of the published 99,997,497. RegionID is
# Zipf-skewed over a few thousand region codes; a user appears about 3.3
# times, mostly in one home region, so the distinct aggregate groups
# millions of (RegionID, UserID) pairs; AdvEngineID is 0 on all but
# about 0.6% of rows; ResolutionWidth is a common screen width.
HITS_ROWS = 10_000_000
HITS_SEED = 20260739
HITS_REGIONS = 4_000
HITS_ZIPF = 1.1
HITS_USERS_PER_ROW = 0.3
HITS_HOME_SHARE = 0.9
HITS_ADV_SHARE = 0.006
HITS_WIDTHS = np.array([1920, 1366, 1536, 1440, 1280, 1600, 1680, 2560,
                        1024, 360, 375, 390, 414, 412, 768, 0], np.int16)
HITS_WIDTH_W = np.array([22, 14, 9, 6, 6, 4, 3, 3, 3, 8, 4, 5, 5, 4, 2,
                         2], np.float64)

Q10 = ("SELECT RegionID, SUM(AdvEngineID), COUNT(*) AS c, "
       "AVG(ResolutionWidth), COUNT(DISTINCT UserID) FROM hits "
       "GROUP BY RegionID ORDER BY c DESC LIMIT 10")
# every group of Q10, without its ORDER BY and LIMIT
Q10_ALL = ("SELECT RegionID, SUM(AdvEngineID), COUNT(*) AS c, "
           "AVG(ResolutionWidth), COUNT(DISTINCT UserID) FROM hits "
           "GROUP BY RegionID")
Q9 = ("SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits "
      "GROUP BY RegionID ORDER BY u DESC LIMIT 10")

# (b) the workload of Databricks' "Introducing Pandas UDF for PySpark":
# ``id`` = row // 10,000 (1,000 groups), ``v`` uniform doubles
PUDF_ROWS = 10_000_000
PUDF_SEED = 20260740
PUDF_GROUP_ROWS = 10_000
PHASE17_CONF = {"spark.sql.shuffle.partitions": str(N_PARTITIONS),
                "spark.rapids.sql.variableFloatAgg.enabled": "true"}


def hits_tables(n: int = HITS_ROWS, seed: int = HITS_SEED) -> dict:
    """hits' four columns as numpy arrays."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, HITS_REGIONS + 1) ** HITS_ZIPF
    cdf = np.cumsum(w) / w.sum()

    def zipf_region(k):
        return np.minimum(np.searchsorted(cdf, rng.random(k)),
                          HITS_REGIONS - 1)
    codes = rng.permutation(np.arange(1, 10 * HITS_REGIONS + 1))[
        :HITS_REGIONS].astype(np.int32)
    n_users = max(1, int(n * HITS_USERS_PER_ROW))
    users = rng.integers(-(1 << 62), 1 << 62, n_users, dtype=np.int64)
    home = zipf_region(n_users)
    u = rng.integers(0, n_users, n)
    region = home[u]
    roam = rng.random(n) >= HITS_HOME_SHARE
    region[roam] = zipf_region(int(roam.sum()))
    adv = np.where(rng.random(n) < HITS_ADV_SHARE,
                   rng.integers(1, 31, n), 0).astype(np.int16)
    width = HITS_WIDTHS[rng.choice(len(HITS_WIDTHS), n,
                                   p=HITS_WIDTH_W / HITS_WIDTH_W.sum())]
    return {"RegionID": codes[region], "AdvEngineID": adv,
            "ResolutionWidth": width, "UserID": users[u]}


def hits_batch(tables):
    """The port's HostBatch of hits (create.sql's types)."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    return host_batch_from_numpy(
        [("RegionID", T.IntegerT), ("AdvEngineID", T.ShortT),
         ("ResolutionWidth", T.ShortT), ("UserID", T.LongT)],
        [tables["RegionID"], tables["AdvEngineID"],
         tables["ResolutionWidth"], tables["UserID"]])


def hits_reference(tables) -> dict:
    """Every region's Q10 row and Q9 row, with numpy: ``{"q10":
    {region: row}, "q9": {region: row}}``."""
    regions, inv = np.unique(tables["RegionID"], return_inverse=True)
    c = np.bincount(inv)
    adv = np.bincount(inv, weights=tables["AdvEngineID"])
    wsum = np.bincount(inv, weights=tables["ResolutionWidth"])
    user = tables["UserID"]
    order = np.lexsort((user, inv))
    si, su = inv[order], user[order]
    first = np.ones(len(si), bool)
    first[1:] = (si[1:] != si[:-1]) | (su[1:] != su[:-1])
    u = np.bincount(si[first], minlength=len(regions))
    q10, q9 = {}, {}
    for i, r in enumerate(regions.tolist()):
        q10[r] = (r, int(adv[i]), int(c[i]), float(wsum[i] / c[i]),
                  int(u[i]))
        q9[r] = (r, int(u[i]))
    return {"q10": q10, "q9": q9}


def _close(a, b, rel_tol: float) -> float:
    """The relative error of ``a`` against ``b``; raises past
    ``rel_tol`` (0 for anything but floats: exact)."""
    if isinstance(b, float):
        err = abs(a - b) / max(abs(b), 1e-300)
        if err > rel_tol:
            raise AssertionError(f"{a!r} != {b!r} (rel {err})")
        return err
    if a != b:
        raise AssertionError(f"{a!r} != {b!r}")
    return 0.0


def check_ranked(rows, want: dict, col: int, what: str,
                 rel_tol: float = 1e-12) -> float:
    """The rows of an ``ORDER BY <col> DESC LIMIT 10`` query: their
    ``col`` values are the reference's ten largest in order (ties make
    the choice among equal rows free), and each row equals the
    reference's row for its key. Returns the largest relative error."""
    top = sorted((r[col] for r in want.values()), reverse=True)[:10]
    if [r[col] for r in rows] != top:
        raise AssertionError(f"{what}: ranked values "
                             f"{[r[col] for r in rows]} != {top}")
    err = 0.0
    for r in rows:
        ref = want.get(r[0])
        if ref is None or len(r) != len(ref):
            raise AssertionError(f"{what}: row {r} has no reference row")
        for a, b in zip(r, ref):
            err = max(err, _close(a, b, rel_tol))
    return err


def check_all_groups(rows, want: dict, what: str,
                     rel_tol: float = 1e-12) -> float:
    """Every group's row against the reference's, keyed by the first
    column."""
    if len(rows) != len(want):
        raise AssertionError(f"{what}: {len(rows)} groups != {len(want)}")
    err = 0.0
    for r in rows:
        ref = want.get(r[0])
        if ref is None:
            raise AssertionError(f"{what}: unexpected group {r}")
        for a, b in zip(r, ref):
            err = max(err, _close(a, b, rel_tol))
    return err


def pudf_tables(n: int = PUDF_ROWS, seed: int = PUDF_SEED) -> dict:
    rng = np.random.default_rng(seed)
    return {"id": (np.arange(n) // PUDF_GROUP_ROWS).astype(np.int32),
            "v": rng.random(n)}


def pudf_batch(tables):
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    return host_batch_from_numpy([("id", T.IntegerT), ("v", T.DoubleT)],
                                 [tables["id"], tables["v"]])


def pudf_plus_one(v):
    return v + 1


def pudf_cdf(v):
    import pandas as pd
    from scipy import stats
    return pd.Series(stats.norm.cdf(v), index=v.index)


def pudf_keep_high(frames):
    for pdf in frames:
        yield pdf[pdf.v > 0.5]


def udf_compiled_fn(v):
    return v * 2.0 + 1.0 if v > 0.5 else -v


def pudf_frames(spark, F, df) -> dict:
    """The phase's Python legs over ``df`` (``id``, ``v``): each maps
    ``v`` and then groups by ``id`` with a sum and a count."""
    plus_one = F.pandas_udf(pudf_plus_one, "double")
    cdf = F.pandas_udf(pudf_cdf, "double")
    compiled = F.udf(udf_compiled_fn, "double")

    def agg(d, col):
        return d.groupBy("id").agg(F.sum(col).alias("s"),
                                   F.count(col).alias("n"))
    return {
        "pandas_udf_plus_one": lambda: agg(
            df.select("id", plus_one("v").alias("x")), "x"),
        "pandas_udf_cdf": lambda: agg(
            df.select("id", cdf("v").alias("x")), "x"),
        "map_in_pandas": lambda: agg(
            df.mapInPandas(pudf_keep_high, "id int, v double"), "v"),
        "udf_compiled": lambda: agg(
            df.select("id", compiled("v").alias("x")), "x"),
    }


def pudf_reference(tables) -> dict:
    """Each Python leg's rows ``(id, sum, count)`` by id, the sums with
    ``math.fsum`` of the values numpy (and scipy) compute."""
    import math
    ids, v = tables["id"], tables["v"]
    bounds = np.flatnonzero(np.diff(ids)) + 1

    def rows(x, keep=None):
        out = {}
        for g, xs, ks in zip(np.split(ids, bounds), np.split(x, bounds),
                             np.split(keep if keep is not None
                                      else np.ones(len(x), bool), bounds)):
            if ks.any():
                out[int(g[0])] = (int(g[0]), math.fsum(xs[ks].tolist()),
                                  int(ks.sum()))
        return out
    out = {"pandas_udf_plus_one": rows(v + 1),
           "map_in_pandas": rows(v, v > 0.5),
           "udf_compiled": rows(np.where(v > 0.5, v * 2.0 + 1.0, -v))}
    try:
        from scipy import stats
        out["pandas_udf_cdf"] = rows(stats.norm.cdf(v))
    except ImportError:
        pass
    return out


def in_turns(dfs: dict, rounds: int = 2) -> dict:
    """Each query's wall in turns (A B, B A, A B, ...), the queries
    already warm: the timed runs and their median."""
    import torch
    names = list(dfs)
    walls = {n: [] for n in names}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            dfs[n].collect()
            torch.cuda.synchronize()
            walls[n].append(time.perf_counter() - t0)
    return {n: {"timed_runs": w, "median_s": statistics.median(w)}
            for n, w in walls.items()}


def cache_info(plan) -> dict:
    """The cached relations an executed plan read: payload bytes, the
    seconds each materialisation took and how many ran."""
    from spark_rapids_tpu_torch.io.cache import CpuCachedScanExec
    rels = {}
    for p in plan_nodes_of(plan):
        if isinstance(p, CpuCachedScanExec):
            rels[id(p.rel)] = p.rel
    return {"cached_relations": len(rels),
            "cached_bytes": sum(r.cached_bytes for r in rels.values()),
            "materialize_s": sum(r.materialize_seconds
                                 for r in rels.values()),
            "materializations": sum(r.materializations
                                    for r in rels.values())}


def join_routes(plan) -> dict:
    return {type(p).__name__: dict(p.route_counts)
            for p in plan_nodes_of(plan) if hasattr(p, "route_counts")}


def python_exec_metrics(plan) -> dict:
    """The Python exec's counters of an executed plan: rows to and from
    the worker, the worker's round trips (``pythonEvalTime``) and the
    copies off and onto the card, in seconds."""
    from spark_rapids_tpu_torch.exec.python_exec import (
        PYTHON_EVAL_TIME, TorchArrowEvalPythonExec, TorchMapInPandasExec)
    (p,) = [n for n in plan_nodes_of(plan) if isinstance(
        n, (TorchArrowEvalPythonExec, TorchMapInPandasExec))]
    m = p.metrics.snapshot()
    return {"exec": type(p).__name__,
            "rows_to_worker": p.child.metrics.snapshot()["numOutputRows"],
            "rows_from_worker": m["numOutputRows"],
            "worker_s": m.get(PYTHON_EVAL_TIME, 0) / 1e9,
            "copyFromDeviceTime_s": m.get("copyFromDeviceTime", 0) / 1e9,
            "copyToDeviceTime_s": m.get("copyToDeviceTime", 0) / 1e9}


def worker_processes() -> list:
    """The Python worker processes of the pool, idle ones included."""
    from spark_rapids_tpu_torch.python import pool as PP
    p = PP._POOL
    return [] if p is None else [w.proc for w in list(p._idle.queue)]


def importable(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def q10_join_probe_case(spark) -> dict:
    """joinProbe at Q10's join on a fresh plan: the plain aggregate's
    rows (the build side adaptive execution broadcasts) against the
    distinct aggregate's first batch."""
    from spark_rapids_tpu_torch.exec.join import TorchShuffledHashJoinExec
    from spark_rapids_tpu_torch.memory import release_plan_handles
    plan = spark.plan_physical(spark.sql(Q10).plan)
    try:
        (j,) = [p for p in plan_nodes_of(plan)
                if isinstance(p, TorchShuffledHashJoinExec)]
        return {"q10_join": join_probe_case(j, "q10_join")}
    finally:
        release_plan_handles(plan)


def cache_udf_phases(device, card: str, arrays, q1_dir: str) -> tuple:
    """Phase 17: ClickBench Q10 (mixed DISTINCT over the planner's
    cached child) and Q9 from memory and from Parquet, TPC-H q1 over a
    cached Parquet read, the pandas UDF and mapInPandas legs, and a
    compiled ``F.udf``; each leg against its numpy reference, then
    groupbyHash at Q10's distinct partial and q1's cached partial batch.
    Every collect here must leave no store handle and no device permit
    held. Returns each leg's kernel launches and the shapes' cases."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.metrics import plan_metrics
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    GATE["strict"] = True
    legs, shapes = {}, {"groupbyHash": {}, "joinProbe": {}}
    t0 = time.perf_counter()
    hits = hits_tables()
    hb = hits_batch(hits)
    want = hits_reference(hits)
    gen_s = time.perf_counter() - t0
    del hits

    def hits_session(path=None):
        s = TorchSparkSession(dict(PHASE17_CONF))
        if path is None:
            s.createDataFrame(hb, num_partitions=N_PARTITIONS) \
                .createOrReplaceTempView("hits")
        else:
            s.read.parquet(path).createOrReplaceTempView("hits")
        return s

    def clickbench(spark, source, **extra):
        leg = f"clickbench_q10_{source}"
        out = windows_leg(spark, card, leg, lambda: spark.sql(Q10),
                          lambda rows: check_ranked(rows, want["q10"], 2,
                                                    leg),
                          "TorchShuffledHashJoinExec")["out"]
        launches = out["launches"]
        plan = spark.last_plan
        if launches["groupbyHash"] <= 0 or (
                source == "parquet" and launches["decodeFused"] <= 0):
            raise AssertionError(f"{leg}: kernels {launches}")
        m = plan_metrics(plan)
        info = dict(cache_info(plan), join_route=join_routes(plan),
                    aqe={k: m.get(k, 0) for k in (
                        "aqeBroadcastFlip", "aqeReplans",
                        "exchangeTotalBytes")},
                    groupby_overflow_reruns=[
                        a.overflow_reruns for a in partial_aggs(plan)])
        if info["materializations"] != 1:
            raise AssertionError(f"{leg}: cache {info}")
        rows = [tuple(r) for r in spark.sql(Q10_ALL).collect()]
        err = check_all_groups(rows, want["q10"], f"{leg} all groups")
        phase(f"{leg}_all_groups", card=card,
              tolerance="avg within 1e-12 relative, the rest exact",
              groups=len(rows), max_rel_err=err,
              count_sum=sum(r[2] for r in rows))
        KR.reset_launches()
        q9_rows = [tuple(r) for r in spark.sql(Q9).collect()]
        q9_launches = dict(KR.LAUNCHES)
        check_ranked(q9_rows, want["q9"], 1, f"clickbench_q9_{source}")
        all_torch(plan_names(spark.last_plan), "q9")
        turns = in_turns({"q10": spark.sql(Q10), "q9": spark.sql(Q9)},
                         rounds=1)
        phase(leg, card=card, rows_in=HITS_ROWS, generate_s=gen_s,
              tolerance="avg within 1e-12 relative, the rest exact",
              **extra, **info, **{k: v for k, v in out.items()
                                   if k != "window_dispatch_count"},
              q9={"rows": q9_rows, "launches": q9_launches},
              turns=turns)
        legs[leg] = launches
        legs[f"clickbench_q9_{source}"] = q9_launches
        if launches["joinProbe"] and not shapes["joinProbe"]:
            shapes["joinProbe"].update(q10_join_probe_case(spark))

    mem = hits_session()
    clickbench(mem, "memory")
    # the plain version takes seconds on an overflowing batch: its time
    # is that of the checked call
    shapes["groupbyHash"].update(partial_groupby_cases(
        mem, mem.plan_physical(mem.sql(Q10).plan), "q10_distinct",
        pick=lambda a: len(a.grouping) == 2, plain_reps=0))
    del mem
    hits_dir = os.path.join(DATA_DIR, "clickbench_hits")
    write_s = write_once(
        hits_dir, lambda d: TorchSparkSession(dict(PHASE17_CONF))
        .createDataFrame(hb, num_partitions=N_PARTITIONS)
        .write.mode("overwrite").parquet(d),
        data_key(seed=HITS_SEED, table="hits", rows=hb.num_rows,
                 partitions=N_PARTITIONS))
    del hb
    clickbench(hits_session(hits_dir), "parquet", write_s=write_s)

    # TPC-H q1 over a cached Parquet read, beside q1 from Parquet
    want_q1 = q1_reference(arrays)
    cs = TorchSparkSession({"spark.sql.shuffle.partitions":
                            str(N_PARTITIONS)})
    cached = cs.read.parquet(q1_dir).cache()
    cached.createOrReplaceTempView("lineitem")
    df = cs.sql(Q1)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = dict(KR.LAUNCHES)
    check_q1_rows(rows, want_q1)
    KR.reset_launches()
    check_q1_rows(df.collect(), want_q1)
    read = dict(KR.LAUNCHES)
    names = plan_names(cs.last_plan)
    all_torch(names, "cached_q1")
    us = TorchSparkSession({"spark.sql.shuffle.partitions":
                            str(N_PARTITIONS)})
    us.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
    udf_q1 = us.sql(Q1)
    KR.reset_launches()
    check_q1_rows(udf_q1.collect(), want_q1)
    uncached = dict(KR.LAUNCHES)
    # the materialisation decodes every row group once; the reads decode
    # none (each cached batch uploads whole and aggregates through the
    # kernel)
    if first["decodeFused"] != uncached["decodeFused"] or \
            first["decodeFused"] <= 0 or read["decodeFused"] != 0 or \
            read["groupbyHash"] <= 0:
        raise AssertionError(f"cached_q1 kernels: first {first}, "
                             f"read {read}, uncached {uncached}")
    turns = in_turns({"cached": df, "uncached": udf_q1})
    prof = profile_collect(df, "cached_q1", card, warm=False)
    rel = cached.plan
    upload = {k: v for k, v in r2c_metrics(cs.last_plan).items()
              if k.endswith("Time") or k == "numInputRows"}
    phase("cached_q1", card=card, rows_in=SF1_ROWS, reference="exact",
          plan=names, first_run_s=first_s, launches_materialize=first,
          launches=read, launches_uncached=uncached,
          materialize_s=rel.materialize_seconds,
          cached_bytes=rel.cached_bytes,
          materializations=rel.materializations, turns=turns,
          median_s=turns["cached"]["median_s"], upload=upload,
          device_idle_share=prof["device_idle_share"],
          device_busy_s=prof["device_busy_s"],
          profiled_wall_s=prof["profiled_wall_s"],
          top_device_us=prof["top_device_us"])
    if rel.materializations != 1:
        raise AssertionError("cached_q1 materialised more than once")
    legs["cached_q1_materialize"] = first
    legs["cached_q1"] = read
    shapes["groupbyHash"].update(partial_groupby_cases(
        cs, cs.plan_physical(df.plan), "cached_q1"))
    del cs, us, cached, df, udf_q1

    # the Python legs over Databricks' pandas UDF table
    t0 = time.perf_counter()
    pt = pudf_tables()
    pb = pudf_batch(pt)
    pwant = pudf_reference(pt)
    pgen_s = time.perf_counter() - t0
    del pt
    have = {m: importable(m) for m in ("pandas", "cloudpickle", "scipy")}
    sp = TorchSparkSession(dict(PHASE17_CONF))
    frames = pudf_frames(sp, F, sp.createDataFrame(
        pb, num_partitions=N_PARTITIONS))
    for leg, node in (("pandas_udf_plus_one", "TorchArrowEvalPythonExec"),
                      ("pandas_udf_cdf", "TorchArrowEvalPythonExec"),
                      ("map_in_pandas", "TorchMapInPandasExec")):
        need = ("pandas", "cloudpickle") + (
            ("scipy",) if leg == "pandas_udf_cdf" else ())
        if not all(have[m] for m in need):
            phase(leg, card=card, skipped=f"needs {need}: {have}")
            continue
        out = windows_leg(sp, card, leg, frames[leg],
                          lambda rows, leg=leg: check_all_groups(
                              rows, pwant[leg], leg), node)["out"]
        phase(leg, card=card, rows_in=PUDF_ROWS, generate_s=pgen_s,
              tolerance="sums within 1e-12 relative, the rest exact",
              python=python_exec_metrics(sp.last_plan),
              **{k: v for k, v in out.items()
                 if k not in ("window_dispatch_count", "rows_out")},
              groups=out["rows_out"])
        legs[leg] = out["launches"]
    workers = worker_processes()
    sp.stop()
    alive = [w.pid for w in workers if w.wait(timeout=10) is None]
    if alive:
        raise AssertionError(f"python workers outlived stop(): {alive}")
    phase("python_workers", card=card, started=len(workers),
          alive_after_stop=len(alive), importable=have)

    from spark_rapids_tpu_torch.exec import fused as FU
    cconf = dict(PHASE17_CONF, **{"spark.rapids.sql.udfCompiler.enabled":
                                  "true"})
    cs = TorchSparkSession(cconf)
    make = pudf_frames(cs, F, cs.createDataFrame(
        pb, num_partitions=N_PARTITIONS))["udf_compiled"]
    out = windows_leg(cs, card, "udf_compiled", make,
                      lambda rows: check_all_groups(
                          rows, pwant["udf_compiled"], "udf_compiled"),
                      "TorchFusedStageExec")["out"]
    stages = [p for p in plan_nodes_of(cs.last_plan)
              if isinstance(p, FU.TorchFusedStageExec)
              and any(type(o).__name__ == "TorchProjectExec"
                      and "CaseWhen" in repr(o.project_list)
                      for o in p.fused_ops)]
    if len(stages) != 1:
        raise AssertionError(f"udf_compiled: no fused compiled project: "
                             f"{out['plan']}")
    FU.reset_graph_counts()
    df = make()
    df.collect()
    replays = dict(FU.GRAPH_COUNTS)
    sm = stage_metrics(cs.last_plan)
    # a stage program runs as one CUDA graph replay a batch (the CPU
    # runs it eagerly)
    if device.type == "cuda" and replays["replays"] != sm["dispatchCount"]:
        raise AssertionError(f"udf_compiled: graph replays {replays} != "
                             f"stage dispatches {sm}")
    phase("udf_compiled", card=card, rows_in=PUDF_ROWS,
          tolerance="sums within 1e-12 relative, the rest exact",
          stage=[type(o).__name__ for o in stages[0].fused_ops],
          graph_counts=replays, stage_dispatches=sm["dispatchCount"],
          **{k: v for k, v in out.items()
             if k not in ("window_dispatch_count", "rows_out")},
          groups=out["rows_out"])
    legs["udf_compiled"] = out["launches"]
    del cs, pb
    GATE["strict"] = False
    phase("cache_udf_kernel_shapes", card=card, tolerance="exact",
          **shapes)
    return legs, shapes


# -- phase 18: the per-operator CPU fallback ----------------------------------
#
# (a) TPC-H q13 at SF1, in TPC-H's text but for the derived column list:
# ``count(o_orderkey) AS c_count`` is named inside the subquery, since
# neither package parses ``AS c_orders (c_custkey, c_count)``. Its join
# condition keeps a NOT LIKE beside the key, so the left outer join is a
# conditional outer join, which both packages run on the host.
Q13 = """
SELECT c_count, count(*) AS custdist
FROM (
    SELECT c_custkey, count(o_orderkey) AS c_count
    FROM customer LEFT OUTER JOIN orders
        ON c_custkey = o_custkey
        AND o_comment NOT LIKE '%special%requests%'
    GROUP BY c_custkey
) c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""
Q13_SEED = 20260741
Q13_CUSTOMERS = 150_000
Q13_ORDERS = 1_500_000
# TPC-H 4.2.2.10's text grammar words ("special" left out: it appears only
# where a comment is drawn to match the pattern)
Q13_WORDS = (
    "furiously", "sly", "careful", "blithe", "quick", "fluffy", "slow",
    "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
    "stealthy", "permanent", "enticing", "idle", "busy", "regular",
    "final", "ironic", "even", "bold", "silent", "foxes", "ideas",
    "theodolites", "pinto", "beans", "instructions", "dependencies",
    "excuses", "platelets", "asymptotes", "courts", "dolphins",
    "multipliers", "sauternes", "warthogs", "frets", "dinos",
    "attainments", "somas", "Tiresias", "patterns", "forges", "braids",
    "hockey", "players", "frays", "warhorses", "dugouts", "notornis",
    "epitaphs", "pearls", "tithes", "waters", "orbits", "gifts",
    "sheaves", "depths", "sentiments", "decoys", "realms", "pains",
    "grouches", "escapades", "packages", "requests", "accounts",
    "deposits", "sleep", "wake", "are", "cajole", "haggle", "nag", "use",
    "boost", "affix", "detect", "integrate", "maintain", "nod", "was",
    "lose", "sublate", "solve", "thrash", "promise", "engage", "hinder",
    "print", "x-ray", "breach", "eat", "grow", "impress", "mold", "poach",
    "serve", "run", "dazzle", "snooze", "doze", "unwind", "kindle",
    "play", "hang", "believe", "doubt", "about", "above", "according",
    "to", "across", "after", "against", "along", "among", "around",
    "at", "atop", "before", "behind", "beneath", "beside", "besides",
    "between", "beyond", "by", "despite", "during", "except", "for",
    "from", "in", "place", "of", "inside", "instead", "into", "near",
    "on", "outside", "over", "past", "since", "through", "throughout",
    "toward", "under", "until", "up", "upon", "whithout", "with",
    "within", "quickly", "carefully", "blithely", "slyly", "fluffily",
    "silently", "furiously", "finally", "ironically", "evenly",
    "boldly", "express", "pending", "unusual")
Q13_MATCH_SHARE = 0.01  # comments with "special ... requests"
Q13_POOL = 1 << 16  # distinct comments each kind is drawn from


def _q13_comment(rng, special: bool) -> str:
    """One comment of 19-78 characters of grammar words; a special one
    holds ``special`` and, after it, ``requests``."""
    target = int(rng.integers(19, 79))
    words = ["special"] if special else []
    while len(" ".join(words)) < target:
        words.append(str(Q13_WORDS[int(rng.integers(0, len(Q13_WORDS)))]))
    if special:
        words.insert(int(rng.integers(1, len(words) + 1)), "requests")
        while len(" ".join(words)) > 78 and len(words) > 2:
            words.pop(-1 if words[-1] != "requests" else -2)
    text = " ".join(words)
    return text if len(text) >= 19 else (text + " " + "x" * 19)[:19]


def q13_tables(n_customers: int = Q13_CUSTOMERS,
               n_orders: int = Q13_ORDERS, seed: int = Q13_SEED) -> dict:
    """customer and orders with the TPC-H 4.2.3 domains: c_custkey
    1..n; dbgen's sparse order keys (the first 8 of every 32);
    o_custkey uniform over the customers whose key is not divisible by 3
    (so a third of them have no order); o_comment from two pools of
    ``Q13_POOL`` comments, the matching one drawn for about 1% of the
    orders. Returns the key arrays and the comment pools and indices."""
    rng = np.random.default_rng(seed)
    custkey = np.arange(1, n_customers + 1, dtype=np.int64)
    okey = np.arange(n_orders, dtype=np.int64)
    okey = (okey // 8) * 32 + okey % 8 + 1
    eligible = custkey[custkey % 3 != 0]
    o_cust = eligible[rng.integers(0, len(eligible), n_orders)]
    plain = np.array([_q13_comment(rng, False) for _ in range(Q13_POOL)],
                     dtype=object)
    special = np.array([_q13_comment(rng, True)
                        for _ in range(Q13_POOL // 64)], dtype=object)
    pool = np.concatenate([plain, special])
    is_special = rng.random(n_orders) < Q13_MATCH_SHARE
    idx = np.where(is_special,
                   len(plain) + rng.integers(0, len(special), n_orders),
                   rng.integers(0, len(plain), n_orders))
    return {"c_custkey": custkey, "o_orderkey": okey, "o_custkey": o_cust,
            "pool": pool, "comment_idx": idx}


def q13_batches(tables) -> dict:
    """The port's HostBatches of customer and orders (the comments with
    their compact bytes)."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.sql import types as T
    n = len(tables["o_orderkey"])
    data, vb = pooled_strings(tables["pool"], tables["comment_idx"])
    ones = np.ones(n, bool)
    orders = HostBatch(
        T.StructType([T.StructField("o_orderkey", T.LongT),
                      T.StructField("o_custkey", T.LongT),
                      T.StructField("o_comment", T.StringT)]),
        [HostColumn(T.LongT, tables["o_orderkey"], ones),
         HostColumn(T.LongT, tables["o_custkey"], ones.copy()),
         HostColumn(T.StringT, data, ones.copy(), vb)], n)
    cust = tables["c_custkey"]
    customer = HostBatch(T.StructType([T.StructField("c_custkey", T.LongT)]),
                         [HostColumn(T.LongT, cust, np.ones(len(cust), bool))],
                         len(cust))
    return {"customer": customer, "orders": orders}


def q13_reference(tables) -> list:
    """q13's rows ``(c_count, custdist)`` in its order, with numpy."""
    import re
    pat = re.compile(r"special.*requests")
    matches = np.array([bool(pat.search(c)) for c in tables["pool"]])
    keep = ~matches[tables["comment_idx"]]
    n_c = len(tables["c_custkey"])
    c_count = np.bincount(tables["o_custkey"][keep] - 1, minlength=n_c)
    dist = np.bincount(c_count)
    rows = [(int(c), int(d)) for c, d in enumerate(dist) if d]
    return sorted(rows, key=lambda r: (-r[1], -r[0]))


# (b) TPC-DS q28 with its qualification substitutions, each block's FROM
# list joined with CROSS JOIN (neither package parses the comma list).
# Each block is a global mixed DISTINCT, planned as a cross join of two
# one-row aggregates over one cached child: 11 nested-loop joins on the
# host, every aggregate on the device.
Q28_SEED = 20260742
Q28_ROWS = 2_000_000  # TPC-DS SF1 has 2,880,404 store_sales rows
# (quantity low, high, list price, coupon amount, wholesale cost)
Q28_BUCKETS = ((0, 5, 8, 459, 57), (6, 10, 90, 2323, 31),
               (11, 15, 142, 12214, 79), (16, 20, 135, 6071, 38),
               (21, 25, 122, 836, 17), (26, 30, 154, 7326, 7))
Q28_COUPON_SHARE = 0.2


def _q28_block(i: int, qlo: int, qhi: int, lp: int, ca: int,
               wc: int) -> str:
    return (f"(SELECT avg(ss_list_price) B{i}_LP, "
            f"count(ss_list_price) B{i}_CNT, "
            f"count(DISTINCT ss_list_price) B{i}_CNTD "
            f"FROM store_sales "
            f"WHERE ss_quantity BETWEEN {qlo} AND {qhi} "
            f"AND (ss_list_price BETWEEN {lp} AND {lp}+10 "
            f"OR ss_coupon_amt BETWEEN {ca} AND {ca}+1000 "
            f"OR ss_wholesale_cost BETWEEN {wc} AND {wc}+20)) B{i}")


Q28 = ("SELECT * FROM "
       + " CROSS JOIN ".join(_q28_block(i + 1, *b)
                             for i, b in enumerate(Q28_BUCKETS))
       + " LIMIT 100")


def q28_tables(n: int = Q28_ROWS, seed: int = Q28_SEED) -> dict:
    """store_sales' four q28 columns with dsdgen's pricing domains, money
    in cents: ss_quantity U[1,100]; ss_wholesale_cost U[1.00,100.00];
    ss_list_price = wholesale x (1 + markup), markup U[0,2.00];
    ss_coupon_amt on 20% of the rows, a share U[0,1.00] of the extended
    sales price (list x (1 - discount U[0,1.00]) x quantity), else 0."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 101, n).astype(np.int32)
    wc = rng.integers(100, 10001, n).astype(np.int64)
    markup = rng.integers(0, 201, n)
    lp = (wc * (100 + markup) + 50) // 100
    disc = rng.integers(0, 101, n)
    sp = (lp * (100 - disc) + 50) // 100
    ext = sp * qty
    share = rng.integers(0, 101, n)
    coupon = np.where(rng.random(n) < Q28_COUPON_SHARE,
                      (ext * share + 50) // 100, 0).astype(np.int64)
    return {"ss_quantity": qty, "ss_list_price": lp,
            "ss_coupon_amt": coupon, "ss_wholesale_cost": wc}


def q28_fields():
    from spark_rapids_tpu_torch.sql import types as T
    money = T.DecimalType(7, 2)
    return [("ss_quantity", T.IntegerT), ("ss_list_price", money),
            ("ss_coupon_amt", money), ("ss_wholesale_cost", money)]


def q28_batch(tables):
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    return host_batch_from_numpy(q28_fields(), [
        tables[name] for name, _t in q28_fields()])


def q28_reference(tables) -> tuple:
    """q28's one row: per block the average list price at its result
    scale 6 (HALF_UP of the unscaled sum x 10^4 over the count), the
    count and the distinct count, with numpy and Python ints."""
    qty, lp = tables["ss_quantity"], tables["ss_list_price"]
    ca, wc = tables["ss_coupon_amt"], tables["ss_wholesale_cost"]
    row = []
    for qlo, qhi, p, c, w in Q28_BUCKETS:
        m = (qty >= qlo) & (qty <= qhi) & (
            ((lp >= p * 100) & (lp <= (p + 10) * 100))
            | ((ca >= c * 100) & (ca <= (c + 1000) * 100))
            | ((wc >= w * 100) & (wc <= (w + 20) * 100)))
        cnt = int(m.sum())
        total = int(lp[m].sum())
        avg = None
        if cnt:
            avg = decimal.Decimal(_half_up_div(total * 10 ** 4, cnt)) \
                .scaleb(-6)
        row += [avg, cnt, int(len(np.unique(lp[m])))]
    return tuple(row)


def check_q28_rows(got, want: tuple, what: str) -> None:
    if len(got) != 1 or tuple(got[0]) != want:
        raise AssertionError(f"{what}: {got} != [{want}]")
    for v, w in zip(got[0][0::3], want[0::3]):
        if w is not None and v.as_tuple().exponent != -6:
            raise AssertionError(f"{what}: average {v!r} not at scale 6")


FALLBACK_CONF = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}
HOST_SOURCE_NAMES = ("CpuLocalScanExec", "CpuFileScanExec",
                     "CpuCachedScanExec")


def host_operators(plan) -> list:
    """The operators of an executed plan left on the host (its host
    sources aside), in plan order."""
    return [type(p).__name__ for p in plan_nodes_of(plan)
            if type(p).__name__.startswith("Cpu")
            and type(p).__name__ not in HOST_SOURCE_NAMES]


def explain_lines(spark, df) -> list:
    """The lines one rewrite of ``df`` prints under
    ``spark.rapids.sql.explain=ALL``."""
    import contextlib
    import io

    from spark_rapids_tpu_torch.memory import release_plan_handles
    spark.conf.set("spark.rapids.sql.explain", "ALL")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            plan = spark.plan_physical(df.plan)
        release_plan_handles(plan)
    finally:
        spark.conf.unset("spark.rapids.sql.explain")
    return out.getvalue().splitlines()


class _Runs:
    """What ``profile_collect`` calls: a plan's own run for ``collect``."""

    def __init__(self, run):
        self.collect = run


def host_seconds(spark, df, what: str, card: str) -> tuple:
    """One run of ``df``'s plan with each host operator's partitions and
    each download under it timed, under torch.profiler: the host
    operators' own seconds (their time less their timed children's), and
    each transition pair's, the download's ``copyFromDeviceTime`` and the
    upload's ``packBatchTime`` and ``copyToDeviceTime`` above a host
    operator; then the run's device busy time and idle share, as
    ``profile_collect`` reads them."""
    import torch

    from spark_rapids_tpu_torch.exec.base import (TorchColumnarToRowExec,
                                                  TorchRowToColumnarExec)
    from spark_rapids_tpu_torch.memory import release_plan_handles
    plan = spark.plan_physical(df.plan)
    spent = {}

    def timed(node):
        plain = node.partitions

        def partitions():
            # a node may drain a child here (a nested-loop join's build)
            t0 = time.perf_counter()
            thunks = plain()
            spent[id(node)] = spent.get(id(node), 0.0) + (
                time.perf_counter() - t0)

            def wrap(thunk):
                def run():
                    it = iter(thunk())
                    while True:
                        t0 = time.perf_counter()
                        b = next(it, None)
                        spent[id(node)] = spent.get(id(node), 0.0) + (
                            time.perf_counter() - t0)
                        if b is None:
                            return
                        yield b
                return run
            return [wrap(t) for t in thunks]
        node.partitions = partitions

    nodes = plan_nodes_of(plan)
    host = [p for p in nodes if type(p).__name__.startswith("Cpu")]
    downloads = [p for p in nodes if isinstance(p, TorchColumnarToRowExec)
                 and p is not plan]
    for p in host + downloads:
        timed(p)
    try:
        prof = profile_collect(_Runs(plan.execute_collect), what, card,
                               warm=False)
    finally:
        release_plan_handles(plan)
    wall = prof["profiled_wall_s"]
    ops = {}
    for p in host:
        own = spent.get(id(p), 0.0) - sum(spent.get(id(c), 0.0)
                                          for c in p.children)
        name = type(p).__name__
        if name not in HOST_SOURCE_NAMES:
            ops.setdefault(name, []).append(own)
    pairs = []
    for p in nodes:
        if isinstance(p, TorchRowToColumnarExec) and type(
                p.child).__name__.startswith("Cpu") and type(
                p.child).__name__ not in HOST_SOURCE_NAMES:
            m = p.metrics.snapshot()
            pairs.append({
                "upload_over": type(p.child).__name__,
                "packBatchTime_s": m.get("packBatchTime", 0) / 1e9,
                "copyToDeviceTime_s": m.get("copyToDeviceTime", 0) / 1e9,
                "downloads_under": [
                    {"copyFromDeviceTime_s":
                     c.metrics.snapshot().get("copyFromDeviceTime", 0) / 1e9,
                     "with_device_work_s": spent.get(id(c), 0.0)}
                    for c in plan_nodes_of(p.child)
                    if isinstance(c, TorchColumnarToRowExec)]})
    return {"wall_s": wall, "host_operator_s": ops,
            "host_operator_total_s": sum(sum(v) for v in ops.values()),
            "transition_pairs": pairs}, prof


# timed runs of a phase-18 leg after its profiled warm run (one since
# phase 22 joined the script: its legs are host-bound and seconds long)
FALLBACK_TIMED_RUNS = 1


def fallback_leg(spark, card: str, what: str, make_df, check,
                 expect) -> dict:
    """One leg of phase 18: the first collect (launches counted), its rows
    through ``check(rows)``, ``expect(plan, host_operators, launches)``
    for the leg's placement and routes, the plan with its host operators,
    the explain lines under ``spark.rapids.sql.explain=ALL``, one warm
    run timed by operator under the profiler (``host_seconds``), and
    ``FALLBACK_TIMED_RUNS`` timed runs (their median)."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    df = make_df()
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = [tuple(r) for r in df.collect()]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    err = check(rows)
    plan = spark.last_plan
    host = host_operators(plan)
    expect(plan, host, launches)
    report = spark.last_rewrite_report.summary()
    t0 = time.perf_counter()
    lines = explain_lines(spark, df)
    steps = {"first_run": first_s, "explain": time.perf_counter() - t0}
    # the warm run: timed by operator, under the profiler
    t0 = time.perf_counter()
    split, prof = host_seconds(spark, df, what, card)
    steps["profiled_run_and_tables"] = time.perf_counter() - t0
    walls = []
    for _ in range(FALLBACK_TIMED_RUNS):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps["timed_runs"] = sum(walls)
    return {"rows": rows, "out": {
        "rows_out": len(rows), "max_rel_err": err,
        "plan": plan.tree_string().splitlines()
        if len(plan_nodes_of(plan)) < 40 else plan_names(plan),
        "host_operators": host, "coverage": report["coverage"],
        "explain_all": lines, "launches": launches,
        "first_run_s": first_s, "seconds": split, "warm_runs": 1,
        "timed_runs": walls, "median_s": statistics.median(walls),
        "device_idle_share": prof["device_idle_share"],
        "device_busy_s": prof["device_busy_s"],
        "profiled_wall_s": prof["profiled_wall_s"],
        "top_device_us": prof["top_device_us"], "leg_steps_s": steps}}


def _expect_q13(plan, host, launches) -> None:
    """The JAX package's q13 placement: the conditional left join on the
    host over two downloads, an upload above it, both aggregates on the
    device through groupbyHash, the project fused with the partial
    aggregate."""
    from spark_rapids_tpu_torch.exec.base import (TorchColumnarToRowExec,
                                                  TorchRowToColumnarExec)
    from spark_rapids_tpu_torch.exec.fused import TorchFusedStageExec
    joins = [p for p in plan_nodes_of(plan)
             if type(p).__name__ in ("CpuShuffledHashJoinExec",
                                     "CpuBroadcastHashJoinExec")]
    up = [p for p in plan_nodes_of(plan)
          if isinstance(p, TorchRowToColumnarExec) and p.child in joins]
    fused = [[type(o).__name__ for o in p.fused_ops]
             for p in plan_nodes_of(plan)
             if isinstance(p, TorchFusedStageExec)]
    if len(joins) != 1 or host != [type(joins[0]).__name__] \
            or len(up) != 1 or not all(
                isinstance(c, TorchColumnarToRowExec)
                or type(c).__name__ in HOST_SOURCE_NAMES
                for c in joins[0].children) \
            or ["TorchProjectExec", "TorchHashAggregateExec"] not in fused \
            or launches["groupbyHash"] <= 0:
        raise AssertionError(f"q13 placement: host {host}, fused {fused}, "
                             f"launches {launches}")


def _expect_q28(plan, host, launches) -> None:
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    aggs = [p for p in plan_nodes_of(plan)
            if isinstance(p, TorchHashAggregateExec)]
    if host.count("CpuBroadcastNestedLoopJoinExec") != 11 or any(
            "Aggregate" in h for h in host) or not aggs \
            or launches["groupbyHash"] <= 0:
        raise AssertionError(f"q28 placement: host {host}, launches "
                             f"{launches}")


def fallback_phases(device, card: str, arrays, q1_dir: str) -> tuple:
    """Phase 18: TPC-H q13 at SF1 and TPC-DS q28 from memory and from
    Parquet, and q1 from phase 7's Parquet files with the aggregate turned
    off, each with its host operators where the JAX package places its
    CPU operators; then groupbyHash at q13's and q28's partial batches and
    the cost model's two constants measured on this card. Every collect
    leaves no store handle and no permit held."""
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    GATE["strict"] = True
    legs, shapes = {}, {"groupbyHash": {}}
    shape_s = {}
    t0 = time.perf_counter()
    t13 = q13_tables()
    b13 = q13_batches(t13)
    want13 = q13_reference(t13)
    t28 = q28_tables()
    b28 = q28_batch(t28)
    want28 = q28_reference(t28)
    gen_s = time.perf_counter() - t0
    del t13, t28
    sizes = {"customer": Q13_CUSTOMERS, "orders": Q13_ORDERS,
             "store_sales": Q28_ROWS}
    dirs = {}
    write_s = 0.0
    for name, b in (("customer", b13["customer"]),
                    ("orders", b13["orders"]), ("store_sales", b28)):
        dirs[name] = os.path.join(DATA_DIR, f"fallback_{name}")
        write_s += write_once(
            dirs[name], lambda d, b=b: TorchSparkSession(dict(FALLBACK_CONF))
            .createDataFrame(b, num_partitions=N_PARTITIONS)
            .write.mode("overwrite").parquet(d),
            data_key(seed=Q13_SEED if name != "store_sales" else Q28_SEED,
                     table=name, rows=b.num_rows, partitions=N_PARTITIONS))

    def session(source):
        s = TorchSparkSession(dict(FALLBACK_CONF))
        for name, b in (("customer", b13["customer"]),
                        ("orders", b13["orders"]), ("store_sales", b28)):
            if source == "memory":
                s.createDataFrame(b, num_partitions=N_PARTITIONS) \
                    .createOrReplaceTempView(name)
            else:
                s.read.parquet(dirs[name]).createOrReplaceTempView(name)
        return s

    for source in ("memory", "parquet"):
        spark = session(source)
        leg = f"q13_{source}"

        def check13(rows, leg=leg):
            if rows != want13:
                raise AssertionError(f"{leg}: rows differ from the "
                                     f"reference ({len(rows)} rows)")
            return 0.0
        out = fallback_leg(spark, card, leg, lambda: spark.sql(Q13),
                           check13, _expect_q13)["out"]
        if source == "parquet" and out["launches"]["decodeFused"] <= 0:
            raise AssertionError(f"{leg}: kernels {out['launches']}")
        phase(leg, card=card, rows_in={k: v for k, v in sizes.items()
                                       if k != "store_sales"},
              generate_s=gen_s, tolerance="exact", **out)
        legs[leg] = out["launches"]
        if source == "memory":
            t_shape = time.perf_counter()
            plan = spark.plan_physical(spark.sql(Q13).plan)
            # the plain version takes seconds on the overflowing batch:
            # its time is that of the checked call
            shapes["groupbyHash"].update(partial_groupby_cases(
                spark, plan, "q13",
                pick=lambda a: a.grouping[0].name == "c_custkey",
                plain_reps=0))
            from spark_rapids_tpu_torch.memory import release_plan_handles
            release_plan_handles(plan)
            shape_s["q13"] = time.perf_counter() - t_shape
        leg = f"q28_{source}"

        def check28(rows, leg=leg):
            check_q28_rows(rows, want28, leg)
            return 0.0
        out = fallback_leg(spark, card, leg, lambda: spark.sql(Q28),
                           check28, _expect_q28)["out"]
        info = cache_info(spark.last_plan)
        phase(leg, card=card, rows_in=Q28_ROWS, tolerance="exact",
              cache=info, **out)
        legs[leg] = out["launches"]
        if source == "memory":
            t_shape = time.perf_counter()
            plan = spark.plan_physical(spark.sql(Q28).plan)
            shapes["groupbyHash"].update(partial_groupby_cases(
                spark, plan, "q28_distinct",
                pick=lambda a: a.grouping[0].name == "ss_list_price"))
            from spark_rapids_tpu_torch.memory import release_plan_handles
            release_plan_handles(plan)
            shape_s["q28"] = time.perf_counter() - t_shape
        del spark
    phase("fallback_data", card=card, generate_s=gen_s, write_s=write_s,
          q13_orders_matching_share=Q13_MATCH_SHARE,
          q13_comment_pool=Q13_POOL, q28_buckets=Q28_BUCKETS)

    # q1 from Parquet with the aggregate off: decodeFused and the fused
    # filter/project on the device, both aggregates on the host
    want_q1 = q1_reference(arrays)
    off = "spark.rapids.sql.exec.HashAggregateExec"
    cs = TorchSparkSession(dict(FALLBACK_CONF, **{off: "false"}))
    cs.read.parquet(q1_dir).createOrReplaceTempView("lineitem")

    def check_q1(rows):
        check_q1_rows(rows, want_q1)
        return 0.0

    def expect_q1(plan, host, launches):
        if host != ["CpuHashAggregateExec", "CpuHashAggregateExec"] or \
                launches["decodeFused"] != N_PARTITIONS or \
                launches["groupbyHash"] != 0:
            raise AssertionError(f"q1_cpu_aggregate: host {host}, "
                                 f"launches {launches}")
    out = fallback_leg(cs, card, "q1_cpu_aggregate", lambda: cs.sql(Q1),
                       check_q1, expect_q1)["out"]
    phase("q1_cpu_aggregate", card=card, rows_in=SF1_ROWS,
          reference="exact", conf={off: "false"}, **out)
    legs["q1_cpu_aggregate"] = out["launches"]
    del cs
    GATE["strict"] = False
    phase("fallback_kernel_shapes", card=card, tolerance="exact",
          seconds=shape_s, **shapes)
    cbo_constants(card, arrays)
    return legs, shapes


def cbo_constants(card: str, arrays) -> dict:
    """The cost model's two constants on this card: the bytes a second of
    a pinned upload and download pair (q1's lineitem at SF1, bytes as the
    model counts them, both ways, over the round trip's seconds less the
    flat cost), and the flat seconds of one empty island's round trip (a
    one-row frame, the median of 20)."""
    import torch

    from spark_rapids_tpu_torch import overrides as PO
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    spark = TorchSparkSession(dict(FALLBACK_CONF))
    hb = host_batch_from_numpy(lineitem_fields(), arrays)
    full = spark.createDataFrame(hb, num_partitions=N_PARTITIONS)
    one = spark.createDataFrame(hb.slice(0, 1), num_partitions=1)

    def median_s(df, reps):
        # the batch that comes back, not Python rows built from it
        df._execute()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            df._execute()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out), out
    flat_s, flat_runs = median_s(one, 20)
    full_s, full_runs = median_s(full, 3)
    width = PO._row_width_bytes(hb.schema)
    moved = 2 * hb.num_rows * width
    wire = moved / max(1e-9, full_s - flat_s)
    out = {"wire_bytes_per_s": wire, "island_flat_s": flat_s,
           "rows": hb.num_rows, "row_width_bytes": width,
           "bytes_both_ways": moved, "round_trip_s": full_s,
           "round_trip_runs": full_runs, "flat_runs": flat_runs,
           "module_wire_bytes_per_s": PO._WIRE_BYTES_PER_S,
           "module_island_flat_s": PO._ISLAND_FLAT_S,
           "plan": plan_names(spark.last_plan)}
    phase("cbo_constants", card=card, **out)
    return out


# -- phase 19: readers and writers ------------------------------------------
#
# (a) TPC-H q1 at SF1 from dbgen-style delimited text: phase 7's seeded
# lineitem written by the port's CSV writer with ``sep='|'`` and no
# header, as dbgen writes ``lineitem.tbl``, read with a decimal(15,2)
# schema. ``reduced``: dbgen's 16 columns and its trailing separator cut
# to q1's seven.
# (b) q1 from phase 7's eight Parquet files under each reader strategy,
# and ``input_file_name()`` under COALESCING (the scan reads as PERFILE).
# (c) q1 over lineitem written with ``partitionBy("l_returnflag",
# "l_linestatus")``: 6 directories, the two columns from their names.
# (d) TPC-DS q3 in its pushed form at bench's q3 scale from ORC written by
# the port's ORC writer, each file a scan partition as in memory.
# (e) The YSB windowed campaign count over JSON lines, the events' wire
# form in the Yahoo Streaming Benchmark. ``reduced``: 1,000,000 events of
# phase 16's 6,000,000 (the JSON writer encodes row by row in the
# reference).
FORMATS_CONF = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}
READER_KEY = "spark.rapids.sql.format.parquet.reader.type"
LINEITEM_DDL = ("l_quantity decimal(15,2), l_extendedprice decimal(15,2), "
                "l_discount decimal(15,2), l_tax decimal(15,2), "
                "l_returnflag string, l_linestatus string, l_shipdate date")
YSB_JSON_EVENTS = 1_000_000
YSB_EVENTS_DDL = ("user_id string, page_id string, ad_id string, "
                  "ad_type string, event_type string, event_time timestamp, "
                  "ip_address string")
YSB_ADS_DDL = "ad_id string, campaign_id string"
# every ORC file its own scan partition, as store_sales' 8 partitions and
# the dimensions' 4 from memory
ORC_CONF = {"spark.sql.files.maxPartitionBytes": str(1 << 20)}
IFF_SQL = ("SELECT f, count(*) AS c FROM (SELECT input_file_name() AS f "
           "FROM lineitem) x GROUP BY f")


def scan_seconds(plan) -> dict:
    """One run's host seconds in the scan (``decodeTime``, ``convertTime``
    and ``ioRetryCount``, summed over its threads) and in the upload
    (``packBatchTime``, ``copyToDeviceTime``)."""
    scan = scan_counts(plan)
    up = r2c_metrics(plan)
    return {"decodeTime_s": scan.get("decodeTime", 0) / 1e9,
            "convertTime_s": scan.get("convertTime", 0) / 1e9,
            "packBatchTime_s": up.get("packBatchTime", 0) / 1e9,
            "copyToDeviceTime_s": up.get("copyToDeviceTime", 0) / 1e9,
            "scan": {k: v for k, v in scan.items()
                     if not k.endswith("Time")},
            "r2c_batches": up.get("numOutputBatches", 0)}


def formats_runs(card: str, what: str, dfs: dict, check, expect,
                 timed: bool = True) -> dict:
    """One leg of phase 19 over one or more sessions' frames ``dfs``
    ({variant: (spark, df)}): each variant's first collect (its launches
    counted, its rows through ``check``, ``expect(variant, launches,
    plan)``), then, where ``timed``, two timed runs in turns (the first
    collect was the warm run; a variant's second run follows the others'
    second) and one profiled run of each, tracing the device only, whose
    scan and upload seconds are read from its plan."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    out = {}
    for v, (spark, df) in dfs.items():
        KR.reset_launches()
        t0 = time.perf_counter()
        rows = [tuple(r) for r in df.collect()]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(KR.LAUNCHES)
        check(rows)
        expect(v, launches, spark.last_plan)
        out[v] = {"rows_out": len(rows), "launches": launches,
                  "first_run_s": first_s,
                  "plan": plan_names(spark.last_plan)}
        if not timed:
            out[v]["first_run"] = scan_seconds(spark.last_plan)
    if not timed:
        return out
    turns = in_turns({v: df for v, (_s, df) in dfs.items()})
    for v, (spark, df) in dfs.items():
        prof = profile_collect(df, f"{what}_{v.lower()}", card, warm=False)
        out[v].update(turns[v], warm_runs=1, **prof,
                      profiled_run=scan_seconds(spark.last_plan))
    return out


def formats_phases(device, card: str, arrays, q1_dir: str) -> dict:
    """Phase 19: the file formats, reader strategies and writers (legs (a)
    to (e) above), each leg exact against its numpy reference, with its
    launches, walls, idle share and the scan's and upload's seconds.
    Returns each leg's and reader's kernel launches."""
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    t_phase = time.perf_counter()
    legs = {}
    want_q1 = q1_reference(arrays)

    def check_q1(rows):
        check_q1_rows(rows, want_q1)

    def session(conf=None):
        return TorchSparkSession(dict(FORMATS_CONF, **(conf or {})))

    # -- set-up: every file written by the port's writers ---------------
    t0 = time.perf_counter()
    lineitem = host_batch_from_numpy(lineitem_fields(), arrays)
    q3 = q3_tables()
    want_q3 = q3_reference(q3)
    q3_types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
                "dec72": T.DecimalType(7, 2)}
    ysb = ysb_tables(YSB_JSON_EVENTS)
    yb = ysb_batches(ysb)
    want_ysb = ysb_reference(ysb)
    gen_s = time.perf_counter() - t0
    dirs = {k: os.path.join(DATA_DIR, f"formats_{k}")
            for k in ("lineitem_tbl", "lineitem_partitioned", "q3_orc",
                      "ysb_json")}
    writes = {}
    writes["lineitem_tbl"] = write_once(
        dirs["lineitem_tbl"], lambda d: session().createDataFrame(
            lineitem, num_partitions=N_PARTITIONS).write.mode("overwrite")
        .csv(d, sep="|"),
        data_key(seed=SEED, rows=SF1_ROWS, partitions=N_PARTITIONS,
                 fmt="tbl"))
    writes["lineitem_partitioned"] = write_once(
        dirs["lineitem_partitioned"], lambda d: session().createDataFrame(
            lineitem, num_partitions=N_PARTITIONS).write.mode("overwrite")
        .partitionBy("l_returnflag", "l_linestatus").parquet(d),
        data_key(seed=SEED, rows=SF1_ROWS, partitions=N_PARTITIONS,
                 fmt="partitioned"))

    def write_q3(d):
        s = session()
        for name, cols in q3.items():
            s.createDataFrame(host_batch_from_numpy(
                [(c, q3_types[k]) for c, k, _a in cols],
                [a for _c, _k, a in cols]),
                num_partitions=Q3_PARTITIONS[name]).write \
                .mode("overwrite").orc(os.path.join(d, name))
    writes["q3_orc"] = write_once(dirs["q3_orc"], write_q3, data_key(
        seed=Q3_SEED, rows=Q3_SALES_ROWS, partitions=Q3_PARTITIONS,
        fmt="orc"))

    def write_ysb(d):
        s = session()
        for name, b in yb.items():
            s.createDataFrame(b, num_partitions=N_PARTITIONS
                              if name == "events" else 1).write \
                .mode("overwrite").json(os.path.join(d, name))
    writes["ysb_json"] = write_once(dirs["ysb_json"], write_ysb, data_key(
        seed=YSB_SEED, rows=YSB_JSON_EVENTS, partitions=N_PARTITIONS,
        fmt="json"))
    sizes = {k: sum(os.path.getsize(os.path.join(r, f))
                    for r, _d, fs in os.walk(d) for f in fs)
             for k, d in dirs.items()}
    n_partition_dirs = sum(
        1 for r, ds, _fs in os.walk(dirs["lineitem_partitioned"])
        if os.path.basename(r).startswith("l_linestatus="))
    if n_partition_dirs != 6:
        raise AssertionError(f"partitioned lineitem: {n_partition_dirs} "
                             "directories, want 6")
    phase("formats_data", card=card, generate_s=gen_s, write_s=writes,
          bytes=sizes, partition_dirs=n_partition_dirs,
          ysb_events=YSB_JSON_EVENTS)

    def launched(name, want=None, at_least=1):
        def expect(v, launches, plan):
            got = launches[name]
            if (want is not None and got != want(v, plan)) or \
                    (want is None and got < at_least):
                raise AssertionError(f"{name} launches under {v}: "
                                     f"{launches}")
        return expect

    def also(*checks):
        def expect(v, launches, plan):
            for c in checks:
                c(v, launches, plan)
        return expect

    def uploads(v, plan):
        return r2c_metrics(plan).get("numOutputBatches", 0)

    # -- (a) q1 from delimited text, PERFILE and MULTITHREADED in turns ---
    dfs = {}
    for reader in ("PERFILE", "MULTITHREADED"):
        s = session({READER_KEY: reader})
        s.read.csv(dirs["lineitem_tbl"], schema=LINEITEM_DDL, sep="|") \
            .createOrReplaceTempView("lineitem")
        dfs[reader] = (s, s.sql(Q1))
    out = formats_runs(card, "q1_tbl", dfs, check_q1, also(
        launched("decodeFused", lambda v, p: 0),
        launched("groupbyHash", uploads)))
    for v, o in out.items():
        phase(f"q1_tbl_{v.lower()}", card=card, rows_in=SF1_ROWS,
              reader=v, reference="exact", **o)
        legs[f"q1_tbl_{v.lower()}"] = o["launches"]

    # -- (b) q1 from Parquet under each reader, and input_file_name() ---
    dfs = {}
    for reader in ("PERFILE", "MULTITHREADED", "COALESCING"):
        s = session({READER_KEY: reader})
        s.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
        dfs[reader] = (s, s.sql(Q1))
    out = formats_runs(card, "q1_readers", dfs, check_q1, also(
        launched("decodeFused",
                 lambda v, p: 0 if v == "COALESCING" else N_PARTITIONS),
        launched("groupbyHash")))
    for v, o in out.items():
        phase(f"q1_readers_{v.lower()}", card=card, rows_in=SF1_ROWS,
              reader=v, reference="exact", **o)
        legs[f"q1_readers_{v.lower()}"] = o["launches"]
    import pyarrow.parquet as pq
    want_files = {os.path.join(q1_dir, f): pq.ParquetFile(
        os.path.join(q1_dir, f)).metadata.num_rows
        for f in os.listdir(q1_dir) if f.endswith(".parquet")}
    s = session({READER_KEY: "COALESCING"})
    s.read.parquet(q1_dir).createOrReplaceTempView("lineitem")

    def check_iff(rows):
        got = {os.path.abspath(f): c for f, c in rows}
        if got != {os.path.abspath(f): c for f, c in want_files.items()}:
            raise AssertionError(f"input_file_name counts: {got}")

    def expect_iff(v, launches, plan):
        from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
        scan = next(p for p in plan_nodes_of(plan)
                    if isinstance(p, CpuFileScanExec))
        if scan.reader_type() != "PERFILE" or launches["groupbyHash"] <= 0:
            raise AssertionError(f"input_file_name: reader "
                                 f"{scan.reader_type()}, {launches}")
    # one collect: the leg's walls are q1's above
    out = formats_runs(card, "q1_readers_iff",
                       {"COALESCING": (s, s.sql(IFF_SQL))}, check_iff,
                       expect_iff, timed=False)["COALESCING"]
    phase("q1_readers_input_file_name", card=card, rows_in=SF1_ROWS,
          conf_reader="COALESCING", read_as="PERFILE", files=want_files,
          reference="exact (footer row counts)", **out)
    legs["q1_readers_input_file_name"] = out["launches"]

    # -- (c) q1 over the partitioned tree ----------------------------------
    s = session()
    s.read.parquet(dirs["lineitem_partitioned"]) \
        .createOrReplaceTempView("lineitem")

    def decoded_all(v, plan):
        return scan_counts(plan).get("deviceDecodedBatches", -1)
    out = formats_runs(card, "q1_partitioned", {"PERFILE": (s, s.sql(Q1))},
                       check_q1, also(launched("decodeFused", decoded_all),
                                      launched("groupbyHash")))["PERFILE"]
    phase("q1_partitioned", card=card, rows_in=SF1_ROWS,
          partition_dirs=n_partition_dirs, reference="exact", **out)
    legs["q1_partitioned"] = out["launches"]

    # -- (d) TPC-DS q3 (pushed form) from ORC --------------------------------
    s = session(ORC_CONF)
    for name in q3:
        s.read.orc(os.path.join(dirs["q3_orc"], name)) \
            .createOrReplaceTempView(name)
    out = formats_runs(card, "q3_orc", {"PERFILE": (s, s.sql(Q3_PUSHED))},
                       lambda rows: check_q3_rows(rows, want_q3, "q3_orc"),
                       also(launched("joinProbe", lambda v, p: 16),
                            launched("decodeFused", lambda v, p: 0),
                            launched("groupbyHash")))["PERFILE"]
    phase("q3_orc", card=card, rows_in=Q3_SALES_ROWS, reference="exact",
          conf=ORC_CONF, **out)
    legs["q3_orc"] = out["launches"]

    # -- (e) YSB over JSON lines ---------------------------------------------
    s = session()
    s.read.json(os.path.join(dirs["ysb_json"], "events"),
                schema=YSB_EVENTS_DDL).createOrReplaceTempView("events")
    s.read.json(os.path.join(dirs["ysb_json"], "ads"),
                schema=YSB_ADS_DDL).createOrReplaceTempView("ads")

    def check_ysb(rows):
        if sorted(rows) != want_ysb:
            raise AssertionError(f"ysb_json: {len(rows)} rows, "
                                 f"{sorted(rows)[:2]} != {want_ysb[:2]}")
    out = formats_runs(card, "ysb_json", {"PERFILE": (s, s.sql(YSB_SQL))},
                       check_ysb, also(launched("joinProbe"),
                                       launched("decodeFused",
                                                lambda v, p: 0)))["PERFILE"]
    phase("ysb_json", card=card, rows_in={"events": YSB_JSON_EVENTS,
                                          "ads": len(ysb["ads"]["ad"])},
          reference="exact", **out)
    legs["ysb_json"] = out["launches"]
    phase("formats_total", card=card,
          seconds=time.perf_counter() - t_phase, launches=legs)
    return legs


# -- phase 20: the query server (serve/) -------------------------------------

# TPC-H q1's DELTA is drawn from [60, 120] days before 1998-12-01 (spec
# 2.4.1.3); Q1 itself is DELTA 90
Q1_DELTAS = (60, 90, 120)
# i_manufact_id bindings (the generator's item table holds 1..1000) and
# d_moy 11 or 12
Q3_BINDINGS = ((128, 11), (436, 12), (677, 11))
SERVE_TENANTS = ("t0", "t1", "t2", "t3")
SERVE_REQUESTS = 8  # per tenant in the mixed leg, q1 and q3 in turn


def q1_shipdate(delta: int) -> str:
    return str(np.datetime64("1998-12-01") - np.timedelta64(delta, "D"))


def q1_text(delta: int = 90) -> str:
    """Q1 with its shipdate bound ``delta`` days before 1998-12-01."""
    return Q1.replace("date '1998-09-02'", f"date '{q1_shipdate(delta)}'")


def q1_references(arrays, shipdates) -> dict:
    """``{shipdate: q1_reference(arrays, shipdate)}`` for several bounds
    at once, the rows ``q1_reference``'s exactly: the rows sorted once by
    group and shipdate, every sum read off exact int64 prefix sums."""
    qty, price, disc, tax, rf, ls, ship = arrays
    flags, stats = ("A", "N", "R"), ("F", "O")
    code = (rf.astype("U1").view(np.uint32).astype(np.int64) << 40) \
        | (ls.astype("U1").view(np.uint32).astype(np.int64) << 32)
    order = np.argsort(code | ship.astype(np.int64), kind="stable")
    code_s, ship_s = code[order], ship[order]
    disc_price = price * (100 - disc)
    prefix = {}
    for name, a in (("qty", qty), ("price", price), ("disc", disc),
                    ("disc_price", disc_price),
                    ("charge", disc_price * (100 + tax))):
        prefix[name] = np.concatenate(([0], np.cumsum(
            a[order], dtype=np.int64)))
    out = {}
    for day in shipdates:
        cutoff = (np.datetime64(day) - np.datetime64("1970-01-01")).astype(
            int)
        rows = []
        for f in flags:
            for st in stats:
                g = (ord(f) << 40) | (ord(st) << 32)
                lo = int(np.searchsorted(code_s, g, side="left"))
                hi = int(np.searchsorted(code_s, g + (1 << 32),
                                         side="left"))
                end = lo + int(np.searchsorted(ship_s[lo:hi], cutoff,
                                               side="right"))
                cnt = end - lo
                if cnt == 0:
                    continue

                def total(name):
                    return int(prefix[name][end] - prefix[name][lo])
                sq, sp, sdisc = total("qty"), total("price"), total("disc")
                rows.append((f, st, (sq, 2), (sp, 2),
                             (total("disc_price"), 4), (total("charge"), 6),
                             (_half_up_div(sq * 10**4, cnt), 6),
                             (_half_up_div(sp * 10**4, cnt), 6),
                             (_half_up_div(sdisc * 10**4, cnt), 6), cnt))
        out[day] = rows
    return out


def q3_text(manufact: int = 128, moy: int = 11) -> str:
    """Q3_PUSHED with its two bindings."""
    return Q3_PUSHED.replace("d_moy = 11", f"d_moy = {moy}").replace(
        "i_manufact_id = 128", f"i_manufact_id = {manufact}")


def execution_launches(plan) -> dict:
    """The kernel launches one executed plan made, from its own counters
    (``kernelDispatchCount.*`` and the joins' ``route_counts``): the
    per-execution counts phase 20 sums against the global counters."""
    from spark_rapids_tpu_torch.metrics import plan_metrics
    m = plan_metrics(plan)
    out = {k: m.get(f"kernelDispatchCount.{k}", 0)
           for k in ("groupbyHash", "decodeFused", "murmur3")}
    out["joinProbe"] = sum(getattr(p, "route_counts", {}).get("joinProbe", 0)
                           for p in distinct_nodes(plan))
    return out


@contextlib.contextmanager
def recording_executions():
    """Every plan a session executes while the block runs, from any
    thread: ``[{"launches", "semaphore_wait_s", "wall_s", "host_s"}]``
    (a wrapper around ``execute_plan``; ``host_s`` sums the upload's
    ``packBatchTime``, ``scanPrefetchTime`` and ``copyToDeviceTime`` and
    the download's ``copyFromDeviceTime``, host nanoseconds). A
    cancelled or failed run is recorded too, with what it launched
    before it stopped; a run that failed in planning launched
    nothing."""
    import threading

    from spark_rapids_tpu_torch.metrics import plan_metrics
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    inner = TorchSparkSession.execute_plan
    runs: list = []
    lock = threading.Lock()

    def recorded(self, plan):
        before = self.thread_last_plan()
        t0 = time.perf_counter()
        try:
            return inner(self, plan)
        finally:
            wall = time.perf_counter() - t0
            done = self.thread_last_plan()
            if done is not None and done is not before:
                m = plan_metrics(done)
                import torch
                entry = {"launches": execution_launches(done),
                         "stream": (torch.cuda.current_stream().cuda_stream
                                    if torch.cuda.is_available() else 0),
                         "semaphore_wait_s":
                         m.get("semaphoreWaitTime", 0) / 1e9,
                         "wall_s": wall,
                         "host_s": sum(m.get(k, 0) for k in (
                             "packBatchTime", "scanPrefetchTime",
                             "copyToDeviceTime",
                             "copyFromDeviceTime")) / 1e9}
                with lock:
                    runs.append(entry)
    TorchSparkSession.execute_plan = recorded
    try:
        yield runs
    finally:
        TorchSparkSession.execute_plan = inner


def serve_state(srv, tenant: str) -> dict:
    """What a finished or cancelled query must leave behind: permits in
    use, open store handles (no cache is on), the tenant's live ledger
    bytes, queries in flight."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.resource import _SEMAPHORE
    store = memory._STORE
    return {"permits_in_use": _SEMAPHORE.in_use if _SEMAPHORE else 0,
            "store_handles": store.live_handles() if store else 0,
            "tenant_live_bytes": memory.store_tenant_stats().get(
                tenant, {}).get("liveBytes", 0),
            "in_flight": srv.stats()["admission"]["inFlight"]}


def settled(srv, tenant: str, timeout: float = 5.0) -> dict:
    """``serve_state`` once every count is 0 (the server's last
    ``finally`` may trail its response by a moment); raises if one
    stays up."""
    end = time.perf_counter() + timeout
    while True:
        st = serve_state(srv, tenant)
        if not any(st.values()):
            return st
        if time.perf_counter() > end:
            raise AssertionError(f"serve: {st} held after a query ended")
        time.sleep(0.005)


def serve_phases(card: str, arrays, q1_dir: str) -> dict:
    """Phase 20: TPC-H q1 at SF1 from phase 7's Parquet and TPC-DS q3's
    pushed form over bench's tables, served by ``QueryServer`` on the
    card to four tenants (4 concurrent queries, 2 a tenant,
    concurrentGpuTasks 2: the JAX package's defaults), every response
    decoded from Arrow IPC and held exactly against its binding's
    reference. Legs: ``serve_mixed`` (four tenants' clients at once, q1
    and q3 in turn over several bindings: per-tenant p50/p99, queries a
    second, plan-cache hits, semaphoreWaitTime, the idle share of one
    profiled served query against the same query's wall in a plain
    session), ``serve_concurrency`` (four q1 requests, one a tenant, at
    maxConcurrentQueries 1 and 4 in turns), ``serve_fusion`` (eight
    same-shape q1 requests while the server is saturated),
    ``serve_lifecycle`` (a deadline, an injected site:cancel stop, the
    cancel verb and a disconnect, each leaving no permit, handle or
    ledger byte), ``serve_result_cache`` (a hit launches nothing; a
    touched file re-executes) and ``serve_launches`` (each kernel's
    global count equals the sum of the executed plans' own counts).
    Returns the launches of each leg."""
    import socket
    import threading

    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import plan_cache as PC
    from spark_rapids_tpu_torch.retry import reset_fault_injection
    from spark_rapids_tpu_torch.serve import QueryServer, ServeClient
    from spark_rapids_tpu_torch.serve import protocol as SP
    from spark_rapids_tpu_torch.serve.client import ServeCancelled
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    tables = q3_tables()
    q3_dir, _w = write_q3_parquet(TorchSparkSession(), tables)
    # the dimensions again in 4 files each (phase 19's ORC partitioning),
    # so the pushed filters' build sides concatenate to joinProbe's size
    dims_dir, dims_write_s = write_q3_parquet(
        TorchSparkSession(), tables,
        {k: Q3_PARTITIONS[k] for k in ("item", "date_dim")},
        name="tpcds_q3_dims4")
    views = {"lineitem": q1_dir,
             "store_sales": os.path.join(q3_dir, "store_sales"),
             "item": os.path.join(dims_dir, "item"),
             "date_dim": os.path.join(dims_dir, "date_dim")}
    t0 = time.perf_counter()
    q1_want = q1_references(arrays, [q1_shipdate(d)
                                     for d in Q1_DELTAS + (105,)])
    want = {q1_text(d): ("q1", q1_want[q1_shipdate(d)])
            for d in Q1_DELTAS + (105,)}
    q3_want = q3_references(tables, Q3_BINDINGS)
    want.update({q3_text(m, y): ("q3", q3_want[(m, y)])
                 for m, y in Q3_BINDINGS})
    ref_s = time.perf_counter() - t0

    def check(sql: str, batch, what: str) -> None:
        kind, rows = want[sql]
        got = [tuple(r) for r in batch.rows()]
        if kind == "q1":
            check_q1_rows(got, rows)
        else:
            check_q3_rows(got, rows, what)

    def server(**conf):
        srv = QueryServer({k: str(v) for k, v in conf.items()}).start()
        for name, path in views.items():
            srv.register_view(name, path)
        return srv

    def mixed_sqls(tenant_i: int, n: int) -> list:
        out = []
        for j in range(n):
            k = tenant_i + j // 2
            out.append(q1_text(Q1_DELTAS[k % len(Q1_DELTAS)]) if j % 2 == 0
                       else q3_text(*Q3_BINDINGS[k % len(Q3_BINDINGS)]))
        return out

    def drive(srv, n: int) -> tuple:
        """Each tenant's client thread sends its ``n`` requests; returns
        (wall, per-tenant latencies, headers, errors)."""
        lat = {t: [] for t in SERVE_TENANTS}
        heads, errors = [], []
        lock = threading.Lock()
        go = threading.Event()

        def client(i: int, tenant: str) -> None:
            try:
                with ServeClient(srv.port, tenant=tenant,
                                 timeout=120) as c:
                    go.wait(30)
                    for sql in mixed_sqls(i, n):
                        t1 = time.perf_counter()
                        batch, head = c.sql(sql)
                        dt = time.perf_counter() - t1
                        check(sql, batch, f"serve {tenant}")
                        with lock:
                            lat[tenant].append(dt)
                            heads.append((sql, head))
            except BaseException as e:  # reported on the main thread
                with lock:
                    errors.append(f"{tenant}: {type(e).__name__}: {e}")
        threads = [threading.Thread(target=client, args=(i, t))
                   for i, t in enumerate(SERVE_TENANTS)]
        for t in threads:
            t.start()
        t1 = time.perf_counter()
        go.set()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t1
        if any(t.is_alive() for t in threads):
            errors.append("a client thread did not finish in 120 s")
        if errors:
            raise AssertionError(f"serve: {errors}")
        return wall, lat, heads

    def since(snap: dict) -> dict:
        now = KR.launch_counts()
        return {k: now[k] - snap[k] for k in now}

    from spark_rapids_tpu_torch.exec import fused as FU
    legs = {}
    launches_before = KR.launch_counts()
    graphs_before = dict(FU.GRAPH_COUNTS)
    allocated = {}
    with recording_executions() as runs:
        # -- mixed: four tenants, q1 and q3 in turn ------------------------
        srv = server()
        pc0 = PC.stats()
        alloc0 = torch.cuda.memory_allocated(device)
        snap = KR.launch_counts()
        n_runs = len(runs)
        cpu0 = time.process_time()
        wall, lat, heads = drive(srv, SERVE_REQUESTS)
        cpu_s = time.process_time() - cpu0
        mixed_launches = since(snap)
        pc1 = PC.stats()
        shapes = {sql for sql, _h in heads}
        # responses arrive in completion order, so a shape's first request
        # may answer after its repeats: at most one miss a shape. A fused
        # executor reports its thread's last lookup, which may be another
        # member's group: only unfused responses count
        miss_by_shape: dict = {}
        for sql, head in heads:
            if not head.get("planCacheHit") and "fusedWith" not in head:
                miss_by_shape[sql] = miss_by_shape.get(sql, 0) + 1
        misses_on_repeat = sum(n - 1 for n in miss_by_shape.values())
        # a shape's first request may be a hit too, when an earlier phase
        # or another tenant planned it; every repeat must hit
        if misses_on_repeat or pc1["misses"] - pc0["misses"] > len(shapes):
            raise AssertionError(
                f"serve_mixed: plan cache missed on {misses_on_repeat} "
                f"repeats; misses {pc1['misses'] - pc0['misses']} for "
                f"{len(shapes)} shapes")
        if not all(mixed_launches[k] for k in ("groupbyHash", "decodeFused",
                                               "joinProbe")):
            raise AssertionError(f"serve_mixed launched {mixed_launches}: "
                                 "want groupbyHash, decodeFused and "
                                 "joinProbe")
        stats = srv.stats()
        mixed_runs = runs[n_runs:]
        sem_wait_s = sum(r["semaphore_wait_s"] for r in mixed_runs)
        settled(srv, "t0")
        alloc1 = torch.cuda.memory_allocated(device)
        # one served q1 under the profiler, and the same query's wall in a
        # plain session in this call: the serving overhead
        q1 = q1_text(90)
        with ServeClient(srv.port, tenant="t0", timeout=120) as c:
            c.sql(q1)  # warm
            served = []
            for _ in range(2):
                t1 = time.perf_counter()
                batch, _h = c.sql(q1)
                served.append(time.perf_counter() - t1)
            check(q1, batch, "served q1")
            prof = profile_call(lambda: c.sql(q1), "serve_q1", card)
        plain = TorchSparkSession()
        plain.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
        pdf = plain.sql(q1)
        check_q1_rows([tuple(r) for r in pdf.collect()], want[q1][1])
        plain_walls = []
        for _ in range(2):
            t1 = time.perf_counter()
            pdf.collect()
            torch.cuda.synchronize()
            plain_walls.append(time.perf_counter() - t1)
        tenants = stats["admission"]["tenants"]
        phase("serve_mixed", card=card, tenants=len(SERVE_TENANTS),
              requests=len(heads), shapes=len(shapes), reference="exact",
              wall_s=wall, qps=len(heads) / wall,
              latency_ms={t: {"p50": tenants[t]["latencyMs"]["p50"],
                              "p99": tenants[t]["latencyMs"]["p99"]}
                          for t in SERVE_TENANTS},
              client_p50_ms={t: statistics.median(v) * 1e3
                             for t, v in lat.items()},
              plan_cache={"hits": pc1["hits"] - pc0["hits"],
                          "misses": pc1["misses"] - pc0["misses"],
                          "misses_on_repeat": misses_on_repeat},
              semaphore_wait_s=sem_wait_s, executions=len(mixed_runs),
              execution_wall_s=sum(r["wall_s"] for r in mixed_runs),
              execution_host_timers_s=sum(r["host_s"]
                                          for r in mixed_runs),
              process_cpu_s=cpu_s, process_cpu_per_wall=cpu_s / wall,
              fused=stats.get("batchFusion"), launches=mixed_launches,
              memory_allocated={"before": alloc0, "after": alloc1},
              served_q1_walls=served, served_q1_median_s=statistics.median(
                  served), plain_q1_walls=plain_walls,
              plain_q1_median_s=statistics.median(plain_walls),
              serving_overhead_s=statistics.median(served)
              - statistics.median(plain_walls),
              references_s=ref_s, dims_write_s=dims_write_s,
              **{f"served_q1_{k}": v for k, v in prof.items()})
        legs["serve_mixed"] = mixed_launches
        allocated["after_mixed"] = torch.cuda.memory_allocated(device)

        # -- fusion: eight same-shape q1 while the server is saturated ------
        # (one slot, held by another query, saturates it; the 8 join one
        # batch)
        srv.shutdown(30)
        # the batch closes when its eighth member joins (maxBatch), well
        # inside the window, so no timing decides who fuses
        srv = server(**{"spark.rapids.sql.serve.batchFusion.windowMs":
                        30000,
                        "spark.rapids.sql.serve.batchFusion.maxBatch": 8,
                        "spark.rapids.sql.serve.maxConcurrentQueries": 1})
        acquires = []
        plain_acquire = srv._admission.acquire

        def counted_acquire(tenant, token=None, signature=None):
            acquires.append(tenant)
            return plain_acquire(tenant, token=token, signature=signature)
        srv._admission.acquire = counted_acquire
        blockers, fused_heads, errors = [], [], []
        lock = threading.Lock()
        q1f = q1_text(120)

        def send(tenant, sql, sink):
            try:
                with ServeClient(srv.port, tenant=tenant, timeout=120) as c:
                    batch, head = c.sql(sql)
                    check(sql, batch, f"fusion {tenant}")
                    with lock:
                        sink.append(head)
            except BaseException as e:
                with lock:
                    errors.append(f"{tenant}: {type(e).__name__}: {e}")
        # the blocker is a q1 at another bound: its own batch closed when
        # it was admitted (the server was idle), and it holds the slot
        # longer than a q3 would
        bl = threading.Thread(target=send, args=(
            "t0", q1_text(60), blockers))
        snap = KR.launch_counts()
        bl.start()
        end = time.perf_counter() + 30
        while not srv._admission.saturated() and time.perf_counter() < end:
            time.sleep(0.001)
        saturated = srv._admission.saturated()
        fl = [threading.Thread(target=send, args=(
            SERVE_TENANTS[i % len(SERVE_TENANTS)], q1f, fused_heads))
            for i in range(8)]
        for t in fl:
            t.start()
        for t in [bl] + fl:
            t.join(120)
        if errors or len(fused_heads) != 8 or len(blockers) != 1:
            raise AssertionError(f"serve_fusion: {errors}")
        fstats = srv.stats()["batchFusion"]
        sizes = sorted(h.get("fusedWith", 1) for h in fused_heads)
        q1_acquires = len(acquires) - 1
        # each fused batch took one slot, each unfused request its own
        slots_expected = fstats["fusedBatches"] + (
            8 - fstats["fusedQueries"])
        if not saturated or fstats["fusedBatches"] < 1 \
                or q1_acquires != slots_expected:
            raise AssertionError(
                f"serve_fusion: saturated {saturated}, {fstats}, sizes "
                f"{sizes}, {q1_acquires} admission slots, want "
                f"{slots_expected}")
        fusion_launches = since(snap)
        phase("serve_fusion", card=card, saturated=saturated,
              max_concurrent_queries=1, window_ms=30000, max_batch=8,
              requests=8,
              reference="exact", fused_sizes=sizes, batch_fusion=fstats,
              admission_slots_q1=q1_acquires, launches=fusion_launches)
        legs["serve_fusion"] = fusion_launches
        allocated["after_fusion"] = torch.cuda.memory_allocated(device)
        srv._admission.acquire = plain_acquire
        srv.shutdown(30)
        srv = server()

        # -- lifecycle: deadline, injected stop, cancel verb, disconnect ---
        life = {}
        snap = KR.launch_counts()
        with ServeClient(srv.port, tenant="t1", timeout=120) as c:
            try:
                c.sql(q1_text(60), timeout_ms=150)
                raise AssertionError("serve: a 150 ms deadline did not "
                                     "stop a served q1")
            except ServeCancelled as e:
                life["deadline"] = {"reason": e.reason, "where": e.where}
            if c.broken or life["deadline"]["reason"] != "deadline":
                raise AssertionError(f"serve deadline: {life}")
            life["deadline"].update(settled(srv, "t1"))
            check(q1_text(60), c.sql(q1_text(60))[0], "after a deadline")

            # the cancel verb from another connection, mid-flight
            res = {}

            def victim():
                try:
                    c.sql(q1_text(90), query_id="victim")
                    res["status"] = "ok"
                except ServeCancelled as e:
                    res.update(reason=e.reason, where=e.where)
            vt = threading.Thread(target=victim)
            vt.start()
            end = time.perf_counter() + 30
            while time.perf_counter() < end and not any(
                    tok.query_id == "victim" and tok.admitted is not None
                    for tok in list(srv._inflight.values())):
                time.sleep(0.001)
            with ServeClient(srv.port, tenant="ops", timeout=60) as op:
                n_cancel = op.cancel(query_id="victim")
            vt.join(60)
            if n_cancel != 1 or res.get("reason") != "cancel" \
                    or c.broken:
                raise AssertionError(f"serve cancel: {n_cancel}, {res}")
            life["cancel"] = dict(res, cancelled=n_cancel,
                                  **settled(srv, "t1"))
            check(q1_text(90), c.sql(q1_text(90))[0], "after a cancel")

        # a client that disconnects mid-query
        before = srv.stats()["lifecycle"]["cancelledByReason"].get(
            "disconnect", 0)
        raw = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        SP.send_msg(raw, {"op": "sql", "sql": q1_text(120),
                          "tenant": "t2"})
        end = time.perf_counter() + 30
        while time.perf_counter() < end and not any(
                tok.tenant == "t2" and tok.admitted is not None
                for tok in list(srv._inflight.values())):
            time.sleep(0.001)
        raw.close()
        end = time.perf_counter() + 30
        while time.perf_counter() < end and srv.stats()["lifecycle"][
                "cancelledByReason"].get("disconnect", 0) == before:
            time.sleep(0.005)
        life["disconnect"] = {
            "cancelled": srv.stats()["lifecycle"]["cancelledByReason"].get(
                "disconnect", 0) - before, **settled(srv, "t2")}
        if life["disconnect"]["cancelled"] != 1:
            raise AssertionError(f"serve disconnect: {life}")
        life_launches = since(snap)
        life["shutdown_drained"] = srv.shutdown(30)
        if not life["shutdown_drained"]:
            raise AssertionError("serve: shutdown() did not drain")

        # an injected site:cancel stop, on a server of its own (the
        # schedule counts every checkpoint of the process)
        reset_fault_injection()
        srv = server(**{"spark.rapids.sql.test.injectOOM": "site:cancel:5"})
        with ServeClient(srv.port, tenant="t3", timeout=120) as c:
            try:
                c.sql(q1_text(90))
                raise AssertionError("serve: site:cancel:5 did not stop q1")
            except ServeCancelled as e:
                life["injected"] = {"reason": e.reason, "where": e.where,
                                    **settled(srv, "t3")}
            if c.broken or life["injected"]["reason"] != "injected":
                raise AssertionError(f"serve injected: {life}")
        if not srv.shutdown(30):
            raise AssertionError("serve: shutdown() did not drain")
        reset_fault_injection()
        phase("serve_lifecycle", card=card, statuses=life,
              launches=life_launches)
        legs["serve_lifecycle"] = life_launches
        allocated["after_lifecycle"] = torch.cuda.memory_allocated(device)

        # -- result cache: a hit launches nothing, a touched file re-runs --
        srv = server(**{"spark.rapids.sql.resultCache.enabled": "true"})
        rc = {}
        q1r = q1_text(105)
        with ServeClient(srv.port, tenant="t0", timeout=120) as c:
            snap = KR.launch_counts()
            b1, h1 = c.sql(q1r)
            rc["miss"] = since(snap)
            check(q1r, b1, "result cache miss")
            snap = KR.launch_counts()
            b2, h2 = c.sql(q1r)
            rc["hit"] = since(snap)
            if not h2.get("resultCacheHit") or any(rc["hit"].values()) \
                    or SP.batch_to_ipc(b1) != SP.batch_to_ipc(b2):
                raise AssertionError(f"serve result cache hit: {h2}, {rc}")
            f0 = sorted(f for f in os.listdir(q1_dir)
                        if f.endswith(".parquet"))[0]
            path = os.path.join(q1_dir, f0)
            st = os.stat(path)
            os.utime(path, ns=(st.st_atime_ns,
                               st.st_mtime_ns + 1_000_000_000))
            snap = KR.launch_counts()
            b3, h3 = c.sql(q1r)
            rc["after_touch"] = since(snap)
            check(q1r, b3, "result cache after a touch")
            if h3.get("resultCacheHit") or rc["after_touch"] != rc["miss"]:
                raise AssertionError(f"serve result cache touch: {h3}, {rc}")
        rstats = srv.stats()["cache"]["result"]
        if not srv.shutdown(30):
            raise AssertionError("serve: shutdown() did not drain")
        phase("serve_result_cache", card=card, reference="exact",
              launches=rc, result_cache=rstats,
              hit_exec_ms=h2["execMs"], miss_exec_ms=h1["execMs"])
        legs["serve_result_cache"] = rc["miss"]
        allocated["after_result_cache"] = torch.cuda.memory_allocated(device)

        # -- maxConcurrentQueries 1 against 4, in turns --------------------
        # (the process CPU seconds of all threads over the wall: near 1
        # where the interpreter's lock serialises the host work)
        turns = {1: [], 4: []}
        detail = {1: [], 4: []}
        for mcq in (1, 4, 4, 1):
            srv = server(**{"spark.rapids.sql.serve.maxConcurrentQueries":
                            mcq})
            n_runs = len(runs)
            cpu0 = time.process_time()
            w, _lat, _h = drive(srv, 1)
            cpu_s = time.process_time() - cpu0
            turn = runs[n_runs:]
            turns[mcq].append(w)
            detail[mcq].append({
                "process_cpu_per_wall": cpu_s / w,
                "mean_execution_wall_s": statistics.mean(
                    r["wall_s"] for r in turn),
                "semaphore_wait_s": sum(r["semaphore_wait_s"]
                                        for r in turn),
                "host_timers_s": sum(r["host_s"] for r in turn)})
            if not srv.shutdown(30):
                raise AssertionError("serve: shutdown() did not drain")
        phase("serve_concurrency", card=card, requests=len(
            SERVE_TENANTS), reference="exact", walls_s={
                f"max_concurrent_{k}": v for k, v in turns.items()},
              turns={f"max_concurrent_{k}": v for k, v in detail.items()},
              locks=["kernels._COUNT_LOCK", "fused._GRAPH_COUNT_LOCK"])

    # -- launch totals: the global counters against the executions --------
    total = since(launches_before)
    summed = {k: sum(r["launches"][k] for r in runs) for k in total}
    if total != summed:
        raise AssertionError(f"serve launches: counted {total}, the "
                             f"executions' own counts sum to {summed}")
    allocated["after_concurrency"] = torch.cuda.memory_allocated(device)
    # every connection thread's device work: its stream (the default
    # stream unless one is set), the stage graphs captured and replayed
    # while queries ran at once, the allocator's bytes after each leg
    phase("serve_launches", card=card, executions=len(runs),
          launches=total, per_execution_sum=summed,
          execution_streams=sorted({r["stream"] for r in runs}),
          graphs={k: FU.GRAPH_COUNTS[k] - graphs_before[k]
                  for k in ("captures", "replays")},
          memory_allocated=allocated,
          seconds=time.perf_counter() - t_phase)
    legs["serve_phase"] = total
    return legs


OBSERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "observe")


def span_launches(loaded) -> dict:
    """Per kernel, the launches a loaded trace records: its
    ``kernelDispatch`` spans (direct launches) plus the kernels each
    stage-program replay span carries (``kernels``)."""
    out: dict = {}
    for s in loaded["spans"]:
        args = s.get("args") or {}
        names = ([args["kernel"]] if s["name"] == "kernelDispatch"
                 else list(args.get("kernels") or []))
        for k in names:
            out[k] = out.get(k, 0) + 1
    return out


def uncatalogued_kinds(loaded) -> list:
    """Span and instant kinds of a loaded trace that neither catalog
    names nor ``describe_metric`` resolves as an ``<exec>.<metric>``
    mirror."""
    from spark_rapids_tpu_torch import trace as TR
    from spark_rapids_tpu_torch.metrics import describe_metric
    bad = set()
    for s in loaded["spans"]:
        name = s["name"]
        owner, _, metric = name.partition(".")
        if name not in TR.SPAN_CATALOG and not (
                metric and describe_metric(metric) is not None):
            bad.add(name)
    bad |= {i["name"] for i in loaded["instants"]
            if i["name"] not in TR.INSTANT_CATALOG}
    return sorted(bad)


def prom_kernel_counts(text: str) -> dict:
    """``srt_kernel_dispatch_count_total{key="<kernel>"}`` of a
    Prometheus exposition, by kernel."""
    out = {}
    for line in text.splitlines():
        if line.startswith("srt_kernel_dispatch_count_total{"):
            key = line.split('key="', 1)[1].split('"', 1)[0]
            out[key] = int(float(line.rsplit(" ", 1)[1]))
    return out


def flight_breakdown(qt, since_ns: int) -> dict:
    """Where the time of the spans a flight recorder took since
    ``since_ns`` went: per span kind its count, its total seconds and
    its exclusive seconds (nested spans on the same thread taken off,
    ``doctor.exclusive_times``), and the recording threads by name."""
    from spark_rapids_tpu_torch.telemetry.doctor import exclusive_times
    spans = [{"name": k, "t0": t0 / 1e3, "t1": t1 / 1e3, "tid": ident}
             for k, t0, t1, ident, *_rest in qt.spans if t0 >= since_ns]
    ex = sorted(exclusive_times(spans).items(),
                key=lambda kv: -kv[1]["exclusive"])
    threads: dict = {}
    for sp in spans:
        name = qt._thread_names.get(sp["tid"], str(sp["tid"]))
        threads.setdefault(name, set()).add(sp["tid"])
    return {"threads": {n: len(v) for n, v in sorted(threads.items())},
            "kinds": {k: {"count": d["count"],
                          "total_s": round(d["total"] / 1e6, 4),
                          "exclusive_s": round(d["exclusive"] / 1e6, 4)}
                      for k, d in ex}}


def observe_phases(card: str, arrays, q1_dir: str) -> tuple:
    """Phase 21: the observability slice on the card. ``observe_traced``:
    TPC-H q1 at SF1 from phase 7's Parquet and TPC-DS q3's pushed form
    (phase 20's files) with a file trace, a profile, the event log, the
    query history and ``metrics.level=DEBUG``; rows exact, the trace
    loads and every kind in it is catalogued, and per kernel the
    ``LAUNCHES`` delta equals the plan's ``kernelDispatchCount.*``, the
    trace's kernelDispatch spans plus its replays' recorded kernels and
    the profile's kernel summary; one event-log line and one history
    record a query. ``observe_overhead``: q1 with tracing off, on in file
    mode and in ring mode, in turns, two timed runs each.
    ``observe_server``: a ``QueryServer`` (the ring recorder on, a 1 ms
    slow-query trigger) serves q1: its bundle and ring dump load and
    the dump's launches equal the delta, the ``metrics`` verb's and a
    loopback scrape's kernel-dispatch counters move by the launches;
    four tenants' q1 at once, read back from the flight recorder (where
    their time went, by span kind and thread); then a second server over the same history, after the lifecycle
    layer is reset (a restart of it), warm-starts its walls and answers
    its first q1 from the plan cache. ``observe_levels``: q1's metric
    names under ``metrics.level`` ESSENTIAL and DEBUG. groupbyHash,
    joinProbe and decodeFused are held against their plain versions at
    the shapes of the traced runs. Returns ``(launches a leg, kernel
    cases)``."""
    import shutil
    import urllib.request

    import torch
    from spark_rapids_tpu_torch import event_log as EL
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import lifecycle as LC
    from spark_rapids_tpu_torch import metrics as M
    from spark_rapids_tpu_torch import profile as PROF
    from spark_rapids_tpu_torch import trace as TR
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.exec.join import TorchBroadcastHashJoinExec
    from spark_rapids_tpu_torch.kernels import decode_fused as DF
    from spark_rapids_tpu_torch.serve import QueryServer, ServeClient
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    from spark_rapids_tpu_torch.telemetry import history as H
    from spark_rapids_tpu_torch.telemetry import triggers as TRG

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    tables = q3_tables()
    q3_dir, _w = write_q3_parquet(TorchSparkSession(), tables)
    dims_dir, _w = write_q3_parquet(
        TorchSparkSession(), tables,
        {k: Q3_PARTITIONS[k] for k in ("item", "date_dim")},
        name="tpcds_q3_dims4")
    q1_views = {"lineitem": q1_dir}
    q3_views = {"store_sales": os.path.join(q3_dir, "store_sales"),
                "item": os.path.join(dims_dir, "item"),
                "date_dim": os.path.join(dims_dir, "date_dim")}
    q1_want = q1_reference(arrays)
    q3_want = q3_reference(tables)

    def nonzero(d: dict) -> dict:
        return {k: v for k, v in d.items() if v}

    def since(snap: dict) -> dict:
        now = KR.launch_counts()
        return nonzero({k: now[k] - snap[k] for k in now})

    def session(views: dict, conf: dict):
        s = TorchSparkSession(dict(
            {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}, **conf))
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        return s

    def timed_collect(df):
        t0 = time.perf_counter()
        rows = [tuple(r) for r in df.collect()]
        return rows, time.perf_counter() - t0

    legs, shapes = {}, {"groupbyHash": {}, "joinProbe": {},
                        "decodeFused": {}}

    # -- a. q1 and q3 traced, profiled, logged, kept in the history -------
    traced = {}
    for q, views, sql in (("q1", q1_views, Q1), ("q3", q3_views,
                                                 Q3_PUSHED)):
        d = os.path.join(OBSERVE_DIR, q)
        TR.reset_tracing()
        s = session(views, {
            "spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.dir": os.path.join(d, "trace"),
            "spark.rapids.sql.profile.enabled": "true",
            "spark.rapids.sql.profile.dir": os.path.join(d, "profile"),
            "spark.rapids.sql.eventLog.dir": os.path.join(d, "events"),
            "spark.rapids.sql.telemetry.history.dir":
                os.path.join(d, "history"),
            "spark.rapids.sql.metrics.level": "DEBUG"})
        df = s.sql(sql)
        snap = KR.launch_counts()
        rows, wall = timed_collect(df)
        launches = since(snap)
        if q == "q1":
            check_q1_rows(rows, q1_want)
        else:
            check_q3_rows(rows, q3_want, "observe q3")
        plan = s.last_plan
        plan_counts = nonzero({k.split(".", 1)[1]: v for k, v in
                               M.plan_metrics(plan).items()
                               if k.startswith("kernelDispatchCount.")})
        files = sorted(os.listdir(os.path.join(d, "trace")))
        if len(files) != 1:
            raise AssertionError(f"observe {q}: trace files {files}")
        loaded = TR.load_trace(os.path.join(d, "trace", files[0]))
        spans = span_launches(loaded)
        bad = uncatalogued_kinds(loaded)
        profs = list(PROF.read_profiles(os.path.join(d, "profile")))
        events = list(EL.read_events(os.path.join(d, "events")))
        records = H.read_records(os.path.join(d, "history"))
        if len(profs) != 1 or len(events) != 1 or len(records) != 1 \
                or events[0]["status"] != "finished" \
                or records[0]["status"] != "finished":
            raise AssertionError(
                f"observe {q}: {len(profs)} profiles, {len(events)} "
                f"event lines, {len(records)} history records")
        prof_counts = profs[0]["kernels"]["dispatches"]
        if bad or not launches or not (
                launches == plan_counts == spans == prof_counts):
            raise AssertionError(
                f"observe {q}: launches {launches}, plan {plan_counts}, "
                f"trace {spans}, profile {prof_counts}, uncatalogued "
                f"{bad}")
        kinds = sorted({sp["name"] for sp in loaded["spans"]})
        traced[q] = {"rows": len(rows), "wall_s": wall,
                     "launches": launches, "plan_counts": plan_counts,
                     "trace_counts": spans, "profile_counts": prof_counts,
                     "replay_spans": sum(1 for sp in loaded["spans"]
                                         if (sp.get("args") or {}).get(
                                             "kernels")),
                     "spans": len(loaded["spans"]),
                     "instants": len(loaded["instants"]),
                     "counters": len(loaded["counters"]),
                     "span_kinds": kinds,
                     "trace_bytes": os.path.getsize(
                         os.path.join(d, "trace", files[0])),
                     "history_fields": sorted(records[0])}
        legs[f"observe_traced_{q}"] = launches
        # the kernels at this run's shapes, against their plain versions
        if q == "q1":
            from spark_rapids_tpu_torch.memory import release_plan_handles
            plan2 = s.plan_physical(s.sql(sql).plan)
            try:
                shapes["groupbyHash"].update(partial_groupby_cases(
                    s, plan2, "observe_q1", plain_reps=1))
            finally:
                release_plan_handles(plan2)
            path = os.path.join(q1_dir, sorted(
                f for f in os.listdir(q1_dir) if f.endswith(".parquet"))[0])
            layout, cap, n, w, ex, in_bytes = staged_on_card(path, device)
            k_active, k_outs = DF.decode_fused(layout, cap, n, w, ex)
            p_active, p_outs = X._encoded_decode_body(layout, cap, w, n, ex)
            torch.cuda.synchronize()
            errs = [max_abs_diff(a, b) for a, b in zip(
                (k_active,) + tuple(k_outs), (p_active,) + tuple(p_outs))]
            if len(k_outs) != len(p_outs) or any(errs):
                raise AssertionError(f"decodeFused != plain: {errs}")
            shapes["decodeFused"]["observe_q1_row_group"] = {
                "rows": n, "cap": cap, "max_abs_err": max(errs)}
        else:
            plan2 = s.plan_physical(s.sql(sql).plan)
            try:
                for j in plan_nodes_of(plan2):
                    if isinstance(j, TorchBroadcastHashJoinExec):
                        what = f"observe_q3_join{len(shapes['joinProbe'])}"
                        shapes["joinProbe"][what] = join_probe_case(j, what)
            finally:
                from spark_rapids_tpu_torch.memory import \
                    release_plan_handles
                release_plan_handles(plan2)
    TR.reset_tracing()
    phase("observe_traced", card=card, reference="exact", queries=traced,
          tolerance="exact", kernel_cases={
              k: {n: {f: c[f] for f in ("rows", "max_abs_err")}
                  for n, c in v.items()} for k, v in shapes.items()})

    # -- b. tracing off, file and ring in turns ----------------------------
    modes = {"off": {},
             "file": {"spark.rapids.sql.trace.enabled": "true",
                      "spark.rapids.sql.trace.dir":
                          os.path.join(OBSERVE_DIR, "overhead")},
             "ring": {"spark.rapids.sql.trace.enabled": "true",
                      "spark.rapids.sql.trace.mode": "ring"}}
    dfs = {m: session(q1_views, c).sql(Q1) for m, c in modes.items()}
    walls = {m: [] for m in modes}
    snap = KR.launch_counts()
    for m in ("off", "file", "ring"):  # a warm run each
        TR.reset_tracing()
        check_q1_rows(timed_collect(dfs[m])[0], q1_want)
    for m in ("off", "file", "ring", "ring", "file", "off"):
        TR.reset_tracing()
        rows, wall = timed_collect(dfs[m])
        check_q1_rows(rows, q1_want)
        walls[m].append(wall)
    TR.reset_tracing()
    legs["observe_overhead"] = since(snap)
    med = {m: statistics.median(v) for m, v in walls.items()}
    phase("observe_overhead", card=card, reference="exact", walls_s=walls,
          median_s=med, file_over_off=med["file"] / med["off"] - 1,
          ring_over_off=med["ring"] / med["off"] - 1,
          launches=legs["observe_overhead"])

    # -- c. a server: the flight recorder, a bundle, the exporter, a warm
    #       start -----------------------------------------------------------
    hist = os.path.join(OBSERVE_DIR, "server_history")
    tel = os.path.join(OBSERVE_DIR, "telemetry")
    conf = {"spark.rapids.sql.telemetry.slowQueryMs": "1",
            "spark.rapids.sql.telemetry.dir": tel,
            "spark.rapids.sql.telemetry.history.dir": hist}

    def server():
        srv = QueryServer(dict(conf))
        srv.register_view("lineitem", q1_dir)
        return srv.start()

    TR.reset_tracing()
    TRG.engine().reset()
    srv = server()
    hport = srv.start_metrics_http(0)
    before = prom_kernel_counts(srv.metrics_text())
    snap = KR.launch_counts()
    with ServeClient(srv.port, tenant="t0", timeout=120) as c:
        batch, head = c.sql(Q1)
        check_q1_rows([tuple(r) for r in batch.rows()], q1_want)
        launches = since(snap)
        if not TRG.engine().drain(60):
            raise AssertionError("observe: the bundle was not written")
        text = c.metrics()
    with urllib.request.urlopen(f"http://127.0.0.1:{hport}/metrics",
                                timeout=60) as r:
        scraped = r.read().decode()
    verb = {k: v - before.get(k, 0)
            for k, v in prom_kernel_counts(text).items()}
    scrape = {k: v - before.get(k, 0)
              for k, v in prom_kernel_counts(scraped).items()}
    bundles = sorted(f for f in os.listdir(tel) if f.startswith("bundle-"))
    if len(bundles) != 1 or not bundles[0].endswith("-slowQuery.json"):
        raise AssertionError(f"observe: bundles {bundles}")
    with open(os.path.join(tel, bundles[0])) as f:
        bundle = json.load(f)
    ring = TR.load_trace(bundle["ringDump"])
    ring_counts = span_launches(ring)
    bad = uncatalogued_kinds(ring)
    if bad or not (launches == ring_counts == nonzero(verb)
                   == nonzero(scrape)):
        raise AssertionError(
            f"observe server: launches {launches}, ring {ring_counts}, "
            f"metrics verb {verb}, scrape {scrape}, uncatalogued {bad}")
    families = sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE ")})
    # the watchdog keeps a p99 from 5 walls of a shape
    with ServeClient(srv.port, tenant="t0", timeout=120) as c:
        for _ in range(4):
            check_q1_rows([tuple(r) for r in c.sql(Q1)[0].rows()], q1_want)
    # four tenants' q1 at once (2 permits, the JAX package's defaults),
    # read back from the flight recorder
    import threading
    errors = []

    def tenant(i: int) -> None:
        try:
            with ServeClient(srv.port, tenant=f"c{i}", timeout=120) as c:
                check_q1_rows([tuple(r) for r in c.sql(Q1)[0].rows()],
                              q1_want)
        except BaseException as e:  # reported on this thread
            errors.append(f"c{i}: {type(e).__name__}: {e}")
    ring_qt = TR.ring_active()
    mark = time.perf_counter_ns()
    threads = [threading.Thread(target=tenant, args=(i,))
               for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    four_wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or ring_qt is None:
        raise AssertionError(f"observe four tenants: {errors}")
    flight = flight_breakdown(ring_qt.snapshot(), mark)
    if not srv.shutdown(30):
        raise AssertionError("observe: shutdown() did not drain")
    sig = H.read_records(hist)[-1]["signature"]
    # the lifecycle layer's restart: its walls and streaks are gone
    LC.reset_lifecycle()
    H.reset_history()
    TR.reset_tracing()
    srv2 = server()
    warm = dict(srv2.warm_start_summary)
    p99 = LC.signature_p99(sig)
    with ServeClient(srv2.port, tenant="t1", timeout=120) as c:
        batch, head2 = c.sql(Q1)
        check_q1_rows([tuple(r) for r in batch.rows()], q1_want)
    if not srv2.shutdown(30):
        raise AssertionError("observe: shutdown() did not drain")
    TR.reset_tracing()
    TRG.engine().reset()
    if warm.get("walls", 0) < 5 or p99 is None \
            or head2.get("planCacheHit") is not True:
        raise AssertionError(f"observe warm start: {warm}, p99 {p99}, "
                             f"{head2}")
    legs["observe_server"] = launches
    phase("observe_server", card=card, reference="exact",
          launches=launches, ring_counts=ring_counts,
          metrics_verb_counts=verb, scrape_counts=scrape,
          bundle=bundles[0], bundle_trigger=bundle["trigger"],
          ring_spans=len(ring["spans"]), ring_instants=len(ring["instants"]),
          families=len(families), exec_ms=head["execMs"],
          four_tenants={"wall_s": four_wall, **flight},
          warm_start=warm, warm_signature_p99_s=p99,
          warm_first_query={k: head2.get(k) for k in (
              "planCacheHit", "execMs", "queueWaitMs")})

    # -- d. metric names at ESSENTIAL and at DEBUG -------------------------
    names = {}
    snap = KR.launch_counts()
    for level in ("ESSENTIAL", "DEBUG"):
        s = session(q1_views, {"spark.rapids.sql.metrics.level": level})
        check_q1_rows(timed_collect(s.sql(Q1))[0], q1_want)
        names[level] = sorted(M.plan_metrics(s.last_plan))
    legs["observe_levels"] = since(snap)
    ess, dbg = set(names["ESSENTIAL"]), set(names["DEBUG"])
    if not ess or not ess < dbg or any(
            M.default_level(n) != M.ESSENTIAL for n in ess):
        raise AssertionError(f"observe levels: {names}")
    phase("observe_levels", card=card, reference="exact",
          essential=names["ESSENTIAL"], debug=names["DEBUG"],
          launches=legs["observe_levels"],
          seconds=time.perf_counter() - t_phase)
    return legs, shapes


def observe_only(card: str) -> None:
    """``--observe``: the kernels' build and phase 21."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs, _shapes = observe_phases(card, arrays, q1_dir)
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "tools")


def knob_cases(spark, q1_dir: str, device, log: dict) -> dict:
    """Each autotune candidate of groupbyHash and decodeFused at q1's own
    shapes (the first batch q1's partial aggregate updates with, at the
    slots the candidate's slotsMult gives; the first row group of phase
    7's files), each held exactly against the plain version and timed on
    the card (``cuda_ms``); ``log`` is ``AT.sweep_log()`` keyed by
    kernel, for the winners."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.columnar import transfer as X
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.kernels import autotune as AT
    from spark_rapids_tpu_torch.kernels import decode_fused as DF
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.memory import release_plan_handles
    out = {"groupbyHash": {}, "decodeFused": {}}
    plan = spark.plan_physical(spark.sql(Q1).plan)
    try:
        agg = find_exec(plan, lambda n: isinstance(n, TorchHashAggregateExec)
                        and n.mode == "partial" and bool(n.grouping))
        b = first_batch(agg.child.device_partitions(), "tools q1")
        key_cols, vals, prims, active = agg.update_inputs(b)
        kw, h, add, mn, mx, _d = KG.table_inputs(
            key_cols, [(v, p, dt) for v, (p, dt) in zip(vals, prims)],
            active)
        ins = (kw, h, active, add, mn, mx)
        for params in AT._GRIDS["groupbyHash"]:
            slots = KR.table_slots(spark.conf_obj, b.capacity,
                                   int(params.get("slotsMult", 1)))

            def launch(params=params, slots=slots):
                return KG.groupby_table(
                    *ins, slots, block_rows=int(params.get("blockRows", 0)),
                    lane_groups=int(params.get("laneGroups", 1)))
            got = launch()
            want = KG.groupby_table_plain(*ins, slots)
            torch.cuda.synchronize()
            if int(got[4].item()) or int(want[4].item()):
                raise AssertionError(f"tools groupbyHash {params} overflowed")
            err = compare_tables(table_rows(*got[:4]), table_rows(*want[:4]))
            if err:
                raise AssertionError(f"groupbyHash {params} != plain: {err}")
            out["groupbyHash"][json.dumps(params, sort_keys=True)] = {
                "rows": b.capacity, "slots": slots, "max_abs_err": err,
                "ms": cuda_ms(launch, 20)}
    finally:
        release_plan_handles(plan)
    path = os.path.join(q1_dir, sorted(
        f for f in os.listdir(q1_dir) if f.endswith(".parquet"))[0])
    layout, cap, n, w, ex, _in_bytes = staged_on_card(path, device)
    p_active, p_outs = X._encoded_decode_body(layout, cap, w, n, ex)
    plain = (p_active,) + tuple(p_outs)
    for params in AT._GRIDS["decodeFused"]:
        rpt = int(params.get("rowsPerThread", 0))

        def launch(rpt=rpt):
            return DF.decode_fused(layout, cap, n, w, ex, rows_per_thread=rpt)
        k_active, k_outs = launch()
        torch.cuda.synchronize()
        errs = [max_abs_diff(a, c) for a, c in
                zip((k_active,) + tuple(k_outs), plain)]
        if len(k_outs) != len(p_outs) or any(errs):
            raise AssertionError(f"decodeFused {params} != plain: {errs}")
        out["decodeFused"][json.dumps(params, sort_keys=True)] = {
            "rows": n, "cap": cap, "max_abs_err": max(errs),
            "ms": cuda_ms(launch, 20)}
    for k, cases in out.items():
        for sweep in log.get(k, []):
            win = json.dumps(sweep["winner"], sort_keys=True)
            if win in cases:
                cases[win]["won_bucket"] = sweep["bucket"]
    return out


def skew_overflow_leg(card: str, device) -> dict:
    """Phase 14's skew leg (``Q_SKEW``, inner join, 4 device partitions)
    three ways: on defaults, with the autotuner sweeping a fresh table,
    and on a table that pins ``slotsMult`` 2 at each bucket the sweep
    saw; rows exact each time, and the partial aggregates'
    ``overflow_reruns`` (batches re-run sorted after the table
    overflowed) of each run."""
    import torch
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.kernels import autotune as AT
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    stables, _hot = skew_tables()
    want = skew_reference(stables)
    kinds = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    batches = {name: host_batch_from_numpy(
        [(c, kinds[k]) for c, k, _a in stables[name]],
        [a for _c, _k, a in stables[name]]) for name in ("store_sales",
                                                         "item")}
    sweep_dir = os.path.join(TOOLS_DIR, "skew_sweep")
    pin_dir = os.path.join(TOOLS_DIR, "skew_pinned")

    def run(extra: dict) -> dict:
        s = TorchSparkSession(dict({
            "spark.sql.shuffle.partitions": str(N_PARTITIONS),
            "spark.rapids.sql.autoBroadcastJoinThreshold": "-1",
            "spark.rapids.sql.shuffle.devicePartitions": "4"}, **extra))
        for name, b in batches.items():
            s.createDataFrame(b, num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
        t0 = time.perf_counter()
        rows = [tuple(r) for r in s.sql(Q_SKEW.format(jt="")).collect()]
        wall = time.perf_counter() - t0
        if rows != want:
            raise AssertionError(f"tools skew: {rows[:4]} != {want[:4]}")
        reruns = [getattr(n, "overflow_reruns", 0)
                  for p in plan_nodes_of(s.last_plan)
                  for n in [p] + list(getattr(p, "fused_ops", []))
                  if hasattr(n, "overflow_reruns")]
        s.stop()
        return {"wall_s": wall, "groupby_overflow_reruns": reruns}

    AT.reset_for_tests()
    out = {"defaults": run({})}
    out["swept"] = run({"spark.rapids.sql.kernel.autotune.enabled": "true",
                        "spark.rapids.sql.kernel.autotune.dir": sweep_dir})
    swept = [sw for sw in AT.sweep_log() if sw["kernel"] == "groupbyHash"]
    out["swept"]["winners"] = {sw["bucket"]: sw["winner"] for sw in swept}
    os.makedirs(pin_dir, exist_ok=True)
    with open(os.path.join(pin_dir, "kernel-autotune.jsonl"), "w") as f:
        for sw in swept:
            f.write(json.dumps({
                "kernel": "groupbyHash", "bucket": sw["bucket"],
                "device": torch.cuda.get_device_name(device),
                "params": {"slotsMult": 2}, "applied": True,
                "defaultMs": None, "bestMs": None, "ts": time.time()})
                + "\n")
    AT.reset_for_tests()
    out["pinned_slotsMult_2"] = run({
        "spark.rapids.sql.kernel.autotune.dir": pin_dir})
    out["pinned_slotsMult_2"]["buckets"] = [sw["bucket"] for sw in swept]
    AT.reset_for_tests()
    phase("tools_skew_slots", card=card, reference="exact", **out)
    return out


def tools_phases(card: str, arrays, q1_dir: str, want_launches=None
                 ) -> tuple:
    """Phase 22: the tooling slice on the card. ``tools_autotune``: the
    autotuner on over a fresh ``kernel.autotune.dir`` runs TPC-H q1 at SF1
    from phase 7's Parquet (rows exact): groupbyHash and decodeFused
    sweep at q1's buckets, every candidate validated against its oracle
    before it is timed; then ``AT.reset_for_tests()`` (a restart) and a
    new session on the same directory: zero sweeps, table hits, rows
    exact, and the launches equal phase 21's q1 (or, alone, this phase's
    untuned q1). A broken candidate (one the kernel refuses, one whose
    output is corrupted) is rejected and never recorded. ``tools_walls``:
    q1 on the tuned table and on defaults in turns, a warm run each and
    the mean of two. ``tools_knobs``: every candidate at q1's shapes,
    exact against the plain versions, timed. ``tools_skew_slots``:
    ``skew_overflow_leg``. ``tools_cli``: ``python -m
    spark_rapids_tpu_torch.tools qualify`` in a subprocess over phase 7's
    files (exit 0, placement equal to the plan's), then in process
    ``profile`` live, ``trace`` and ``hotspots`` over a traced q1,
    ``docs --out`` identical to docs/torch/ and ``lint`` (exit 0).
    Returns ``(launches a leg, {kernel: tuned knobs a bucket},
    kernel cases)``."""
    import contextlib as _ctx
    import io
    import shutil

    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import tools as TL
    from spark_rapids_tpu_torch import trace as TR
    from spark_rapids_tpu_torch.kernels import autotune as AT
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    tune = os.path.join(TOOLS_DIR, "autotune")
    q1_want = q1_reference(arrays)
    legs = {}

    def since(snap: dict) -> dict:
        now = KR.launch_counts()
        return {k: now[k] - snap[k] for k in now if now[k] - snap[k]}

    def session(conf: dict):
        s = TorchSparkSession(dict(
            {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}, **conf))
        s.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
        return s

    def timed_q1(s):
        t0 = time.perf_counter()
        rows = [tuple(r) for r in s.sql(Q1).collect()]
        wall = time.perf_counter() - t0
        check_q1_rows(rows, q1_want)
        return wall

    tuned_conf = {"spark.rapids.sql.kernel.autotune.enabled": "true",
                  "spark.rapids.sql.kernel.autotune.dir": tune}

    # -- a. the cold sweep ------------------------------------------------
    AT.reset_for_tests()
    snap = KR.launch_counts()
    cold_wall = timed_q1(session(tuned_conf))
    cold = since(snap)
    st = AT.stats()
    log = AT.sweep_log()
    sweep_launches = {}
    for sw in log:
        # each candidate: its oracle check, a warm launch, the timed ones
        n = sum(1 + (1 + AT.TIMED_LAUNCHES if c["ok"] else 0)
                for c in sw["candidates"])
        sweep_launches[sw["kernel"]] = sweep_launches.get(sw["kernel"],
                                                          0) + n
        if not all(c["ok"] for c in sw["candidates"]):
            raise AssertionError(f"tools: a grid candidate failed: {sw}")
    kernels_swept = sorted({sw["kernel"] for sw in log})
    if kernels_swept != ["decodeFused", "groupbyHash"] \
            or st["sweeps"] != len(log) or st["rejected"]:
        raise AssertionError(f"tools cold sweep: {st}, {kernels_swept}")
    with open(os.path.join(tune, "kernel-autotune.jsonl")) as f:
        table = [json.loads(line) for line in f if line.strip()]
    if len(table) != len(log) or any(
            sorted(e) != ["applied", "bestMs", "bucket", "defaultMs",
                          "device", "kernel", "params", "ts"]
            or e["device"] != torch.cuda.get_device_name(0) for e in table):
        raise AssertionError(f"tools table: {table}")
    # q1's own launches: the cold run's minus the sweeps'
    cold_query = {k: v - sweep_launches.get(k, 0) for k, v in cold.items()}
    tuned = {e["kernel"]: {} for e in table}
    for e in table:
        tuned[e["kernel"]][e["bucket"]] = e["params"] if e["applied"] else {}

    # -- b. a restart on the same table ------------------------------------
    AT.reset_for_tests()
    s_tuned = session(tuned_conf)
    snap = KR.launch_counts()
    timed_q1(s_tuned)
    warm = since(snap)
    st2 = AT.stats()
    if st2["sweeps"] or not st2["hits"] or st2["loaded"] != len(table):
        raise AssertionError(f"tools restart: {st2}")
    if warm != cold_query:
        raise AssertionError(f"tools restart launches {warm} != the cold "
                             f"run's query launches {cold_query}")
    s_plain = session({})
    snap = KR.launch_counts()
    timed_q1(s_plain)
    plain_launches = since(snap)
    want = want_launches or plain_launches
    if warm != want or plain_launches != want:
        raise AssertionError(f"tools launches: tuned {warm}, defaults "
                             f"{plain_launches}, phase 21 {want_launches}")
    legs["tools_cold"], legs["tools_restart"] = cold, warm
    phase("tools_autotune", card=card, reference="exact",
          cold_wall_s=cold_wall, sweeps=log, table=table,
          stats_cold=st, stats_restart=st2, launches_cold=cold,
          launches_sweeps=sweep_launches, launches_restart=warm,
          launches_phase21=want_launches,
          seconds=time.perf_counter() - t_phase)

    # -- c. broken candidates: rejected, never recorded --------------------
    broken_dir = os.path.join(TOOLS_DIR, "broken")
    grid = list(AT._GRIDS["groupbyHash"])
    real_launch = AT._GroupbyProbe.launch

    def corrupted(self, params):
        out = real_launch(self, {k: v for k, v in params.items()
                                 if k != "corrupt"})
        if params.get("corrupt"):  # one lane of one group off by one
            add_out = out[1].clone()
            add_out[int(torch.nonzero(out[0] >= 0)[0, 0]), 0] += 1
            out = (out[0], add_out) + tuple(out[2:])
        return out
    AT.reset_for_tests()
    AT._GRIDS["groupbyHash"] = grid + [{"laneGroups": 3},
                                       {"corrupt": 1}]
    AT._GroupbyProbe.launch = corrupted
    try:
        from spark_rapids_tpu_torch.conf import TorchConf
        params, was_tuned = AT.params_for(TorchConf({
            "spark.rapids.sql.kernel.autotune.enabled": "true",
            "spark.rapids.sql.kernel.autotune.dir": broken_dir}),
            "groupbyHash", 1 << 16, device=device)
    finally:
        AT._GRIDS["groupbyHash"] = grid
        AT._GroupbyProbe.launch = real_launch
    bst = AT.stats()
    blog = AT.sweep_log()[-1]
    with open(os.path.join(broken_dir, "kernel-autotune.jsonl")) as f:
        btable = [json.loads(line) for line in f if line.strip()]
    outcomes = {json.dumps(c["params"], sort_keys=True): c["ok"]
                for c in blog["candidates"]}
    if bst["rejected"] != 2 or outcomes.get('{"laneGroups": 3}') is not \
            False or outcomes.get('{"corrupt": 1}') is not False \
            or len(btable) != 1 or btable[0]["params"] in (
                {"laneGroups": 3}, {"corrupt": 1}):
        raise AssertionError(f"tools broken candidate: {bst}, {blog}, "
                             f"{btable}")
    phase("tools_broken_candidate", card=card, bucket=1 << 16,
          outcomes=outcomes, rejected=bst["rejected"], recorded=btable,
          winner=params, tuned=was_tuned)

    # -- d. walls: tuned and defaults in turns -----------------------------
    walls = {"tuned": [], "defaults": []}
    sessions = {"tuned": s_tuned, "defaults": s_plain}
    AT.reset_for_tests()
    for which in ("tuned", "defaults", "defaults", "tuned"):
        walls[which].append(timed_q1(sessions[which]))
    phase("tools_walls", card=card, reference="exact", walls_s=walls,
          mean_s={k: statistics.mean(v) for k, v in walls.items()},
          tuned_over_defaults=statistics.mean(walls["tuned"])
          / statistics.mean(walls["defaults"]) - 1)

    # -- e. each knob at q1's shapes, against the plain versions -----------
    by_kernel = {}
    for sw in log:
        by_kernel.setdefault(sw["kernel"], []).append(sw)
    knobs = knob_cases(s_plain, q1_dir, device, by_kernel)
    phase("tools_knobs", card=card, tolerance="exact", cases=knobs,
          tuned=tuned)

    # -- e2. does slotsMult 2 clear the skew leg's overflow? ---------------
    skew_slots = skew_overflow_leg(card, device)

    # -- f. the CLI on the card --------------------------------------------
    # the subprocess runs beside the in-process commands (it only plans
    # q1: host work and the probe launch, no kernel timed meanwhile)
    t_sub = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_tpu_torch.tools", "qualify",
         Q1, "--view", f"lineitem={q1_dir}"], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    try:
        def cli(*argv) -> tuple:
            buf = io.StringIO()
            with _ctx.redirect_stdout(buf):
                rc = TL._main(list(argv))
            return rc, buf.getvalue()
        prof = TL.profile(s_plain, s_plain.sql(Q1))
        if prof.rows != len(q1_want):
            raise AssertionError(f"tools profile: {prof.rows} rows")
        tdir = os.path.join(TOOLS_DIR, "trace")
        TR.reset_tracing()
        s_traced = session(dict(tuned_conf, **{
            "spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.dir": tdir}))
        timed_q1(s_traced)
        TR.reset_tracing()
        rc_trace, trace_out = cli("trace", tdir)
        rc_hot, hot_out = cli("hotspots", tdir, "--top", "40")
        docs_tmp = os.path.join(TOOLS_DIR, "docs")
        rc_docs, _o = cli("docs", "--out", docs_tmp)
        docs_same = all(
            open(os.path.join(docs_tmp, f)).read()
            == open(os.path.join(repo, "docs", "torch", f)).read()
            for f, _g in TL.doc_generators())
        rc_lint, lint_out = cli("lint", "--root", repo)
        sub_out, sub_err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:  # never leave the subprocess running
            proc.kill()
            proc.wait()
    sub_s = time.perf_counter() - t_sub
    if proc.returncode != 0:
        raise AssertionError(f"tools qualify exited {proc.returncode}: "
                             f"{sub_err[-2000:]}")
    placed = [ln[4:] for ln in sub_out.splitlines() if ln.startswith("  + ")]
    rep = TL.qualify_sql(s_plain, Q1)
    if placed != rep.device_ops or not placed:
        raise AssertionError(f"tools qualify: {placed} != {rep.device_ops}")
    hot = [ln.strip() for ln in hot_out.splitlines()
           if "kernelDispatch[" in ln or "Exec.dispatch[" in ln]
    if (rc_trace, rc_hot, rc_docs, rc_lint) != (0, 0, 0, 0) \
            or not docs_same or "critical path" not in trace_out:
        raise AssertionError(
            f"tools CLI: trace {rc_trace}, hotspots {rc_hot}, docs "
            f"{rc_docs} (same {docs_same}), lint {rc_lint}: "
            f"{lint_out[-1500:]}")
    phase("tools_cli", card=card, qualify_rc=proc.returncode,
          qualify_placement=placed, qualify_subprocess_s=sub_s,
          profile_operators=len(prof.operators), trace_rc=rc_trace,
          hotspots_rc=rc_hot, hotspots_kernel_rows=hot, docs_rc=rc_docs,
          docs_identical=docs_same, lint_rc=rc_lint,
          lint_summary=lint_out.strip().splitlines()[-1],
          seconds=time.perf_counter() - t_phase)
    AT.reset_for_tests()
    return legs, tuned, knobs


def tools_only(card: str) -> None:
    """``--tools``: the kernels' build and phase 22."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs, tuned, _k = tools_phases(card, arrays, q1_dir)
    phase("total", seconds=time.perf_counter() - T_START, launches=legs,
          tuned=tuned)


SYNC_WARNING = "called a synchronizing CUDA operation"


def enclosing_qualnames(root: str, rel: str, line: int, memo: dict) -> list:
    """The qualnames of the defs in ``rel`` that enclose ``line``, innermost
    first, named as the linter names them (``lint.astutil.qualname``);
    ``memo`` keeps each file's defs."""
    import ast
    from spark_rapids_tpu_torch.lint import astutil as LA
    defs = memo.get(rel)
    if defs is None:
        tree = LA.FileCtx(root, rel).tree
        defs = memo[rel] = [
            (n.lineno, n.end_lineno, LA.qualname(n)) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    return [q for a, _b, q in sorted(((a, b, q) for a, b, q in defs
                                      if a <= line <= b), reverse=True)]


class SyncRecorder:
    """Every synchronisation PyTorch reports under
    ``torch.cuda.set_sync_debug_mode("warn")``, attributed to the innermost
    frame of the port's package on the stack of the thread that issued it
    (the calling line of the op, or, for an op that runs inside PyTorch's
    own Python code, the port's line that called into it). Installed as
    ``warnings.showwarning`` inside ``warnings.catch_warnings``; other
    warnings pass through."""

    def __init__(self, root: str):
        import collections
        import threading
        self.root = root
        self.pkg = os.path.join(root, "spark_rapids_tpu_torch") + os.sep
        self.lines = collections.Counter()  # "<rel>:<line>"
        # ("<rel>:<line>", the calling frame's "<rel>:<line>" or None)
        self.calls = collections.Counter()
        self.threads = collections.Counter()
        self.outside = collections.Counter()  # syncs with no package frame
        self.passed = []
        self._lock = threading.Lock()

    def hook(self, message, category, filename, lineno, file=None,
             line=None):
        import threading
        import traceback
        if SYNC_WARNING not in str(message):
            self.passed.append((str(message), filename, lineno))
            return
        ours = []
        for fr in reversed(traceback.extract_stack()[:-1]):
            path = os.path.abspath(fr.filename)
            if path.startswith(self.pkg):
                rel = os.path.relpath(path, self.root).replace(os.sep, "/")
                ours.append(f"{rel}:{fr.lineno}")
                if len(ours) == 2:
                    break
        with self._lock:
            self.threads[threading.current_thread().name] += 1
            if not ours:
                self.outside[f"{os.path.basename(filename)}:{lineno}"] += 1
            else:
                self.lines[ours[0]] += 1
                self.calls[(ours[0], ours[1] if len(ours) > 1
                            else None)] += 1


def sync_probe(device) -> dict:
    """How this PyTorch build reports a synchronisation: whether one
    ``.item()`` warns with the calling line as the warning's location, and
    which explicit ``synchronize()`` calls pass through the detector."""
    import warnings
    import torch
    x = torch.ones(4, device=device)
    ev = torch.cuda.Event()
    counts = {}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            line = sys._getframe().f_lineno + 1
            x.sum().item()
            counts["item"] = len(rec)
            torch.cuda.synchronize(device)
            counts["torch.cuda.synchronize"] = len(rec) - sum(counts.values())
            torch.cuda.current_stream(device).synchronize()
            counts["Stream.synchronize"] = len(rec) - sum(counts.values())
            ev.record()
            ev.synchronize()
            counts["Event.synchronize"] = len(rec) - sum(counts.values())
        finally:
            torch.cuda.set_sync_debug_mode(0)
    first = rec[0] if rec else None
    return {"warns": counts,
            "warning_location": None if first is None else
            f"{os.path.basename(first.filename)}:{first.lineno}",
            "location_is_caller": first is not None
            and os.path.basename(first.filename) == os.path.basename(
                __file__) and first.lineno == line}


def audited_collect(df, root: str, cfg, memo: dict) -> dict:
    """One ``df.collect()`` under ``torch.cuda.set_sync_debug_mode("warn")``,
    every sync recorded with its stack on whichever thread issued it
    (``SyncRecorder``) and attributed to ``<rel>::<qualname>`` through the
    linter's own ``FileCtx``: the rows, the wall, the launches, the syncs
    per function, caller and line, and those in a function of the
    linter's ``hot_scope`` that no ``sync_allowlist`` entry covers
    (``unsanctioned``; the entry names the function or one enclosing
    it)."""
    import warnings
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    torch.cuda.synchronize()
    rec = SyncRecorder(root)
    snap = KR.launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = rec.hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = [tuple(r) for r in df.collect()]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    wall = time.perf_counter() - t0
    now = KR.launch_counts()
    launches = {k: now[k] - snap[k] for k in now if now[k] - snap[k]}

    def function_of(site):
        rel, line = site.rsplit(":", 1)
        quals = enclosing_qualnames(root, rel, int(line), memo) \
            or ["<module>"]
        return rel, quals

    by_function: dict = {}
    by_caller: dict = {}
    unsanctioned = {}
    for (site, caller), n in sorted(rec.calls.items(),
                                    key=lambda kv: str(kv[0])):
        rel, quals = function_of(site)
        key = f"{rel}::{quals[0]} <- " + (
            "?" if caller is None else
            "{0}::{1[0]}".format(*function_of(caller)))
        by_caller[key] = by_caller.get(key, 0) + n
    for site, n in sorted(rec.lines.items()):
        rel, quals = function_of(site)
        fn = f"{rel}::{quals[0]}"
        by_function[fn] = by_function.get(fn, 0) + n
        hot = any(rel.startswith(h) for h in cfg.hot_scope)
        if hot and not any(f"{rel}::{qn}" in cfg.sync_allowlist
                           for qn in quals):
            unsanctioned[site] = fn
    return {"rows": rows, "wall_s": wall, "launches": launches,
            "syncs": sum(rec.lines.values()) + sum(rec.outside.values()),
            "by_function": by_function, "by_caller": by_caller,
            "by_line": dict(sorted(rec.lines.items())),
            "outside_package": dict(rec.outside),
            "threads": dict(rec.threads), "unsanctioned": unsanctioned}


def sync_audit_phases(card: str, arrays, q1_dir: str) -> dict:
    """Phase 23: every runtime synchronisation of the main path held
    against the linter's ``sync_allowlist``. TPC-H q1 at SF1 from phase
    7's Parquet (decodeFused, groupbyHash inside a CUDA graph) and TPC-DS
    q3's pushed form from phase 20's files (joinProbe) run once warm, then
    once more under ``torch.cuda.set_sync_debug_mode("warn")``, each sync
    recorded with its stack (``SyncRecorder``; the upload ring's producer
    thread records too) and attributed to ``<rel>::<qualname>`` through
    the linter's own ``FileCtx``. ``sync_audit`` prints, per query, the
    rows (exact), the syncs per function and per line, and the launches;
    the run fails when a sync falls in a function of the linter's
    ``hot_scope`` that no ``sync_allowlist`` entry covers (the entry names
    the function or one enclosing it), and when a query records no sync
    at all. ``sync_probe`` says first where this build puts a sync's
    warning (not at the calling line on PyTorch 2.11, hence the stacks).
    Explicit ``torch.cuda.synchronize()`` and ``Event.synchronize()``
    calls do not pass through the detector (``Stream.synchronize()``
    does; the probe shows which): the static ``hidden-sync`` rule alone
    covers them, and so the columnar-to-row download, which copies into
    pinned memory on its own stream and waits on an event
    (``finish_to_host``), takes no sync the detector sees. Returns the
    launches a query in the audited runs."""
    import torch
    from spark_rapids_tpu_torch.lint.config import LintConfig
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = LintConfig()
    probe = sync_probe(device)
    tables = q3_tables()
    q3_dir, _w = write_q3_parquet(TorchSparkSession(), tables)
    dims_dir, _w = write_q3_parquet(
        TorchSparkSession(), tables,
        {k: Q3_PARTITIONS[k] for k in ("item", "date_dim")},
        name="tpcds_q3_dims4")
    queries = (
        ("q1", {"lineitem": q1_dir}, Q1,
         lambda rows: check_q1_rows(rows, q1_reference(arrays))),
        ("q3", {"store_sales": os.path.join(q3_dir, "store_sales"),
                "item": os.path.join(dims_dir, "item"),
                "date_dim": os.path.join(dims_dir, "date_dim")}, Q3_PUSHED,
         lambda rows: check_q3_rows(rows, q3_reference(tables),
                                    "sync_audit q3")))
    memo: dict = {}
    legs, failures = {}, []
    for q, views, sql, check in queries:
        s = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        df = s.sql(sql)
        check([tuple(r) for r in df.collect()])  # warm, not audited
        a = audited_collect(df, root, cfg, memo)
        check(a["rows"])
        unsanctioned, total = a["unsanctioned"], a["syncs"]
        legs[q] = a["launches"]
        phase("sync_audit", card=card, query=q, rows=len(a["rows"]),
              reference="exact", syncs=total,
              by_function=a["by_function"], by_caller=a["by_caller"],
              by_line=a["by_line"], outside_package=a["outside_package"],
              threads=a["threads"], unsanctioned=unsanctioned,
              launches=a["launches"], audited_wall_s=a["wall_s"],
              probe=probe, seconds=time.perf_counter() - t_phase)
        if unsanctioned:
            failures.append(f"{q}: syncs in hot-scope functions outside "
                            f"sync_allowlist: {unsanctioned}")
        if total == 0:
            failures.append(f"{q}: no sync recorded (the columnar-to-row "
                            "download must show)")
    if not probe["warns"].get("item"):
        failures.append(f".item() did not warn: {probe}")
    if failures:
        raise AssertionError("sync_audit: " + "; ".join(failures))
    return legs


def sync_audit_only(card: str) -> None:
    """``--sync-audit``: the kernels' build and phase 23."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs = sync_audit_phases(card, arrays, q1_dir)
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def mesh_counters(plan) -> dict:
    """The mesh counters of an executed plan: per-chip scan units and
    dispatches, mesh exchanges, padding, demoted chips and the external
    leg's bytes."""
    from spark_rapids_tpu_torch.metrics import plan_metrics
    m = plan_metrics(plan)
    keep = ("meshScanUnits.chip", "dispatchCount.chip", "numIciExchanges",
            "meshPadWaste", "degradedChips", "externalShuffle")
    return {k: v for k, v in sorted(m.items()) if k.startswith(keep)}


def multichip_phases(card: str, arrays, q1_dir: str) -> tuple:
    """Phase 24: multi-chip execution over 4 chips emulated on the card
    (``parallel.mesh.emulate_chips(4, cuda:0)``: one process, every chip
    a slot of the same card, as the JAX package's tests force 8 host
    devices). TPC-H q1 at SF1 from phase 7's 8 Parquet files and TPC-DS
    q3's pushed form from phase 20's files under
    ``spark.rapids.shuffle.mode=ici`` and ``ici.devices=4``
    (``multichip_q1``, ``multichip_q3``): rows exact, the plan all
    ``Torch*``, ``numIciExchanges`` at least 1, every chip's
    ``meshScanUnits`` (q1: 2 row groups each) and ``dispatchCount``
    above 0, ``meshPadWaste``, and each kernel's launches (the counters
    set to 0 just before the collect) equal to the plan's own counts.
    The murmur3 launch of each mesh exchange is held against its plain
    version on chip 0's padded slot (``mesh_murmur3``). Then q1 with
    ``injectChipFailure`` ``1`` (``degradedChips`` 1) and ``0,1,2``
    (down to the single-chip path; ``multichip_degrade``), q1 under
    ``shuffle.mode=external`` (``multichip_external``:
    ``externalShuffleBytes`` above 0), ``sum_count_step`` over the 4
    chips against a host reduction (``multichip_step``), and q1's wall
    under ``ici`` and ``inprocess`` in turns (``multichip_walls``: one
    warm run, then the mean of two; emulated chips share one card, so
    this claims nothing about scaling). Returns ``(launches a leg,
    murmur3 cases)``."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.parallel import ici as ICI
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.parallel.step import dryrun_multichip
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    n_chips = 4
    tables = q3_tables()
    q3_dir, _w = write_q3_parquet(TorchSparkSession(), tables)
    dims_dir, _w = write_q3_parquet(
        TorchSparkSession(), tables,
        {k: Q3_PARTITIONS[k] for k in ("item", "date_dim")},
        name="tpcds_q3_dims4")
    q1_want = q1_reference(arrays)
    q3_want = q3_reference(tables)
    q1_views = {"lineitem": q1_dir}
    q3_views = {"store_sales": os.path.join(q3_dir, "store_sales"),
                "item": os.path.join(dims_dir, "item"),
                "date_dim": os.path.join(dims_dir, "date_dim")}
    check_q1 = lambda rows: check_q1_rows(rows, q1_want)  # noqa: E731
    check_q3 = lambda rows: check_q3_rows(rows, q3_want,  # noqa: E731
                                          "multichip q3")
    ici = {"spark.rapids.shuffle.mode": "ici",
           "spark.rapids.shuffle.ici.devices": str(n_chips),
           "spark.sql.shuffle.partitions": str(N_PARTITIONS)}
    # the routing of every mesh exchange: chip 0's padded slot, its key
    # expressions and partition count, for the murmur3 case
    routed: list = []
    route_call = ICI._Routing.__call__

    def recording_route(self, padded):
        routed.append((self, padded[0]))
        return route_call(self, padded)

    def session(conf, views):
        s = TorchSparkSession(conf)
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        return s

    def run(leg, conf, views, sql, check):
        """One collect with the launch counters set to 0 just before it
        and read just after: ``(rows' wall, plan, launches)``."""
        R.reset_fault_injection()
        s = session(conf, views)
        try:
            df = s.sql(sql)
            torch.cuda.synchronize()
            KR.reset_launches()
            t0 = time.perf_counter()
            rows = [tuple(r) for r in df.collect()]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = KR.launch_counts()
            check(rows)
            plan = s.last_plan
            all_torch(plan_names(plan), leg)
            own = execution_launches(plan)
            if {k: launches[k] for k in own} != own:
                raise AssertionError(f"{leg}: launches {launches} != the "
                                     f"plan's own counts {own}")
            return wall, plan, {k: v for k, v in launches.items() if v}
        finally:
            s.stop()

    prev = PM.emulated_chips()
    PM.emulate_chips(n_chips, device)
    ICI._Routing.__call__ = recording_route
    legs, cases = {}, {}
    try:
        for q, views, sql, check, units in (
                ("q1", q1_views, Q1, check_q1, 2),
                ("q3", q3_views, Q3_PUSHED, check_q3, None)):
            leg = f"multichip_{q}"
            run(leg, ici, views, sql, check)  # warm
            routed.clear()
            wall, plan, launches = run(leg, ici, views, sql, check)
            mc = mesh_counters(plan)
            scan = {c: mc.get(f"meshScanUnits.chip{c}", 0)
                    for c in range(n_chips)}
            disp = {c: mc.get(f"dispatchCount.chip{c}", 0)
                    for c in range(n_chips)}
            if mc.get("numIciExchanges", 0) < 1:
                raise AssertionError(f"{leg}: no mesh exchange: {mc}")
            if min(scan.values()) <= 0 or min(disp.values()) <= 0:
                raise AssertionError(f"{leg}: a chip scanned or ran "
                                     f"nothing: {mc}")
            if units is not None and set(scan.values()) != {units}:
                raise AssertionError(f"{leg}: scan units {scan}")
            if "meshPadWaste" not in mc:
                raise AssertionError(f"{leg}: no meshPadWaste: {mc}")
            if launches.get("murmur3", 0) != n_chips * mc["numIciExchanges"]:
                raise AssertionError(f"{leg}: murmur3 launches {launches} "
                                     f"for {mc['numIciExchanges']} mesh "
                                     f"exchanges over {n_chips} chips")
            route, slot = routed[0]
            cols = key_columns(route.exprs, slot)
            case = murmur3_case(cols, slot.capacity, route.n_parts)
            cases[f"mesh_exchange_{q}"] = case
            legs[leg] = launches
            phase(leg, card=card, chips=n_chips, rows="exact",
                  wall_s=wall, counters=mc, launches=launches,
                  mesh_murmur3=case, plan=plan_names(plan),
                  seconds=time.perf_counter() - t_phase)

        for chips, degraded in (("1", 1), ("0,1,2", 3)):
            conf = dict(ici, **{"spark.rapids.sql.test.injectChipFailure":
                                chips})
            wall, plan, launches = run("multichip_degrade", conf, q1_views,
                                       Q1, check_q1)
            mc = mesh_counters(plan)
            if mc.get("degradedChips", 0) != degraded:
                raise AssertionError(f"chips {chips} failing: {mc}")
            legs[f"multichip_degrade_{degraded}"] = launches
            phase("multichip_degrade", card=card, failing=chips,
                  rows="exact", wall_s=wall, counters=mc,
                  launches=launches)

        ext = {"spark.rapids.shuffle.mode": "external",
               "spark.sql.shuffle.partitions": str(N_PARTITIONS)}
        wall, plan, launches = run("multichip_external", ext, q1_views, Q1,
                                   check_q1)
        mc = mesh_counters(plan)
        if mc.get("externalShuffleBytes", 0) <= 0:
            raise AssertionError(f"external leg shipped nothing: {mc}")
        legs["multichip_external"] = launches
        phase("multichip_external", card=card, rows="exact", wall_s=wall,
              counters=mc, launches=launches)

        KR.reset_launches()
        got = dryrun_multichip(n_chips, cap=1 << 16)
        step_launches = {k: v for k, v in KR.launch_counts().items() if v}
        phase("multichip_step", card=card, chips=n_chips, keys=len(got),
              reference="host reduction, exact", launches=step_launches)

        inproc = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}
        walls = {"ici": [], "inprocess": []}
        for name, conf in (("ici", ici), ("inprocess", inproc)):
            run(f"multichip_walls_{name}", conf, q1_views, Q1, check_q1)
        for name, conf in (("ici", ici), ("inprocess", inproc),
                           ("inprocess", inproc), ("ici", ici)):
            walls[name].append(run(f"multichip_walls_{name}", conf,
                                   q1_views, Q1, check_q1)[0])
        phase("multichip_walls", card=card, chips=n_chips,
              mean_wall_s={k: sum(v) / len(v) for k, v in walls.items()},
              walls_s=walls, note="emulated chips share one card: "
              "no scaling claim", seconds=time.perf_counter() - t_phase)
    finally:
        ICI._Routing.__call__ = route_call
        PM.set_active_mesh(None)
        if prev is None:
            PM.emulate_chips(None)
        else:
            PM.emulate_chips(*prev)
    return legs, cases


def multichip_only(card: str) -> None:
    """``--multichip``: the kernels' build and phase 24."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs, cases = multichip_phases(card, arrays, q1_dir)
    phase("total", seconds=time.perf_counter() - T_START, launches=legs,
          murmur3_cases=cases)


TASK_COUNTS = (1, 2, 4)


@contextlib.contextmanager
def counting_materializations():
    """Each shuffle exchange's materializations while the block runs, by
    node id (the exchange's ``_materialize_inner`` counted)."""
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    counts: dict = {}
    inner = TorchShuffleExchangeExec._materialize_inner

    def counting(self):
        counts[id(self)] = counts.get(id(self), 0) + 1
        return inner(self)

    TorchShuffleExchangeExec._materialize_inner = counting
    try:
        yield counts
    finally:
        TorchShuffleExchangeExec._materialize_inner = inner


def distinct_nodes(plan) -> list:
    """The distinct nodes of an executed plan (a reused broadcast once),
    fused constituents included."""
    seen, out, stack = set(), [], [plan]
    while stack:
        p = stack.pop()
        if id(p) in seen:
            continue
        seen.add(id(p))
        out.append(p)
        stack.extend(getattr(p, "fused_ops", None) or [])
        stack.extend(p.children)
    return out


def concurrency_counters(plan, materialized: dict) -> dict:
    """What the concurrency guards of an executed plan counted: the scan
    partitions its split planning made, each shuffle exchange's
    materializations, the broadcasts and their builds, and the FK fast
    path's joins."""
    from spark_rapids_tpu_torch.exec.exchange import (
        TorchBroadcastExchangeExec, TorchShuffleExchangeExec)
    from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
    nodes = distinct_nodes(plan)
    bx = [n for n in nodes if isinstance(n, TorchBroadcastExchangeExec)]
    return {"scan_partitions": [len(n._parts) for n in nodes
                                if isinstance(n, CpuFileScanExec)],
            "exchange_materializations": [
                materialized.get(id(n), 0) for n in nodes
                if isinstance(n, TorchShuffleExchangeExec)],
            "broadcasts": len(bx),
            "broadcastBuilds": sum(n.metrics.value("broadcastBuilds")
                                   for n in bx),
            "fkFastPathJoins": sum(n.route_counts.get("fkFastPathJoins", 0)
                                   for n in nodes
                                   if hasattr(n, "route_counts"))}


def measured_collect(leg: str, s, df, check, materialized: dict) -> dict:
    """One collect of ``df`` (a warm plan) with the launch counters set to
    0 just before it and read just after: the rows checked, every kernel's
    launches equal to the executed plan's own counts, each shuffle
    exchange materialized once and each broadcast built once. Returns the
    wall, the launches, the graphs captured during it and the counters."""
    import torch
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.exec import fused as FU
    R.reset_fault_injection()
    torch.cuda.synchronize()
    captures0 = FU.GRAPH_COUNTS["captures"]
    materialized.clear()
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = [tuple(r) for r in df.collect()]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KR.launch_counts()
    captures = FU.GRAPH_COUNTS["captures"] - captures0
    check(rows)
    plan = s.last_plan
    all_torch(plan_names(plan), leg)
    own = execution_launches(plan)
    if {k: launches[k] for k in own} != own:
        raise AssertionError(f"{leg}: launches {launches} != the plan's "
                             f"own counts {own}")
    counters = concurrency_counters(plan, materialized)
    if any(m != 1 for m in counters["exchange_materializations"]):
        raise AssertionError(f"{leg}: an exchange did not materialize "
                             f"exactly once: {counters}")
    if counters["broadcastBuilds"] != counters["broadcasts"]:
        raise AssertionError(f"{leg}: a broadcast did not build exactly "
                             f"once: {counters}")
    return {"wall_s": wall, "launches": {k: v for k, v in launches.items()
                                         if v},
            "new_captures": captures, "counters": counters, "plan": plan}


def mesh_gap_profile(card: str, q1_views: dict, check, tasks_list,
                     n_chips: int = 4) -> dict:
    """Where q1's extra time over 4 emulated chips goes, against the
    in-process plan on the same card: at each task count, ``ici`` and
    ``inprocess`` each run once warm, once into the flight recorder
    (``trace.mode=ring``; each span kind's count, total and exclusive
    seconds, summed over threads: ``flight_breakdown``) and once under
    torch.profiler tracing the device only (device busy seconds and the
    idle share: ``profile_collect``); then their walls in turns (ici,
    inprocess, inprocess, ici). Returns the mean walls a task count and
    mode."""
    import torch
    from spark_rapids_tpu_torch import trace as TR
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    device = torch.device("cuda", 0)
    ici = {"spark.rapids.shuffle.mode": "ici",
           "spark.rapids.shuffle.ici.devices": str(n_chips),
           "spark.sql.shuffle.partitions": str(N_PARTITIONS)}
    inproc = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}
    ring = {"spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.mode": "ring"}
    prev = PM.emulated_chips()
    PM.emulate_chips(n_chips, device)
    out: dict = {}
    try:
        for tasks in tasks_list:
            t = {"spark.rapids.sql.taskParallelism": str(tasks)}
            profiles, walls = {}, {"ici": [], "inprocess": []}
            for mode, conf in (("ici", ici), ("inprocess", inproc)):
                for traced in (False, True):
                    s = TorchSparkSession(dict(conf, **t,
                                               **(ring if traced else {})))
                    try:
                        for name, path in q1_views.items():
                            s.read.parquet(path).createOrReplaceTempView(
                                name)
                        df = s.sql(Q1)
                        if traced:
                            TR.reset_tracing()
                            check([tuple(r) for r in df.collect()])
                            qt = TR.ring_active()
                            mark = time.perf_counter_ns()
                            t0 = time.perf_counter()
                            check([tuple(r) for r in df.collect()])
                            torch.cuda.synchronize()
                            ring_wall = time.perf_counter() - t0
                            flight = flight_breakdown(qt.snapshot(), mark)
                            TR.reset_tracing()
                        else:
                            check([tuple(r) for r in df.collect()])
                            prof = profile_collect(
                                df, f"mesh_gap_{mode}_{tasks}", card,
                                warm=False)
                    finally:
                        s.stop()
                profiles[mode] = {"ring_wall_s": ring_wall,
                                  "flight": flight, "device": prof}
            for mode, conf in (("ici", ici), ("inprocess", inproc),
                               ("inprocess", inproc), ("ici", ici)):
                s = TorchSparkSession(dict(conf, **t))
                try:
                    for name, path in q1_views.items():
                        s.read.parquet(path).createOrReplaceTempView(name)
                    df = s.sql(Q1)
                    check([tuple(r) for r in df.collect()])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    check([tuple(r) for r in df.collect()])
                    torch.cuda.synchronize()
                    walls[mode].append(time.perf_counter() - t0)
                finally:
                    s.stop()
            kinds = set(profiles["ici"]["flight"]["kinds"]) | set(
                profiles["inprocess"]["flight"]["kinds"])

            def ex(mode, k):
                return profiles[mode]["flight"]["kinds"].get(
                    k, {}).get("exclusive_s", 0.0)
            gap = sorted(((k, round(ex("ici", k) - ex("inprocess", k), 4))
                          for k in kinds), key=lambda kv: -abs(kv[1]))
            mean = {m: sum(v) / len(v) for m, v in walls.items()}
            out[tasks] = mean
            phase("mesh_gap_profile", card=card, chips=n_chips, tasks=tasks,
                  mean_wall_s=mean, walls_s=walls,
                  exclusive_gap_s=dict(gap), profiles=profiles,
                  note="emulated chips share one card; exclusive seconds "
                  "are summed over threads")
    finally:
        TR.reset_tracing()
        PM.set_active_mesh(None)
        if prev is None:
            PM.emulate_chips(None)
        else:
            PM.emulate_chips(*prev)
    return out


def within_or_exit(leg: str, card: str, seconds: float, fn):
    """``fn()`` on a thread of its own, its result returned or its error
    raised. A leg still running after ``seconds`` is a deadlock: its
    threads can never be joined, so the script prints the leg's failure
    and ends the process at once."""
    import threading
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # raised again on the calling thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        phase(leg, card=card, ok=False,
              error=f"no end within {seconds} s: a deadlock")
        sys.stdout.flush()
        os._exit(1)
    if "error" in out:
        raise out["error"]
    return out["value"]


def broadcast_guard_reference(tables, manufact_max: int = 500,
                              date_min: int = 36524) -> list:
    """Exact rows of ``broadcast_guard_query`` from the q3 tables' arrays:
    (brand, count) of the sales whose item has ``i_manufact_id`` at most
    ``manufact_max``, then of those sold after ``date_min``, sorted."""
    cols = {t: {c: a for c, _k, a in tables[t]} for t in tables}
    it, ss = cols["item"], cols["store_sales"]
    idx = ss["ss_item_sk"] - 1
    keep = it["i_manufact_id"][idx] <= manufact_max
    brand = it["i_brand"][idx].astype(str)
    out = []
    for m in (keep, keep & (ss["ss_sold_date_sk"] > date_min)):
        b, c = np.unique(brand[m], return_counts=True)
        out += [(x, int(n)) for x, n in zip(b, c)]
    return sorted(out)


def broadcast_guard_query(s, paths: dict, build: str,
                          manufact_max: int = 500, date_min: int = 36524):
    """Two aggregates, each over a join with a broadcast whose build side
    holds an exchange: ``build`` ``sort`` orders the items (a range
    exchange), ``limit`` takes at most every item (a single-partition
    exchange). At one shuffle partition each aggregate is one task, so
    two task threads build the two broadcasts at once."""
    from spark_rapids_tpu_torch.sql import functions as F
    d = (s.read.parquet(paths["item"])
         .where(F.col("i_manufact_id") <= manufact_max)
         .select("i_item_sk", "i_brand"))
    d = d.orderBy("i_item_sk") if build == "sort" else d.limit(1 << 30)
    ss = s.read.parquet(paths["store_sales"])
    cond = F.col("ss_item_sk") == F.col("i_item_sk")
    return (ss.join(d, cond).groupBy("i_brand")
            .agg(F.count("*").alias("c"))
            .union(ss.where(F.col("ss_sold_date_sk") > date_min)
                   .join(d, cond).groupBy("i_brand")
                   .agg(F.count("*").alias("c"))))


@contextlib.contextmanager
def late_exchanges(seconds: float = 0.3):
    """Each shuffle exchange's materialization starts ``seconds`` late,
    after the caller's permit went back: threads waiting for a permit
    take it before the exchange's pull threads ask for one."""
    from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
    inner = TorchShuffleExchangeExec._materialize_inner

    def late(self):
        time.sleep(seconds)
        return inner(self)

    TorchShuffleExchangeExec._materialize_inner = late
    try:
        yield
    finally:
        TorchShuffleExchangeExec._materialize_inner = inner


def broadcast_guard_legs(card: str, tables, paths: dict) -> dict:
    """Broadcasts whose build sides hold an exchange, at 4 tasks with
    adaptive execution off and ``concurrentGpuTasks`` 1 and 2, each
    exchange's materialization started late (``late_exchanges``), each
    leg under ``within_or_exit``. ``task_parallel_broadcast_direct``: four
    threads ask one broadcast over a grouped aggregate of ``item``
    (groupbyHash over a hash exchange) at once; it builds once and every
    thread gets its batch, exact against numpy. ``task_parallel_broadcast``:
    ``broadcast_guard_query`` (sort and limit builds) exact against
    ``broadcast_guard_reference``, each broadcast built once and the
    launches equal to the plan's own counts. Returns the launches a
    leg."""
    import threading

    import torch
    from spark_rapids_tpu_torch.exec.exchange import (
        TorchBroadcastExchangeExec, TorchShuffleExchangeExec)
    from spark_rapids_tpu_torch.memory import release_plan_handles
    from spark_rapids_tpu_torch.resource import (get_semaphore,
                                                 release_current_thread)
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    device = torch.device("cuda", 0)
    want = broadcast_guard_reference(tables)
    manu = {c: a for c, _k, a in tables["item"]}["i_manufact_id"]
    ids, counts = np.unique(manu, return_counts=True)
    want_direct = sorted(zip(ids.tolist(), counts.tolist()))
    legs: dict = {}
    with late_exchanges():
        for permits in (1, 2):
            conf = {"spark.rapids.sql.taskParallelism": "4",
                    "spark.sql.adaptive.enabled": "false",
                    "spark.rapids.sql.concurrentGpuTasks": str(permits)}
            # -- four consumers of one broadcast at once ---------------
            s = TorchSparkSession(dict(conf))
            try:
                df = s.read.parquet(paths["item"]).groupBy(
                    "i_manufact_id").agg(F.count("*").alias("c"))
                root = s.plan_physical(df.plan, announce=False)
                if not any(isinstance(n, TorchShuffleExchangeExec)
                           for n in distinct_nodes(root)):
                    raise AssertionError("broadcast_direct: no exchange "
                                         "under the build")
                bx = TorchBroadcastExchangeExec(root.children[0],
                                                s.conf_obj, device)
                got: list = [None] * 4

                def consumer(i):
                    try:
                        got[i] = bx.materialize_device()
                    finally:
                        release_current_thread()

                def ask_at_once():
                    ts = [threading.Thread(target=consumer, args=(i,),
                                           daemon=True) for i in range(4)]
                    for t in ts:
                        t.start()
                    for t in ts:
                        t.join()
                    torch.cuda.synchronize()

                t0 = time.perf_counter()
                within_or_exit("task_parallel_broadcast_direct", card, 120,
                               ask_at_once)
                wall = time.perf_counter() - t0
                if any(b is not got[0] for b in got) or got[0] is None:
                    raise AssertionError("broadcast_direct: the consumers "
                                         "got different batches")
                h = got[0].to_host().to_pydict()
                rows = sorted(zip(h["i_manufact_id"], h["c"]))
                if rows != want_direct:
                    raise AssertionError("broadcast_direct: rows differ "
                                         "from numpy's")
                builds = bx.metrics.value("broadcastBuilds")
                if builds != 1:
                    raise AssertionError(f"broadcast_direct: {builds} "
                                         "builds")
                release_plan_handles(root)
                if get_semaphore(s.conf_obj).in_use:
                    raise AssertionError("broadcast_direct: a permit "
                                         "leaked")
                phase("task_parallel_broadcast_direct", card=card,
                      tasks=4, concurrent_gpu_tasks=permits, consumers=4,
                      rows="exact", broadcastBuilds=builds, wall_s=wall)
            finally:
                s.stop()
            # -- two builds over exchanges on two task threads ---------
            for build in ("sort", "limit"):
                leg = f"task_parallel_broadcast_{build}_{permits}"
                s = TorchSparkSession(dict(conf, **{
                    "spark.sql.shuffle.partitions": "1",
                    "spark.rapids.sql.shuffle.devicePartitions": "1"}))
                try:
                    df = broadcast_guard_query(s, paths, build)

                    def check(rows):
                        if sorted(tuple(r) for r in rows) != want:
                            raise AssertionError(f"{leg}: rows differ "
                                                 "from numpy's")

                    def legrun():
                        check(df.collect())  # warm
                        with counting_materializations() as mat:
                            return measured_collect(leg, s, df, check, mat)

                    m = within_or_exit(leg, card, 120, legrun)
                finally:
                    s.stop()
                if m["counters"]["broadcasts"] != 2:
                    raise AssertionError(f"{leg}: {m['counters']}")
                legs[leg] = m["launches"]
                phase("task_parallel_broadcast", card=card, build=build,
                      tasks=4, concurrent_gpu_tasks=permits, rows="exact",
                      wall_s=m["wall_s"], launches=m["launches"],
                      **m["counters"])
    return legs


def stream_order_check(card: str, iters: int = 200,
                       n: int = 1 << 24) -> dict:
    """Two threads, each enqueuing on a ``torch.cuda.Stream`` of its own,
    replay one cached stage key (``run_program``) over two batches of
    their own, ``iters`` times each; every output is held against the
    eager function on its batch, the mismatches counted on the card so
    that no host sync orders the two streams. ``StageProgram.run`` makes
    each run wait on the previous run's event before it writes the static
    inputs: without that wait one thread's copy in overlaps the other's
    replay, and outputs go wrong."""
    import threading

    import torch
    from spark_rapids_tpu_torch import metrics as M
    from spark_rapids_tpu_torch.exec import fused as FU

    device = torch.device("cuda", 0)

    def fn(xs):
        x = xs[0]
        y = x * 40503 + 7
        for _ in range(6):
            y = (y ^ (y >> 7)) * 31 + x
        return [y], None

    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    batches = [[torch.randint(0, 1 << 40, (n,), dtype=torch.int64,
                              device=device, generator=g)
                for _ in range(2)] for _ in range(2)]
    expected = [[fn([b])[0][0] for b in per] for per in batches]
    reg = M.MetricRegistry(owner="streamOrderCheck")
    key = ("streamOrderCheck", n)
    captures0 = FU.GRAPH_COUNTS["captures"]
    FU.run_program(key, fn, [batches[0][0]], reg)  # the capture
    torch.cuda.synchronize()
    bad = [None, None]

    def worker(i):
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            miss = torch.zeros((), dtype=torch.int64, device=device)
            for it in range(iters):
                out, _meta = FU.run_program(key, fn, [batches[i][it % 2]],
                                            reg)
                miss += (out[0] != expected[i][it % 2]).sum()
        stream.synchronize()
        bad[i] = int(miss)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    out = {"threads": 2, "replays_each": iters, "rows": n,
           "mismatched_values": bad,
           "captures": FU.GRAPH_COUNTS["captures"] - captures0,
           "wall_s": wall}
    phase("task_parallel_stream_order", card=card, **out)
    FU.STAGE_CACHE.clear()
    if any(bad) or out["captures"] != 1:
        raise AssertionError(f"task_parallel_stream_order: {out}")
    return out


def task_parallel_phases(card: str, arrays, q1_dir: str,
                         gap_profile: bool = False) -> dict:
    """Phase 25: one device plan's partitions on
    ``spark.rapids.sql.taskParallelism`` task threads, and the exchanges'
    drains on as many pull threads. TPC-H q1 at SF1 from phase 7's
    Parquet and TPC-DS q3's pushed form from phase 23's files, each at 1,
    2 and 4 tasks (``concurrentGpuTasks`` at its default, 2), one warm
    run and one measured (``task_parallel``): rows exact, each kernel's
    launches equal to the executed plan's own counts, each exchange
    materialized once, each broadcast built once; the scan's partitions,
    ``fkFastPathJoins`` and the graphs captured after the warm run
    printed; before them, q3 at 4 tasks from an empty stage cache
    (``task_parallel_cold``: task threads capture at once, one capture
    a key). Then the walls in turns (1, 2, 4, 4, 2, 1 tasks;
    ``task_parallel_walls``), each 4-task leg once under the sync audit
    (``task_parallel_audit``: no unsanctioned sync), q1 over 4 emulated
    chips under ``shuffle.mode=ici`` at 1 and 4 tasks
    (``task_parallel_mesh``: rows exact, each chip's ``dispatchCount``
    equal at both), broadcasts whose build sides hold exchanges at 4
    tasks and ``concurrentGpuTasks`` 1 and 2 (``broadcast_guard_legs``),
    one stage key replayed from two threads on two streams
    (``stream_order_check``), with ``gap_profile`` (``--tasks``; the
    whole script leaves it out for time) the mesh gap's profile at 1 and
    4 tasks
    (``mesh_gap_profile``), and a leg over two real cards, which skips
    with its reason on a machine with one (``task_parallel_two_cards``).
    Returns the launches a leg."""
    import torch
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.lint.config import LintConfig
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    cfg, memo = LintConfig(), {}
    tables = q3_tables()
    q3_dir, _w = write_q3_parquet(TorchSparkSession(), tables)
    dims_dir, _w = write_q3_parquet(
        TorchSparkSession(), tables,
        {k: Q3_PARTITIONS[k] for k in ("item", "date_dim")},
        name="tpcds_q3_dims4")
    q1_want = q1_reference(arrays)
    q3_want = q3_reference(tables)
    q1_views = {"lineitem": q1_dir}
    check_q1 = lambda rows: check_q1_rows(rows, q1_want)  # noqa: E731
    queries = {
        "q1": (q1_views, Q1, check_q1),
        "q3": ({"store_sales": os.path.join(q3_dir, "store_sales"),
                "item": os.path.join(dims_dir, "item"),
                "date_dim": os.path.join(dims_dir, "date_dim")}, Q3_PUSHED,
               lambda rows: check_q3_rows(rows, q3_want, "task_parallel q3"))}
    base = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}

    def session(conf, views):
        s = TorchSparkSession(conf)
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        return s

    legs: dict = {}
    # -- cold: q3 at 4 tasks from an empty stage cache, so task threads
    # capture graphs at once; one capture a key all the same
    FU.STAGE_CACHE.clear()
    st0, c0 = FU.STAGE_CACHE.stats(), FU.GRAPH_COUNTS["captures"]
    views, sql, check = queries["q3"]
    s = session(dict(base, **{"spark.rapids.sql.taskParallelism": "4"}),
                views)
    try:
        check([tuple(r) for r in s.sql(sql).collect()])
    finally:
        s.stop()
    st1 = FU.STAGE_CACHE.stats()
    cold = {"captures": FU.GRAPH_COUNTS["captures"] - c0,
            "keys_built": st1["misses"] - st0["misses"],
            "keys_cached": st1["size"],
            "contention": st1["contention"] - st0["contention"]}
    phase("task_parallel_cold", card=card, query="q3", tasks=4,
          rows="exact", **cold, seconds=time.perf_counter() - t_phase)
    if not cold["captures"] == cold["keys_built"] > 0:
        raise AssertionError(f"task_parallel_cold: not one capture a "
                             f"key: {cold}")
    with counting_materializations() as materialized:
        # -- a. each query at 1, 2 and 4 tasks, warm then measured ---------
        prepared = {}
        for q, (views, sql, check) in queries.items():
            for tasks in TASK_COUNTS:
                s = session(dict(base, **{"spark.rapids.sql.taskParallelism":
                                          str(tasks)}), views)
                df = s.sql(sql)
                check([tuple(r) for r in df.collect()])  # warm
                leg = f"task_parallel_{q}_{tasks}"
                m = measured_collect(leg, s, df, check, materialized)
                legs[leg] = m["launches"]
                prepared[(q, tasks)] = (s, df, m)
                phase("task_parallel", card=card, query=q, tasks=tasks,
                      concurrent_gpu_tasks=2, rows="exact",
                      wall_s=m["wall_s"], launches=m["launches"],
                      plan_launches=execution_launches(m["plan"]),
                      new_captures=m["new_captures"], **m["counters"],
                      seconds=time.perf_counter() - t_phase)
        # -- b. the walls in turns ----------------------------------------
        for q, (_views, _sql, check) in queries.items():
            walls = {t: [] for t in TASK_COUNTS}
            for tasks in TASK_COUNTS + TASK_COUNTS[::-1]:
                s, df, _m = prepared[(q, tasks)]
                walls[tasks].append(measured_collect(
                    f"task_parallel_walls_{q}_{tasks}", s, df, check,
                    materialized)["wall_s"])
            phase("task_parallel_walls", card=card, query=q,
                  mean_wall_s={t: sum(v) / len(v) for t, v in walls.items()},
                  walls_s=walls, order=list(TASK_COUNTS + TASK_COUNTS[::-1]))
        # -- c. each 4-task leg under the sync audit ------------------------
        for q, (_views, _sql, check) in queries.items():
            s, df, _m = prepared[(q, 4)]
            a = audited_collect(df, root, cfg, memo)
            check(a["rows"])
            phase("task_parallel_audit", card=card, query=q, tasks=4,
                  rows="exact", syncs=a["syncs"],
                  by_function=a["by_function"], threads=a["threads"],
                  unsanctioned=a["unsanctioned"], launches=a["launches"])
            if a["unsanctioned"]:
                raise AssertionError(f"task_parallel {q}: syncs outside "
                                     f"sync_allowlist: {a['unsanctioned']}")
        for s, _df, _m in prepared.values():
            s.stop()
        prepared.clear()

        # -- d. q1 over 4 emulated chips at 1 and 4 tasks ------------------
        n_chips = 4
        ici = dict(base, **{"spark.rapids.shuffle.mode": "ici",
                            "spark.rapids.shuffle.ici.devices": str(n_chips)})
        prev = PM.emulated_chips()
        PM.emulate_chips(n_chips, device)
        per_chip = {}
        try:
            for tasks in (1, 4):
                s = session(dict(ici, **{"spark.rapids.sql.taskParallelism":
                                         str(tasks)}), q1_views)
                try:
                    df = s.sql(Q1)
                    check_q1([tuple(r) for r in df.collect()])  # warm
                    leg = f"task_parallel_mesh_q1_{tasks}"
                    m = measured_collect(leg, s, df, check_q1, materialized)
                finally:
                    s.stop()
                mc = mesh_counters(m["plan"])
                per_chip[tasks] = {k: v for k, v in mc.items()
                                   if k.startswith("dispatchCount.chip")}
                if mc.get("numIciExchanges", 0) < 1:
                    raise AssertionError(f"{leg}: no mesh exchange: {mc}")
                legs[leg] = m["launches"]
                phase("task_parallel_mesh", card=card, chips=n_chips,
                      tasks=tasks, rows="exact", wall_s=m["wall_s"],
                      counters=mc, launches=m["launches"],
                      new_captures=m["new_captures"], **m["counters"])
        finally:
            PM.set_active_mesh(None)
            if prev is None:
                PM.emulate_chips(None)
            else:
                PM.emulate_chips(*prev)
        if per_chip[1] != per_chip[4] or len(per_chip[4]) != n_chips:
            raise AssertionError(f"task_parallel_mesh: per-chip dispatches "
                                 f"differ: {per_chip}")

    # -- e. broadcasts whose build sides hold exchanges, and one stage
    # key replayed from two streams ---------------------------------------
    legs.update(broadcast_guard_legs(card, tables, {
        "item": os.path.join(dims_dir, "item"),
        "store_sales": os.path.join(q3_dir, "store_sales")}))
    stream_order_check(card)

    # -- f. where the mesh's extra time goes, at 1 task and with the
    # concurrent drain ----------------------------------------------------
    if gap_profile:
        mesh_gap_profile(card, q1_views, check_q1, (1, 4))

    # -- g. two real cards -------------------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        phase("task_parallel_two_cards", card=card, skipped=True,
              device_count=n_cards,
              reason="one card on this machine: a mesh of real cards needs "
              "two (unverified)")
    else:
        s = session(dict(base, **{"spark.rapids.shuffle.mode": "ici",
                                  "spark.rapids.shuffle.ici.devices": "2",
                                  "spark.rapids.sql.taskParallelism": "4"}),
                    q1_views)
        try:
            df = s.sql(Q1)
            check_q1([tuple(r) for r in df.collect()])
            with counting_materializations() as materialized:
                m = measured_collect("task_parallel_two_cards", s, df,
                                     check_q1, materialized)
        finally:
            s.stop()
        legs["task_parallel_two_cards"] = m["launches"]
        phase("task_parallel_two_cards", card=card, skipped=False,
              device_count=n_cards, rows="exact", wall_s=m["wall_s"],
              counters=mesh_counters(m["plan"]), launches=m["launches"])
    phase("task_parallel_done", card=card,
          seconds=time.perf_counter() - t_phase)
    return legs


def tasks_only(card: str) -> None:
    """``--tasks``: the kernels' build and phase 25."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs = task_parallel_phases(card, arrays, q1_dir, gap_profile=True)
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    # -- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    print(card, flush=True)
    try:
        import pyarrow  # noqa: F401
        pyarrow_ok = True
    except ImportError:
        pyarrow_ok = False
    device = torch.device("cuda", 0)
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          pyarrow_importable=pyarrow_ok,
          pandas_importable=importable("pandas"),
          cloudpickle_importable=importable("cloudpickle"),
          scipy_importable=importable("scipy"),
          pyarrow_spec=importlib.util.find_spec("pyarrow") is not None)

    gate_protocol()

    # -- 2. build + probe ------------------------------------------------
    build_s = device_caps.probe(device)
    args = sys.argv[1:]
    parent = ParentKernels(args[args.index("--ab") + 1]) \
        if "--ab" in args else None
    phase("build", nvcc_seconds=round(build_s, 3), probe="ok",
          libraries=sorted(f for f in os.listdir(KR.BUILD_DIR)
                           if f.endswith(".so")),
          ptxas=ptxas_report())
    capability_phase(device)

    # -- 3. kernel parity on the card ------------------------------------
    battery = DeviceBatch.from_host(murmur3_battery(1 << 20, 5), device)
    got = KM.murmur3_columns(battery.columns, battery.capacity)
    want = H.murmur3_columns(battery.columns, battery.capacity)
    torch.cuda.synchronize()
    m3_err = int((got.long() - want.long()).abs().max())
    if m3_err != 0:
        raise AssertionError("murmur3 kernel != plain at 1M rows")

    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    fields = [("l_quantity", T.DecimalType(15, 2)),
              ("l_extendedprice", T.DecimalType(15, 2)),
              ("l_discount", T.DecimalType(15, 2)),
              ("l_tax", T.DecimalType(15, 2)),
              ("l_returnflag", T.StringT), ("l_linestatus", T.StringT),
              ("l_shipdate", T.DateT)]
    t0 = time.perf_counter()
    arrays = lineitem_arrays()
    spark.createDataFrame(host_batch_from_numpy(fields, arrays),
                          num_partitions=N_PARTITIONS) \
        .createOrReplaceTempView("lineitem")
    gen_s = time.perf_counter() - t0
    df = spark.sql(Q1)

    # the main path's own kernel inputs, from partition 0 of a q1 plan
    probe_plan = spark.plan_physical(df.plan)
    agg = find_exec(probe_plan, lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    batch = next(iter(agg.child.device_partitions()[0]()))
    key_cols, vals, prims, active = agg.update_inputs(batch)
    entries = [(v, p, dt) for v, (p, dt) in zip(vals, prims)]
    slots = KR.table_slots(spark.conf_obj, batch.capacity)
    kw, h, add, mn, mx, _decode = KG.table_inputs(key_cols, entries,
                                                  active)
    gb_in = (kw, h, active, add, mn, mx)
    gb_q1 = groupby_case(gb_in, slots)
    # many groups: about 700 keys into 1024 slots, q1's add lanes plus a
    # min and a max lane
    gb_many = groupby_case(many_groups_inputs(device), 1024)
    gb_err = max(gb_q1["max_abs_err"], gb_many["max_abs_err"])
    # overflow case: 5000 distinct keys into a 1024-slot table
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.integers(0, 5000, 1 << 16)).to(device)
    okw = torch.stack([g, g * 7], dim=1).contiguous()
    oh = g * 2654435761
    ovalid = torch.ones_like(g, dtype=torch.bool)
    olanes = KG._lane_matrix([torch.ones_like(g)], g.shape[0], device)
    o_k = KG.groupby_table(okw, oh, ovalid, olanes, olanes, olanes, 1024)
    o_p = KG.groupby_table_plain(okw, oh, ovalid, olanes, olanes, olanes,
                                 1024)
    torch.cuda.synchronize()
    if not (int(o_k[4].item()) and int(o_p[4].item())):
        raise AssertionError("groupbyHash overflow flag not raised")

    # murmur3 at q1's exchange shapes: the partial aggregate's output
    part_out = next(iter(agg.device_partitions()[0]()))
    xkeys = part_out.columns[:2]
    mk = KM.murmur3_columns(xkeys, part_out.capacity)
    mp = H.murmur3_columns(xkeys, part_out.capacity)
    torch.cuda.synchronize()
    m3_err = max(m3_err, int((mk.long() - mp.long()).abs().max()))
    if m3_err != 0:
        raise AssertionError("murmur3 kernel != plain at q1 shapes")
    # the widest request (16 columns, strings at char caps 8, 16, 64)
    # and the exchange's partition ids at q1's shape, each against the
    # plain version
    wide = DeviceBatch.from_host(murmur3_wide_batch(1 << 16, 6), device)
    caps = sorted(c.char_cap for c in wide.columns if hasattr(c, "char_cap"))
    if len(wide.columns) != KM.MAX_COLS or caps != [8, 8, 16, 64]:
        raise AssertionError(f"murmur3 wide batch: {len(wide.columns)} "
                             f"columns, char caps {caps}")
    m3_cases = {"wide_16_columns": (wide.columns, wide.capacity, 0),
                "q1_exchange_n_parts": (xkeys, part_out.capacity,
                                        N_PARTITIONS),
                "wide_n_parts_200": (wide.columns, wide.capacity, 200)}
    for name, (cols, cap, n_parts) in m3_cases.items():
        got = KM.murmur3_columns(cols, cap, 42, n_parts=n_parts)
        want = H.murmur3_columns(cols, cap, 42)
        if n_parts:
            want = torch.remainder(want.to(torch.int64),
                                   n_parts).to(torch.int32)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            raise AssertionError(f"murmur3 kernel != plain on {name}: {err}")
    phase("kernel_parity", murmur3_rows_1m=battery.capacity,
          murmur3_cases={k: {"rows": v[1], "columns": len(v[0]),
                             "n_parts": v[2]} for k, v in m3_cases.items()},
          murmur3_char_caps=caps,
          murmur3_max_abs_err=m3_err, groupby_cap=batch.capacity,
          groupby_key_words=int(kw.shape[1]), groupby_slots=slots,
          groupby_lanes=gb_q1["lanes_add_min_max"],
          groupby_groups=gb_q1["groups"],
          groupby_many_groups=gb_many["groups"],
          groupby_max_abs_err=gb_err, overflow_case="flagged by both")

    # -- 4. q1 at SF1 through the session ----------------------------------
    want_rows = q1_reference(arrays)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    check_q1_rows(rows, want_rows)
    names = plan_names(spark.last_plan)
    r2c = names.index("TorchRowToColumnarExec")
    if names[0] != "TorchColumnarToRowExec" or not all(
            n.startswith("Torch") for n in names[:r2c + 1]):
        raise AssertionError(f"q1 plan is not all Torch*: {names}")
    partial = find_exec(spark.last_plan, lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    # one card: the planner's exchanges coalesce to one partition, so q1
    # hashes no partition ids (as in the JAX package)
    if launches["groupbyHash"] <= 0 or launches["murmur3"] != 0:
        raise AssertionError(f"q1 kernels: {launches} (want groupbyHash "
                             "launched and no murmur3)")
    if partial.overflow_reruns != 0:
        raise AssertionError(f"{partial.overflow_reruns} overflow re-runs")
    ring = check_default_ring(spark.last_plan, False, "q1 from memory")
    phase("q1_sf1", rows_in=SF1_ROWS, partitions=N_PARTITIONS,
          rows_out=len(rows), reference="exact", plan=names,
          launches=launches, overflow_reruns=partial.overflow_reruns,
          ring=ring,
          first_run_s=round(first_s, 4), generate_s=round(gen_s, 3))

    # -- 5. times -------------------------------------------------------------
    df.collect()  # warm
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    phase("q1_wall", card=card, warm_runs=1, timed_runs=walls,
          median_s=wall, rows_per_s=SF1_ROWS / wall)

    m3_ms = cuda_ms(lambda: KM.murmur3_columns(xkeys, part_out.capacity),
                    200)
    m3_plain_ms = wall_ms(lambda: H.murmur3_columns(
        xkeys, part_out.capacity), 20)
    m3_bytes = part_out.capacity * 4 + sum(
        c.chars.numel() + c.lengths.numel() * 4 + c.validity.numel()
        for c in xkeys)
    m3_1m_ms = cuda_ms(lambda: KM.murmur3_columns(
        battery.columns, battery.capacity), 20)
    m3_1m_plain_ms = wall_ms(lambda: H.murmur3_columns(
        battery.columns, battery.capacity), 3)
    m3_1m_bytes = battery.capacity * 4 + sum(
        t.numel() * t.element_size() for c in battery.columns
        for t in c.arrays())
    wide_bytes = wide.capacity * 4 + sum(
        t.numel() * t.element_size() for c in wide.columns
        for t in c.arrays())
    m3_wide_ms = cuda_ms(lambda: KM.murmur3_columns(
        wide.columns, wide.capacity), 50)
    m3_wide_k = device_kernels(
        lambda: KM.murmur3_columns(wide.columns, wide.capacity))
    m3_q1_k = device_kernels(
        lambda: KM.murmur3_columns(xkeys, part_out.capacity))
    m3_1m_k = device_kernels(
        lambda: KM.murmur3_columns(battery.columns, battery.capacity))
    # the exchange's partition ids at q1's shape, as hash_partition_ids
    # asks for them
    pid_k = device_kernels(
        lambda: H.partition_ids(xkeys, part_out.capacity, N_PARTITIONS))
    pid_ms = cuda_ms(lambda: H.partition_ids(
        xkeys, part_out.capacity, N_PARTITIONS), 200)
    px = torch.arange(8, dtype=torch.int32, device=device)
    probe_ms = cuda_ms(lambda: device_caps.launch_probe(px), 200)
    probe_plain_ms = wall_ms(lambda: px * 2, 200)
    phase("kernel_times", card=card,
          probe={"rows": 8, "ms": probe_ms, "plain_ms": probe_plain_ms,
                 "bytes": 64, "bound_ms": 64 / HBM_BYTES_PER_S * 1e3},
          groupbyHash_q1=gb_q1, groupbyHash_many_groups=gb_many,
          murmur3_q1={"rows": part_out.capacity, "ms": m3_ms,
                      "plain_ms": m3_plain_ms, "bytes": m3_bytes,
                      "cuda_launches": m3_q1_k["launches"],
                      "kernel_us": m3_q1_k["kernel_us"]},
          murmur3_1m={"rows": battery.capacity, "ms": m3_1m_ms,
                      "plain_ms": m3_1m_plain_ms, "bytes": m3_1m_bytes,
                      "bound_ms": m3_1m_bytes / HBM_BYTES_PER_S * 1e3,
                      "cuda_launches": m3_1m_k["launches"],
                      "kernel_us": m3_1m_k["kernel_us"]},
          murmur3_wide={"rows": wide.capacity,
                        "columns": len(wide.columns), "ms": m3_wide_ms,
                        "bytes": wide_bytes,
                        "bound_ms": wide_bytes / HBM_BYTES_PER_S * 1e3,
                        "cuda_launches": m3_wide_k["launches"],
                        "kernel_us": m3_wide_k["kernel_us"]},
          partition_ids_q1={"rows": part_out.capacity,
                            "n_parts": N_PARTITIONS, "ms": pid_ms,
                            "cuda_launches": pid_k["launches"],
                            "kernel_us": pid_k["kernel_us"],
                            "busy_us": pid_k["busy_us"],
                            "span_us": pid_k["span_us"]})

    if pid_k["launches"] != 1 or m3_1m_k["launches"] != 1:
        raise AssertionError(
            f"murmur3 CUDA kernels: {m3_1m_k['launches']} at 1M rows, "
            f"{pid_k['launches']} for q1's partition ids (want 1 each)")
    if parent is not None:
        ab = {}
        for name, (p_fn, c_fn, reps) in {
                "q1_exchange_hash": (
                    lambda: parent.murmur3(xkeys, part_out.capacity),
                    lambda: KM.murmur3_columns(xkeys, part_out.capacity),
                    200),
                "q1_partition_ids": (
                    lambda: parent.partition_ids(xkeys, part_out.capacity,
                                                 N_PARTITIONS),
                    lambda: H.partition_ids(xkeys, part_out.capacity,
                                            N_PARTITIONS), 200),
                "battery_1m": (
                    lambda: parent.murmur3(battery.columns,
                                           battery.capacity),
                    lambda: KM.murmur3_columns(battery.columns,
                                               battery.capacity), 20),
                "wide_16_columns": (
                    lambda: parent.murmur3(wide.columns, wide.capacity),
                    lambda: KM.murmur3_columns(wide.columns,
                                               wide.capacity), 50)}.items():
            if not torch.equal(p_fn(), c_fn()):
                raise AssertionError(f"parent murmur3 differs on {name}")
            ab[name] = ab_case(p_fn, c_fn, reps)
        phase("ab_murmur3", card=card, cases=ab,
              parent_ptxas=parent.ptxas["murmur3"])

    jp = q3_phases(device, card, "--breakdown" in sys.argv[1:], parent)
    tables = q3_tables()
    rp = repartition_phase(device, card, tables)
    dfu = parquet_phases(device, card, arrays, "--breakdown" in sys.argv[1:])
    upload_split(fields, arrays, device, card)
    ring_phases(card, fields, arrays, dfu["q1_dir"], tables)
    stage_fusion_phase(card, fields, arrays, dfu["q1_dir"], tables)
    mem = memory_phase(card, fields, arrays, dfu["q1_dir"], tables)

    q12 = q12_phases(device, card)
    q1_double_phase(card, arrays)
    exprs_card_phase(device, card)
    joins, jshapes = joins_phases(device, card)
    windows, wshapes = windows_phases(device, card)
    nested, nshapes = nested_phases(device, card)
    cache_udf, cshapes = cache_udf_phases(device, card, arrays,
                                          dfu["q1_dir"])
    fallback, fshapes = fallback_phases(device, card, arrays, dfu["q1_dir"])
    formats = formats_phases(device, card, arrays, dfu["q1_dir"])
    serve = serve_phases(card, arrays, dfu["q1_dir"])
    observe, oshapes = observe_phases(card, arrays, dfu["q1_dir"])
    tools, tuned, knobs = tools_phases(card, arrays, dfu["q1_dir"],
                                       observe["observe_traced_q1"])
    audit = sync_audit_phases(card, arrays, dfu["q1_dir"])
    multichip, mshapes = multichip_phases(card, arrays, dfu["q1_dir"])
    tasks = task_parallel_phases(card, arrays, dfu["q1_dir"])

    if "--breakdown" in sys.argv[1:]:
        breakdown(df, card)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"],
          strict_collects=GATE.get("strict_collects", 0),
          counters=list(PROTOCOL_COUNTERS))
    if GATE["collects"] == 0:
        raise AssertionError("no collect was checked by the protocol gate")

    def case_fields(c):
        return {k: c[k] for k in ("rows", "ms", "plain_ms", "bound_ms")}

    kernels = [
        {"name": "groupbyHash", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/groupby_hash.cu",
         "replaces": "spark_rapids_tpu/kernels/groupby_hash.py:311",
         # one CUDA kernel serves the tiled Pallas kernel too
         "also_replaces": "spark_rapids_tpu/kernels/groupby_hash.py:429",
         "launches": launches["groupbyHash"],
         "max_abs_err": max([gb_err, jp["groupby_q3"]["max_abs_err"]]
                            + [c["max_abs_err"]
                               for c in mem["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in jshapes["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in wshapes["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in nshapes["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in cshapes["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in fshapes["groupbyHash"].values()]
                            + [c["max_abs_err"]
                               for c in oshapes["groupbyHash"].values()]),
         "ms": gb_q1["ms"], "plain_ms": gb_q1["plain_ms"],
         "bound_ms": gb_q1["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "cases": {name: {k: c[k] for k in ("rows", "groups", "ms",
                                            "plain_ms", "bound_ms")}
                   for name, c in (("q1_partial", gb_q1),
                                   ("q3_partial", jp["groupby_q3"]),
                                   ("many_groups", gb_many))
                   + tuple(mem["groupbyHash"].items())
                   + tuple(jshapes["groupbyHash"].items())
                   + tuple(wshapes["groupbyHash"].items())
                   + tuple(nshapes["groupbyHash"].items())
                   + tuple(cshapes["groupbyHash"].items())
                   + tuple(fshapes["groupbyHash"].items())
                   + tuple(oshapes["groupbyHash"].items())}},
        {"name": "murmur3", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
         "replaces": "spark_rapids_tpu/kernels/murmur3.py:62",
         "launches": rp["launches"],
         "max_abs_err": max([m3_err, rp["case"]["max_abs_err"]]
                            + [c["max_abs_err"]
                               for c in mem["murmur3"].values()]
                            + [c["max_abs_err"]
                               for c in jshapes["murmur3"].values()]
                            + [c["max_abs_err"]
                               for c in nshapes["murmur3"].values()]
                            + [c["max_abs_err"]
                               for c in mshapes.values()]),
         "ms": rp["case"]["ms"], "plain_ms": rp["case"]["plain_ms"],
         "bound_ms": rp["case"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "cases": {"repartition_exchange": {
                       k: rp["case"][k] for k in ("rows", "ms", "plain_ms",
                                                  "bound_ms")},
                   "q1_exchange": {"rows": part_out.capacity, "ms": m3_ms,
                                   "bound_ms": m3_bytes / HBM_BYTES_PER_S
                                   * 1e3},
                   "battery_1m": {"rows": battery.capacity, "ms": m3_1m_ms,
                                  "bound_ms": m3_1m_bytes / HBM_BYTES_PER_S
                                  * 1e3},
                   "wide_16_columns": {"rows": wide.capacity,
                                       "ms": m3_wide_ms,
                                       "bound_ms": wide_bytes
                                       / HBM_BYTES_PER_S * 1e3},
                   "q1_partition_ids": {"rows": part_out.capacity,
                                        "ms": pid_ms,
                                        "cuda_launches": pid_k["launches"]},
                   **{name: case_fields(c)
                      for name, c in mem["murmur3"].items()},
                   **{name: case_fields(c)
                      for name, c in jshapes["murmur3"].items()},
                   **{name: case_fields(c)
                      for name, c in nshapes["murmur3"].items()},
                   **{name: case_fields(c)
                      for name, c in mshapes.items()}}},
        {"name": "joinProbe", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/join_probe.cu",
         "replaces": "spark_rapids_tpu/kernels/join_probe.py:40",
         "launches": jp["launches"],
         "max_abs_err": max([jp["max_abs_err"]]
                            + [c["max_abs_err"]
                               for c in wshapes["joinProbe"].values()]
                            + [c["max_abs_err"]
                               for c in nshapes["joinProbe"].values()]
                            + [c["max_abs_err"]
                               for c in cshapes["joinProbe"].values()]
                            + [c["max_abs_err"]
                               for c in oshapes["joinProbe"].values()]),
         "ms": jp["ms"], "plain_ms": jp["plain_ms"],
         "bound_ms": jp["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "cases": dict(jp["cases"], **{
             name: {k: c[k] for k in ("rows", "ms", "plain_ms", "bound_ms")}
             for name, c in list(wshapes["joinProbe"].items())
             + list(nshapes["joinProbe"].items())
             + list(cshapes["joinProbe"].items())
             + list(oshapes["joinProbe"].items())})},
        {"name": "decodeFused", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/decode_fused.cu",
         "replaces": "spark_rapids_tpu/kernels/decode_fused.py:95",
         "launches": dfu["launches"],
         "max_abs_err": max([dfu["max_abs_err"]]
                            + [c["max_abs_err"] for c in
                               oshapes["decodeFused"].values()]),
         "ms": dfu["ms"], "plain_ms": dfu["plain_ms"],
         "bound_ms": dfu["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "cases": {name: {k: c[k] for k in ("rows", "cuda_launches", "ms",
                                            "plain_ms", "bound_ms")}
                   for name, c in dfu["cases"].items()}},
    ]
    for k in kernels:
        name = k["name"]
        k["launches_q12"] = {leg: q12[leg][name] for leg in q12}
        k["launches_joins"] = {leg: joins[leg][name] for leg in joins}
        k["launches_windows"] = {leg: windows[leg][name]
                                 for leg in windows}
        k["launches_nested"] = {leg: nested[leg][name] for leg in nested}
        k["launches_cache_udf"] = {leg: cache_udf[leg][name]
                                   for leg in cache_udf}
        k["launches_fallback"] = {leg: fallback[leg][name]
                                  for leg in fallback}
        k["launches_formats"] = {leg: formats[leg][name] for leg in formats}
        k["launches_serve"] = {leg: serve[leg][name] for leg in serve}
        k["launches_observe"] = {leg: observe[leg].get(name, 0)
                                 for leg in observe}
        k["launches_tools"] = {leg: tools[leg].get(name, 0)
                               for leg in tools}
        k["launches_sync_audit"] = {leg: audit[leg].get(name, 0)
                                    for leg in audit}
        k["launches_multichip"] = {leg: multichip[leg].get(name, 0)
                                   for leg in multichip}
        k["launches_task_parallel"] = {leg: tasks[leg].get(name, 0)
                                       for leg in tasks}
        if name in knobs:
            # the autotuner's winners a capacity bucket, and every
            # candidate at q1's shapes (exact, card ms)
            k["tuned"] = tuned.get(name, {})
            k["autotune_cases"] = knobs[name]
    if any(leak.poll() is None for leak in worker_processes()):
        raise AssertionError("a Python worker outlived its session")
    phase("total", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def walls_only(card: str, runs: int = 5) -> None:
    """``--walls``: q1 from memory and from Parquet, both q3 forms and the
    repartition path through the session's entry points, each exact, with
    the upload
    ring's key unset and set to 0: one warm run, then ``runs`` timed
    runs, each with the seconds the garbage collector took in it. Uses
    only the session's API, so a copy of this script placed in another
    checkout times that checkout's package: run two checkouts in turns
    in one call to compare them on one card."""
    import gc
    import torch
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    fields = lineitem_fields()
    arrays = lineitem_arrays()
    tables = q3_tables()
    want = {"q1": q1_reference(arrays), "q3": q3_reference(tables),
            "repartition": repartition_reference(tables)}
    types = {"long": T.LongT, "int": T.IntegerT, "str": T.StringT,
             "dec72": T.DecimalType(7, 2)}
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    gc_s, t_gc = [0.0], [0.0]

    def on_gc(ev, _info):
        if ev == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]
    gc.callbacks.append(on_gc)
    try:
        for ring in ("unset", "0"):
            conf = {"spark.sql.shuffle.partitions": str(N_PARTITIONS)}
            if ring != "unset":
                conf["spark.rapids.sql.format.parquet.deviceDecode."
                     "maxInFlight"] = ring
            spark = TorchSparkSession(conf)
            spark.createDataFrame(host_batch_from_numpy(fields, arrays),
                                  num_partitions=N_PARTITIONS) \
                .createOrReplaceTempView("lineitem")
            spark.read.parquet(q1_dir).createOrReplaceTempView("lineitem_pq")
            for name, cols in tables.items():
                spark.createDataFrame(
                    host_batch_from_numpy(
                        [(c, types[k]) for c, k, _a in cols],
                        [a for _c, _k, a in cols]),
                    num_partitions=Q3_PARTITIONS[name]) \
                    .createOrReplaceTempView(name)
            q1_pq = spark.sql(Q1.replace("FROM lineitem",
                                         "FROM lineitem_pq"))
            for query, df in (("q1", spark.sql(Q1)), ("q1_parquet", q1_pq),
                              ("q3_pushed", spark.sql(Q3_PUSHED)),
                              ("q3_bench", spark.sql(Q3_BENCH)),
                              ("repartition", repartition_df(spark, tables))):
                df.collect()  # warm
                walls, gcs = [], []
                for _ in range(runs):
                    gc_s[0] = 0.0
                    t0 = time.perf_counter()
                    rows = df.collect()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    gcs.append(gc_s[0])
                if query.startswith("q1"):
                    check_q1_rows(rows, want["q1"])
                elif query == "repartition":
                    check_repartition_rows(rows, want["repartition"])
                else:
                    check_q3_rows(rows, want["q3"], query)
                phase("walls", card=card, query=query, max_in_flight=ring,
                      reference="exact", timed_runs=walls, gc_s=gcs,
                      median_s=statistics.median(walls),
                      median_less_gc_s=statistics.median(
                          w - g for w, g in zip(walls, gcs)))
    finally:
        gc.callbacks.remove(on_gc)


def memory_only(card: str) -> None:
    """``--memory``: the kernels' build and ``memory_phase`` alone."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    gate_protocol()
    phase("build", nvcc_seconds=round(device_caps.probe(
        torch.device("cuda", 0)), 3), torch=torch.__version__,
        cuda=torch.version.cuda)
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    memory_phase(card, lineitem_fields(), arrays, q1_dir, q3_tables())
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])


def exprs_only(card: str) -> None:
    """``--exprs``: the kernels' build and the phases of phase 13
    (capabilities, q12 from memory and Parquet, q1 in its double form,
    the expression battery)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda)
    capability_phase(device)
    q12 = q12_phases(device, card)
    q1_double_phase(card, lineitem_arrays())
    exprs_card_phase(device, card)
    phase("total", seconds=time.perf_counter() - T_START, q12_launches=q12)


def joins_only(card: str) -> None:
    """``--joins``: the kernels' build and phase 14 (q12 in its optimizer
    form and q19 from memory and from Parquet, the skew leg)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda)
    gate_protocol()
    legs, _shapes = joins_phases(device, card)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def windows_only(card: str) -> None:
    """``--windows``: the kernels' build and phase 15 (q98, q51's store
    half, the q86-shaped rollup, the union and the range)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda)
    gate_protocol()
    legs, _shapes = windows_phases(device, card)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def nested_only(card: str) -> None:
    """``--nested``: the kernels' build and phase 16 (the YSB windowed
    campaign count and the Stack Overflow tag queries)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda)
    gate_protocol()
    legs, _shapes = nested_phases(device, card)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def cache_udf_only(card: str) -> None:
    """``--cache-udf``: the kernels' build and phase 17 (ClickBench Q10
    and Q9, q1 over a cached Parquet read, the Python legs)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pandas_importable=importable("pandas"),
          cloudpickle_importable=importable("cloudpickle"),
          scipy_importable=importable("scipy"))
    gate_protocol()
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs, _shapes = cache_udf_phases(device, card, arrays, q1_dir)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"],
          strict_collects=GATE.get("strict_collects", 0))
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def fallback_only(card: str) -> None:
    """``--fallback``: the kernels' build and phase 18 (q13 and q28 from
    memory and from Parquet, q1 with its aggregate on the host, the
    kernel shapes and the cost model's constants)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    gate_protocol()
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs, _shapes = fallback_phases(device, card, arrays, q1_dir)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"],
          strict_collects=GATE.get("strict_collects", 0))
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def formats_only(card: str) -> None:
    """``--formats``: the kernels' build and phase 19 (q1 from delimited
    text, under each reader and from a partitioned tree, q3 from ORC and
    YSB from JSON lines)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    gate_protocol()
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs = formats_phases(device, card, arrays, q1_dir)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def serve_only(card: str) -> None:
    """``--serve``: the kernels' build and phase 20 (q1 and q3 served to
    four tenants: the mixed leg, fusion, the lifecycle, the result cache,
    maxConcurrentQueries 1 against 4, the launch totals)."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    device = torch.device("cuda", 0)
    phase("build", nvcc_seconds=round(device_caps.probe(device), 3),
          torch=torch.__version__, cuda=torch.version.cuda,
          pyarrow_importable=importable("pyarrow"))
    gate_protocol()
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    legs = serve_phases(card, arrays, q1_dir)
    phase("protocol_gate", collects_checked=GATE["collects"],
          collects_under_pressure=GATE["skipped"])
    phase("total", seconds=time.perf_counter() - T_START, launches=legs)


def fusion_only(card: str) -> None:
    """``--fusion``: the kernels' build and ``stage_fusion_phase`` alone."""
    import torch
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    phase("build", nvcc_seconds=round(device_caps.probe(
        torch.device("cuda", 0)), 3), torch=torch.__version__,
        cuda=torch.version.cuda)
    arrays = lineitem_arrays()
    q1_dir, _s = write_q1_parquet(TorchSparkSession(), arrays)
    stage_fusion_phase(card, lineitem_fields(), arrays, q1_dir,
                       q3_tables())


if __name__ == "__main__":
    if any(a in sys.argv[1:] for a in ("--walls", "--fusion", "--memory",
                                       "--exprs", "--joins", "--windows",
                                       "--nested", "--cache-udf",
                                       "--fallback", "--formats",
                                       "--serve", "--observe",
                                       "--tools", "--sync-audit",
                                       "--multichip", "--tasks")):
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            sys.exit(2)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(card, flush=True)
        if "--fusion" in sys.argv[1:]:
            fusion_only(card)
        elif "--exprs" in sys.argv[1:]:
            exprs_only(card)
        elif "--joins" in sys.argv[1:]:
            joins_only(card)
        elif "--windows" in sys.argv[1:]:
            windows_only(card)
        elif "--nested" in sys.argv[1:]:
            nested_only(card)
        elif "--cache-udf" in sys.argv[1:]:
            cache_udf_only(card)
        elif "--fallback" in sys.argv[1:]:
            fallback_only(card)
        elif "--formats" in sys.argv[1:]:
            formats_only(card)
        elif "--serve" in sys.argv[1:]:
            serve_only(card)
        elif "--observe" in sys.argv[1:]:
            observe_only(card)
        elif "--tools" in sys.argv[1:]:
            tools_only(card)
        elif "--sync-audit" in sys.argv[1:]:
            sync_audit_only(card)
        elif "--multichip" in sys.argv[1:]:
            multichip_only(card)
        elif "--tasks" in sys.argv[1:]:
            tasks_only(card)
        elif "--memory" in sys.argv[1:]:
            memory_only(card)
        else:
            walls_only(card)
        sys.exit(0)
    sys.exit(main())
