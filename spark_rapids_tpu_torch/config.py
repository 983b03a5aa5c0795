"""Typed configuration: ``RapidsConf`` and the keys the ported slices read.

Port of a subset of ``spark_rapids_tpu/config.py``: the keys of the Q1,
Q6 and q3 paths, of the planning route (optimizer, override engine,
transitions, joins, the hash exchange), of the parquet scan and of the
query lifecycle (memory runtime, plan cache, scheduler, chaos). Keys keep the reference's strings, so one settings dict
configures both packages. The per-operator switches
``spark.rapids.sql.exec.<Exec>`` and ``spark.rapids.sql.expression.<Expr>``
are read by ``RapidsConf.is_op_enabled`` without a declared entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"invalid boolean config value: {v!r}")


@dataclass(frozen=True)
class ConfEntry:
    key: str
    doc: str
    default: Any
    converter: Callable[[Any], Any]

    def get(self, settings: Dict[str, str]) -> Any:
        raw = settings.get(self.key)
        return self.default if raw is None else self.converter(raw)


SQL_ENABLED = ConfEntry(
    "spark.rapids.sql.enabled",
    "Enable (true) or disable (false) device acceleration of SQL plans.",
    True, _parse_bool)

SQL_MODE = ConfEntry(
    "spark.rapids.sql.mode",
    "executeOnTPU runs converted plans on the device; explainOnly only "
    "reports what would run there and returns the CPU plan.",
    "executeOnTPU", str)

EXPLAIN = ConfEntry(
    "spark.rapids.sql.explain",
    "NONE, NOT_ON_TPU (log the reasons operators stay on the CPU) or ALL.",
    "NOT_ON_TPU", str)

TEST_ASSERT_ON_TPU = ConfEntry(
    "spark.rapids.sql.test.enabled",
    "Testing only: fail if any operator in the plan did not convert to the "
    "device.", False, _parse_bool)

OPTIMIZER_ENABLED = ConfEntry(
    "spark.rapids.sql.optimizer.enabled",
    "Cost-based optimizer over the tagged plan (not yet ported: true "
    "raises).", False, _parse_bool)

LOGICAL_COLUMN_PRUNING = ConfEntry(
    "spark.rapids.tpu.optimizer.columnPruning.enabled",
    "Logical column pruning: projections restricted to the columns an "
    "operator's ancestors reference.", True, _parse_bool)

VARIABLE_FLOAT_AGG_ENABLED = ConfEntry(
    "spark.rapids.sql.variableFloatAgg.enabled",
    "Allow float sum/avg aggregations whose result can vary with the "
    "order of accumulation; false keeps them on the CPU.", True, _parse_bool)

# the reference's cast incompatibility switches (config.py:1472-1488): off,
# the cast's operator runs in the host engine

CAST_FLOAT_TO_STRING_ENABLED = ConfEntry(
    "spark.rapids.sql.castFloatToString.enabled",
    "Enable float->string casts on TPU (Java-exact shortest-round-trip "
    "formatting; reference castFloatToString incompatibility switch).",
    True, _parse_bool)

CAST_STRING_TO_FLOAT_ENABLED = ConfEntry(
    "spark.rapids.sql.castStringToFloat.enabled",
    "Enable string->float casts on TPU (reference castStringToFloat "
    "incompatibility switch).", True, _parse_bool)

CAST_STRING_TO_TIMESTAMP_ENABLED = ConfEntry(
    "spark.rapids.sql.castStringToTimestamp.enabled",
    "Enable string->timestamp casts on TPU (reference "
    "castStringToTimestamp incompatibility switch).", True, _parse_bool)

# the device regex engine's sizing (reference config.py:1414-1445)

REGEX_MAX_DEVICE_ROW_BYTES = ConfEntry(
    "spark.rapids.sql.regexp.maxDeviceRowBytes",
    "Longest string row the device regex DFA walks (rlike); a batch with a "
    "longer row takes the host path.", 4096, int)

REGEX_MAX_SPAN_ROW_BYTES = ConfEntry(
    "spark.rapids.sql.regexp.maxSpanRowBytes",
    "Longest string row for the device regexp_replace/extract span walk "
    "(O(bytes x row length)); a batch with a longer row takes the host "
    "path.", 512, int)

REGEX_MAX_DFA_STATES = ConfEntry(
    "spark.rapids.tpu.regex.maxDfaStates",
    "Upper bound on device regex DFA states; a pattern compiling larger "
    "takes the host path.", 128, int)

ANSI_ENABLED = ConfEntry(
    "spark.sql.ansi.enabled",
    "ANSI mode: arithmetic overflow and invalid casts raise instead of "
    "returning null.", False, _parse_bool)

SESSION_TZ = ConfEntry(
    "spark.sql.session.timeZone",
    "Session timezone for timestamp semantics.", "UTC", str)

BATCH_SIZE_ROWS = ConfEntry(
    "spark.rapids.sql.batchSizeRows",
    "Target maximum rows per columnar batch.", 1 << 20,
    lambda v: int(str(v), 0))

COMPILED_AGG_ENABLED = ConfEntry(
    "spark.rapids.tpu.agg.compiledStage.enabled",
    "Fuse eligible scan->filter->project->groupBy pipelines into one stage "
    "with a direct-indexed group table (small key domains only).",
    True, _parse_bool)

COMPILED_AGG_MAX_GROUPS = ConfEntry(
    "spark.rapids.tpu.agg.compiled.maxGroups",
    "Largest combined group-key domain the compiled aggregation stage may "
    "direct-index.", 4096, lambda v: int(str(v), 0))


_BYTE_UNITS = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def _parse_bytes(v: Any) -> int:
    """A byte size: an integer (``-1`` allowed) or one with a k/m/g/t
    unit, optionally followed by ``b`` (``10m``, ``64mb``)."""
    s = str(v).strip().lower()
    s = s[:-1] if s.endswith("b") else s
    if s and s[-1] in _BYTE_UNITS:
        return int(float(s[:-1]) * _BYTE_UNITS[s[-1]])
    return int(s)


LOGICAL_JOIN_STRATEGY = ConfEntry(
    "spark.rapids.tpu.optimizer.joinStrategy.enabled",
    "Cost-based build-side choice: swap an inner equi-join's inputs when "
    "the size estimate says the right (build) side is the larger, so the "
    "smaller side is built or broadcast; a projection restores the column "
    "order.", True, _parse_bool)

LOGICAL_JOIN_SWAP_RATIO = ConfEntry(
    "spark.rapids.tpu.optimizer.joinStrategy.swapRatio",
    "The estimated right side must exceed the left by this factor before "
    "the sides are swapped.", 1.5, float)

SHUFFLE_PARTITIONS = ConfEntry(
    "spark.sql.shuffle.partitions",
    "Default number of shuffle partitions.", 16, lambda v: int(str(v), 0))

SHUFFLE_MODE = ConfEntry(
    "spark.rapids.shuffle.mode",
    "ICI keeps shuffle blocks on the device, the port's only mode and so "
    "its default (the reference defaults to MULTITHREADED, host-serialized "
    "shuffle files, which return the same rows and are not yet ported: "
    "asking for them raises).", "ICI", str)

AQE_COALESCE_ENABLED = ConfEntry(
    "spark.sql.adaptive.coalescePartitions.enabled",
    "Coalesce small shuffle partitions after materialization (not yet "
    "ported: true raises).", False, _parse_bool)

AQE_SKEW_JOIN_ENABLED = ConfEntry(
    "spark.sql.adaptive.skewJoin.enabled",
    "Split skewed shuffle partitions of a join (not yet ported: true "
    "raises).", False, _parse_bool)

AUTO_BROADCAST_JOIN_THRESHOLD = ConfEntry(
    "spark.sql.autoBroadcastJoinThreshold",
    "Broadcast the build side of an equi-join when its estimated size is "
    "at most this many bytes (-1 disables).", 10 * 1024 * 1024,
    _parse_bytes)

SYMMETRIC_JOIN_ENABLED = ConfEntry(
    "spark.rapids.sql.join.useShuffledSymmetricHashJoin",
    "Use the symmetric shuffled hash join, which builds each partition on "
    "whichever side materialized smaller.", True, _parse_bool)

COMPILED_JOIN_ENABLED = ConfEntry(
    "spark.rapids.tpu.join.compiledStage.enabled",
    "Fuse eligible star-join pipelines (fact scan->filter->project -> "
    "many-to-one equi-joins -> groupBy) into one stage per fact batch: "
    "dimensions build once as sorted device key arrays, the fact side "
    "probes them, and the aggregate groups by the dimension row.",
    True, _parse_bool)

COMPILED_JOIN_MAX_DIM_ROWS = ConfEntry(
    "spark.rapids.tpu.join.compiled.maxDimRows",
    "Largest dimension row count the compiled join stage materializes; "
    "past it the stage re-runs on the general join path.", 1 << 22,
    lambda v: int(str(v), 0))

COMPILED_JOIN_DIM_CACHE_SIZE = ConfEntry(
    "spark.rapids.tpu.join.compiled.dimCacheSize",
    "Entries of the compiled join stage's cross-query dimension build "
    "cache; each pins its device key and payload arrays.", 8,
    lambda v: int(str(v), 0))


# ---------------------------------------------------------------------------
# the parquet scan (reference config.py:813-903 and :945)
# ---------------------------------------------------------------------------

PARQUET_ENABLED = ConfEntry(
    "spark.rapids.sql.format.parquet.enabled",
    "Enable device parquet scans; false keeps the scan on the CPU, which "
    "reads with pyarrow and hands host batches to the next operator.",
    True, _parse_bool)

PARQUET_DEVICE_DECODE_ENABLED = ConfEntry(
    "spark.rapids.tpu.parquet.deviceDecode.enabled",
    "Decode parquet pages on the device: the host parses the footer and "
    "page headers, decompresses pages and walks the RLE run headers, then "
    "uploads the raw page bytes once a row group and decodes every column "
    "on the device. A column the device decode does not cover (INT96, "
    "nested, other encodings) decodes on the host for that column only; "
    "each such demotion is counted. False reads whole tables with pyarrow "
    "and uploads them.", True, _parse_bool)

PARQUET_DEVICE_DECODE_VERIFY = ConfEntry(
    "spark.rapids.tpu.parquet.deviceDecode.verify",
    "Cross-check every device-decoded row group against pyarrow's decode "
    "of the same columns; a mismatch re-reads the row group on the host "
    "(counted). Roughly doubles the scan's cost.", False, _parse_bool)

PARQUET_READER_TYPE = ConfEntry(
    "spark.rapids.sql.format.parquet.reader.type",
    "AUTO, PERFILE, COALESCING or MULTITHREADED: how the host path reads "
    "the files of a partition (AUTO: COALESCING for several files, else "
    "PERFILE).", "AUTO", str)

MULTITHREAD_READ_NUM_THREADS = ConfEntry(
    "spark.rapids.sql.multiThreadedRead.numThreads",
    "Thread-pool size of the MULTITHREADED host reader.", 8,
    lambda v: int(str(v), 0))

PARQUET_CHUNK_BYTES = ConfEntry(
    "spark.rapids.sql.reader.chunked.maxDecodeBytes",
    "PERFILE host reads stream row groups in chunks whose compressed size "
    "stays under this many bytes (0 disables chunking).", 256 << 20,
    lambda v: int(str(v), 0))

PARQUET_REBASE_MODE_READ = ConfEntry(
    "spark.rapids.sql.parquet.datetimeRebaseModeInRead",
    "CORRECTED reads dates and timestamps of unmarked files as proleptic "
    "Gregorian; LEGACY rebases them from the hybrid Julian calendar. Files "
    "with Spark's legacy footer marker always rebase (on the host).",
    "CORRECTED", str)

FILECACHE_ENABLED = ConfEntry(
    "spark.rapids.filecache.enabled",
    "Cache remote scan inputs on local disk (not yet ported: true raises).",
    False, _parse_bool)

# ---------------------------------------------------------------------------
# the other host formats, the file writer and df.cache() (reference
# config.py:904-946, :992, :1096-1100, :1497)
# ---------------------------------------------------------------------------

CSV_ENABLED = ConfEntry(
    "spark.rapids.sql.format.csv.enabled",
    "Enable device CSV scans (host read, one upload a table).", True,
    _parse_bool)

JSON_ENABLED = ConfEntry(
    "spark.rapids.sql.format.json.enabled",
    "Enable device JSON scans (host read, one upload a table).", True,
    _parse_bool)

ORC_ENABLED = ConfEntry(
    "spark.rapids.sql.format.orc.enabled",
    "Enable device ORC scans (host read, one upload a table).", True,
    _parse_bool)

PARQUET_WRITE_ENABLED = ConfEntry(
    "spark.rapids.sql.format.parquet.write.enabled",
    "Enable accelerated parquet writes.", True, _parse_bool)

ORC_WRITE_ENABLED = ConfEntry(
    "spark.rapids.sql.format.orc.write.enabled",
    "Enable accelerated ORC writes.", True, _parse_bool)

BUCKETING_WRITE_ENABLED = ConfEntry(
    "spark.rapids.sql.format.write.bucketing.enabled",
    "Enable bucketBy writes (per-bucket files with a bucket-spec sidecar; "
    "reference GpuFileFormatWriter bucketing).", True, _parse_bool)

CACHE_BATCH_ROWS = ConfEntry(
    "spark.rapids.sql.cache.batchSizeRows",
    "Rows per parquet-compressed cached batch in df.cache() (reference "
    "ParquetCachedBatchSerializer per-batch encoding).", 1 << 18,
    lambda v: int(str(v), 0))

CACHE_HOST_LIMIT = ConfEntry(
    "spark.rapids.sql.cache.hostMemoryLimit",
    "Host-memory budget for cached-relation blobs; overflow spills whole "
    "compressed batches to local disk (0 disables the cap).", 0,
    _parse_bytes)

LOGICAL_PUSHDOWN = ConfEntry(
    "spark.rapids.tpu.optimizer.pushdown.enabled",
    "Logical filter/projection pushdown through explicit exchanges "
    "(Repartition), so rows are dropped before they are shuffled.", True,
    _parse_bool)

# ---------------------------------------------------------------------------
# the memory runtime (reference config.py:531-566)
# ---------------------------------------------------------------------------

def _parse_list(v: Any):
    return v if isinstance(v, list) else \
        [s.strip() for s in str(v).split(",") if s.strip()]


CONCURRENT_TPU_TASKS = ConfEntry(
    "spark.rapids.tpu.concurrentTpuTasks",
    "Number of concurrent tasks that may hold device memory at once; gated "
    "by the device semaphore (reference GpuSemaphore, default 2).",
    2, lambda v: int(str(v), 0))

HBM_ALLOC_FRACTION = ConfEntry(
    "spark.rapids.memory.tpu.allocFraction",
    "Fraction of the device's memory budgeted for columnar data (reference "
    "RMM_ALLOC_FRACTION). The torch caching allocator owns the physical "
    "memory; this bounds the logical accounting. Read once, when the first "
    "session starts.", 0.75, float)

DEVICE_TOTAL_BYTES = ConfEntry(
    "spark.rapids.memory.device.totalBytes",
    "The device memory that allocFraction applies to. Unset: the card's, "
    "from torch.cuda.mem_get_info. A session on the CPU has no device "
    "memory to read and must set it. Read once, when the first session "
    "starts.", None, _parse_bytes)

HOST_SPILL_STORAGE_SIZE = ConfEntry(
    "spark.rapids.memory.host.spillStorageSize",
    "Host memory that holds spilled device batches before they go to disk "
    "(reference HOST_SPILL_STORAGE_SIZE). Read once, when the spill "
    "catalog starts.", 1 << 30, _parse_bytes)

OOM_RETRY_MAX = ConfEntry(
    "spark.rapids.memory.tpu.oomMaxRetries",
    "Retries of an allocation after synchronizing + spilling before "
    "declaring OOM.", 3, lambda v: int(str(v), 0))

TASK_RETRY_LIMIT = ConfEntry(
    "spark.rapids.memory.tpu.taskRetryLimit",
    "How many times the task-level retry framework re-runs a batch on "
    "TorchRetryOOM (splitting on TorchSplitAndRetryOOM) before giving up "
    "(reference RmmRapidsRetryIterator bound).", 8, lambda v: int(str(v), 0))

# ---------------------------------------------------------------------------
# failure handling (reference config.py:955-964, 1245-1270)
# ---------------------------------------------------------------------------

CORE_DUMP_DIR = ConfEntry(
    "spark.rapids.tpu.coreDump.dir",
    "When set, fatal device errors write a diagnostic bundle (device name, "
    "torch.cuda.memory_stats(), the budget, task metrics, traceback) here "
    "before the executor exits (reference GpuCoreDumpHandler).",
    None, str)

FATAL_ERROR_EXIT = ConfEntry(
    "spark.rapids.tpu.fatalError.exit",
    "Exit the process on a fatal device error so a cluster manager can "
    "reschedule (reference RapidsExecutorPlugin.logGpuDebugInfoAndExit). "
    "Off by default: the engine runs in the application's own process.",
    False, _parse_bool)

DEVICE_RETRY_MAX_ATTEMPTS = ConfEntry(
    "spark.rapids.tpu.deviceRetry.maxAttempts",
    "How many times a device dispatch is re-attempted after a TRANSIENT "
    "device error before the error propagates. Fatal errors (a sticky CUDA "
    "context: illegal address, launch failure, device-side assert, ECC) "
    "are never retried.", 4, lambda v: int(str(v), 0))

DEVICE_RETRY_BACKOFF_BASE_MS = ConfEntry(
    "spark.rapids.tpu.deviceRetry.backoffBaseMs",
    "Base delay of the transient-device-error retry backoff; attempt n "
    "sleeps min(base * 2^(n-1), backoffMaxMs) scaled by a random jitter in "
    "[0.5, 1.0].", 10.0, float)

DEVICE_RETRY_BACKOFF_MAX_MS = ConfEntry(
    "spark.rapids.tpu.deviceRetry.backoffMaxMs",
    "Upper bound on a single transient-retry backoff sleep.", 2000.0, float)

# ---------------------------------------------------------------------------
# the plan cache, the query lifecycle and the scheduler (reference
# config.py:1013-1024, 1272-1355)
# ---------------------------------------------------------------------------

PLAN_CACHE_ENABLED = ConfEntry(
    "spark.rapids.tpu.plan.cache.enabled",
    "Process-wide plan cache owned by the serving scheduler: a "
    "normalized-logical-plan + schema + conf fingerprint maps to the "
    "finished physical plan with literal parameter slots; hits skip "
    "planning and only re-bind the literals.", True, _parse_bool)

PLAN_CACHE_MAX_ENTRIES = ConfEntry(
    "spark.rapids.tpu.plan.cache.maxEntries",
    "Plan-cache capacity; least-recently-used entries are evicted past "
    "this bound.", 256, lambda v: int(str(v), 0))

QUERY_TIMEOUT_MS = ConfEntry(
    "spark.rapids.tpu.query.timeoutMs",
    "Default per-query deadline in milliseconds (0 disables). A query "
    "past its deadline is cancelled at its next checkpoint (partition-task "
    "start, batch pull, exchange map task) and raises "
    "QueryDeadlineExceeded with every resource released. "
    "df.collect(timeout=seconds) overrides it per call.",
    0, lambda v: int(str(v), 0))

QUERY_RETRY_BUDGET = ConfEntry(
    "spark.rapids.tpu.query.retryBudget",
    "Total TRANSIENT device-error retries one query may consume across all "
    "of its tasks; past it the next transient error fails that query "
    "alone.", 64, lambda v: int(str(v), 0))

QUERY_PRIORITY = ConfEntry(
    "spark.rapids.tpu.query.priority",
    "SLO priority class for this session's queries: 'interactive', "
    "'batch' or 'background'. Admission is strict class precedence with "
    "earliest-deadline-first within a class; under sustained overload the "
    "scheduler sheds the LOWEST class first, returning a typed QueryShed "
    "result with a retry-after hint.", "interactive", str)

SCHED_MAX_CONCURRENT = ConfEntry(
    "spark.rapids.tpu.sched.maxConcurrentQueries",
    "How many admitted queries may execute concurrently against the "
    "device (their tasks still contend on the device semaphore).",
    8, lambda v: int(str(v), 0))

SCHED_MAX_QUEUE = ConfEntry(
    "spark.rapids.tpu.sched.maxQueuedQueries",
    "Bound on the scheduler's admission queue across all sessions; a "
    "submission past it is rejected with the typed QueryQueueFull "
    "backpressure error.", 64, lambda v: int(str(v), 0))

SCHED_HBM_WATERMARK = ConfEntry(
    "spark.rapids.tpu.sched.hbmAdmissionWatermark",
    "Admit a queued query only while the device budget's usage is at or "
    "below this fraction of the budget (waived when no query runs).",
    0.9, float)

SCHED_CLASS_AGING_MS = ConfEntry(
    "spark.rapids.tpu.sched.classAgingMs",
    "Anti-starvation bound: a ticket queued longer than this is promoted "
    "over class precedence (oldest first). 0 disables aging.",
    10000.0, float)

SCHED_TENANT_HBM_QUOTA = ConfEntry(
    "spark.rapids.tpu.sched.tenantHbmQuota",
    "Per-tenant device-memory quota as a fraction of the budget: a session "
    "whose live queries hold more than quota x budget has its next query "
    "queue. <= 0 disables quotas.", 0.0, float)

SCHED_SHED_AFTER_MS = ConfEntry(
    "spark.rapids.tpu.sched.shedAfterMs",
    "Sustained-overload bound: when a queued query has waited past this "
    "with every slot held and a strictly lower class running, the lowest "
    "running class is shed through its cancel token. 0 disables overload "
    "shedding.", 5000.0, float)

# ---------------------------------------------------------------------------
# metrics, profiling and the query tracer (reference config.py:966,
# 1115-1170)
# ---------------------------------------------------------------------------

DEBUG_DUMP_PATH = ConfEntry(
    "spark.rapids.sql.debug.dumpPath",
    "When set, operators dump their last good batch to parquet under this "
    "directory on failure (reference DumpUtils.scala).", None, str)

METRICS_LEVEL = ConfEntry(
    "spark.rapids.sql.metrics.level",
    "ESSENTIAL, MODERATE, or DEBUG metric verbosity (reference GpuMetric "
    "levels).", "MODERATE", str)

PROFILE_PATH_PREFIX = ConfEntry(
    "spark.rapids.profile.pathPrefix",
    "If set, session.profiler() writes torch.profiler Chrome traces of the "
    "enclosed queries under this path (reference spark.rapids.profile.* "
    "CUPTI profiler).", None, str)

TRACE_ENABLED = ConfEntry(
    "spark.rapids.tpu.trace.enabled",
    "Query timeline tracing: record a span tree per query — query → "
    "plan.build → partition task → operator → shuffle map task — with "
    "instant events for compiled-stage and parquet-decode launches, "
    "audited device→host syncs, budget alloc/pressure, spill, semaphore "
    "waits, shuffle reads, transient device-error retries and chaos "
    "injections. Exported as Chrome trace-event JSON, "
    "session.explain(\"metrics\") and the session.last_query_profile() "
    "diagnostics bundle. Near-zero overhead when off (a module-flag check "
    "per site).", False, _parse_bool)

TRACE_BUFFER_EVENTS = ConfEntry(
    "spark.rapids.tpu.trace.bufferEvents",
    "Ring-buffer capacity of the query tracer in records (one span costs "
    "two records, one instant event one). On overflow the oldest records "
    "are overwritten and the bundle reports the drop count.",
    262144, lambda v: int(str(v), 0))

TRACE_CATEGORIES = ConfEntry(
    "spark.rapids.tpu.trace.categories",
    "Comma-separated event/span categories to record (op, task, dispatch, "
    "sync, memory, shuffle, shuffle.map, retry, chaos); empty records "
    "everything.", [], _parse_list)

TRACE_TAG = ConfEntry(
    "spark.rapids.tpu.trace.tag",
    "Stem prefix for traced-query names and their artifact files "
    "(<tag>-<n>.trace.json instead of query-<n>.trace.json).", None, str)

TRACE_DIR = ConfEntry(
    "spark.rapids.tpu.trace.dir",
    "When set (and tracing is enabled), every traced query writes its "
    "Chrome trace (<query>.trace.json) and diagnostics bundle "
    "(<query>.profile.json) under this directory; the paths are recorded "
    "in last_query_profile()['artifacts'].", None, str)

TRACE_MAX_CONCURRENT = ConfEntry(
    "spark.rapids.tpu.trace.maxConcurrentQueries",
    "Capacity cap on simultaneously traced queries. A query beyond the cap "
    "runs untraced and increments the trace.dropped_queries registry "
    "counter.", 16, lambda v: int(str(v), 0))

# ---------------------------------------------------------------------------
# the always-on metrics registry and the flight recorder (reference
# config.py:1180-1233)
# ---------------------------------------------------------------------------

OBS_METRICS_ENABLED = ConfEntry(
    "spark.rapids.tpu.obs.metrics.enabled",
    "The always-on process-wide metrics registry: counters, gauges and "
    "log2-bucket histograms (query latency, plan-cache hits, HBM pressure, "
    "spill bytes, scheduler waits).", True, _parse_bool)

OBS_FLIGHT_EVENTS = ConfEntry(
    "spark.rapids.tpu.obs.flightRecorderEvents",
    "Ring capacity of the always-on crash flight recorder (notable events "
    "only).", 512, lambda v: int(str(v), 0))

OBS_POSTMORTEM_DIR = ConfEntry(
    "spark.rapids.tpu.obs.postmortemDir",
    "When set, a fatal device error, an exhausted transient-retry loop or "
    "a genuine budget OOM writes a postmortem bundle here.", None, str)

# ---------------------------------------------------------------------------
# the seeded chaos fault injector (reference config.py:1368-1407)
# ---------------------------------------------------------------------------

CHAOS_ENABLED = ConfEntry(
    "spark.rapids.tpu.test.chaos.enabled",
    "Testing only: arm the seeded chaos fault injector.", False, _parse_bool)

CHAOS_SEED = ConfEntry(
    "spark.rapids.tpu.test.chaos.seed",
    "Chaos injector seed; each site derives an independent PRNG stream "
    "from (seed, site).", 0, lambda v: int(str(v), 0))

CHAOS_SITES = ConfEntry(
    "spark.rapids.tpu.test.chaos.sites",
    "Comma-separated injection sites to arm; empty means every site.",
    [], _parse_list)

CHAOS_KINDS = ConfEntry(
    "spark.rapids.tpu.test.chaos.kinds",
    "Comma-separated fault kinds to draw from; empty means every kind "
    "applicable at the site.", [], _parse_list)

CHAOS_PROBABILITY = ConfEntry(
    "spark.rapids.tpu.test.chaos.probability",
    "Per-site-visit probability of injecting a fault.", 0.05, float)

CHAOS_MAX_INJECTIONS = ConfEntry(
    "spark.rapids.tpu.test.chaos.maxInjections",
    "Cap on total randomized injections per configure (0 = unbounded).",
    0, lambda v: int(str(v), 0))

CHAOS_LATENCY_MS = ConfEntry(
    "spark.rapids.tpu.test.chaos.latencyMs",
    "Upper bound of the injected delay for the `latency` fault kind.",
    2.0, float)


class RapidsConf:
    """Immutable snapshot of settings, one per query."""

    def __init__(self, settings: Optional[Dict[str, str]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._settings)

    def get_raw(self, key: str, default: Optional[str] = None
                ) -> Optional[str]:
        return self._settings.get(key, default)

    def is_op_enabled(self, key: str, default: bool = True) -> bool:
        """A per-operator switch (``spark.rapids.sql.exec.<Exec>``,
        ``spark.rapids.sql.expression.<Expr>``)."""
        raw = self._settings.get(key)
        return default if raw is None else _parse_bool(raw)

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def explain_only(self) -> bool:
        return str(self.get(SQL_MODE)).lower() == "explainonly"

    @property
    def ansi_enabled(self) -> bool:
        return self.get(ANSI_ENABLED)

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS)
