"""Typed configuration: ``RapidsConf`` and the keys the ported slices read.

Port of a subset of ``spark_rapids_tpu/config.py``: the keys of the Q1,
Q6 and q3 paths and of the planning route (optimizer, override engine,
transitions, joins, the hash exchange). Keys keep the reference's strings, so one settings dict
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

ANSI_ENABLED = ConfEntry(
    "spark.sql.ansi.enabled",
    "ANSI mode: arithmetic overflow and invalid casts raise instead of "
    "returning null.", False, _parse_bool)

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


class RapidsConf:
    """Immutable snapshot of settings, one per query."""

    def __init__(self, settings: Optional[Dict[str, str]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._settings)

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
