"""Typed configuration: ``RapidsConf`` and the keys the ported slices read.

Port of a subset of ``spark_rapids_tpu/config.py``: the keys of the Q1 and
Q6 paths and of the planning route (optimizer, override engine,
transitions). Keys keep the reference's strings, so one settings dict
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
