"""Typed configuration: ``RapidsConf`` and the keys the Q1 path reads.

Port of the Q1 subset of ``spark_rapids_tpu/config.py``. Keys keep the
reference's strings, so one settings dict configures both packages.
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

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def ansi_enabled(self) -> bool:
        return self.get(ANSI_ENABLED)

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS)
