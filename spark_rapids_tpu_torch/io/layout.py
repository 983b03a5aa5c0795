"""Hive-style dynamic-partition layout of the file writer (port of
``spark_rapids_tpu/io/layout.py``; reference GpuFileFormatDataWriter
dynamic partitioning): one ``k1=v1/k2=v2`` directory for each distinct
combination of the partition columns, ``__HIVE_DEFAULT_PARTITION__`` for a
null."""

from __future__ import annotations

from typing import Iterator, List, Tuple

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def iter_hive_partitions(table, part_cols: List[str]
                         ) -> Iterator[Tuple[dict, str, object]]:
    """Split an Arrow table by its partition-column combinations: yields
    (partition values {col: str or None}, subdirectory "k1=v1/k2=v2", the
    rows' data columns) a combination."""
    import pyarrow.compute as pc
    data_cols = [c for c in table.column_names if c not in part_cols]
    combos = table.select(part_cols).group_by(part_cols).aggregate([])
    for row in combos.to_pylist():
        mask = None
        for k in part_cols:
            v = row[k]
            m = pc.is_null(table.column(k)) if v is None \
                else pc.equal(table.column(k), v)
            m = pc.fill_null(m, False)
            mask = m if mask is None else pc.and_(mask, m)
        sub = table.filter(mask).select(data_cols)
        subdir = "/".join(
            f"{k}={HIVE_DEFAULT_PARTITION if row[k] is None else row[k]}"
            for k in part_cols)
        yield ({k: None if row[k] is None else str(row[k])
                for k in part_cols}, subdir, sub)
