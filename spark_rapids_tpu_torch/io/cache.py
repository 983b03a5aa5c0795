"""Device-resident cached relation (port of ``DeviceCachedRelation`` from
``spark_rapids_tpu/io/cache.py``)."""

from __future__ import annotations

from typing import List

from ..expressions.base import AttributeReference
from ..plan.logical import LogicalPlan


class DeviceCachedRelation(LogicalPlan):
    """The materialized result held as device batches: repeated queries
    skip the upload and keep per-column memoized key statistics."""

    def __init__(self, batches: List, output):
        self._batches = list(batches)
        self._output = list(output)
        self.num_rows = sum(b.num_rows for b in batches)

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def batches(self) -> List:
        return self._batches

    def node_desc(self) -> str:
        return (f"DeviceCachedRelation[{self.num_rows} rows, "
                f"{len(self._batches)} batches]")
