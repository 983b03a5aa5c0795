"""User-facing session + DataFrame API (the Q1 subset of
``spark_rapids_tpu/session.py``).

Execution: logical plan → planner (device execs) → compiled-stage pass →
partition loop, run directly by ``DataFrame.collect``. The reference's
optimizer, scheduler and override engine come in later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .config import RapidsConf
from .device import DeviceLike, resolve_device
from .expressions.base import (Alias, Expression, Literal,
                               UnresolvedAttribute)
from .plan import logical as L


class Column:
    """Expression wrapper with the pyspark.sql.Column operator surface."""

    def __init__(self, expr: Expression):
        self._expr = expr

    def _bin(self, cls, other, reflected=False):
        l, r = (_expr(other), self._expr) if reflected else \
            (self._expr, _expr(other))
        return Column(cls(l, r))

    def __add__(self, other):
        from .expressions.arithmetic import Add
        return self._bin(Add, other)

    def __radd__(self, other):
        from .expressions.arithmetic import Add
        return self._bin(Add, other, True)

    def __sub__(self, other):
        from .expressions.arithmetic import Subtract
        return self._bin(Subtract, other)

    def __rsub__(self, other):
        from .expressions.arithmetic import Subtract
        return self._bin(Subtract, other, True)

    def __mul__(self, other):
        from .expressions.arithmetic import Multiply
        return self._bin(Multiply, other)

    def __rmul__(self, other):
        from .expressions.arithmetic import Multiply
        return self._bin(Multiply, other, True)

    def __truediv__(self, other):
        from .expressions.arithmetic import Divide
        return self._bin(Divide, other)

    def __rtruediv__(self, other):
        from .expressions.arithmetic import Divide
        return self._bin(Divide, other, True)

    def __eq__(self, other):  # type: ignore[override]
        from .expressions.predicates import EqualTo
        return self._bin(EqualTo, other)

    def __ne__(self, other):  # type: ignore[override]
        from .expressions.predicates import EqualTo, Not
        return Column(Not(EqualTo(self._expr, _expr(other))))

    def __lt__(self, other):
        from .expressions.predicates import LessThan
        return self._bin(LessThan, other)

    def __le__(self, other):
        from .expressions.predicates import LessThanOrEqual
        return self._bin(LessThanOrEqual, other)

    def __gt__(self, other):
        from .expressions.predicates import GreaterThan
        return self._bin(GreaterThan, other)

    def __ge__(self, other):
        from .expressions.predicates import GreaterThanOrEqual
        return self._bin(GreaterThanOrEqual, other)

    def __and__(self, other):
        from .expressions.predicates import And
        return self._bin(And, other)

    def __or__(self, other):
        from .expressions.predicates import Or
        return self._bin(Or, other)

    def __invert__(self):
        from .expressions.predicates import Not
        return Column(Not(self._expr))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self._expr, name))

    name = alias

    def __repr__(self) -> str:
        return f"Column<{self._expr.pretty()}>"


def _expr(x) -> Expression:
    if isinstance(x, Column):
        return x._expr
    if isinstance(x, Expression):
        return x
    return Literal(x)


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: "TorchSession"):
        self._plan = plan
        self.session = session

    @property
    def columns(self) -> List[str]:
        return [a.name for a in self._plan.output]

    def filter(self, condition) -> "DataFrame":
        return DataFrame(L.Filter(_expr(condition), self._plan), self.session)

    where = filter

    def withColumn(self, name: str, col) -> "DataFrame":
        exprs: List[Expression] = []
        replaced = False
        for a in self._plan.output:
            if a.name == name:
                exprs.append(Alias(_expr(col), name))
                replaced = True
            else:
                exprs.append(a)
        if not replaced:
            exprs.append(Alias(_expr(col), name))
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def groupBy(self, *cols) -> "GroupedData":
        return GroupedData(self, [UnresolvedAttribute(c) if isinstance(c, str)
                                  else _expr(c) for c in cols])

    groupby = groupBy

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def device_cache(self) -> "DataFrame":
        """Materialize once into device-resident batches (batchSizeRows
        rows each) and replace the plan with a device scan: repeated
        queries skip the upload and keep per-column key statistics."""
        from .io.cache import DeviceCachedRelation
        return DataFrame(DeviceCachedRelation(self.session._execute_batches(
            self._plan), self._plan.output), self.session)

    def collect(self) -> List[Dict[str, Any]]:
        """Execute and fetch all rows as dicts (the reference's shape)."""
        rows: List[Dict[str, Any]] = []
        names = self.columns
        for b in self.session._execute_batches(self._plan):
            rows.extend(b.rename(names).to_pylist())
        return rows

    def explain(self) -> str:
        s = self.session._physical_plan(self._plan).tree_string()
        print(s)
        return s


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs) -> DataFrame:
        node = L.Aggregate(self._keys, [_expr(a) for a in aggs],
                           self._df._plan)
        return DataFrame(node, self._df.session)


class TorchSession:
    """The SparkSession analogue on one torch device: ``cuda`` unless the
    caller passes ``device="cpu"``."""

    def __init__(self, conf: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self._settings: Dict[str, str] = {k: str(v)
                                          for k, v in (conf or {}).items()}
        self.device = resolve_device(device)

    def _rapids_conf(self) -> RapidsConf:
        return RapidsConf(self._settings)

    def createDataFrame(self, data, num_partitions: int = 1) -> DataFrame:
        """From a dict of numpy arrays (or lists), a list of dicts, or a
        ``pyarrow.Table``."""
        from .columnar.batch import TorchColumnarBatch
        if isinstance(data, dict):
            table = TorchColumnarBatch.from_numpy_columns(data)
        elif isinstance(data, list) and data and isinstance(data[0], dict):
            table = TorchColumnarBatch.from_pylist(data)
        elif type(data).__module__.startswith("pyarrow"):
            table = TorchColumnarBatch.from_arrow(data)
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(L.LocalRelation(table, num_partitions), self)

    def _physical_plan(self, plan: L.LogicalPlan):
        from .execs.compiled import compile_agg_stages
        from .plan.planner import plan_physical
        conf = self._rapids_conf()
        if not conf.sql_enabled:
            raise NotImplementedError(
                "spark.rapids.sql.enabled=false (CPU execution) not yet "
                "ported")
        return compile_agg_stages(plan_physical(plan, conf, self.device),
                                  conf)

    def _execute_batches(self, plan: L.LogicalPlan) -> List:
        from .execs.base import TaskContext
        final = self._physical_plan(plan)
        conf = self._rapids_conf()
        out = []
        for p in range(final.num_partitions()):
            out.extend(final.execute_partition(p, TaskContext(p, conf)))
        return out
