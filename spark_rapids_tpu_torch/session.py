"""User-facing session + DataFrame API (a subset of
``spark_rapids_tpu/session.py``).

Execution, as in the reference: every ``collect()`` goes to the
process-wide scheduler (``serving/scheduler.execute_plan``): one conf
snapshot, a ``QueryContext`` with a deadline and a cancel token,
admission (SLO class queues, the budget watermark, tenant quotas,
shedding), planning through the plan cache — logical plan → optimizer
(join swap, column pruning) → planner (CPU physical plan) →
``TorchOverrides`` (retarget to the device, transitions, compiled join and
aggregation stages), or a cached template with its literals re-bound — and
the per-partition loop under the task semaphore, with spillable batches
and out-of-memory retry in the execs.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Any, Dict, List, Optional, Union

import torch

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

    def __mod__(self, other):
        from .expressions.arithmetic import Remainder
        return self._bin(Remainder, other)

    def __neg__(self):
        from .expressions.arithmetic import UnaryMinus
        return Column(UnaryMinus(self._expr))

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

    def eqNullSafe(self, other) -> "Column":
        """``<=>``: equality where two nulls are equal; never null."""
        from .expressions.predicates import EqualNullSafe
        return self._bin(EqualNullSafe, other)

    def __invert__(self):
        from .expressions.predicates import Not
        return Column(Not(self._expr))

    def like(self, pattern: str) -> "Column":
        from .expressions.strings import Like
        return Column(Like(self._expr, pattern))

    def rlike(self, pattern: str) -> "Column":
        from .expressions.regex import RLike
        return Column(RLike(self._expr, pattern))

    def startswith(self, other) -> "Column":
        from .expressions.strings import StartsWith
        return Column(StartsWith(self._expr, _expr(other)))

    def endswith(self, other) -> "Column":
        from .expressions.strings import EndsWith
        return Column(EndsWith(self._expr, _expr(other)))

    def contains(self, other) -> "Column":
        from .expressions.strings import Contains
        return Column(Contains(self._expr, _expr(other)))

    def cast(self, to) -> "Column":
        """Cast to a type or a Spark type name (``"int"``, ``"double"``,
        ``"long"``, ``"date"``, ...)."""
        from .expressions.cast import Cast
        from .types import type_from_string
        return Column(Cast(self._expr, type_from_string(to)
                           if isinstance(to, str) else to))

    def isNull(self) -> "Column":
        from .expressions.nullexprs import IsNull
        return Column(IsNull(self._expr))

    def isNotNull(self) -> "Column":
        from .expressions.nullexprs import IsNotNull
        return Column(IsNotNull(self._expr))

    def isin(self, *values) -> "Column":
        """``IN`` a list: ``isin(1, 2)`` or ``isin([1, 2])``."""
        from .expressions.predicates import In
        items = values[0] if len(values) == 1 \
            and isinstance(values[0], (list, tuple)) else values
        return Column(In(self._expr, [_expr(v) for v in items]))

    def between(self, lower, upper) -> "Column":
        """``lower <= self AND self <= upper``."""
        from .expressions.predicates import (And, GreaterThanOrEqual,
                                             LessThanOrEqual)
        return Column(And(GreaterThanOrEqual(self._expr, _expr(lower)),
                          LessThanOrEqual(self._expr, _expr(upper))))

    def substr(self, start: int, length: int) -> "Column":
        from .expressions.strings import Substring
        return Column(Substring(self._expr, Literal(start), Literal(length)))

    def alias(self, name: str) -> "Column":
        return Column(Alias(self._expr, name))

    def over(self, spec) -> "Column":
        """This function over a window (``window.WindowSpec``)."""
        from .window import WindowExpression
        return Column(WindowExpression(self._expr, spec))

    def asc(self) -> "L.SortOrder":
        return L.SortOrder(self._expr, True)

    def desc(self) -> "L.SortOrder":
        return L.SortOrder(self._expr, False)

    def asc_nulls_last(self) -> "L.SortOrder":
        return L.SortOrder(self._expr, True, nulls_first=False)

    def desc_nulls_first(self) -> "L.SortOrder":
        return L.SortOrder(self._expr, False, nulls_first=True)

    name = alias

    def __repr__(self) -> str:
        return f"Column<{self._expr.pretty()}>"


def _expr(x) -> Expression:
    if isinstance(x, Column):
        return x._expr
    if isinstance(x, Expression):
        return x
    return Literal(x)


def _col_exprs(cols) -> List[Expression]:
    """Column names or Columns as expressions (a name resolves later)."""
    return [UnresolvedAttribute(c) if isinstance(c, str) else _expr(c)
            for c in cols]


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: "TorchSession"):
        self._plan = plan
        self.session = session

    def __getitem__(self, name: str) -> Column:
        """A resolved reference to one of this frame's columns (it keeps
        naming this frame's column through a join)."""
        return Column(self._plan.resolve_name(name))

    def col(self, name: str) -> Column:
        return self[name]

    @property
    def columns(self) -> List[str]:
        return [a.name for a in self._plan.output]

    @property
    def schema(self):
        """The columns as a ``StructType``."""
        from .types import StructField, StructType
        return StructType([StructField(a.name, a.dtype, a.nullable)
                           for a in self._plan.output])

    def selectExpr(self, *exprs) -> "DataFrame":
        """Column names only, as the reference's."""
        return self.select(*exprs)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(a, new) if a.name == old else a
                 for a in self._plan.output]
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def drop(self, *names: str) -> "DataFrame":
        keep = [a for a in self._plan.output if a.name not in names]
        return DataFrame(L.Project(keep, self._plan), self.session)

    def dropDuplicates(self, subset: Optional[List[str]] = None
                       ) -> "DataFrame":
        """Deduplicate on ``subset`` (default: every column), keeping each
        key's first row (Spark's Dataset.dropDuplicates: ``first()`` of
        the other columns), in the original column order."""
        if not subset:
            return self.distinct()
        from .expressions.aggregates import First
        keys = [self._plan.resolve_name(c) for c in subset]
        key_ids = {k.expr_id for k in keys}
        rest = [a for a in self._plan.output if a.expr_id not in key_ids]
        node = L.Aggregate(keys, [Alias(First(a, ignore_nulls=False), a.name)
                                  for a in rest], self._plan)
        # back to the original order by expr id (a join's output may repeat
        # a name)
        by_orig = {orig.expr_id: out for out, orig in
                   zip(node.output, list(keys) + rest)}
        return DataFrame(L.Project([by_orig[a.expr_id]
                                    for a in self._plan.output], node),
                         self.session)

    def sample(self, withReplacement=None, fraction=None, seed=None
               ) -> "DataFrame":
        """pyspark's forms: ``sample(fraction)``, ``sample(fraction,
        seed)``, ``sample(withReplacement, fraction[, seed])``."""
        if not isinstance(withReplacement, bool) \
                and withReplacement is not None:
            withReplacement, fraction, seed = False, withReplacement, fraction
        if fraction is None:
            raise ValueError("sample() requires a fraction")
        return DataFrame(L.Sample(self._plan, fraction,
                                  bool(withReplacement), seed), self.session)

    def sortWithinPartitions(self, *cols) -> "DataFrame":
        order = [c if isinstance(c, L.SortOrder)
                 else L.SortOrder(_col_exprs([c])[0], True) for c in cols]
        return DataFrame(L.Sort(order, False, self._plan), self.session)

    def repartition(self, num: int, *cols) -> "DataFrame":
        """A hash exchange on ``cols`` into ``num`` partitions, or round
        robin without them."""
        if cols:
            node = L.Repartition(self._plan, num, "hash", _col_exprs(cols))
        else:
            node = L.Repartition(self._plan, num, "roundrobin")
        return DataFrame(node, self.session)

    def coalesce(self, num: int) -> "DataFrame":
        """Fewer partitions: a round-robin exchange into ``num`` (none when
        there are no more than ``num`` already)."""
        return DataFrame(L.Repartition(self._plan, num, "coalesce"),
                         self.session)

    @property
    def write(self):
        """A ``DataFrameWriter`` (``io/writer.py``)."""
        from .io.writer import DataFrameWriter
        return DataFrameWriter(self)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self.session)

    def select(self, *cols) -> "DataFrame":
        """Columns by name, or Column expressions (``alias`` names
        them)."""
        exprs = _col_exprs(cols)
        if _has_window(exprs):
            return _project_with_windows(exprs, self)
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def distinct(self) -> "DataFrame":
        """SELECT DISTINCT: a keys-only aggregate over every column (Spark's
        ReplaceDeduplicateWithAggregate, as the reference lowers it)."""
        return DataFrame(L.Aggregate(list(self._plan.output), [],
                                     self._plan), self.session)

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(L.Join(self._plan, other._plan, "cross"),
                         self.session)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Join on a Column condition: its AND of column equalities across
        the sides (e.g. ``a["k"] == b["k"]``) are the equi-keys and the
        other conjuncts the residual condition; mismatched key types widen
        to a common type. With no equality the join is a nested-loop
        join on the condition, and with ``on=None`` a cross join. On a
        column name or a list of names, a USING join (``_join_using``)."""
        if on is None:
            return DataFrame(L.Join(self._plan, other._plan,
                                    "cross" if how == "inner" else how),
                             self.session)
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)) and on \
                and all(isinstance(c, str) for c in on):
            return self._join_using(other, list(on), how)
        left, right = self._plan, other._plan
        lk, rk, residual = _extract_equi_keys(_expr(on), left, right)
        lk, rk = _coerce_join_keys(lk, rk)
        return DataFrame(L.Join(left, right, how, lk, rk, residual),
                         self.session)

    def _join_using(self, other: "DataFrame", names: List[str],
                    how: str) -> "DataFrame":
        """A USING join, as Spark returns it: the key columns once, first
        (the left's for inner and left joins, the right's for a right
        join, their coalesce for a full join), then the left's other
        columns, then the right's (a semi or anti join: the left's
        columns). The reference keeps the left's key in place, and for a
        right or full join its nulls (ROADMAP C-ref-22)."""
        from .expressions.nullexprs import Coalesce
        left, right = self._plan, other._plan
        lk0 = [left.resolve_name(c) for c in names]
        rk0 = [right.resolve_name(c) for c in names]
        lk, rk = _coerce_join_keys(lk0, rk0)
        node = L.Join(left, right, how, lk, rk)
        jt = node.join_type
        if jt in ("leftsemi", "semi", "leftanti", "anti"):
            return DataFrame(node, self.session)
        by_id = {a.expr_id: a for a in node.output}
        keys: List[Expression] = []
        for name, l0, r0, lc, rc in zip(names, lk0, rk0, lk, rk):
            if jt in ("rightouter", "right"):
                keys.append(by_id[r0.expr_id])
            elif jt in ("fullouter", "outer", "full"):
                same = l0.dtype == r0.dtype
                keys.append(Alias(Coalesce(
                    by_id[l0.expr_id] if same else lc,
                    by_id[r0.expr_id] if same else rc), l0.name))
            else:
                keys.append(by_id[l0.expr_id])
        key_ids = {a.expr_id for a in lk0 + rk0}
        rest = [a for a in node.output if a.expr_id not in key_ids]
        return DataFrame(L.Project(keys + rest, node), self.session)

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
        if _has_window(exprs):
            return _project_with_windows(exprs, self)
        return DataFrame(L.Project(exprs, self._plan), self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL, by position."""
        return DataFrame(L.Union([self._plan, other._plan]), self.session)

    unionAll = union

    def _set_op(self, other: "DataFrame", keep_right: bool) -> "DataFrame":
        """INTERSECT / EXCEPT with distinct-set semantics, lowered as the
        reference does: a union of both sides, each tagged by the side it
        came from, a group-by over every column with the max of each tag,
        and a filter on which sides contributed. Grouping treats two nulls
        as equal, which is the null-safe equality set operations need."""
        from .expressions.aggregates import Max
        from .functions import col, lit
        if len(self._plan.output) != len(other._plan.output):
            raise ValueError("set op requires equal column counts")
        names = [a.name for a in self._plan.output]

        def tag(df, left, right):
            return df.select(*[Column(a).alias(n)
                               for a, n in zip(df._plan.output, names)],
                             lit(left).alias("__setop_l"),
                             lit(right).alias("__setop_r"))

        u = tag(self, 1, 0).union(tag(other, 0, 1))
        out = u._plan.output
        aggs = [Alias(Max(out[len(names)]), "__l"),
                Alias(Max(out[len(names) + 1]), "__r")]
        g = DataFrame(L.Aggregate(list(out[:len(names)]), aggs, u._plan),
                      self.session)
        cond = (col("__l") == 1) & ((col("__r") == 1) if keep_right
                                    else (col("__r") == 0))
        return g.filter(cond).select(*names)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        return self._set_op(other, keep_right=True)

    def exceptDistinct(self, other: "DataFrame") -> "DataFrame":
        """EXCEPT DISTINCT (pyspark's ``subtract``)."""
        return self._set_op(other, keep_right=False)

    subtract = exceptDistinct

    def groupBy(self, *cols) -> "GroupedData":
        return GroupedData(self, _col_exprs(cols))

    groupby = groupBy

    def rollup(self, *cols) -> "GroupedData":
        """GROUP BY ROLLUP: the grouping sets (all), (all but the last),
        ..., () (lowered through Expand)."""
        keys = _col_exprs(cols)
        sets = [list(range(i)) for i in range(len(keys), -1, -1)]
        return GroupedData(self, keys, grouping_sets=sets)

    def cube(self, *cols) -> "GroupedData":
        """GROUP BY CUBE: all 2^n grouping sets."""
        keys = _col_exprs(cols)
        n = len(keys)
        sets = [[i for i in range(n) if (mask >> i) & 1 == 0]
                for mask in range(1 << n)]
        sets.sort(key=lambda st: (-len(st), st))
        return GroupedData(self, keys, grouping_sets=sets)

    def groupingSets(self, sets, *cols) -> "GroupedData":
        """GROUPING SETS: ``sets`` lists subsets of ``cols``, by name or by
        position."""
        keys = _col_exprs(cols)
        names = [c if isinstance(c, str) else None for c in cols]
        idx_sets = [[item if isinstance(item, int) else names.index(item)
                     for item in st] for st in sets]
        return GroupedData(self, keys, grouping_sets=idx_sets)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *cols, ascending: Union[bool, List[bool], None] = None
             ) -> "DataFrame":
        order = []
        for i, c in enumerate(cols):
            if isinstance(c, L.SortOrder):
                order.append(c)
            else:
                e = UnresolvedAttribute(c) if isinstance(c, str) else _expr(c)
                asc = ascending[i] if isinstance(ascending, list) else (
                    ascending if ascending is not None else True)
                order.append(L.SortOrder(e, asc))
        return DataFrame(L.Sort(order, True, self._plan), self.session)

    orderBy = sort

    def device_cache(self) -> "DataFrame":
        """Materialize once into device-resident batches (batchSizeRows
        rows each) and replace the plan with a device scan: repeated
        queries skip the upload and keep per-column key statistics."""
        from .io.cache import DeviceCachedRelation
        from .serving.query_context import QueryShed
        batches = self.session._execute_batches(self._plan, on_device=True)
        if isinstance(batches, QueryShed):
            raise RuntimeError(f"device_cache was shed: {batches!r}")
        return DataFrame(DeviceCachedRelation(batches, self._plan.output),
                         self.session)

    def cache(self) -> "DataFrame":
        """Materialize once and replace the plan with a scan of the result,
        held as parquet-compressed host batches
        (``spark.rapids.sql.cache.batchSizeRows`` rows each) that spill to
        disk past ``spark.rapids.sql.cache.hostMemoryLimit`` (reference
        ParquetCachedBatchSerializer; ``io/cache.CachedRelation``)."""
        from .config import CACHE_BATCH_ROWS, CACHE_HOST_LIMIT
        from .io.cache import CachedRelation
        conf = self.session._rapids_conf()
        return DataFrame(CachedRelation(
            self.to_arrow(), batch_rows=conf.get(CACHE_BATCH_ROWS),
            host_limit_bytes=conf.get(CACHE_HOST_LIMIT)), self.session)

    persist = cache

    def to_arrow(self, timeout: Optional[float] = None,
                 priority: Optional[str] = None):
        """Execute (as ``collect``) and return the rows as one
        ``pyarrow.Table``, or the scheduler's ``QueryShed``."""
        import pyarrow as pa
        from .serving.query_context import QueryShed
        from .types import to_arrow
        out = self.session._execute_batches(self._plan, timeout=timeout,
                                            priority=priority)
        if isinstance(out, QueryShed):
            return out
        names = self.columns
        schema = pa.schema([(a.name, to_arrow(a.dtype))
                            for a in self._plan.output])
        tables = [b.rename(names).to_arrow() for b in out]
        if not tables:
            return schema.empty_table()
        return pa.concat_tables(tables).cast(schema)

    toArrow = to_arrow

    def toPandas(self):
        """The rows as a pandas DataFrame (needs pandas)."""
        return self.to_arrow().to_pandas()

    def count(self) -> int:
        """The row count: Spark's ``groupBy().count()``, one aggregate on
        the device, through the scheduler like ``collect``."""
        return int(self.groupBy().count().collect()[0]["count"])

    def show(self, n: int = 20, truncate: bool = True) -> None:
        """Print the first ``n`` rows in Spark's table format (values over
        20 characters cut to 17 and ``...``; nulls as ``null``; the
        reference prints pandas' table, ROADMAP C-ref-24)."""
        rows = self.limit(n + 1).collect()
        print(_show_string(self.columns, rows, n, truncate), end="")

    def to_device_batches(self) -> List:
        """ML interop (reference ColumnarRdd): execute the plan and hand
        back its batches on the session's device, partition by partition
        (``_device_partitions``)."""
        return [b for part in self._device_partitions() for b in part]

    def _device_partitions(self) -> List[List]:
        """Each partition's device batches: the physical plan runs
        directly, without the final download (a host plan uploads), and
        its shuffle blocks go when it ends, as a query's do."""
        from .execs.base import TaskContext
        from .execs.transitions import DeviceToHostExec, HostToDeviceExec
        from .plan.optimizer import optimize_logical
        session = self.session
        if session._stopped:
            # a stopped session must not bring the shared shuffle state back
            raise RuntimeError(
                f"TorchSession {session._session_id} is stopped")
        conf = session._rapids_conf()
        optimized, _ = optimize_logical(self._plan, conf)
        final = session._final_plan(optimized, conf)
        while isinstance(final, DeviceToHostExec):
            final = final.children[0]
        if not final.is_tpu:
            final = HostToDeviceExec(final)
        names = self.columns
        out: List[List] = []
        try:
            for p in range(final.num_partitions()):
                ctx = TaskContext(p, conf, session.device, session.counters)
                try:
                    out.append([b.rename(names)
                                for b in final.execute_partition(p, ctx)])
                finally:
                    ctx.complete()
        finally:
            for node in final.collect_nodes():
                if hasattr(node, "cleanup_shuffle"):
                    node.cleanup_shuffle()
        return out

    def to_device_arrays(self) -> dict:
        """Column name → tensor of the whole result on the session's
        device. A nullable column comes back zero-filled at its nulls
        with a bool tensor ``<name>__valid`` beside it (a raw buffer
        cannot hold SQL nulls); a string column stays an Arrow array on
        the host."""
        import pyarrow as pa
        from .columnar.batch import concat_batches
        from .columnar.vector import column_to_arrow, lane_mask
        from .types import to_arrow
        batches = self.to_device_batches()
        dev = self.session.device
        if not batches:
            return {a.name: _empty_tensor(a.dtype, dev)
                    if a.dtype.np_dtype is not None
                    else pa.array([], type=to_arrow(a.dtype))
                    for a in self._plan.output}
        whole = concat_batches(batches)
        n = whole.num_rows
        out = {}
        for name, col in zip(self.columns, whole.columns):
            if col.offsets is not None:
                out[name] = column_to_arrow(col)
            elif col.validity is not None:
                v = col.validity[:n]
                out[name] = torch.where(lane_mask(v, col.data[:n]),
                                        col.data[:n],
                                        torch.zeros((), dtype=col.data.dtype,
                                                    device=col.data.device))
                out[f"{name}__valid"] = v
            else:
                out[name] = col.data[:n]
        return out

    def collect(self, timeout: Optional[float] = None,
                priority: Optional[str] = None):
        """Execute and fetch all rows as dicts (the reference's shape).
        `timeout` (seconds) sets a deadline for THIS query (overriding
        spark.rapids.tpu.query.timeoutMs): past it the query is cancelled
        at its next checkpoint and raises QueryDeadlineExceeded with every
        resource released. `priority` overrides the session's SLO class.
        Under sustained overload the scheduler may SHED the query: the
        return value is then a typed ``QueryShed`` result with a
        retry-after hint instead of the rows."""
        from .serving.query_context import QueryShed
        out = self.session._execute_batches(self._plan, timeout=timeout,
                                            priority=priority)
        if isinstance(out, QueryShed):
            return out
        rows: List[Dict[str, Any]] = []
        names = self.columns
        for b in out:
            rows.extend(b.rename(names).to_pylist())
        return rows

    def explain(self, mode: str = "formatted") -> str:
        """The plan cache's verdict for this query (``planCache=hit``,
        ``miss``, ``off`` or ``uncacheable``), the applied optimizer rules,
        the optimized logical plan and the physical plan ('*' marks device
        operators), as the reference prints them. ``mode="metrics"`` hands
        over to the session: the LAST executed query's plan annotated with
        its metrics (``TorchSession.explain``)."""
        if str(mode) == "metrics":
            return self.session.explain("metrics")
        from .config import PLAN_CACHE_ENABLED
        from .plan.optimizer import explain_logical, optimize_logical
        from .serving.plan_cache import fingerprint
        from .serving.scheduler import QueryScheduler
        conf = self.session._rapids_conf()
        status = "off"
        if conf.get(PLAN_CACHE_ENABLED):
            fp = fingerprint(self._plan, conf)
            if fp is None:
                status = "uncacheable"
            else:
                inst = QueryScheduler.peek()
                status = ("hit" if inst is not None
                          and inst.plan_cache.peek(fp.key) else "miss")
        optimized, rules = optimize_logical(self._plan, conf)
        lines = [f"planCache={status}"]
        if rules:
            lines.append(f"appliedRules={', '.join(rules)}")
            lines.append("== Optimized Logical Plan ==")
            lines.append(explain_logical(optimized))
            lines.append("== Physical Plan ==")
        lines.append(self.session._final_plan(optimized, conf).tree_string())
        s = "\n".join(lines)
        print(s)
        return s

    def explain_fallback(self) -> str:
        """What would not run on the device, and why."""
        from .plan.optimizer import optimize_logical
        from .plan.overrides import TorchOverrides
        from .plan.planner import plan_physical
        conf = self.session._rapids_conf()
        optimized, _ = optimize_logical(self._plan, conf)
        out = TorchOverrides.explain_plan(plan_physical(optimized, conf),
                                          conf)
        if _has_file_scan(optimized):
            # the scan's demotions to the host so far in this session
            from .io.device_decode import FALLBACK_KEYS
            counts = ", ".join(f"{k}={self.session.counters[k]}"
                               for k in FALLBACK_KEYS)
            out += f"\nscan: parquet device decode, {counts}"
        return out


def _empty_tensor(dtype, device):
    """An empty tensor of a fixed-width type's carrier."""
    return torch.zeros(0, dtype=dtype.torch_dtype, device=device)


def _show_cell(v, truncate: bool) -> str:
    if v is None:
        return "null"
    text = ("true" if v else "false") if isinstance(v, bool) else str(v)
    if truncate and len(text) > 20:
        text = text[:17] + "..."
    return text


def _show_string(names: List[str], rows: List[dict], n: int,
                 truncate: bool = True) -> str:
    """Spark's ``Dataset.showString``: a +---+ framed table, cells right
    aligned, and a line saying so when more than ``n`` rows exist."""
    cells = [[_show_cell(r[c], truncate) for c in names] for r in rows[:n]]
    widths = [max([3, len(c)] + [len(r[i]) for r in cells])
              for i, c in enumerate(names)]
    sep = "+" + "+".join("-" * w for w in widths) + "+\n"

    def line(vals):
        return "|" + "|".join(v.rjust(w) for v, w in zip(vals, widths)) \
            + "|\n"

    out = sep + line(names) + sep + "".join(line(r) for r in cells) + sep
    if len(rows) > n:
        out += f"only showing top {n} row{'s' if n != 1 else ''}\n"
    return out


def _has_file_scan(plan: L.LogicalPlan) -> bool:
    return isinstance(plan, L.FileScan) or any(
        _has_file_scan(c) for c in plan.children)


def _coerce_join_keys(lk: List[Expression], rk: List[Expression]):
    """Widen mismatched equi-join key types to a common type (Spark's
    findWiderTypeForTwo): the two sides of a shuffled join must hash the
    same width, since murmur3 hashes int32 and int64 differently."""
    from .expressions.cast import Cast
    from .types import (ByteType, DecimalType, DoubleT, DoubleType,
                        FloatType, IntegerType, LongType, ShortType)
    order = {ByteType: 0, ShortType: 1, IntegerType: 2, LongType: 3,
             FloatType: 4, DoubleType: 5}
    out_l, out_r = [], []
    for a, b in zip(lk, rk):
        try:
            ta, tb = a.dtype, b.dtype
        except ValueError:
            # a key named by ``col()`` is resolved by the join itself: it
            # passes through uncoerced, as in the reference
            out_l.append(a)
            out_r.append(b)
            continue
        if isinstance(ta, DecimalType) or isinstance(tb, DecimalType):
            # Spark's wider decimal (an integral side as its decimal; a
            # float side takes both to double)
            from .types import NumericType, decimal_common_type
            if ta != tb and not (isinstance(ta, NumericType)
                                 and isinstance(tb, NumericType)):
                raise ValueError(f"join key type mismatch {ta} vs {tb}: "
                                 "cast one side explicitly")
            common = ta if ta == tb else decimal_common_type(ta, tb)
            out_l.append(a if ta == common else Cast(a, common))
            out_r.append(b if tb == common else Cast(b, common))
            continue
        if type(ta) is type(tb):
            out_l.append(a)
            out_r.append(b)
            continue
        ra, rb = order.get(type(ta)), order.get(type(tb))
        if ra is None or rb is None:
            raise ValueError(f"join key type mismatch {ta} vs {tb}: cast "
                             "one side explicitly")
        if (ra <= 3) != (rb <= 3):
            common = DoubleT  # integral vs fractional
        else:
            common = ta if ra >= rb else tb
        out_l.append(a if type(ta) is type(common) else Cast(a, common))
        out_r.append(b if type(tb) is type(common) else Cast(b, common))
    return out_l, out_r


def _extract_equi_keys(cond: Expression, left, right):
    """Split an AND-tree of EqualTo(left side, right side) into the key
    lists + the residual condition."""
    from .expressions.base import AttributeReference
    from .expressions.predicates import And, EqualTo
    left_ids = {a.expr_id for a in left.output}
    right_ids = {a.expr_id for a in right.output}
    conjuncts: List[Expression] = []

    def flatten(e):
        if isinstance(e, And):
            flatten(e.children[0])
            flatten(e.children[1])
        else:
            conjuncts.append(e)

    def ids(e):
        return {x.expr_id for x in
                e.collect(lambda n: isinstance(n, AttributeReference))}

    flatten(cond)
    lk, rk, residual = [], [], []
    for c in conjuncts:
        if isinstance(c, EqualTo):
            a, b = c.children
            if ids(a) <= left_ids and ids(b) <= right_ids:
                lk.append(a)
                rk.append(b)
                continue
            if ids(a) <= right_ids and ids(b) <= left_ids:
                lk.append(b)
                rk.append(a)
                continue
        residual.append(c)
    res = None
    for c in residual:
        res = c if res is None else And(res, c)
    return lk, rk, res


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression],
                 grouping_sets: Optional[List[List[int]]] = None):
        self._df = df
        self._keys = keys
        self._grouping_sets = grouping_sets

    def agg(self, *aggs) -> DataFrame:
        exprs = [_expr(a) for a in aggs]
        if self._grouping_sets is not None:
            return self._agg_grouping_sets(exprs)
        node = L.Aggregate(self._keys, exprs, self._df._plan)
        return DataFrame(node, self._df.session)

    def count(self) -> DataFrame:
        from .expressions.aggregates import Count
        return self.agg(Column(Alias(Count(Literal(1)), "count")))

    def _named_aggs(self, cls, word: str, names) -> DataFrame:
        return self.agg(*[Column(Alias(cls(UnresolvedAttribute(n)),
                                       f"{word}({n})")) for n in names])

    def sum(self, *names: str) -> DataFrame:
        from .expressions.aggregates import Sum
        return self._named_aggs(Sum, "sum", names)

    def avg(self, *names: str) -> DataFrame:
        from .expressions.aggregates import Average
        return self._named_aggs(Average, "avg", names)

    mean = avg

    def min(self, *names: str) -> DataFrame:
        from .expressions.aggregates import Min
        return self._named_aggs(Min, "min", names)

    def max(self, *names: str) -> DataFrame:
        from .expressions.aggregates import Max
        return self._named_aggs(Max, "max", names)

    def _agg_grouping_sets(self, agg_exprs: List[Expression]) -> DataFrame:
        """Grouping sets as Expand, then Aggregate, then Project (Spark's
        ResolveGroupingAnalytics, the reference's lowering). The Expand
        keeps every child column, so the aggregates see the real values;
        it adds one copy of each grouping expression, nulled where the set
        leaves it out (``_gset_i``), and the ``_gid`` bitmask (bit n-1-i
        set when key i is left out). Those copies and ``_gid`` are the
        aggregate's keys: a rolled-up null and a null in the data fall in
        different groups."""
        from .expressions.base import AttributeReference, output_name
        from .expressions.bitwise import BitwiseAnd, ShiftRight
        from .expressions.cast import Cast
        from .expressions.generators import GroupingExpr, GroupingID
        from .types import ByteT, LongT
        child = self._df._plan
        keys = [L.resolve_expression(k, child) for k in self._keys]
        n = len(keys)
        gset_attrs = [AttributeReference(f"_gset_{i}", k.dtype, True)
                      for i, k in enumerate(keys)]
        gid_attr = AttributeReference("_gid", LongT, False)
        projections: List[List[Expression]] = []
        for st in self._grouping_sets:
            gid = 0
            proj: List[Expression] = list(child.output)
            for i, k in enumerate(keys):
                if i in st:
                    proj.append(k)
                else:
                    proj.append(Literal(None, k.dtype))
                    gid |= 1 << (n - 1 - i)
            proj.append(Literal(gid, LongT))
            projections.append(proj)
        expand = L.Expand(projections,
                          list(child.output) + gset_attrs + [gid_attr],
                          child, resolve=False)

        def lower_markers(e: Expression) -> Expression:
            def rule(x: Expression):
                if isinstance(x, GroupingID):
                    return gid_attr
                if isinstance(x, GroupingExpr):
                    inner = L.resolve_expression(x.child, child)
                    for i, k in enumerate(keys):
                        if isinstance(inner, AttributeReference) \
                                and isinstance(k, AttributeReference) \
                                and inner.expr_id == k.expr_id:
                            return Cast(BitwiseAnd(
                                ShiftRight(gid_attr, Literal(n - 1 - i)),
                                Literal(1, LongT)), ByteT)
                    raise ValueError(f"grouping() argument {inner.pretty()}"
                                     " is not a grouping column")
                return None
            return e.transform(rule)

        lowered = []
        for e in agg_exprs:
            low = lower_markers(e)
            if low is not e and not isinstance(e, Alias):
                # the user-visible name of an unaliased marker
                low = Alias(low, L.resolve_expression(e, child).pretty())
            lowered.append(low)
        node = L.Aggregate(list(gset_attrs) + [gid_attr], lowered, expand)
        # the keys under their own names, then the aggregates; _gid goes
        out = [Alias(node.output[i], output_name(k))
               for i, k in enumerate(keys)]
        out += [node.output[n + 1 + j] for j in range(len(lowered))]
        return DataFrame(L.Project(out, node), self._df.session)


def _has_window(exprs) -> bool:
    from .window import WindowExpression
    return any(e.collect(lambda x: isinstance(x, WindowExpression))
               for e in exprs)


def _project_with_windows(exprs, df: DataFrame) -> DataFrame:
    """Window expressions into a ``WindowOp`` below the projection, each
    occurrence replaced by a reference to its output column (Spark's
    ExtractWindowExpressions)."""
    from .window import WindowExpression
    windows: List = []
    for e in exprs:
        for w in e.collect(lambda x: isinstance(x, WindowExpression)):
            if not any(w is x for x in windows):
                windows.append(w)
    node = L.WindowOp(windows, df._plan)
    attrs = node.window_attrs

    def replace(e: Expression) -> Expression:
        def rule(x: Expression):
            for i, w in enumerate(windows):
                if x is w:
                    return attrs[i]
            return None
        return e.transform(rule)

    return DataFrame(L.Project([replace(e) for e in exprs], node),
                     df.session)


class TorchSessionBuilder:
    """``TorchSession.builder``: settings, then ``getOrCreate()`` (a new
    session each call, as the reference's)."""

    def __init__(self):
        self._conf: Dict[str, str] = {}

    def config(self, key: str, value: Any) -> "TorchSessionBuilder":
        self._conf[key] = str(value)
        return self

    def appName(self, name: str) -> "TorchSessionBuilder":
        self._conf["spark.app.name"] = name
        return self

    def master(self, m: str) -> "TorchSessionBuilder":
        return self

    def getOrCreate(self, device: DeviceLike = None) -> "TorchSession":
        """A session on ``device`` (the card unless ``"cpu"``)."""
        return TorchSession(self._conf, device=device)


class _BuilderAccessor:
    """``TorchSession.builder`` on the class or an instance."""

    def __get__(self, obj, cls) -> TorchSessionBuilder:
        return TorchSessionBuilder()


class TorchSession:
    """The SparkSession analogue on one torch device: ``cuda`` unless the
    caller passes ``device="cpu"``. Each session is one frontend of the
    process-wide scheduler: its queries submit under its id, so
    ``cancel()`` and ``stop()`` target exactly its queries. ``counters``
    counts the session's runtime events: ``fallback_runs`` (a compiled
    aggregation stage re-ran on the general path), ``fallbackReruns`` (a
    compiled join stage did), ``sort_fallback_runs`` (a grouped aggregate
    sorted out of core), ``global_chunked_runs`` (an ungrouped one merged
    per-chunk states), and the parquet scan's ``fallback_columns``,
    ``fallback_row_groups`` and ``fallback_files`` (demotions to the host
    decode) and ``scan.*`` time split (``io/parquet.TorchFileScanExec``).
    ``last_task_metrics()`` holds the last query's retry, split, spill and
    semaphore-wait counts."""

    builder = _BuilderAccessor()

    #: session-id mint (itertools.count.__next__ is atomic in CPython)
    _session_ids = itertools.count(1)

    def __init__(self, conf: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self._settings: Dict[str, str] = {k: str(v)
                                          for k, v in (conf or {}).items()}
        self.device = resolve_device(device)
        self.counters: Counter = Counter()
        from .chaos import FaultInjector
        from .config import OBS_METRICS_ENABLED
        from .memory.device import TorchDeviceManager
        from .obs import flight as _flight
        from .obs import metrics as _metrics
        from .serving import scheduler as _sched
        rc = self._rapids_conf()
        # the device budget's size: allocFraction × the card's memory
        # (once a process, as the reference's startup-only conf)
        TorchDeviceManager.initialize(rc, self.device)
        # arm/disarm the process-wide fault injector when the conf
        # mentions chaos; apply the metrics switch and the flight
        # recorder's ring size and postmortem dir
        FaultInjector.maybe_configure(rc)
        _metrics.set_enabled(rc.get(OBS_METRICS_ENABLED))
        _flight.maybe_configure(rc)
        self._session_id = f"sess-{next(TorchSession._session_ids)}"
        self._stopped = False
        _sched.register_session(self)
        _sched.QueryScheduler.get(rc)

    class _Conf:
        """``session.conf``: a plan-relevant key's change drops the plans
        cached under its other values."""

        def __init__(self, session: "TorchSession"):
            self._s = session

        def set(self, key: str, value: Any) -> None:
            self._s._settings[key] = str(value)
            _invalidate_cached_plans(key, str(value))

        def get(self, key: str, default: Optional[str] = None
                ) -> Optional[str]:
            return self._s._settings.get(key, default)

        def unset(self, key: str) -> None:
            self._s._settings.pop(key, None)
            _invalidate_cached_plans(key, None)

    @property
    def conf(self) -> "_Conf":
        return TorchSession._Conf(self)

    def _rapids_conf(self) -> RapidsConf:
        return RapidsConf(self._settings)

    @property
    def read(self):
        """A ``DataFrameReader``: ``read.parquet(path)``."""
        from .io.reader import DataFrameReader
        return DataFrameReader(self)

    def createDataFrame(self, data, schema=None, num_partitions: int = 1,
                        validity=None) -> DataFrame:
        """From a dict of numpy arrays, lists or ``HostStrings`` (with an
        optional dict of bool ``validity`` arrays), a list of dicts, a
        ``pyarrow.Table``, a pandas DataFrame, or a list of tuples with a
        ``schema`` (column names, a ``StructType`` or a DDL string)."""
        from .columnar.batch import TorchColumnarBatch
        if isinstance(data, dict):
            table = TorchColumnarBatch.from_numpy_columns(data, validity)
        elif isinstance(data, list) and data and isinstance(data[0], dict):
            table = TorchColumnarBatch.from_pylist(data)
        elif type(data).__module__.startswith("pyarrow"):
            table = TorchColumnarBatch.from_arrow(data)
        elif type(data).__module__.startswith("pandas"):
            import pyarrow as pa
            table = TorchColumnarBatch.from_arrow(
                pa.Table.from_pandas(data, preserve_index=False))
        elif isinstance(data, list) and schema is not None:
            table = _rows_with_schema(data, schema)
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(L.LocalRelation(table, num_partitions), self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              numPartitions: int = 1) -> DataFrame:
        """One bigint column ``id``: start, start + step, ... below end
        (``range(n)``: 0 to n - 1)."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.Range(start, end, step, numPartitions), self)

    def _final_plan(self, optimized: L.LogicalPlan, conf: RapidsConf):
        from .plan.overrides import TorchOverrides
        from .plan.planner import plan_physical
        return TorchOverrides.apply(plan_physical(optimized, conf), conf)

    def _execute_batches(self, plan: L.LogicalPlan, on_device: bool = False,
                         timeout: Optional[float] = None,
                         priority: Optional[str] = None):
        """Submit one query through the scheduler (admission, deadline,
        plan cache, the partition loop): host batches, or with
        ``on_device`` the device batches under the final download — or a
        typed ``QueryShed`` when the scheduler shed it."""
        if self._stopped:
            raise RuntimeError(f"TorchSession {self._session_id} is stopped")
        from .serving.scheduler import execute_plan
        return execute_plan(self, plan, timeout=timeout, priority=priority,
                            on_device=on_device)

    def last_admit_wait_ms(self) -> Optional[float]:
        """Admission-queue wait of this session's last query in
        milliseconds (None before any query, or when it was rejected or
        shed while queued)."""
        return getattr(self, "_last_admit_wait_ms", None)

    def last_task_metrics(self) -> Dict[str, int]:
        """Task-accumulator deltas of the last query alone: semaphore
        wait, retry and split counts, retry block time, spill bytes by
        tier, read-spill time, device retries."""
        return dict(getattr(self, "_last_task_metrics", {}) or {})

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The always-on process-wide metrics registry readout."""
        from .obs import metrics as _metrics
        return _metrics.full_snapshot()

    def last_query_metrics(self, level: Optional[str] = None
                           ) -> Dict[str, Dict[str, int]]:
        """Per-operator metrics of the last executed query, keyed
        ``"i:NodeName"`` in preorder, at `level` or below (default
        ``spark.rapids.sql.metrics.level``; the reference surfaces these
        as SQLMetrics in the Spark SQL UI)."""
        from .config import METRICS_LEVEL
        from .profiling import metric_level_filter
        snap = getattr(self, "_last_metrics_snapshot", None)
        if snap is None:
            return {}
        lvl = str(level or self._rapids_conf().get(METRICS_LEVEL)).upper()
        return metric_level_filter(snap, lvl)

    def last_sync_ledger(self) -> Dict[str, Dict[str, int]]:
        """Per-operator blocking device→host transfer counts of the last
        query alone ({operator: {kind: count}}), from the audited gate."""
        return {op: dict(kinds)
                for op, kinds in (getattr(self, "_last_sync_ledger", None)
                                  or {}).items()}

    def last_query_profile(self) -> Optional[Dict[str, Any]]:
        """The diagnostics bundle of the last TRACED query
        (spark.rapids.tpu.trace.enabled; docs/observability.md "Bundle
        schema"): span tree, per-operator dispatch and sync counts
        reconciled against ``calls_by_kind`` and the sync ledger, chaos
        and retry events, and — with spark.rapids.tpu.trace.dir set — the
        paths of the Chrome trace and bundle JSON under ['artifacts'].
        None when the last query ran untraced."""
        return getattr(self, "_last_query_profile", None)

    def explain(self, mode: str = "metrics", level: Optional[str] = None
                ) -> str:
        """The LAST executed query's physical plan annotated per node with
        its metric values, dispatch counts and blocking-sync counts (the
        Spark SQL UI analogue). Works with tracing off."""
        if str(mode) != "metrics":
            raise ValueError(
                f"TorchSession.explain supports mode='metrics'; for plan "
                f"shape use DataFrame.explain() (got {mode!r})")
        from .config import METRICS_LEVEL
        from .obs import render_explain_metrics
        lvl = str(level or self._rapids_conf().get(METRICS_LEVEL))
        s = render_explain_metrics(
            getattr(self, "_last_plan_tree", None) or [],
            getattr(self, "_last_metrics_snapshot", None) or {},
            self.last_sync_ledger(), level=lvl)
        print(s)
        return s

    def profiler(self):
        """Context manager running torch.profiler over the enclosed
        queries; the Chrome trace lands under
        spark.rapids.profile.pathPrefix (required) as
        ``<prefix>/rapids-torch-profile-<ns>/trace.json``. On a CUDA
        session it records the device's kernels too, or raises."""
        from .config import PROFILE_PATH_PREFIX
        from .profiling import TorchProfiler
        prefix = self._rapids_conf().get(PROFILE_PATH_PREFIX)
        if not prefix or prefix == "None":
            raise ValueError("set spark.rapids.profile.pathPrefix to profile")
        return TorchProfiler(prefix, self.device)

    def cancel(self) -> int:
        """Cancel this session's queued and running queries: each observes
        its cancel token at its next checkpoint and unwinds, returning its
        permits, budget bytes, spill entries and shuffle blocks. Returns
        how many queries were flagged."""
        from .serving.scheduler import QueryScheduler
        return QueryScheduler.get().cancel_session(self._session_id)

    def stop(self) -> None:
        """Shut this session down (idempotent): cancel and drain its
        queries, drop its per-query state, and — when it was the last live
        session with nothing running — release the shared shuffle
        catalog."""
        if self._stopped:
            return
        self._stopped = True
        from .obs import flight as _flight
        from .serving import scheduler as _sched
        sched = _sched.QueryScheduler.get()
        n = sched.cancel_session(self._session_id, reason="session.stop")
        drained = sched.drain_session(self._session_id, timeout_s=30.0)
        for attr in ("_last_task_metrics", "_last_plan_cache",
                     "_last_opt_rules", "_last_metrics_snapshot",
                     "_last_plan_tree", "_last_sync_ledger",
                     "_last_query_profile"):
            if hasattr(self, attr):
                setattr(self, attr, None)
        _flight.note("session.stop", session=self._session_id,
                     cancelled=n, drained=drained)
        _sched.release_session(self)
        if not _sched.other_live_sessions(self):
            _sched.request_shared_release()

    def __enter__(self) -> "TorchSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def _rows_with_schema(rows: List, schema):
    """Tuples by position under column names, a ``StructType`` or a DDL
    string, as a host table (the schema's types where it has them)."""
    from .columnar.batch import TorchColumnarBatch
    from .types import StructType, parse_ddl
    if isinstance(schema, str):
        schema = parse_ddl(schema)
    names = schema.field_names if isinstance(schema, StructType) \
        else list(schema)
    if not isinstance(schema, StructType):
        return TorchColumnarBatch.from_pylist(
            [dict(zip(names, r)) for r in rows])
    import pyarrow as pa
    from .types import to_arrow
    cols = list(zip(*rows)) if rows else [() for _ in names]
    return TorchColumnarBatch.from_arrow(pa.table(
        {f.name: pa.array(list(c), type=to_arrow(f.data_type))
         for f, c in zip(schema.fields, cols)}))


def _invalidate_cached_plans(key: str, value: Optional[str]) -> None:
    """Conf-change invalidation hook for the scheduler-owned plan cache: a
    plan-relevant key changing drops entries planned under another value
    (no-op before the scheduler exists)."""
    from .serving.scheduler import QueryScheduler
    inst = QueryScheduler.peek()
    if inst is not None:
        inst.plan_cache.invalidate_conf(key, value)
