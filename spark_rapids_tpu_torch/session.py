"""User-facing session + DataFrame API (a subset of
``spark_rapids_tpu/session.py``).

Execution, as in the reference: logical plan → optimizer (join swap,
column pruning) → planner (CPU physical plan) → ``TorchOverrides``
(retarget to the device, transitions, compiled join and aggregation
stages) → partition loop, run directly by ``DataFrame.collect``. The reference's scheduler (admission,
deadlines, plan cache) comes in a later slice.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Union

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

    def like(self, pattern: str) -> "Column":
        from .expressions.strings import Like
        return Column(Like(self._expr, pattern))

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


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: "TorchSession"):
        self._plan = plan
        self.session = session

    def __getitem__(self, name: str) -> Column:
        """A resolved reference to one of this frame's columns (it keeps
        naming this frame's column through a join)."""
        return Column(self._plan.resolve_name(name))

    @property
    def columns(self) -> List[str]:
        return [a.name for a in self._plan.output]

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self.session)

    def select(self, *cols) -> "DataFrame":
        """Columns by name, or Column expressions (``alias`` names
        them)."""
        exprs = [UnresolvedAttribute(c) if isinstance(c, str) else _expr(c)
                 for c in cols]
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
        join on the condition, and with ``on=None`` a cross join."""
        if on is None:
            return DataFrame(L.Join(self._plan, other._plan,
                                    "cross" if how == "inner" else how),
                             self.session)
        if isinstance(on, (str, list, tuple)):
            raise NotImplementedError(
                "join on column names not yet ported: pass a Column "
                "condition")
        left, right = self._plan, other._plan
        lk, rk, residual = _extract_equi_keys(_expr(on), left, right)
        lk, rk = _coerce_join_keys(lk, rk)
        return DataFrame(L.Join(left, right, how, lk, rk, residual),
                         self.session)

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
        return DataFrame(DeviceCachedRelation(self.session._execute_batches(
            self._plan, on_device=True), self._plan.output), self.session)

    def collect(self) -> List[Dict[str, Any]]:
        """Execute and fetch all rows as dicts (the reference's shape)."""
        rows: List[Dict[str, Any]] = []
        names = self.columns
        for b in self.session._execute_batches(self._plan):
            rows.extend(b.rename(names).to_pylist())
        return rows

    def explain(self) -> str:
        """The applied optimizer rules, the optimized logical plan and the
        physical plan ('*' marks device operators), as the reference prints
        them (its ``planCache=`` line waits with the scheduler)."""
        from .plan.optimizer import explain_logical, optimize_logical
        conf = self.session._rapids_conf()
        optimized, rules = optimize_logical(self._plan, conf)
        lines = []
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
        ta, tb = a.dtype, b.dtype
        if isinstance(ta, DecimalType) or isinstance(tb, DecimalType):
            if repr(ta) != repr(tb):
                raise ValueError(f"join key type mismatch {ta} vs {tb}: "
                                 "cast one side explicitly")
            out_l.append(a)
            out_r.append(b)
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
    def __init__(self, df: DataFrame, keys: List[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs) -> DataFrame:
        node = L.Aggregate(self._keys, [_expr(a) for a in aggs],
                           self._df._plan)
        return DataFrame(node, self._df.session)


class TorchSession:
    """The SparkSession analogue on one torch device: ``cuda`` unless the
    caller passes ``device="cpu"``. ``counters`` counts the session's
    runtime events: ``fallback_runs`` (a compiled aggregation stage re-ran
    on the general path), ``fallbackReruns`` (a compiled join stage did),
    ``sort_fallback_runs`` (a grouped aggregate sorted out of core), and
    the parquet scan's ``fallback_columns``, ``fallback_row_groups`` and
    ``fallback_files`` (demotions to the host decode) and ``scan.*`` time
    split (``io/parquet.TorchFileScanExec``)."""

    def __init__(self, conf: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self._settings: Dict[str, str] = {k: str(v)
                                          for k, v in (conf or {}).items()}
        self.device = resolve_device(device)
        self.counters: Counter = Counter()

    def _rapids_conf(self) -> RapidsConf:
        return RapidsConf(self._settings)

    @property
    def read(self):
        """A ``DataFrameReader``: ``read.parquet(path)``."""
        from .io.reader import DataFrameReader
        return DataFrameReader(self)

    def createDataFrame(self, data, num_partitions: int = 1,
                        validity=None) -> DataFrame:
        """From a dict of numpy arrays, lists or ``HostStrings`` (with an
        optional dict of bool ``validity`` arrays), a list of dicts, or a
        ``pyarrow.Table``."""
        from .columnar.batch import TorchColumnarBatch
        if isinstance(data, dict):
            table = TorchColumnarBatch.from_numpy_columns(data, validity)
        elif isinstance(data, list) and data and isinstance(data[0], dict):
            table = TorchColumnarBatch.from_pylist(data)
        elif type(data).__module__.startswith("pyarrow"):
            table = TorchColumnarBatch.from_arrow(data)
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(L.LocalRelation(table, num_partitions), self)

    def _final_plan(self, optimized: L.LogicalPlan, conf: RapidsConf):
        from .plan.overrides import TorchOverrides
        from .plan.planner import plan_physical
        return TorchOverrides.apply(plan_physical(optimized, conf), conf)

    def _execute_batches(self, plan: L.LogicalPlan,
                         on_device: bool = False) -> List:
        """Run a query: host batches, or with ``on_device`` the device
        batches under the final download."""
        from .execs.base import TaskContext
        from .execs.transitions import DeviceToHostExec, HostToDeviceExec
        from .plan.optimizer import optimize_logical
        conf = self._rapids_conf()
        final = self._final_plan(optimize_logical(plan, conf)[0], conf)
        if on_device:
            while isinstance(final, DeviceToHostExec):
                final = final.children[0]
            if not final.is_tpu:  # a host plan (e.g. a bare table): upload
                final = HostToDeviceExec(final)
        out = []
        try:
            for p in range(final.num_partitions()):
                out.extend(final.execute_partition(
                    p, TaskContext(p, conf, self.device, self.counters)))
        finally:
            # the query's shuffle blocks leave the device with it
            for node in final.collect_nodes():
                if hasattr(node, "cleanup_shuffle"):
                    node.cleanup_shuffle()
        return out
