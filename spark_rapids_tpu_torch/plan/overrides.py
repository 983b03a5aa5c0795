"""TorchOverrides: the plan-override engine retargeting CPU operators to
the device (port of the engine and the Project/Filter/range/device-scan/
file-scan/sort/aggregate/join (hash, nested loop, cartesian)/exchange
(hash, round robin, coalesce, single)/TopN/limit/union/window/expand/
sample/data-writing-command rules of ``spark_rapids_tpu/plan/overrides.py``).

Flow: CPU physical plan → wrap in a PlanMeta tree → tag (reasons) →
convert supported subtrees to device execs → insert HostToDevice /
DeviceToHost at the boundaries → compiled join stages → compiled
aggregation stages. Explain and
fallback reporting (``spark.rapids.sql.explain``) and the explainOnly mode
are the reference's. Later slices add their operators with
``register_exec``. A ``df.cache()`` scan (``CpuCachedScanExec``) stays on
the host, as the local table scan does, and a transition uploads its
output. Segment fusion (``execs/fusion.py``) and batch coalescing
(``execs/coalesce.py``) are not yet ported.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

from ..config import (EXPLAIN, OPTIMIZER_ENABLED, SQL_ENABLED,
                      TEST_ASSERT_ON_TPU, RapidsConf)
from ..execs import basic as TB
from ..execs import cpu as CE
from ..execs.aggregates import CpuHashAggregateExec
from ..execs.base import CpuExec, PhysicalPlan
from ..execs.broadcast import CpuBroadcastHashJoinExec
from ..execs.sample import CpuSampleExec
from ..execs.write import CpuDataWritingCommandExec
from ..execs.joins import (CpuBroadcastNestedLoopJoinExec,
                           CpuCartesianProductExec, CpuShuffledHashJoinExec)
from ..execs.transitions import (CpuDeviceScanExec, DeviceToHostExec,
                                 HostToDeviceExec)
from ..io.parquet import CpuFileScanExec
from ..shuffle.exchange import CpuShuffleExchangeExec
from .meta import PlanMeta

log = logging.getLogger("spark_rapids_tpu_torch")


class ExecRule:
    """Replacement rule for one CPU exec class."""

    def __init__(self, cpu_cls: type, desc: str, conf_key: str,
                 tag: Callable[[PlanMeta], None],
                 convert: Callable[[PlanMeta, List[PhysicalPlan]],
                                   PhysicalPlan]):
        self.cpu_cls = cpu_cls
        self.desc = desc
        self.conf_key = conf_key
        self._tag = tag
        self._convert = convert

    def tag(self, meta: PlanMeta) -> None:
        if not meta.conf.is_op_enabled(self.conf_key, True):
            meta.will_not_work_on_tpu(f"disabled via {self.conf_key}")
        self._tag(meta)

    def convert(self, meta: PlanMeta,
                children: List[PhysicalPlan]) -> PhysicalPlan:
        return self._convert(meta, [ensure_device(c) for c in children])


def ensure_device(plan: PhysicalPlan) -> PhysicalPlan:
    return plan if plan.is_tpu else HostToDeviceExec(plan)


def ensure_host(plan: PhysicalPlan) -> PhysicalPlan:
    return DeviceToHostExec(plan) if plan.is_tpu else plan


_EXEC_RULES: Dict[type, ExecRule] = {}


def register_exec(cpu_cls: type, desc: str, conf_key: str, tag=None,
                  convert=None) -> None:
    _EXEC_RULES[cpu_cls] = ExecRule(cpu_cls, desc, conf_key,
                                    tag or (lambda m: None), convert)


def exec_rules() -> Dict[type, ExecRule]:
    return dict(_EXEC_RULES)


# ---------------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------------


def _tag_project(meta: PlanMeta) -> None:
    meta.add_exprs(meta.plan.exprs)


def _convert_project(meta: PlanMeta, children):
    p = meta.plan
    return TB.TorchProjectExec(p.exprs, children[0], p.output)


def _tag_filter(meta: PlanMeta) -> None:
    meta.add_exprs([meta.plan.condition])


def _convert_filter(meta: PlanMeta, children):
    return TB.TorchFilterExec(meta.plan.condition, children[0])


def _convert_device_scan(meta: PlanMeta, children):
    from ..execs.transitions import TorchDeviceScanExec
    return TorchDeviceScanExec(meta.plan.batches, meta.plan.output)


def _tag_keys(meta: PlanMeta, what: str, exprs) -> None:
    from .typechecks import decimal_key_reason
    why = decimal_key_reason(what, exprs)
    if why:
        meta.will_not_work_on_tpu(why)


def _tag_sort(meta: PlanMeta) -> None:
    meta.add_exprs([o.child for o in meta.plan.order])
    _tag_keys(meta, "sort", [o.child for o in meta.plan.order])


def _convert_sort(meta: PlanMeta, children):
    from ..execs.sort import TorchSortExec
    return TorchSortExec(meta.plan.order, meta.plan.global_sort, children[0])


def _tag_aggregate(meta: PlanMeta) -> None:
    from ..execs.aggregates import split_result_exprs
    from ..expressions.aggregates import VARIANCE_OPS
    from .typechecks import conf_gate_reason
    p = meta.plan
    meta.add_exprs(p.grouping)
    _tag_keys(meta, "group", p.grouping)
    agg_fns, result_exprs = split_result_exprs(p.aggregates)
    for fn in agg_fns:
        if fn.update_op not in ("sum", "count", "min", "max", "avg",
                                "first", "last") \
                and fn.update_op not in VARIANCE_OPS:
            meta.will_not_work_on_tpu(
                f"aggregate {type(fn).__name__} is not supported on TPU")
        gate = conf_gate_reason(fn, meta.conf)
        if gate:
            meta.will_not_work_on_tpu(gate)
        for c in fn.children:
            meta.add_exprs([c])
    meta.add_exprs(result_exprs)


def _convert_aggregate(meta: PlanMeta, children):
    from ..execs.aggregates import TorchHashAggregateExec
    p = meta.plan
    return TorchHashAggregateExec(p.grouping, p.aggregates, children[0],
                                  p.output, per_partition=p.per_partition)


def _tag_hash_join(meta: PlanMeta) -> None:
    p = meta.plan
    meta.add_exprs(p.left_keys)
    meta.add_exprs(p.right_keys)
    _tag_keys(meta, "join", list(p.left_keys) + list(p.right_keys))
    if p.condition is not None:
        meta.add_exprs([p.condition])


def _convert_hash_join(meta: PlanMeta, children):
    from ..config import SYMMETRIC_JOIN_ENABLED
    from ..execs.joins import (_MIRROR_JOIN, TorchShuffledHashJoinExec,
                               TorchShuffledSymmetricHashJoinExec)
    p = meta.plan
    cls = TorchShuffledSymmetricHashJoinExec \
        if meta.conf.get(SYMMETRIC_JOIN_ENABLED) \
        and p.join_type in _MIRROR_JOIN else TorchShuffledHashJoinExec
    return cls(children[0], children[1], p.join_type, p.left_keys,
               p.right_keys, p.condition, p.output,
               per_partition=p.per_partition)


def _convert_broadcast_join(meta: PlanMeta, children):
    from ..execs.broadcast import TorchBroadcastHashJoinExec
    p = meta.plan
    return TorchBroadcastHashJoinExec(children[0], children[1], p.join_type,
                                      p.left_keys, p.right_keys, p.condition,
                                      p.output)


def _tag_nested_loop_join(meta: PlanMeta) -> None:
    if meta.plan.condition is not None:
        meta.add_exprs([meta.plan.condition])


def _convert_nested_loop_join(meta: PlanMeta, children):
    from ..execs.joins import TorchBroadcastNestedLoopJoinExec
    p = meta.plan
    return TorchBroadcastNestedLoopJoinExec(children[0], children[1],
                                            p.join_type, p.condition,
                                            p.output)


def _convert_cartesian(meta: PlanMeta, children):
    from ..execs.joins import TorchCartesianProductExec
    p = meta.plan
    return TorchCartesianProductExec(children[0], children[1], p.condition,
                                     p.output)


def _tag_exchange(meta: PlanMeta) -> None:
    meta.add_exprs(meta.plan.keys)
    _tag_keys(meta, "partition", meta.plan.keys)


def _convert_exchange(meta: PlanMeta, children):
    from ..config import AQE_COALESCE_ENABLED, AQE_SKEW_JOIN_ENABLED
    from ..shuffle.exchange import TorchShuffleExchangeExec
    for entry in (AQE_COALESCE_ENABLED, AQE_SKEW_JOIN_ENABLED):
        if meta.conf.get(entry):
            raise NotImplementedError(
                f"AQE shuffle readers not yet ported ({entry.key}=true)")
    p = meta.plan
    return TorchShuffleExchangeExec(children[0], p.partitioning, p.keys,
                                    p.num_partitions())


def _tag_top_n(meta: PlanMeta) -> None:
    meta.add_exprs([o.child for o in meta.plan.order])
    _tag_keys(meta, "sort", [o.child for o in meta.plan.order])


def _convert_top_n(meta: PlanMeta, children):
    from ..execs.sort import TorchTopNExec
    p = meta.plan
    return TorchTopNExec(p.n, p.order, children[0], p.offset)


def _tag_file_scan(meta: PlanMeta) -> None:
    # the planner already refused column types the port cannot carry
    from ..config import CSV_ENABLED, JSON_ENABLED, ORC_ENABLED, \
        PARQUET_ENABLED
    entry = {"parquet": PARQUET_ENABLED, "csv": CSV_ENABLED,
             "json": JSON_ENABLED, "orc": ORC_ENABLED}.get(meta.plan.fmt)
    if entry is not None and not meta.conf.get(entry):
        meta.will_not_work_on_tpu(
            f"{meta.plan.fmt} scans disabled via {entry.key}")


def _convert_file_scan(meta: PlanMeta, children):
    from ..io.parquet import TorchFileScanExec
    p = meta.plan
    return TorchFileScanExec(p.paths, p.fmt, p.output,
                             pushed_filters=p.pushed_filters,
                             options=p.options,
                             num_partitions=p.num_partitions())


def _convert_range(meta: PlanMeta, children):
    p = meta.plan
    return TB.TorchRangeExec(p.start, p.end, p.step, p.num_partitions(),
                             p.output)


def _convert_sample(meta: PlanMeta, children):
    from ..execs.sample import TorchSampleExec
    p = meta.plan
    return TorchSampleExec(p.fraction, p.with_replacement, p.seed,
                           children[0])


def _tag_write(meta: PlanMeta) -> None:
    from ..config import ORC_WRITE_ENABLED, PARQUET_WRITE_ENABLED
    fmt = meta.plan.spec.fmt
    entry = {"parquet": PARQUET_WRITE_ENABLED,
             "orc": ORC_WRITE_ENABLED}.get(fmt)
    if entry is not None and not meta.conf.get(entry):
        meta.will_not_work_on_tpu(f"{fmt} writes disabled via {entry.key}")


def _convert_write(meta: PlanMeta, children):
    from ..execs.write import TorchDataWritingCommandExec
    return TorchDataWritingCommandExec(children[0], meta.plan.spec)


def _tag_window(meta: PlanMeta) -> None:
    from ..execs.window import DEVICE_AGGREGATES, DEVICE_FUNCTIONS
    from ..expressions.aggregates import AggregateFunction
    from ..types import BinaryType, DecimalType, StringType
    from ..window import Lag, Lead

    def is_string(e) -> bool:
        return isinstance(e.dtype, (StringType, BinaryType))

    for we in meta.plan.window_exprs:
        fn = we.function
        name = type(fn).__name__
        if any(isinstance(e.dtype, DecimalType) and e.dtype.wide for e in
               tuple(we.spec.partition_by)
               + tuple(o.child for o in we.spec.order_by)):
            # the card sorts and segments by one-lane keys; the reference
            # has no device key for a two-limb decimal either
            meta.will_not_work_on_tpu(
                f"window function {name} partitioned or ordered by a "
                "decimal128 key is not supported on TPU (decimal128 keys "
                "not yet ported, ROADMAP A6)")
        if isinstance(fn, AggregateFunction):
            if fn.update_op not in DEVICE_AGGREGATES:
                # collect_list / collect_set over a window, among others
                meta.will_not_work_on_tpu(
                    f"window aggregate {name} is not supported "
                    "on TPU (not yet ported)")
            elif fn.update_op in ("sum", "avg") and any(map(is_string,
                                                            fn.children)):
                # Spark casts a string to double for sum/avg; the window
                # exec has no string-to-double cast of its input
                meta.will_not_work_on_tpu(
                    f"window aggregate {name} of a string is not "
                    "supported on TPU (not yet ported)")
            meta.add_exprs(fn.children)
        elif not isinstance(fn, DEVICE_FUNCTIONS):
            meta.will_not_work_on_tpu(
                f"window function {name} not supported on TPU")
        elif isinstance(fn, (Lead, Lag)):
            meta.add_exprs(fn.children)
        meta.add_exprs(we.spec.partition_by)
        meta.add_exprs([o.child for o in we.spec.order_by])


def _convert_window(meta: PlanMeta, children):
    from ..execs.window import TorchWindowExec
    return TorchWindowExec(meta.plan.window_exprs, children[0],
                           meta.plan.output)


def _tag_expand(meta: PlanMeta) -> None:
    for proj in meta.plan.projections:
        meta.add_exprs(proj)


def _convert_expand(meta: PlanMeta, children):
    from ..execs.generate import TorchExpandExec
    return TorchExpandExec(meta.plan.projections, children[0],
                           meta.plan.output)


register_exec(CE.CpuProjectExec, "projection",
              "spark.rapids.sql.exec.ProjectExec", _tag_project,
              _convert_project)
register_exec(CE.CpuFilterExec, "filter", "spark.rapids.sql.exec.FilterExec",
              _tag_filter, _convert_filter)
register_exec(CE.CpuRangeExec, "range", "spark.rapids.sql.exec.RangeExec",
              None, _convert_range)
register_exec(CpuSampleExec, "sample", "spark.rapids.sql.exec.SampleExec",
              None, _convert_sample)
register_exec(CpuDataWritingCommandExec, "data writing command",
              "spark.rapids.sql.exec.DataWritingCommandExec", _tag_write,
              _convert_write)
register_exec(CpuDeviceScanExec, "device-cached scan",
              "spark.rapids.sql.exec.InMemoryTableScanExec", None,
              _convert_device_scan)
register_exec(CE.CpuSortExec, "sort", "spark.rapids.sql.exec.SortExec",
              _tag_sort, _convert_sort)
register_exec(CpuHashAggregateExec, "hash aggregate",
              "spark.rapids.sql.exec.HashAggregateExec", _tag_aggregate,
              _convert_aggregate)
register_exec(CpuShuffledHashJoinExec, "shuffled hash join",
              "spark.rapids.sql.exec.ShuffledHashJoinExec", _tag_hash_join,
              _convert_hash_join)
register_exec(CpuBroadcastHashJoinExec, "broadcast hash join",
              "spark.rapids.sql.exec.BroadcastHashJoinExec", _tag_hash_join,
              _convert_broadcast_join)
register_exec(CpuBroadcastNestedLoopJoinExec, "broadcast nested loop join",
              "spark.rapids.sql.exec.BroadcastNestedLoopJoinExec",
              _tag_nested_loop_join, _convert_nested_loop_join)
register_exec(CpuCartesianProductExec, "cartesian product",
              "spark.rapids.sql.exec.CartesianProductExec",
              _tag_nested_loop_join, _convert_cartesian)
register_exec(CpuShuffleExchangeExec, "shuffle exchange",
              "spark.rapids.sql.exec.ShuffleExchangeExec", _tag_exchange,
              _convert_exchange)
register_exec(CpuFileScanExec, "file scan",
              "spark.rapids.sql.exec.FileSourceScanExec", _tag_file_scan,
              _convert_file_scan)
register_exec(CE.CpuTopNExec, "top-N (sort+limit fusion)",
              "spark.rapids.sql.exec.TakeOrderedAndProjectExec", _tag_top_n,
              _convert_top_n)
register_exec(CE.CpuUnionExec, "union", "spark.rapids.sql.exec.UnionExec",
              None, lambda m, ch: TB.TorchUnionExec(ch, m.plan.output))
register_exec(CE.CpuWindowExec, "window", "spark.rapids.sql.exec.WindowExec",
              _tag_window, _convert_window)
register_exec(CE.CpuExpandExec, "expand", "spark.rapids.sql.exec.ExpandExec",
              _tag_expand, _convert_expand)
register_exec(CE.CpuLocalLimitExec, "local limit",
              "spark.rapids.sql.exec.LocalLimitExec", None,
              lambda m, ch: TB.TorchLocalLimitExec(m.plan.n, ch[0]))
register_exec(CE.CpuGlobalLimitExec, "global limit",
              "spark.rapids.sql.exec.GlobalLimitExec", None,
              lambda m, ch: TB.TorchGlobalLimitExec(m.plan.n, ch[0],
                                                    m.plan.offset))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def wrap_and_tag_plan(plan: PhysicalPlan, conf: RapidsConf) -> PlanMeta:
    """Wrap a CPU plan in its meta tree (reference wrapAndTagPlan)."""
    meta = PlanMeta(plan, conf, _EXEC_RULES.get(type(plan)))
    meta.child_plans = [wrap_and_tag_plan(c, conf) for c in plan.children]
    for cm in meta.child_plans:
        cm.parent = meta
    return meta


class TorchOverrides:
    """Reference TpuOverrides (GpuOverrides.apply)."""

    @staticmethod
    def apply(plan: PhysicalPlan, conf: RapidsConf) -> PhysicalPlan:
        if not conf.get(SQL_ENABLED):
            return plan
        meta = wrap_and_tag_plan(plan, conf)
        meta.tag_for_tpu()
        if conf.get(OPTIMIZER_ENABLED):
            raise NotImplementedError(
                f"CBO not yet ported ({OPTIMIZER_ENABLED.key}=true)")
        if str(conf.get(EXPLAIN)).upper() in ("NOT_ON_TPU", "ALL"):
            reasons: List[str] = []
            meta.collect_fallback_reasons(reasons)
            for r in reasons:
                log.info(r)
        if conf.explain_only:
            return plan  # report only: the CPU plan stands
        converted = meta.convert_if_needed()
        final = TorchTransitionOverrides.apply(converted, conf)
        from ..execs.compiled import compile_agg_stages
        from ..execs.compiled_join import compile_join_agg_stages
        # join stages first: a join pipeline gets the fused star-join stage
        return compile_agg_stages(compile_join_agg_stages(final, conf), conf)

    @staticmethod
    def explain_plan(plan: PhysicalPlan, conf: RapidsConf) -> str:
        """What would not run on the device, and why (reference
        ExplainPlan.explainCatalystSQLPlan)."""
        meta = wrap_and_tag_plan(plan, conf)
        meta.tag_for_tpu()
        reasons: List[str] = []
        meta.collect_fallback_reasons(reasons)
        if not reasons:
            return "The whole plan can run on the TPU"
        return "\n".join(reasons)


class TorchTransitionOverrides:
    """Final boundary fixups + the everything-on-the-device test assertion
    (reference GpuTransitionOverrides)."""

    @staticmethod
    def apply(plan: PhysicalPlan, conf: RapidsConf) -> PhysicalPlan:
        plan = ensure_host(_collapse_transitions(plan))  # rows end on host
        if conf.get(TEST_ASSERT_ON_TPU):
            TorchTransitionOverrides.assert_is_on_tpu(plan)
        return plan

    @staticmethod
    def assert_is_on_tpu(plan: PhysicalPlan) -> None:
        allowed_cpu = (DeviceToHostExec, HostToDeviceExec,
                       CE.CpuLocalTableScanExec, CE.CpuCachedScanExec)
        for node in plan.collect_nodes():
            if isinstance(node, CpuExec) and not isinstance(node, allowed_cpu):
                raise AssertionError(
                    f"Part of the plan is not columnar: {node.node_desc()}\n"
                    + plan.tree_string())


def _collapse_transitions(plan: PhysicalPlan) -> PhysicalPlan:
    """Remove HostToDevice(DeviceToHost(x)) → x and vice versa."""
    new_children = [_collapse_transitions(c) for c in plan.children]
    if isinstance(plan, HostToDeviceExec) \
            and isinstance(new_children[0], DeviceToHostExec):
        return new_children[0].children[0]
    if isinstance(plan, DeviceToHostExec) \
            and isinstance(new_children[0], HostToDeviceExec):
        return new_children[0].children[0]
    if all(a is b for a, b in zip(new_children, plan.children)):
        return plan
    import copy
    new = copy.copy(plan)
    new.children = new_children
    return new
