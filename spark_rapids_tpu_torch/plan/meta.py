"""Meta/tagging framework: wraps each physical node and expression with its
conversion state and its reasons for staying on the CPU.

Port of ``spark_rapids_tpu/plan/meta.py``. The meta tree is built over the
CPU physical plan; ``tag_for_tpu`` records reasons; ``convert_if_needed``
produces the device plan where possible and keeps CPU subtrees otherwise
(per-operator fallback). The reason strings are the reference's, word for
word, so ``explain_fallback()`` reads the same in both packages.
"""

from __future__ import annotations

from typing import List, Sequence

from ..config import RapidsConf
from ..expressions.base import Expression
from .typechecks import (conf_gate_reason, decimal_input_reason,
                         expr_sig_for, is_expr_registered)


class RapidsMeta:
    def __init__(self, conf: RapidsConf):
        self.conf = conf
        self.reasons: List[str] = []

    def will_not_work_on_tpu(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_this_be_replaced(self) -> bool:
        return not self.reasons


class ExprMeta(RapidsMeta):
    """Per-expression meta (reference BaseExprMeta)."""

    def __init__(self, expr: Expression, conf: RapidsConf, parent=None):
        super().__init__(conf)
        self.expr = expr
        self.parent = parent
        self.child_exprs = [ExprMeta(c, conf, self) for c in expr.children]

    def tag_for_tpu(self) -> None:
        e = self.expr
        if not is_expr_registered(type(e)):
            self.will_not_work_on_tpu(
                f"expression {type(e).__name__} is not supported on TPU")
        else:
            sig = expr_sig_for(type(e))
            if sig is not None:
                try:
                    r = sig.check(e.dtype)
                except NotImplementedError:
                    r = None
                if r is not None:
                    self.will_not_work_on_tpu(
                        f"expression {type(e).__name__} produces an "
                        f"unsupported type: {r}")
            if not getattr(e, "tpu_supported", True):
                why = getattr(e, "tpu_unsupported_reason", None)
                self.will_not_work_on_tpu(
                    f"expression {type(e).__name__} is disabled on TPU"
                    + (f": {why}" if why else ""))
            key = f"spark.rapids.sql.expression.{type(e).__name__}"
            if not self.conf.is_op_enabled(key, True):
                self.will_not_work_on_tpu(
                    f"expression {type(e).__name__} has been disabled via "
                    f"{key}")
            gate = conf_gate_reason(e, self.conf)
            if gate:
                self.will_not_work_on_tpu(gate)
            dec = decimal_input_reason(e)
            if dec:
                self.will_not_work_on_tpu(dec)
        for c in self.child_exprs:
            c.tag_for_tpu()

    @property
    def can_expr_tree_be_replaced(self) -> bool:
        return self.can_this_be_replaced and all(
            c.can_expr_tree_be_replaced for c in self.child_exprs)

    def collect_reasons(self, out: List[str]) -> None:
        for r in self.reasons:
            out.append(f"@Expression {self.expr.pretty()}: {r}")
        for c in self.child_exprs:
            c.collect_reasons(out)


class PlanMeta(RapidsMeta):
    """Per-operator meta (reference SparkPlanMeta)."""

    def __init__(self, plan, conf: RapidsConf, rule=None, parent=None):
        super().__init__(conf)
        self.plan = plan
        self.rule = rule
        self.parent = parent
        self.child_plans: List["PlanMeta"] = []
        self.expr_metas: List[ExprMeta] = []
        self.converted = None  # set by convert_if_needed

    def add_exprs(self, exprs: Sequence[Expression]) -> None:
        self.expr_metas.extend(ExprMeta(e, self.conf, self) for e in exprs)

    def tag_for_tpu(self) -> None:
        if self.rule is None:
            self.will_not_work_on_tpu(
                f"no TPU replacement rule for {type(self.plan).__name__}")
        else:
            self.rule.tag(self)
        for em in self.expr_metas:
            em.tag_for_tpu()
            if not em.can_expr_tree_be_replaced:
                inner: List[str] = []
                em.collect_reasons(inner)
                for r in inner:
                    self.will_not_work_on_tpu(r)
        for c in self.child_plans:
            c.tag_for_tpu()

    def convert_if_needed(self):
        converted_children = [c.convert_if_needed() for c in self.child_plans]
        if self.can_this_be_replaced and self.rule is not None:
            self.converted = self.rule.convert(self, converted_children)
            return self.converted
        # stay on the CPU: a CPU node needs CPU children, so every converted
        # child is downloaded through a transition
        from ..execs.transitions import DeviceToHostExec
        new_children = [DeviceToHostExec(conv) if conv.is_tpu else conv
                        for conv in converted_children]
        if all(a is b.plan for a, b in zip(self.plan.children,
                                            self.child_plans)) \
                and not any(c.is_tpu for c in converted_children):
            self.converted = self.plan
        else:
            self.converted = _rewire(self.plan, new_children)
        # why it stays on the host (test mode admits the tagged decimal
        # host-only operators)
        self.converted.tagged_reasons = list(self.reasons)
        return self.converted

    def collect_fallback_reasons(self, out: List[str]) -> None:
        for r in self.reasons:
            out.append(f"!Exec {type(self.plan).__name__} cannot run on TPU: "
                       f"{r}")
        for c in self.child_plans:
            c.collect_fallback_reasons(out)


def _rewire(plan, new_children):
    import copy
    new = copy.copy(plan)
    new.children = list(new_children)
    return new
