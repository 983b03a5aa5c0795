"""Logical optimizer, run before ``plan_physical`` (port of the
column-pruning rule of ``spark_rapids_tpu/plan/optimizer.py``).

**columnPruning** — top-down required-column analysis through Project,
Filter, Sort and Aggregate: unreferenced projections and aggregate columns
drop, and an in-memory relation under an aggregate (whose scan yields
full-width batches) gets a pass-through Project, so device batches carry
only the referenced columns.

The reference's other two rules wait for the nodes they rewrite:
pushdown through a ``Repartition`` and the cost-based join swap.

Every rule keeps expression OBJECT identity for unchanged subtrees and the
``expr_id`` of every attribute of a rebuilt node, since
``bind_references`` resolves strictly by expr_id. Nodes a rule created or
modified carry the rule name in ``_opt_rules`` (shown by ``explain()``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Set, Tuple

from ..config import LOGICAL_COLUMN_PRUNING, RapidsConf
from ..expressions.base import AttributeReference
from . import logical as L

RULE_PRUNE = "ColumnPruning"


def _tag(node, rule: str):
    rules = list(getattr(node, "_opt_rules", ()))
    if rule not in rules:
        rules.append(rule)
    node._opt_rules = rules
    return node


def _refs(e) -> Set[int]:
    """expr_ids of every attribute an expression (or SortOrder)
    references."""
    if e is None:
        return set()
    if isinstance(e, L.SortOrder):
        return _refs(e.child)
    return {a.expr_id for a in
            e.collect(lambda x: isinstance(x, AttributeReference))}


def _refs_all(exprs) -> Set[int]:
    out: Set[int] = set()
    for e in exprs:
        out |= _refs(e)
    return out


def _passthrough_project(child: L.LogicalPlan, keep_ids: Set[int],
                         rule: str) -> L.LogicalPlan:
    """Wrap ``child`` in a Project selecting only ``keep_ids`` (child output
    order). Pass-through attributes keep their expr_ids, so ancestors still
    bind."""
    kept = [a for a in child.output if a.expr_id in keep_ids]
    if not kept:
        kept = child.output[:1]
    if len(kept) == len(child.output):
        return child
    return _tag(L.Project(kept, child), rule)


def _rebuild_with_children(plan: L.LogicalPlan, children) -> L.LogicalPlan:
    """Shallow-copy a node with new children, keeping every resolved field
    object-identical (never re-runs __init__, which would mint fresh
    expr_ids)."""
    if all(a is b for a, b in zip(children, plan.children)) \
            and len(children) == len(plan.children):
        return plan
    new = copy.copy(plan)
    new.children = tuple(children)
    return new


def _prune(plan: L.LogicalPlan, required: Optional[Set[int]],
           applied: Set[str]) -> L.LogicalPlan:
    """required=None means "every output column" (the query root, or a
    parent we cannot analyze)."""
    if isinstance(plan, L.Project):
        if required is None:
            kept_ix = list(range(len(plan.exprs)))
        else:
            kept_ix = [i for i, a in enumerate(plan._output)
                       if a.expr_id in required] or [0]
        kept_exprs = [plan.exprs[i] for i in kept_ix]
        child = _prune(plan.child, _refs_all(kept_exprs), applied)
        if len(kept_ix) == len(plan.exprs):
            return _rebuild_with_children(plan, (child,))
        new = object.__new__(L.Project)
        new.children = (child,)
        new.exprs = kept_exprs
        new._output = [plan._output[i] for i in kept_ix]
        applied.add(RULE_PRUNE)
        return _tag(new, RULE_PRUNE)

    if isinstance(plan, L.Filter):
        need = None if required is None \
            else (required | _refs(plan.condition))
        return _rebuild_with_children(plan,
                                      (_prune(plan.child, need, applied),))

    if isinstance(plan, L.Sort):
        need = None if required is None \
            else (required | _refs_all(plan.order))
        return _rebuild_with_children(
            plan, (_prune(plan.children[0], need, applied),))

    if isinstance(plan, L.Aggregate):
        n_group = len(plan.grouping)
        if required is None:
            kept_ix = list(range(len(plan.aggregates)))
        else:
            # grouping columns always stay (they define the groups and lead
            # the output); unreferenced aggregate columns drop
            kept_ix = [i for i in range(len(plan.aggregates))
                       if plan._output[n_group + i].expr_id in required]
            if not kept_ix and not plan.grouping:
                kept_ix = [0]
        kept_aggs = [plan.aggregates[i] for i in kept_ix]
        need = _refs_all(plan.grouping) | _refs_all(kept_aggs)
        child = _prune(plan.children[0], need, applied)
        if need and any(a.expr_id not in need for a in child.output):
            child = _passthrough_project(child, need, RULE_PRUNE)
            applied.add(RULE_PRUNE)
        if len(kept_ix) == len(plan.aggregates):
            return _rebuild_with_children(plan, (child,))
        new = object.__new__(L.Aggregate)
        new.children = (child,)
        new.grouping = plan.grouping
        new.aggregates = kept_aggs
        new._output = (plan._output[:n_group]
                       + [plan._output[n_group + i] for i in kept_ix])
        applied.add(RULE_PRUNE)
        return _tag(new, RULE_PRUNE)

    # relations and unknown nodes: no pruning below; a wrapping Aggregate
    # projects their output down instead
    return plan


def optimize_logical(plan: L.LogicalPlan,
                     conf: RapidsConf) -> Tuple[L.LogicalPlan, List[str]]:
    """Run the enabled rules; returns (optimized plan, applied rule
    names). A disabled or no-op pipeline returns the input plan."""
    applied: Set[str] = set()
    if conf.get(LOGICAL_COLUMN_PRUNING):
        plan = _prune(plan, None, applied)
    return plan, sorted(applied)


def explain_logical(plan: L.LogicalPlan, indent: int = 0) -> str:
    """tree_string with per-node optimizer-rule annotations."""
    desc = plan.node_desc()
    rules = getattr(plan, "_opt_rules", ())
    if rules:
        desc += f"  [rules: {', '.join(rules)}]"
    lines = ["  " * indent + desc]
    for c in plan.children:
        lines.append(explain_logical(c, indent + 1))
    return "\n".join(lines)
