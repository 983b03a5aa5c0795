"""Logical optimizer, run before ``plan_physical`` (port of the
cost-based join swap and the column-pruning rule of
``spark_rapids_tpu/plan/optimizer.py``).

**joinStrategy** — an inner equi-join whose right (build) side is
estimated larger than its left by ``joinStrategy.swapRatio``
(``plan/cbo.py``) swaps its inputs, so the smaller side is built or
broadcast; a restoring Project keeps the original column order.

**columnPruning** — top-down required-column analysis through Project,
Filter, Limit, Sort, Aggregate and Join: unreferenced projections and
aggregate columns drop, and an in-memory relation under an aggregate or a
join (whose scan yields full-width batches) gets a pass-through Project,
so device batches carry only the referenced columns.

The reference's third rule, pushdown through a ``Repartition``, waits for
the node it rewrites.

Every rule keeps expression OBJECT identity for unchanged subtrees and the
``expr_id`` of every attribute of a rebuilt node, since
``bind_references`` resolves strictly by expr_id. Nodes a rule created or
modified carry the rule name in ``_opt_rules`` (shown by ``explain()``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Set, Tuple

from ..config import (LOGICAL_COLUMN_PRUNING, LOGICAL_JOIN_STRATEGY,
                      LOGICAL_JOIN_SWAP_RATIO, RapidsConf)
from ..expressions.base import AttributeReference
from . import logical as L

RULE_PRUNE = "ColumnPruning"
RULE_JOIN = "CostBasedJoin"


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


def _join_swap(plan: L.LogicalPlan, conf: RapidsConf,
               applied: Set[str]) -> L.LogicalPlan:
    children = [_join_swap(c, conf, applied) for c in plan.children]
    plan = _rebuild_with_children(plan, children)
    if not (isinstance(plan, L.Join) and plan.join_type == "inner"
            and plan.left_keys and not getattr(plan, "_opt_swapped", False)):
        return plan
    from .cbo import estimate_logical_bytes
    est_l = estimate_logical_bytes(plan.left)
    est_r = estimate_logical_bytes(plan.right)
    ratio = conf.get(LOGICAL_JOIN_SWAP_RATIO)
    if est_l is None or est_r is None or est_r <= est_l * ratio:
        return plan
    # the keys and condition are resolved: the constructor keeps the same
    # expression objects, and the restoring Project keeps the original
    # output attributes (and their order) for the parent
    original = plan.output
    swapped = L.Join(plan.right, plan.left, "inner", plan.right_keys,
                     plan.left_keys, plan.condition)
    swapped._opt_swapped = True
    _tag(swapped, RULE_JOIN)
    applied.add(RULE_JOIN)
    return _tag(L.Project(original, swapped), RULE_JOIN)


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

    if isinstance(plan, L.Limit):
        return _rebuild_with_children(
            plan, (_prune(plan.children[0], required, applied),))

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

    if isinstance(plan, L.Join):
        key_cond = (_refs_all(plan.left_keys) | _refs_all(plan.right_keys)
                    | _refs(plan.condition))
        want = None if required is None else (required | key_cond)
        new_children = []
        for side in plan.children:
            side_need = None if want is None else \
                (want & {a.expr_id for a in side.output})
            pruned = _prune(side, side_need, applied)
            if side_need and any(a.expr_id not in side_need
                                 for a in pruned.output):
                # a side that cannot narrow itself (an in-memory relation)
                # is projected down, so the join moves only what it needs
                pruned = _passthrough_project(pruned, side_need, RULE_PRUNE)
                applied.add(RULE_PRUNE)
            new_children.append(pruned)
        return _rebuild_with_children(plan, new_children)

    # relations and unknown nodes: no pruning below; a wrapping Aggregate
    # or Join projects their output down instead
    return plan


def optimize_logical(plan: L.LogicalPlan,
                     conf: RapidsConf) -> Tuple[L.LogicalPlan, List[str]]:
    """Run the enabled rules; returns (optimized plan, applied rule
    names). A disabled or no-op pipeline returns the input plan."""
    applied: Set[str] = set()
    if conf.get(LOGICAL_JOIN_STRATEGY):
        plan = _join_swap(plan, conf, applied)
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
