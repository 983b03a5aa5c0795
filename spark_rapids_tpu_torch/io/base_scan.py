"""Scan helpers: pushable conjuncts, the Arrow filter, and row-group
exclusion by footer statistics (port of ``spark_rapids_tpu/io/base_scan.py``).

A pushable conjunct compares a column with a literal. Pushed conjuncts
prune row groups before any decode; the exact Filter stays above the scan,
so pruning never changes a result. ``IN``, ``IS NULL`` and the ORC dataset
expression wait for the expressions and the format they need.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..expressions import predicates as P
from ..expressions.base import AttributeReference, Expression, Literal


def _as_literal(e: Expression) -> Optional[Literal]:
    """A literal, possibly under a value-preserving cast the analyzer put
    in (``k = cast(3 AS bigint)``). Only numeric-to-numeric casts of
    numeric literals fold: a value-changing cast must not push its raw
    value into pruning."""
    from ..expressions.cast import Cast
    from ..types import FractionalType, IntegralType
    while isinstance(e, Cast):
        inner = e.children[0]
        if not isinstance(inner, Literal):
            return None
        v = inner.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        if not isinstance(e.dtype, (IntegralType, FractionalType)):
            return None
        if isinstance(e.dtype, IntegralType) and not isinstance(v, int):
            return None
        e = inner
    return e if isinstance(e, Literal) else None


_OPS = ((P.EqualTo, "=="), (P.LessThan, "<"), (P.LessThanOrEqual, "<="),
        (P.GreaterThan, ">"), (P.GreaterThanOrEqual, ">="))
_FLIPPED = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _leaf_filter(e: Expression) -> Optional[Tuple[str, str, object]]:
    for cls, op in _OPS:
        if isinstance(e, cls):
            l, r = e.children
            rl, ll = _as_literal(r), _as_literal(l)
            if isinstance(l, AttributeReference) and rl is not None \
                    and rl.value is not None:
                return (l.name, op, rl.value)
            if isinstance(r, AttributeReference) and ll is not None \
                    and ll.value is not None:
                return (r.name, _FLIPPED[op], ll.value)
    return None


def arrow_filter_from_condition(conjuncts: Sequence[Expression]):
    """AND-list of expressions → the Arrow DNF filter (one conjunction),
    or None when nothing converts."""
    leaves = [leaf for leaf in map(_leaf_filter, conjuncts) if leaf]
    return leaves or None


def split_conjuncts(cond: Expression) -> List[Expression]:
    out: List[Expression] = []

    def walk(e: Expression):
        if isinstance(e, P.And):
            walk(e.children[0])
            walk(e.children[1])
        else:
            out.append(e)

    walk(cond)
    return out


def pushable(e: Expression) -> bool:
    return _leaf_filter(e) is not None


def rg_excluded(rg, arrow_filter) -> bool:
    """True only when a pushed min/max leaf provably excludes every row of
    the row group (reference GpuParquetFileFilterHandler). The host reader
    and the device decode prune with it alike."""
    if not arrow_filter:
        return False
    stats = {}
    for j in range(rg.num_columns):
        col = rg.column(j)
        st = col.statistics
        if st is not None and st.has_min_max:
            stats[col.path_in_schema.split(".")[0]] = (st.min, st.max)
    for name, op, val in arrow_filter:
        if name not in stats:
            continue
        lo, hi = stats[name]
        try:
            if ((op == "==" and (val < lo or val > hi))
                    or (op in ("<", "<=") and lo > val)
                    or (op in (">", ">=") and hi < val)):
                return True
        except TypeError:
            continue
    return False


def dataset_filter_expr(arrow_filter):
    """Pushed-filter tuples as a ``pyarrow.dataset`` expression, or None
    when none converts: the ORC read applies it with stripe statistics
    pruning (the ORC analogue of parquet's ``filters=``); the exact Filter
    above the scan keeps the rows the same either way."""
    import pyarrow.compute as pc
    expr = None
    for name, op, val in arrow_filter or ():
        f = pc.field(name)
        if op in ("=", "=="):
            e = f == val
        elif op == "<":
            e = f < val
        elif op == "<=":
            e = f <= val
        elif op == ">":
            e = f > val
        elif op == ">=":
            e = f >= val
        elif op == "in":
            e = f.isin(list(val))
        else:
            continue
        expr = e if expr is None else (expr & e)
    return expr
