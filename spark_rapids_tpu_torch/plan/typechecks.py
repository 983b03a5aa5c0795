"""Expression registry + type-support matrix (port of the registry part of
``spark_rapids_tpu/plan/typechecks.py``).

``register_expr`` records, for each expression class the port can evaluate
on the device, the TypeSig its result may take. The tagging layer
(plan/meta.py) keeps an operator on the CPU when one of its expressions is
unregistered, produces an unsupported type, is switched off by
``spark.rapids.sql.expression.<Name>=false``, or is gated by
``conf_gate_reason``. Only the expression classes the port has are
registered. ``scan_type_error`` is the file scan's type check.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..types import TypeSig, TypeSigs

_EXPR_RULES: Dict[type, "ExprRule"] = {}


class ExprRule:
    def __init__(self, cls: type, type_sig: Optional[TypeSig], desc: str):
        self.cls = cls
        self.type_sig = type_sig
        self.desc = desc


def register_expr(cls: type, type_sig: Optional[TypeSig], desc: str) -> None:
    _EXPR_RULES[cls] = ExprRule(cls, type_sig, desc)


def is_expr_registered(cls: type) -> bool:
    return cls in _EXPR_RULES


def expr_sig_for(cls: type) -> Optional[TypeSig]:
    r = _EXPR_RULES.get(cls)
    return r.type_sig if r else None


def _register_builtin_exprs() -> None:
    from ..expressions import aggregates as AGG
    from ..expressions import arithmetic as A
    from ..expressions import base as B
    from ..expressions import cast as C
    from ..expressions import conditional as CO
    from ..expressions import mathexprs as M
    from ..expressions import nullexprs as N
    from ..expressions import predicates as P
    from ..expressions import strings as S
    sig_all = TypeSigs.all_basic
    register_expr(B.Literal, sig_all, "literal value")
    register_expr(B.AttributeReference, sig_all, "column reference")
    register_expr(B.Alias, sig_all, "named expression")
    register_expr(C.Cast, sig_all, "cast between numeric, boolean and date "
                  "types")
    for cls in (A.Add, A.Subtract, A.Multiply):
        register_expr(cls, TypeSigs.numeric,
                      f"{cls.__name__.lower()} of numerics")
    register_expr(A.Divide, TypeSigs.numeric, "fractional division")
    for cls in (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                P.GreaterThanOrEqual):
        register_expr(cls, TypeSigs.BOOLEAN, f"comparison {cls.symbol}")
    register_expr(P.And, TypeSigs.BOOLEAN, "logical AND (Kleene)")
    register_expr(P.Or, TypeSigs.BOOLEAN, "logical OR (Kleene)")
    register_expr(P.Not, TypeSigs.BOOLEAN, "logical NOT")
    register_expr(P.In, TypeSigs.BOOLEAN, "IN (literal list)")
    register_expr(P.InSet, TypeSigs.BOOLEAN, "IN over a literal set (isin)")
    register_expr(N.IsNull, TypeSigs.BOOLEAN, "IS NULL")
    register_expr(N.IsNotNull, TypeSigs.BOOLEAN, "IS NOT NULL")
    # the branches are fixed-width: a string CASE WHEN is not yet ported
    branch = TypeSigs.numeric + TypeSigs.BOOLEAN + TypeSigs.DATE \
        + TypeSigs.NULL
    register_expr(CO.If, branch, "if/else")
    register_expr(CO.CaseWhen, branch, "CASE WHEN")
    register_expr(M.Round, TypeSigs.numeric, "round (HALF_UP)")
    register_expr(S.Like, TypeSigs.BOOLEAN, "SQL LIKE with % and _")
    register_expr(S.Substring, TypeSigs.STRING,
                  "substring (device ragged gather, ASCII)")
    register_expr(AGG.Sum, TypeSigs.numeric, "sum aggregate")
    register_expr(AGG.Average, TypeSigs.numeric, "average aggregate")
    # min/max of strings reduce on the host in the reference (pyarrow);
    # that path is not yet ported, so string results stay off the device
    minmax = TypeSigs.numeric + TypeSigs.DATE + TypeSigs.NULL
    register_expr(AGG.Min, minmax, "min aggregate")
    register_expr(AGG.Max, minmax, "max aggregate")
    register_expr(AGG.Count, TypeSigs.integral, "count aggregate")


_register_builtin_exprs()


def conf_gate_reason(e, conf) -> Optional[str]:
    """Config-driven expression gates beyond the per-class switch. The
    reference's cast gates (float↔string, string→timestamp) wait with the
    string casts; the float-aggregation gate is here."""
    from ..config import VARIABLE_FLOAT_AGG_ENABLED
    from ..expressions.aggregates import Average, Sum
    from ..types import DoubleType, FloatType
    if isinstance(e, (Sum, Average)) and e.children \
            and isinstance(e.children[0].dtype, (FloatType, DoubleType)) \
            and not conf.get(VARIABLE_FLOAT_AGG_ENABLED):
        return ("float aggregation result can vary with parallelism; "
                f"disabled via {VARIABLE_FLOAT_AGG_ENABLED.key}")
    return None


def scan_type_error(attrs) -> Optional[str]:
    """Why a file scan cannot read its columns: the first one whose type
    the port has no carrier for (``TypeSigs.scan``: no decimal, no nested
    type). The planner raises it."""
    from ..types import TypeSigs
    for a in attrs:
        try:
            supported = TypeSigs.scan.check(a.dtype) is None
        except NotImplementedError:
            supported = False
        if not supported:
            return (f"scan of column {a.name}: type "
                    f"{a.dtype.simple_string()} has no carrier in the port "
                    "(not yet ported)")
    return None
