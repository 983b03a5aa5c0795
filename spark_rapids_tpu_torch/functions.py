"""pyspark.sql.functions-compatible surface (the subset of
``spark_rapids_tpu/functions.py`` that the 22 TPC-H queries of
``benchmarks/tpch.py`` and the 99 TPC-DS queries of
``benchmarks/tpcds.py`` use, with the rest of the variance family and of
the window functions, the string and regex functions and ``hash``)."""

from __future__ import annotations

from typing import Any

from .expressions import aggregates as _G
from .expressions import conditional as _C
from .expressions import nullexprs as _N
from .expressions.base import Literal, UnresolvedAttribute
from .session import Column, _expr


def col(name: str) -> Column:
    return Column(UnresolvedAttribute(name))


column = col


def lit(value: Any) -> Column:
    return Column(Literal(value))


def _expr_or_col(c):
    return UnresolvedAttribute(c) if isinstance(c, str) else _expr(c)


def sum(c) -> Column:  # noqa: A001
    return Column(_G.Sum(_expr_or_col(c)))


def count(c) -> Column:
    return Column(_G.Count(_expr_or_col(c) if not isinstance(c, str) or c != "*"
                           else Literal(1)))


def count_star() -> Column:
    return Column(_G.Count(Literal(1)))


def like(c, pattern: str) -> Column:
    from .expressions.strings import Like
    return Column(Like(_expr_or_col(c), pattern))


def avg(c) -> Column:
    return Column(_G.Average(_expr_or_col(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(_G.Min(_expr_or_col(c)))


def max(c) -> Column:  # noqa: A001
    return Column(_G.Max(_expr_or_col(c)))


class WhenBuilder(Column):
    """``when(cond, value)[.when(...)].otherwise(value)``: a CASE WHEN that
    is null where no branch holds until ``otherwise`` gives its ELSE."""

    def __init__(self, branches):
        self._branches = branches
        super().__init__(_C.CaseWhen(branches))

    def when(self, condition, value) -> "WhenBuilder":
        return WhenBuilder(self._branches + [(_expr(condition),
                                              _expr(value))])

    def otherwise(self, value) -> Column:
        return Column(_C.CaseWhen(self._branches, _expr(value)))


def when(condition, value) -> WhenBuilder:
    return WhenBuilder([(_expr(condition), _expr(value))])


def round(c, scale: int = 0) -> Column:  # noqa: A001
    """HALF_UP rounding to ``scale`` decimal places."""
    from .expressions.mathexprs import Round
    return Column(Round(_expr_or_col(c), Literal(scale)))


def substring(c, pos: int, length: int) -> Column:
    """Spark's 1-based ``substring(str, pos, len)``."""
    from .expressions.strings import Substring
    return Column(Substring(_expr_or_col(c), Literal(pos), Literal(length)))


def coalesce(*cols) -> Column:
    return Column(_N.Coalesce(*[_expr(c) for c in cols]))


def isnull(c) -> Column:
    return Column(_N.IsNull(_expr(c)))


def floor(c) -> Column:
    from .expressions.mathexprs import Floor
    return Column(Floor(_expr_or_col(c)))


def abs(c) -> Column:  # noqa: A001
    from .expressions.arithmetic import Abs
    return Column(Abs(_expr_or_col(c)))


def concat(*cols) -> Column:
    from .expressions.strings import ConcatStr
    return Column(ConcatStr(*[_expr_or_col(c) for c in cols]))


def hash(*cols) -> Column:  # noqa: A001
    from .expressions.hashexprs import Murmur3Hash
    return Column(Murmur3Hash(*[_expr_or_col(c) for c in cols]))


# --- strings ---------------------------------------------------------------

def _string_fn(cls_name: str):
    def fn(c) -> Column:
        from .expressions import strings as S
        return Column(getattr(S, cls_name)(_expr_or_col(c)))
    fn.__name__ = cls_name.lower()
    return fn


length = _string_fn("Length")
upper = _string_fn("Upper")
lower = _string_fn("Lower")
trim = _string_fn("Trim")
ltrim = _string_fn("LTrim")
rtrim = _string_fn("RTrim")
reverse = _string_fn("Reverse")
initcap = _string_fn("InitCap")
octet_length = _string_fn("OctetLength")
bit_length = _string_fn("BitLength")
ascii = _string_fn("Ascii")  # noqa: A001


def repeat(c, n: int) -> Column:
    from .expressions.strings import StringRepeat
    return Column(StringRepeat(_expr_or_col(c), Literal(n)))


def replace(c, search: str, replacement: str = "") -> Column:
    from .expressions.strings import StringReplace
    return Column(StringReplace(_expr_or_col(c), Literal(search),
                                Literal(replacement)))


def translate(c, from_str: str, to_str: str) -> Column:
    from .expressions.strings import StringTranslate
    return Column(StringTranslate(_expr_or_col(c), Literal(from_str),
                                  Literal(to_str)))


def locate(substr: str, c, pos: int = 1) -> Column:
    from .expressions.strings import StringLocate
    return Column(StringLocate(Literal(substr), _expr_or_col(c),
                               Literal(pos)))


def instr(c, substr: str) -> Column:
    from .expressions.strings import StringLocate
    return Column(StringLocate(Literal(substr), _expr_or_col(c)))


def lpad(c, length_: int, pad: str = " ") -> Column:
    from .expressions.strings import LPad
    return Column(LPad(_expr_or_col(c), Literal(length_), Literal(pad)))


def rpad(c, length_: int, pad: str = " ") -> Column:
    from .expressions.strings import RPad
    return Column(RPad(_expr_or_col(c), Literal(length_), Literal(pad)))


def concat_ws(sep: str, *cols) -> Column:
    from .expressions.strings import ConcatWs
    return Column(ConcatWs(Literal(sep) if isinstance(sep, str)
                           else _expr(sep),
                           *[_expr_or_col(c) for c in cols]))


def substring_index(c, delim: str, count: int) -> Column:
    from .expressions.strings import SubstringIndex
    return Column(SubstringIndex(_expr_or_col(c), Literal(delim),
                                 Literal(count)))


def format_number(c, d: int) -> Column:
    from .expressions.strings import FormatNumber
    return Column(FormatNumber(_expr_or_col(c), Literal(d)))


def conv(c, from_base: int, to_base: int) -> Column:
    from .expressions.strings import Conv
    return Column(Conv(_expr_or_col(c), Literal(from_base),
                       Literal(to_base)))


def rlike(c, pattern: str) -> Column:
    from .expressions.regex import RLike
    return Column(RLike(_expr_or_col(c), pattern))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    from .expressions.regex import RegexpReplace
    return Column(RegexpReplace(_expr_or_col(c), pattern, replacement))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    from .expressions.regex import RegexpExtract
    return Column(RegexpExtract(_expr_or_col(c), pattern, idx))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(_G.First(_expr_or_col(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(_G.Last(_expr_or_col(c), ignorenulls))


# --- the variance family ---------------------------------------------------

def stddev(c) -> Column:
    return Column(_G.StddevSamp(_expr_or_col(c)))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return Column(_G.StddevPop(_expr_or_col(c)))


def variance(c) -> Column:
    return Column(_G.VarianceSamp(_expr_or_col(c)))


var_samp = variance


def var_pop(c) -> Column:
    return Column(_G.VariancePop(_expr_or_col(c)))


# --- window functions ------------------------------------------------------

def row_number() -> Column:
    from .window import RowNumber
    return Column(RowNumber())


def rank() -> Column:
    from .window import Rank
    return Column(Rank())


def dense_rank() -> Column:
    from .window import DenseRank
    return Column(DenseRank())


def ntile(n: int) -> Column:
    from .window import NTile
    return Column(NTile(Literal(int(n))))


def percent_rank() -> Column:
    from .window import PercentRank
    return Column(PercentRank())


def cume_dist() -> Column:
    from .window import CumeDist
    return Column(CumeDist())


def lead(c, offset: int = 1, default=None) -> Column:
    from .window import Lead
    d = Literal(default) if default is not None else None
    return Column(Lead(_expr_or_col(c), offset, d))


def lag(c, offset: int = 1, default=None) -> Column:
    from .window import Lag
    d = Literal(default) if default is not None else None
    return Column(Lag(_expr_or_col(c), offset, d))


# --- grouping sets ---------------------------------------------------------

def grouping_id() -> Column:
    from .expressions.generators import GroupingID
    return Column(GroupingID())


def grouping(c) -> Column:
    from .expressions.generators import GroupingExpr
    return Column(GroupingExpr(_expr_or_col(c)))
