"""pyspark.sql.functions-compatible surface (the subset of
``spark_rapids_tpu/functions.py`` that the 22 TPC-H queries of
``benchmarks/tpch.py`` and the 99 TPC-DS queries of
``benchmarks/tpcds.py`` use, with the rest of the variance family and of
the window functions, the string and regex functions and ``hash``, and
the scalar functions: math, ``pmod``/``negative``, bitwise, NaN and null
handling, ``greatest``/``least``, ``xxhash64``/``hive_hash``/``md5``, date
and time in the session time zone, and the partition, row-id, ``rand``
and input-file functions)."""

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
    return Column(_N.Coalesce(*[_expr_or_col(c) for c in cols]))


def isnull(c) -> Column:
    return Column(_N.IsNull(_expr_or_col(c)))


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
    return Column(StringRepeat(_expr_or_col(c), _expr(n)))


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


# --- the scalar functions --------------------------------------------------

def _unary_fn(module: str, cls_name: str, fn_name: str):
    def fn(c) -> Column:
        import importlib
        mod = importlib.import_module(f"{__package__}.expressions.{module}")
        return Column(getattr(mod, cls_name)(_expr_or_col(c)))
    fn.__name__ = fn_name
    fn.__doc__ = f"``{fn_name}(col)``"
    return fn


sqrt = _unary_fn("mathexprs", "Sqrt", "sqrt")
cbrt = _unary_fn("mathexprs", "Cbrt", "cbrt")
exp = _unary_fn("mathexprs", "Exp", "exp")
expm1 = _unary_fn("mathexprs", "Expm1", "expm1")
log10 = _unary_fn("mathexprs", "Log10", "log10")
log2 = _unary_fn("mathexprs", "Log2", "log2")
log1p = _unary_fn("mathexprs", "Log1p", "log1p")
sin = _unary_fn("mathexprs", "Sin", "sin")
cos = _unary_fn("mathexprs", "Cos", "cos")
tan = _unary_fn("mathexprs", "Tan", "tan")
asin = _unary_fn("mathexprs", "Asin", "asin")
acos = _unary_fn("mathexprs", "Acos", "acos")
atan = _unary_fn("mathexprs", "Atan", "atan")
sinh = _unary_fn("mathexprs", "Sinh", "sinh")
cosh = _unary_fn("mathexprs", "Cosh", "cosh")
tanh = _unary_fn("mathexprs", "Tanh", "tanh")
asinh = _unary_fn("mathexprs", "Asinh", "asinh")
acosh = _unary_fn("mathexprs", "Acosh", "acosh")
atanh = _unary_fn("mathexprs", "Atanh", "atanh")
cot = _unary_fn("mathexprs", "Cot", "cot")
degrees = _unary_fn("mathexprs", "ToDegrees", "degrees")
radians = _unary_fn("mathexprs", "ToRadians", "radians")
rint = _unary_fn("mathexprs", "Rint", "rint")
signum = _unary_fn("mathexprs", "Signum", "signum")
ceil = _unary_fn("mathexprs", "Ceil", "ceil")
ceiling = ceil


def log(base, c=None) -> Column:
    """``log(x)``, the natural log, or ``log(base, x)``."""
    from .expressions.mathexprs import Log, Logarithm
    if c is None:
        return Column(Log(_expr_or_col(base)))
    return Column(Logarithm(_expr_or_col(base), _expr_or_col(c)))


def pow(l, r) -> Column:  # noqa: A001
    from .expressions.mathexprs import Pow
    return Column(Pow(_expr_or_col(l), _expr_or_col(r)))


def atan2(l, r) -> Column:
    from .expressions.mathexprs import Atan2
    return Column(Atan2(_expr_or_col(l), _expr_or_col(r)))


def hypot(a, b) -> Column:
    from .expressions.mathexprs import Hypot
    return Column(Hypot(_expr_or_col(a), _expr_or_col(b)))


def bround(c, scale: int = 0) -> Column:
    """HALF_EVEN rounding to ``scale`` decimal places."""
    from .expressions.mathexprs import BRound
    return Column(BRound(_expr_or_col(c), Literal(scale)))


def pmod(l, r) -> Column:
    from .expressions.arithmetic import Pmod
    return Column(Pmod(_expr_or_col(l), _expr_or_col(r)))


def negative(c) -> Column:
    from .expressions.arithmetic import UnaryMinus
    return Column(UnaryMinus(_expr_or_col(c)))


bit_count = _unary_fn("bitwise", "BitwiseCount", "bit_count")
bitwise_not = _unary_fn("bitwise", "BitwiseNot", "bitwise_not")


def shiftleft(c, n: int) -> Column:
    from .expressions.bitwise import ShiftLeft
    return Column(ShiftLeft(_expr_or_col(c), _expr(n)))


def shiftright(c, n: int) -> Column:
    from .expressions.bitwise import ShiftRight
    return Column(ShiftRight(_expr_or_col(c), _expr(n)))


def shiftrightunsigned(c, n: int) -> Column:
    from .expressions.bitwise import ShiftRightUnsigned
    return Column(ShiftRightUnsigned(_expr_or_col(c), _expr(n)))


def isnan(c) -> Column:
    return Column(_N.IsNaN(_expr_or_col(c)))


def nanvl(a, b) -> Column:
    return Column(_N.NaNvl(_expr_or_col(a), _expr_or_col(b)))


def greatest(*cols) -> Column:
    """A string names a column (pyspark's reading)."""
    return Column(_C.Greatest(*[_expr_or_col(c) for c in cols]))


def least(*cols) -> Column:
    return Column(_C.Least(*[_expr_or_col(c) for c in cols]))


def xxhash64(*cols) -> Column:
    from .expressions.hashexprs import XxHash64
    return Column(XxHash64(*[_expr_or_col(c) for c in cols]))


def hive_hash(*cols) -> Column:
    from .expressions.hashexprs import HiveHash
    return Column(HiveHash(*[_expr_or_col(c) for c in cols]))


md5 = _unary_fn("hashexprs", "Md5", "md5")

year = _unary_fn("datetime", "Year", "year")
month = _unary_fn("datetime", "Month", "month")
dayofmonth = _unary_fn("datetime", "DayOfMonth", "dayofmonth")
quarter = _unary_fn("datetime", "Quarter", "quarter")
dayofweek = _unary_fn("datetime", "DayOfWeek", "dayofweek")
weekday = _unary_fn("datetime", "WeekDay", "weekday")
dayofyear = _unary_fn("datetime", "DayOfYear", "dayofyear")
weekofyear = _unary_fn("datetime", "WeekOfYear", "weekofyear")
hour = _unary_fn("datetime", "Hour", "hour")
minute = _unary_fn("datetime", "Minute", "minute")
second = _unary_fn("datetime", "Second", "second")
last_day = _unary_fn("datetime", "LastDay", "last_day")
timestamp_seconds = _unary_fn("datetime", "SecondsToTimestamp",
                              "timestamp_seconds")
timestamp_millis = _unary_fn("datetime", "MillisToTimestamp",
                             "timestamp_millis")
timestamp_micros = _unary_fn("datetime", "MicrosToTimestamp",
                             "timestamp_micros")


def date_add(date, days) -> Column:
    from .expressions.datetime import DateAdd
    return Column(DateAdd(_expr_or_col(date), _expr_or_col(days)))


def date_sub(date, days) -> Column:
    from .expressions.datetime import DateSub
    return Column(DateSub(_expr_or_col(date), _expr_or_col(days)))


def datediff(end, start) -> Column:
    from .expressions.datetime import DateDiff
    return Column(DateDiff(_expr_or_col(end), _expr_or_col(start)))


def add_months(date, months) -> Column:
    from .expressions.datetime import AddMonths
    return Column(AddMonths(_expr_or_col(date), _expr_or_col(months)))


def date_format(c, fmt: str) -> Column:
    from .expressions.datetime import DateFormatClass
    return Column(DateFormatClass(_expr_or_col(c), _expr(fmt)))


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    from .expressions.datetime import FromUnixTime
    return Column(FromUnixTime(_expr_or_col(c), _expr(fmt)))


def unix_timestamp(ts, fmt: str = None) -> Column:
    """``unix_timestamp(ts)`` of a timestamp or date; a string parses
    with ``fmt`` (default ``yyyy-MM-dd HH:mm:ss``) in the session zone."""
    from .expressions.datetime import UnixTimestamp
    return Column(UnixTimestamp(_expr_or_col(ts), None if fmt is None
                                else _expr(fmt)))


def to_unix_timestamp(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    from .expressions.datetime import ToUnixTimestamp
    return Column(ToUnixTimestamp(_expr_or_col(c), _expr(fmt)))


def spark_partition_id() -> Column:
    from .expressions.misc import SparkPartitionID
    return Column(SparkPartitionID())


def monotonically_increasing_id() -> Column:
    from .expressions.misc import MonotonicallyIncreasingID
    return Column(MonotonicallyIncreasingID())


def rand(seed: int = 0) -> Column:
    from .expressions.misc import Rand
    return Column(Rand(Literal(seed)))


def input_file_name() -> Column:
    from .expressions.misc import InputFileName
    return Column(InputFileName())


def input_file_block_start() -> Column:
    from .expressions.misc import InputFileBlockStart
    return Column(InputFileBlockStart())


def input_file_block_length() -> Column:
    from .expressions.misc import InputFileBlockLength
    return Column(InputFileBlockLength())
