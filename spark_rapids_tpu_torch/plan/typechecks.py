"""Expression registry + type-support matrix (port of the registry part of
``spark_rapids_tpu/plan/typechecks.py``).

``register_expr`` records, for each expression class the port can evaluate
on the device, the TypeSig its result may take (the reference's rules,
descriptions, ``incompat`` notes and ``host_assisted`` flags). The tagging layer
(plan/meta.py) keeps an operator on the CPU when one of its expressions is
unregistered, produces an unsupported type, is switched off by
``spark.rapids.sql.expression.<Name>=false``, or is gated by
``conf_gate_reason``. Only the expression classes the port has are
registered. ``scan_type_error`` is the file scan's type check.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

from ..types import TypeSig, TypeSigs

_EXPR_RULES: Dict[type, "ExprRule"] = {}


class ExprRule:
    def __init__(self, cls: type, type_sig: Optional[TypeSig], desc: str,
                 incompat: Optional[str] = None,
                 host_assisted: bool = False):
        self.cls = cls
        self.type_sig = type_sig
        self.desc = desc
        self.incompat = incompat
        self.host_assisted = host_assisted  # correct, partly on the host


def register_expr(cls: type, type_sig: Optional[TypeSig], desc: str,
                  incompat: Optional[str] = None,
                  host_assisted: bool = False) -> None:
    _EXPR_RULES[cls] = ExprRule(cls, type_sig, desc, incompat, host_assisted)


def is_expr_registered(cls: type) -> bool:
    return cls in _EXPR_RULES


def expr_sig_for(cls: type) -> Optional[TypeSig]:
    r = _EXPR_RULES.get(cls)
    return r.type_sig if r else None


def _register_builtin_exprs() -> None:
    from .. import window as WIN
    from ..expressions import aggregates as AGG
    from ..expressions import arithmetic as A
    from ..expressions import base as B
    from ..expressions import bitwise as BW
    from ..expressions import cast as C
    from ..expressions import conditional as CO
    from ..expressions import generators as GEN
    from ..expressions import hashexprs as H
    from ..expressions import mathexprs as M
    from ..expressions import nullexprs as N
    from ..expressions import predicates as P
    from ..expressions import regex as RX
    from ..expressions import strings as S
    from ..types import TypeEnum, TypeSig
    sig_all = TypeSigs.all_basic
    ts = TypeSig([TypeEnum.TIMESTAMP])
    d128 = TypeSigs.DECIMAL_128
    register_expr(B.Literal, sig_all + ts + d128, "literal value")
    register_expr(B.AttributeReference, sig_all + ts + d128,
                  "column reference")
    register_expr(B.Alias, sig_all + ts + d128, "named expression")
    register_expr(C.Cast, sig_all + TypeSig([TypeEnum.TIMESTAMP]) + d128,
                  "cast between numeric, decimal, boolean and date types; "
                  "to and from strings through the host",
                  incompat="string casts run on the host")
    for cls in (A.Add, A.Subtract, A.Multiply):
        register_expr(cls, TypeSigs.numeric + d128,
                      f"{cls.__name__.lower()} of numerics (decimal128 "
                      "as two int64 limbs)")
    register_expr(A.Divide, TypeSigs.numeric + d128, "fractional division")
    for cls in (P.EqualTo, P.EqualNullSafe, P.LessThan, P.LessThanOrEqual,
                P.GreaterThan, P.GreaterThanOrEqual):
        register_expr(cls, TypeSigs.BOOLEAN, f"comparison {cls.symbol}")
    register_expr(P.And, TypeSigs.BOOLEAN, "logical AND (Kleene)")
    register_expr(P.Or, TypeSigs.BOOLEAN, "logical OR (Kleene)")
    register_expr(P.Not, TypeSigs.BOOLEAN, "logical NOT")
    register_expr(P.In, TypeSigs.BOOLEAN, "IN (literal list)")
    register_expr(P.InSet, TypeSigs.BOOLEAN, "IN over a literal set (isin)")
    register_expr(N.IsNull, TypeSigs.BOOLEAN, "IS NULL")
    register_expr(N.IsNotNull, TypeSigs.BOOLEAN, "IS NOT NULL")
    branch = TypeSigs.numeric + TypeSigs.BOOLEAN + TypeSigs.DATE \
        + TypeSigs.STRING + TypeSigs.NULL
    register_expr(CO.If, branch + d128, "if/else")
    register_expr(CO.CaseWhen, branch + d128, "CASE WHEN")
    register_expr(M.Round, TypeSigs.numeric + d128, "round (HALF_UP)")
    register_expr(H.Murmur3Hash, TypeSigs.integral, "spark murmur3 hash")
    register_expr(S.Like, TypeSigs.BOOLEAN, "SQL LIKE with % and _",
                  incompat="'_' over non-ASCII handled via host path")
    register_expr(S.Substring, TypeSigs.STRING,
                  "substring (device ragged gather)",
                  incompat="non-ASCII handled via host path")
    register_expr(S.Length, TypeSigs.integral, "string char length")
    register_expr(S.Upper, TypeSigs.STRING, "uppercase",
                  incompat="non-ASCII handled via host path")
    register_expr(S.Lower, TypeSigs.STRING, "lowercase",
                  incompat="non-ASCII handled via host path")
    register_expr(S.StartsWith, TypeSigs.BOOLEAN, "prefix test",
                  incompat="non-literal pattern via host path")
    register_expr(S.EndsWith, TypeSigs.BOOLEAN, "suffix test",
                  incompat="non-literal pattern via host path")
    register_expr(S.Contains, TypeSigs.BOOLEAN,
                  "substring test (device window match)",
                  incompat="non-literal pattern via host path")
    for cls in (S.StringRepeat, S.StringReplace, S.SubstringIndex):
        register_expr(cls, TypeSigs.STRING,
                      f"string fn {cls.__name__.lower()} (device, UTF-8 "
                      "safe)", incompat="non-literal arguments via host path")
    for cls in (S.Trim, S.LTrim, S.RTrim, S.Reverse, S.InitCap, S.LPad,
                S.RPad, S.StringTranslate):
        register_expr(cls, TypeSigs.STRING,
                      f"string fn {cls.__name__.lower()} (device)",
                      incompat="non-ASCII handled via host path")
    for cls in (S.StringLocate, S.StringInstr):
        register_expr(cls, TypeSigs.integral,
                      "locate/instr (device first-match)",
                      incompat="non-ASCII handled via host path")
    register_expr(S.ConcatWs, TypeSigs.STRING, "concat_ws (device)",
                  incompat="non-literal separator via host path")
    register_expr(S.OctetLength, TypeSigs.integral,
                  "byte length (device offsets math)")
    register_expr(S.BitLength, TypeSigs.integral,
                  "bit length (device offsets math)")
    register_expr(S.Ascii, TypeSigs.integral, "first code point",
                  incompat="non-ASCII handled via host path")
    register_expr(S.FormatNumber, TypeSigs.STRING, "format_number",
                  host_assisted=True)
    register_expr(S.Conv, TypeSigs.STRING, "base conversion",
                  host_assisted=True)
    register_expr(RX.RLike, TypeSigs.BOOLEAN,
                  "regex match: literal rewrite or compiled byte-DFA on "
                  "the device (kernels/regex_dfa.py); out-of-subset "
                  "patterns run on the host",
                  incompat="out-of-subset patterns run on host")
    register_expr(RX.RegexpReplace, TypeSigs.STRING,
                  "regex replace: DFA span matching + device byte assembly; "
                  "out-of-subset patterns / group refs run on the host",
                  incompat="out-of-subset patterns run on host")
    register_expr(RX.RegexpExtract, TypeSigs.STRING,
                  "regex extract: group 0 via device DFA span matching; "
                  "capture groups on the host",
                  incompat="capture groups run on host")
    register_expr(AGG.Sum, TypeSigs.numeric + d128, "sum aggregate")
    register_expr(AGG.Average, TypeSigs.numeric + d128, "average aggregate")
    # min/max of strings reduce in a host-assisted segment, as the
    # reference's (execs/aggregates._host_string_minmax)
    minmax = TypeSigs.numeric + TypeSigs.DATE + TypeSigs.STRING \
        + TypeSigs.NULL + d128
    register_expr(AGG.Min, minmax, "min aggregate")
    register_expr(AGG.Max, minmax, "max aggregate")
    register_expr(AGG.Count, TypeSigs.integral, "count aggregate")
    register_expr(AGG.First, TypeSigs.all_basic + TypeSigs.NULL + d128,
                  "first(ignoreNulls) aggregate")
    register_expr(AGG.Last, TypeSigs.all_basic + TypeSigs.NULL + d128,
                  "last(ignoreNulls) aggregate")
    for cls in (AGG.StddevSamp, AGG.StddevPop, AGG.VarianceSamp,
                AGG.VariancePop):
        register_expr(cls, TypeSigs.fp,
                      f"{cls.update_op} ((n, sum, sumsq) state)")
    register_expr(A.Abs, TypeSigs.numeric + TypeSigs.DECIMAL_128,
                  "absolute value")
    register_expr(M.Floor, TypeSigs.numeric + TypeSigs.DECIMAL_128,
                  "floor")
    register_expr(N.Coalesce, TypeSigs.numeric + TypeSigs.BOOLEAN
                  + TypeSigs.DATE + TypeSigs.STRING + TypeSigs.NULL + d128,
                  "first non-null")
    register_expr(S.ConcatStr, TypeSigs.STRING,
                  "concat (device ragged gather, UTF-8 safe)")
    register_expr(BW.BitwiseAnd, TypeSigs.integral, "bitwise &")
    register_expr(BW.ShiftRight, TypeSigs.integral, "shift >>")
    # window functions (evaluated by the window exec)
    register_expr(WIN.WindowExpression, TypeSigs.all_basic + TypeSigs.NULL,
                  "windowed aggregate/function application")
    for cls in (WIN.RowNumber, WIN.Rank, WIN.DenseRank, WIN.NTile):
        register_expr(cls, TypeSigs.integral, f"{cls.name}()")
    register_expr(WIN.PercentRank, TypeSigs.fp, "percent_rank()")
    register_expr(WIN.CumeDist, TypeSigs.fp, "cume_dist()")
    register_expr(WIN.Lag, TypeSigs.all_basic + TypeSigs.NULL,
                  "lag(col, offset, default)")
    register_expr(WIN.Lead, TypeSigs.all_basic + TypeSigs.NULL,
                  "lead(col, offset, default)")
    register_expr(GEN.GroupingExpr, TypeSigs.all_basic + TypeSigs.NULL,
                  "grouping set marker")
    register_expr(GEN.GroupingID, TypeSigs.integral,
                  "grouping_id (lowered to the Expand gid column)")
    _register_scalar_functions(sig_all, ts)


def _register_scalar_functions(sig_all, ts) -> None:
    """The scalar functions (the reference's rules for them)."""
    from ..expressions import arithmetic as A
    from ..expressions import bitwise as BW
    from ..expressions import conditional as CO
    from ..expressions import datetime as DT
    from ..expressions import hashexprs as H
    from ..expressions import mathexprs as M
    from ..expressions import misc as MISC
    from ..expressions import nullexprs as N
    sig_num = TypeSigs.numeric
    register_expr(A.IntegralDivide, sig_num, "integral division")
    d128 = TypeSigs.DECIMAL_128
    register_expr(A.Remainder, sig_num + d128,
                  "remainder (java sign semantics)")
    register_expr(A.Pmod, sig_num + d128, "positive modulus")
    register_expr(A.UnaryMinus, sig_num + d128, "negation")
    register_expr(A.UnaryPositive, sig_num + d128, "unary plus")
    register_expr(N.IsNaN, TypeSigs.BOOLEAN, "IS NaN")
    register_expr(N.NaNvl, TypeSigs.fp, "NaN replacement")
    register_expr(N.AtLeastNNonNulls, TypeSigs.BOOLEAN,
                  "at-least-n-non-nulls filter (na.drop)")
    register_expr(N.KnownNotNull, sig_all + ts, "known-not-null marker")
    register_expr(N.KnownFloatingPointNormalized, TypeSigs.fp,
                  "known-normalized marker (passthrough)")
    register_expr(N.NormalizeNaNAndZero, TypeSigs.fp,
                  "NaN/-0.0 canonicalization")
    minmax = sig_num + TypeSigs.BOOLEAN + TypeSigs.DATE + ts + TypeSigs.NULL
    register_expr(CO.Greatest, minmax + d128, "row-wise greatest")
    register_expr(CO.Least, minmax + d128, "row-wise least")
    for cls in (M.Sqrt, M.Cbrt, M.Exp, M.Expm1, M.Sin, M.Cos, M.Tan, M.Asin,
                M.Acos, M.Atan, M.Sinh, M.Cosh, M.Tanh, M.Log, M.Log10,
                M.Log2, M.Log1p, M.Pow, M.Atan2, M.Signum, M.Asinh,
                M.Acosh, M.Atanh, M.Cot, M.ToDegrees, M.ToRadians, M.Rint,
                M.Hypot):
        register_expr(cls, sig_num, f"math fn {cls.__name__.lower()}")
    register_expr(M.Logarithm, TypeSigs.fp,
                  "log(base, x) — null on domain error")
    register_expr(M.Ceil, sig_num + d128, "math fn ceil")
    register_expr(M.BRound, sig_num + d128, "bround (HALF_EVEN)")
    register_expr(H.XxHash64, TypeSigs.integral,
                  "spark xxhash64 (device XXH64 over the string bytes)")
    register_expr(H.HiveHash, TypeSigs.integral,
                  "hive bucketing hash (device 31h+b fold)")
    register_expr(H.Md5, TypeSigs.STRING, "md5 hex digest",
                  host_assisted=True)
    for cls in (BW.BitwiseOr, BW.BitwiseXor):
        register_expr(cls, TypeSigs.integral, f"bitwise {cls.symbol}")
    register_expr(BW.BitwiseNot, TypeSigs.integral, "bitwise NOT")
    register_expr(BW.BitwiseCount, TypeSigs.integral, "bit_count")
    for cls in (BW.ShiftLeft, BW.ShiftRightUnsigned):
        register_expr(cls, TypeSigs.integral, f"shift {cls.symbol}")
    for cls in (DT.Year, DT.Month, DT.DayOfMonth, DT.Quarter, DT.DayOfWeek,
                DT.WeekDay, DT.DayOfYear, DT.WeekOfYear, DT.Hour, DT.Minute,
                DT.Second, DT.DateDiff):
        register_expr(cls, TypeSigs.integral,
                      f"datetime field {cls.__name__.lower()}")
    register_expr(DT.LastDay, TypeSigs.DATE, "last day of month")
    register_expr(DT.DateAdd, TypeSigs.DATE, "date add/sub days")
    register_expr(DT.DateSub, TypeSigs.DATE, "date_sub")
    register_expr(DT.AddMonths, TypeSigs.DATE, "add months (day-clamped)")
    register_expr(DT.UnixTimestampFromTs, TypeSigs.integral, "unix seconds")
    register_expr(DT.ToUnixMicros, TypeSigs.integral, "unix micros")
    for cls in (DT.SecondsToTimestamp, DT.MillisToTimestamp,
                DT.MicrosToTimestamp):
        register_expr(cls, ts, f"{cls.__name__.lower()} (device scaling)")
    register_expr(DT.FromUnixTime, TypeSigs.STRING,
                  "from_unixtime (device byte assembly, session tz)",
                  incompat="non-numeric pattern tokens via host path")
    register_expr(DT.DateFormatClass, TypeSigs.STRING,
                  "date_format (device byte assembly, session tz)",
                  incompat="non-numeric pattern tokens via host path")
    register_expr(DT.ToUnixTimestamp, TypeSigs.integral,
                  "to_unix_timestamp (device for ts/date)",
                  incompat="string parsing via host path")
    register_expr(DT.UnixTimestamp, TypeSigs.integral,
                  "unix_timestamp (device for ts/date)",
                  incompat="string parsing via host path")
    register_expr(MISC.SparkPartitionID, TypeSigs.integral,
                  "spark_partition_id()")
    register_expr(MISC.MonotonicallyIncreasingID, TypeSigs.integral,
                  "monotonically_increasing_id()")
    register_expr(MISC.Rand, TypeSigs.fp,
                  "rand(seed) — device threefry PRNG",
                  incompat="sequence differs from Spark XORShiftRandom")
    register_expr(MISC.InputFileName, TypeSigs.STRING, "input_file_name()")
    register_expr(MISC.InputFileBlockStart, TypeSigs.integral,
                  "input_file_block_start()")
    register_expr(MISC.InputFileBlockLength, TypeSigs.integral,
                  "input_file_block_length()")


_register_builtin_exprs()


# ---------------------------------------------------------------------------
# decimal inputs: which expressions evaluate decimal children on the card
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decimal_input_classes() -> frozenset:
    """The expression classes whose device code takes decimal children,
    one lane (precision <= 18) or two limbs."""
    from ..expressions import aggregates as AGG
    from ..expressions import arithmetic as A
    from ..expressions import base as B
    from ..expressions import cast as C
    from ..expressions import conditional as CO
    from ..expressions import hashexprs as H
    from ..expressions import mathexprs as M
    from ..expressions import nullexprs as N
    from ..expressions import predicates as P
    return frozenset({
        B.Alias, C.Cast, A.Add, A.Subtract, A.Multiply, A.UnaryMinus,
        A.UnaryPositive, A.Abs, P.EqualTo, P.EqualNullSafe, P.LessThan,
        P.LessThanOrEqual, P.GreaterThan, P.GreaterThanOrEqual, P.In,
        P.InSet, N.IsNull, N.IsNotNull, CO.If, CO.CaseWhen, CO.Greatest,
        CO.Least, N.Coalesce, AGG.Sum, AGG.Average, AGG.Min, AGG.Max,
        AGG.Count, AGG.First, AGG.Last, H.Murmur3Hash, H.XxHash64,
        A.Divide, A.Remainder, A.Pmod, M.Round, M.BRound, M.Floor, M.Ceil})


def decimal_input_reason(e) -> Optional[str]:
    """Why ``e`` cannot run on the card over its decimal children (None
    when it can): the port's device code carries decimals through the
    expressions above; anything else over a decimal waits (ROADMAP A6)."""
    from ..types import DecimalType
    for c in e.children:
        try:
            dt = c.dtype
        except (ValueError, NotImplementedError):
            continue
        if isinstance(dt, DecimalType) \
                and type(e) not in _decimal_input_classes():
            name = type(e).__name__
            return (f"expression {name} over {dt.simple_string()} is not "
                    f"supported on TPU (decimal {name} not yet ported, "
                    "ROADMAP A6)")
    return None


def decimal_key_reason(what: str, exprs) -> Optional[str]:
    """Why a key of ``what`` (group, sort, join, partition) stays off the
    card: a two-limb decimal key (ROADMAP A6; one-lane decimal keys order
    as their int64)."""
    from ..types import DecimalType
    for e in exprs:
        dt = e.dtype
        if isinstance(dt, DecimalType) and dt.wide:
            return (f"{what} key {e.pretty()} of {dt.simple_string()} is "
                    "not supported on TPU (decimal128 keys not yet ported, "
                    "ROADMAP A6)")
    return None


def conf_gate_reason(e, conf) -> Optional[str]:
    """Config-driven expression gates beyond the per-class switch
    (reference RapidsConf incompatibility switches: castFloatToString,
    castStringToFloat, castStringToTimestamp, variableFloatAgg). A gated
    expression keeps its operator in the host engine."""
    from ..config import (CAST_FLOAT_TO_STRING_ENABLED,
                          CAST_STRING_TO_FLOAT_ENABLED,
                          CAST_STRING_TO_TIMESTAMP_ENABLED,
                          VARIABLE_FLOAT_AGG_ENABLED)
    from ..expressions.aggregates import Average, Sum
    from ..expressions.cast import Cast
    from ..types import DoubleType, FloatType, StringType, TimestampType
    if isinstance(e, Cast) and e.children:
        src, dst = e.children[0].dtype, e.dtype
        if isinstance(src, (FloatType, DoubleType)) \
                and isinstance(dst, StringType) \
                and not conf.get(CAST_FLOAT_TO_STRING_ENABLED):
            return ("float-to-string cast disabled via "
                    f"{CAST_FLOAT_TO_STRING_ENABLED.key}")
        if isinstance(src, StringType) \
                and isinstance(dst, (FloatType, DoubleType)) \
                and not conf.get(CAST_STRING_TO_FLOAT_ENABLED):
            return ("string-to-float cast disabled via "
                    f"{CAST_STRING_TO_FLOAT_ENABLED.key}")
        if isinstance(src, StringType) \
                and isinstance(dst, TimestampType) \
                and not conf.get(CAST_STRING_TO_TIMESTAMP_ENABLED):
            return ("string-to-timestamp cast disabled via "
                    f"{CAST_STRING_TO_TIMESTAMP_ENABLED.key}")
    if isinstance(e, (Sum, Average)) and e.children \
            and isinstance(e.children[0].dtype, (FloatType, DoubleType)) \
            and not conf.get(VARIABLE_FLOAT_AGG_ENABLED):
        return ("float aggregation result can vary with parallelism; "
                f"disabled via {VARIABLE_FLOAT_AGG_ENABLED.key}")
    return None


def scan_type_error(attrs) -> Optional[str]:
    """Why a file scan cannot read its columns: the first one whose type
    the port has no carrier for (``TypeSigs.scan``: no nested type). The
    planner raises it."""
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
