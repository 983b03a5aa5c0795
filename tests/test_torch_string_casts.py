"""Casts to and from strings in the port (``spark_rapids_tpu_torch/
expressions/cast.py``) held to the reference's ``Cast.eval_tpu`` on the
JAX CPU backend, exactly, compared as strings where the result is text:

* integral, float, double, boolean, date and timestamp → string (Java's
  ``Double.toString``/``Float.toString`` text for floats: the vectorized
  path and the row-at-a-time ``_spark_float_str`` agree on every value);
* string → byte/short/int/long, float/double, boolean, date and timestamp
  (the UTC session zone), with whitespace, signs, special literals,
  overflow, garbage and nulls;
* literals by the same rules.

Inputs come from a numpy seed. Where the reference departs from Spark
(ROADMAP C-ref-15), the port is held to Spark's answer instead."""

import collections
import datetime

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.columnar.batch import TpuColumnarBatch
from spark_rapids_tpu.columnar.vector import TpuColumnVector
from spark_rapids_tpu.expressions import base as RB
from spark_rapids_tpu.expressions import cast as RC
from spark_rapids_tpu import types as RT
import spark_rapids_tpu_torch.expressions.strings as PS
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import TorchColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import TorchColumnVector
from spark_rapids_tpu_torch.expressions import base as PB
from spark_rapids_tpu_torch.expressions import cast as PC
from spark_rapids_tpu_torch.expressions.base import EvalContext
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

N = 300


def _values():
    rng = np.random.default_rng(41)
    i = rng.integers(-2**31, 2**31, N).astype(np.int32)
    i[:4] = [0, -1, 2**31 - 1, -2**31]
    ln = rng.integers(-2**62, 2**62, N).astype(np.int64)
    d = rng.choice([1.0, 1e-3, 1e7, 1e-5, 123.456], N) \
        * rng.normal(size=N) * 10.0 ** rng.integers(-8, 12, N)
    d[:10] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e7, 9999999.999999998,
              1e-3, 0.1, 5e-324]
    f = d.astype(np.float32)
    b = rng.random(N) < 0.5
    days = rng.integers(-200_000, 200_000, N).astype(np.int32)
    micros = rng.integers(-2**55, 2**55, N).astype(np.int64)
    micros[:3] = [0, 1, -1]
    ints = [" 42 ", "-7", "+5", "0", "2147483647", "-2147483648",
            "2147483648", "99999999999999999999", "abc", "", "12a", "-",
            "9223372036854775807", "-9223372036854775808", "  -0012  ",
            "127", "128", "-129", "32767", "40000"]
    dbls = ["1.5", " -2.25e3 ", "nan", "NaN", "Infinity", "-inf", "+inf",
            "1d", "2.5f", ".5", "5.", "1e400", "abc", "", "-0.0", "1e-400",
            "0x10", "3.14159265358979", "  7  ", "1E5"]
    bools = ["true", "FALSE", " t ", "y", "yes", "no", "n", "0", "1", "x",
             "", "tRuE"]
    dates = ["2020-01-31", " 1998-12-01 ", "2020-02-30", "2020-1-5",
             "2020-01", "2020", "2020-01-31T12:00", "2020-01-31 x",
             "0001-01-01", "9999-12-31", "+2020-03-04", "abc", "",
             "2020-13-01"]
    stamps = ["2020-01-31 12:34:56", "2020-01-31T12:34:56.123456",
              "2020-01-31 12:34:56.5Z", "2020-01-31 01:02:03+02:00",
              "2020-01-31 01:02:03 UTC", "2020-01-31", "epoch",
              "2020-01-31 25:00:00", "1969-12-31 23:59:59.999999",
              "abc", "2020-01-31 12:34", "2020-01-31 12:34:56-0130"]

    def pick(pool):
        out = list(rng.choice(np.array(pool, dtype=object), N))
        out[:len(pool)] = pool
        return [None if rng.random() < 0.05 else v for v in out]

    null = rng.random(N) < 0.07
    return {"i": i, "l": ln, "d": d, "f": f, "b": b, "dt": days,
            "ts": micros, "s_int": pick(ints), "s_dbl": pick(dbls),
            "s_bool": pick(bools), "s_date": pick(dates),
            "s_ts": pick(stamps)}, null


COLS, NULL = _values()
TYPES = {"i": "int", "l": "bigint", "d": "double", "f": "float",
         "b": "boolean", "dt": "date", "ts": "timestamp"}


def _arrow(name):
    v = COLS[name]
    if name.startswith("s_"):
        return pa.array(v, pa.string())
    mask = NULL
    if name == "dt":
        return pa.array(v, pa.int32(), mask=mask).cast(pa.date32())
    if name == "ts":
        return pa.array(v, pa.int64(), mask=mask).cast(
            pa.timestamp("us", tz="UTC"))
    return pa.array(v, mask=mask)


def _port_column(name):
    v = COLS[name]
    if name.startswith("s_"):
        return TorchColumnVector.from_numpy(PT.StringT,
                                            np.array(v, dtype=object))
    dtype = PT.type_from_string(TYPES[name])
    return TorchColumnVector.from_numpy(dtype, v, ~NULL)


def _cast_rows(name, to):
    arr = _arrow(name)
    rcol = TpuColumnVector.from_arrow(arr)
    rref = RB.AttributeReference("c", rcol.dtype, ordinal=0)
    rbatch = TpuColumnarBatch([rcol], N, names=["c"])
    want = RC.Cast(rref, RT.parse_ddl_type(to)).eval_tpu(rbatch)
    want = want.to_arrow().to_pylist()[:N]
    pcol = _port_column(name)
    pref = PB.AttributeReference("c", pcol.dtype, ordinal=0)
    pbatch = TorchColumnarBatch([pcol], N, names=["c"])
    ctx = EvalContext(counters=collections.Counter())
    got = PC.Cast(pref, PT.type_from_string(to)).eval_device(pbatch, ctx)
    assert PS.host_path_counts(ctx.counters) == {("Cast", "string cast"): 1}
    return got.to_pylist(), want


def _pad_year(text):
    """A timestamp's text with its year padded to four digits, as Spark
    writes it (the reference leaves it unpadded, ROADMAP C-ref-45)."""
    if text is None:
        return None
    year, rest = text.split("-", 1)
    return year.zfill(4) + "-" + rest


@pytest.mark.parametrize("name", sorted(TYPES))
def test_to_string_equals_the_reference(name):
    got, want = _cast_rows(name, "string")
    if name == "ts":
        want = [_pad_year(w) for w in want]
    assert got == want


def _instants(rows):
    """Timestamps as epoch microseconds (the reference's carry a zone)."""
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    return [None if v is None else (v.replace(tzinfo=datetime.timezone.utc)
                                    - epoch) // datetime.timedelta(
                                        microseconds=1) for v in rows]


#: (column, target) pairs; the rows where the reference is not Spark's
#: answer (C-ref-15) are checked apart below
PARSES = [("s_int", t) for t in ("tinyint", "smallint", "int", "bigint")] \
    + [("s_dbl", t) for t in ("double", "float")] \
    + [("s_bool", "boolean"), ("s_date", "date"), ("s_ts", "timestamp"),
       ("s_int", "double"), ("s_date", "timestamp")]


@pytest.mark.parametrize("name,to", PARSES)
def test_from_string_equals_the_reference(name, to):
    got, want = _cast_rows(name, to)
    if to == "timestamp":
        got, want = _instants(got), _instants(want)
    if to in ("double", "float"):
        # NaN != NaN: compare the text
        got, want = [repr(v) for v in got], [repr(v) for v in want]
    assert got == want


def test_round_trips_through_strings():
    for name, to in (("i", "int"), ("l", "bigint"), ("d", "double"),
                     ("b", "boolean"), ("dt", "date")):
        pcol = _port_column(name)
        pref = PB.AttributeReference("c", pcol.dtype, ordinal=0)
        pbatch = TorchColumnarBatch([pcol], N, names=["c"])
        dt = PT.type_from_string(to)
        back = PC.Cast(PC.Cast(pref, PT.StringT), dt).eval_device(pbatch)
        want = pcol.to_pylist()
        if name == "d":  # Java's shortest text parses back exactly
            back, want = [repr(v) for v in back.to_pylist()], \
                [repr(v) for v in want]
        else:
            back = back.to_pylist()
        assert back == want, name


def test_float_text_vectorized_equals_row_at_a_time():
    rng = np.random.default_rng(5)
    d = rng.normal(size=5000) * 10.0 ** rng.integers(-12, 14, 5000)
    d[:6] = [1e-3, 1e7, 9999999.999999998, 0.0009999999999999998, -1e-3,
             123.0]
    for is32 in (False, True):
        v = d.astype(np.float32) if is32 else d
        got = PC._float_strings(pa.array(v), is32).to_pylist()
        assert got == [RC._spark_float_str(float(x), is32) for x in v]


@pytest.mark.parametrize("value,src,to", [
    (42, "int", "string"), (-1.5, "double", "string"), (True, "boolean",
                                                        "string"),
    (1e20, "double", "string"), (" 17 ", "string", "int"),
    ("2.5", "string", "double"), ("yes", "string", "boolean")])
def test_literal_casts_equal_the_reference(value, src, to):
    from spark_rapids_tpu_torch.columnar.vector import TorchScalar
    got = PC.Cast(PB.Literal(value, PT.type_from_string(src)),
                  PT.type_from_string(to)).eval_device(None)
    assert isinstance(got, TorchScalar)
    want = RC._cast_scalar(value, RT.parse_ddl_type(src),
                           RT.parse_ddl_type(to), False)
    assert got.value == want


def test_spark_answers_where_the_reference_departs():
    """C-ref-15: Spark's ``UTF8String.toInt`` truncates a fraction ("1.5"
    is 1, "5." is 5, "-.7" is 0) and reads no Python-only syntax ("1_000"
    and "٣" are null); a literal past the type's range is null, as a
    column's (the reference wraps a literal), and the literal "no" casts
    to false (the reference's literal cast takes Python's truth of the
    text: true)."""
    vals = ["1.5", "5.", "-.7", "1_000", "٣", "1.5x", "+.", None]
    pcol = TorchColumnVector.from_numpy(PT.StringT,
                                        np.array(vals, dtype=object))
    pref = PB.AttributeReference("c", PT.StringT, ordinal=0)
    got = PC.Cast(pref, PT.IntegerT).eval_device(
        TorchColumnarBatch([pcol], len(vals)))
    assert got.to_pylist() == [1, 5, 0, None, None, None, 0, None]
    lit = PC.Cast(PB.Literal("2147483648"), PT.IntegerT).eval_device(None)
    assert lit.value is None
    assert PC.Cast(PB.Literal("1_0"), PT.DoubleT).eval_device(None) \
        .value is None
    assert PC.Cast(PB.Literal("no"), PT.BooleanT).eval_device(None) \
        .value is False
    assert RC._cast_scalar("no", RT.StringT, RT.BooleanT, False) is True
