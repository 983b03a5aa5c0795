"""TPC-H Q1 and Q6 as Spark writes them over decimal(12, 2) measures
(Spark's TPC-H schema), at 4,096 rows: on the port's device path (test
mode: every operator on the card) and in its host engine, both equal to
a Python ``decimal`` oracle exactly — values, scales and types. The
reference's answers are recorded (ROADMAP C-ref-37: its decimal
arithmetic keeps the left operand's type, so its Q1 sums go wrong)."""

import decimal

import pytest

from spark_rapids_tpu_torch import datagen, tpch
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.memory.device import TorchDeviceManager
from spark_rapids_tpu_torch.session import TorchSession

TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)

ROWS = 4096
DEC = decimal.Decimal
EXACT = decimal.Context(prec=100, rounding=decimal.ROUND_HALF_UP)


@pytest.fixture(scope="module")
def table():
    return datagen.decimal_lineitem_arrow(datagen.lineitem_decimal(ROWS))


def _half_up(v: DEC, scale: int) -> DEC:
    return v.quantize(DEC(1).scaleb(-scale), context=EXACT)


def _spark_avg(total: DEC, n: int, p: int, s: int) -> DEC:
    """Spark's avg of decimal(p, s): the sum over the count as its decimal
    Divide gives it (HALF_UP at scale 38 - intDigits of the sum type, here
    18), then cast HALF_UP to (p + 4, s + 4)."""
    q_scale = max(38 - (min(p + 10, 38) - s), min(s + 21, 6))
    q = _half_up(EXACT.divide(total, DEC(n)), q_scale)
    return _half_up(q, s + 4)


def q1_oracle(t):
    groups = {}
    for r in t.to_pylist():
        if r["l_shipdate"] > 10471:
            continue
        g = groups.setdefault((r["l_returnflag"], r["l_linestatus"]),
                              [DEC(0)] * 6 + [0])
        price, disc, tax = r["l_extendedprice"], r["l_discount"], r["l_tax"]
        disc_price = EXACT.multiply(price, EXACT.subtract(DEC(1), disc))
        charge = EXACT.multiply(disc_price, EXACT.add(DEC(1), tax))
        for i, v in enumerate((r["l_quantity"], price, disc_price, charge,
                               disc)):
            g[i] = EXACT.add(g[i], v)
        g[6] += 1
    out = []
    for (rf, ls), g in sorted(groups.items()):
        n = g[6]
        out.append({"l_returnflag": rf, "l_linestatus": ls,
                    "sum_qty": _half_up(g[0], 2),
                    "sum_base_price": _half_up(g[1], 2),
                    "sum_disc_price": _half_up(g[2], 4),
                    "sum_charge": _half_up(g[3], 6),
                    "avg_qty": _spark_avg(g[0], n, 12, 2),
                    "avg_price": _spark_avg(g[1], n, 12, 2),
                    "avg_disc": _spark_avg(g[4], n, 12, 2),
                    "count_order": n})
    return out


def q6_oracle(t):
    total = DEC("0.0000")
    for r in t.to_pylist():
        if 8766 <= r["l_shipdate"] < 9131 \
                and DEC("0.05") <= r["l_discount"] <= DEC("0.07") \
                and r["l_quantity"] < 24:
            total = EXACT.add(total, EXACT.multiply(r["l_extendedprice"],
                                                    r["l_discount"]))
    return [{"revenue": _half_up(total, 4)}]


@pytest.fixture(scope="module")
def oracles(table):
    return {"q1": q1_oracle(table), "q6": q6_oracle(table)}


Q1_TYPES = [PT.StringT, PT.StringT, PT.DecimalType(22, 2),
            PT.DecimalType(22, 2), PT.DecimalType(36, 4),
            PT.DecimalType(38, 6), PT.DecimalType(16, 6),
            PT.DecimalType(16, 6), PT.DecimalType(16, 6), PT.LongT]


def _session(device: bool) -> TorchSession:
    conf = {"spark.rapids.sql.test.enabled": "true"} if device else \
        {"spark.rapids.sql.enabled": "false"}
    return TorchSession(conf, device="cpu")


@pytest.mark.parametrize("cached", [False, True], ids=["local", "cached"])
@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("query", ["q1", "q6"])
def test_decimal_tpch_matches_python_decimal(query, device, cached, table,
                                             oracles):
    s = _session(device)
    df = s.createDataFrame(table)
    if cached:
        df = df.cache()
    q = {"q1": tpch.q1_decimal, "q6": tpch.q6_decimal}[query](
        {"lineitem": df})
    got = q.collect()
    want = oracles[query]
    assert got == want
    # the scale too, not only the value
    assert [[str(v) for v in r.values()] for r in got] == \
        [[str(v) for v in r.values()] for r in want]
    types = [f.data_type for f in q.schema.fields]
    assert types == (Q1_TYPES if query == "q1" else
                     [PT.DecimalType(35, 4)])
    if device:
        # test mode: every operator ran on the card, the decimal products
        # past 18 digits on the limb path, nothing on the decimal host hop
        plan = q.explain().split("== Physical Plan ==")[-1]
        for scan in ("CpuLocalTableScanExec", "CpuCachedScan"):
            plan = plan.replace(scan, "")
        assert "Cpu" not in plan
        assert s.counters["decimal.hostPath"] == 0


def test_decimal_q1_limb_path_and_collect_repeats(table):
    """Both of Q1's products are past 18 digits (26 and 38), so Q1 runs
    the two-limb path on the card; a second collect gives the same rows."""
    s = _session(True)
    df = s.createDataFrame(table)
    q = tpch.q1_decimal({"lineitem": df})
    plan = q.explain()
    assert "TorchHashAggregate" in plan and "TorchCompiledAggStage" not in plan
    first = q.collect()
    assert q.collect() == first


def test_reference_q1_answers_recorded(table, oracles):
    """The reference's Q1 over the same decimal table. On its device path
    (the sums' decimal(22, 2) sends its aggregate to its host engine)
    ``1 - l_discount`` keeps the integer type, so ``sum_disc_price`` and
    ``sum_charge`` come out negative (C-ref-37), and each avg is rounded
    to the input's two places before it is widened (C-ref-42); its counts
    and plain sums agree with Spark's. Its host engine raises on the
    products' 40 digits (C-ref-43)."""
    from spark_rapids_tpu.session import TpuSession
    import spark_rapids_tpu.functions as RF
    dev = TpuSession({"spark.rapids.sql.enabled": "true"})
    got = tpch.q1_decimal({"lineitem": dev.createDataFrame(table)},
                          F=RF).collect()
    want = oracles["q1"]
    for g, w in zip(got, want):
        for k in ("count_order", "sum_qty", "sum_base_price"):
            assert g[k] == w[k]
        assert g["sum_disc_price"] < 0 < w["sum_disc_price"]
        assert g["sum_charge"] < 0 < w["sum_charge"]
        assert g["avg_qty"] == _half_up(_half_up(w["avg_qty"], 2), 6)
    host = TpuSession({"spark.rapids.sql.enabled": "false"})
    with pytest.raises(Exception, match="precision out of range"):
        tpch.q1_decimal({"lineitem": host.createDataFrame(table)},
                        F=RF).collect()


def test_chip_smoke_phase18_rehearsal(tmp_path):
    """chip_smoke's phase 18 off the card at small sizes: every check of
    (a)-(d) against its numpy and Python oracles and the host engine (no
    timing lines)."""
    import chip_smoke
    from spark_rapids_tpu_torch import functions as TF
    chip_smoke.decimal_paths(TF, TorchSession, "cpu", str(tmp_path),
                             device="cpu", rows=1 << 12, file_rows=1 << 11,
                             sweep_rows=1 << 13, div_rows=1 << 11,
                             rest_rows=1 << 13, rest_check=1 << 11)
