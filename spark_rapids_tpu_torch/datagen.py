"""Deterministic TPC-H data generator: the eight tables of the TPC-H
schema that ``benchmarks/tpch.py`` reads (port of that part of
``spark_rapids_tpu/datagen.py``).

Every column is a pure function of (seed, table, column, partition): each
draws from its own numpy stream in exactly the reference's order, so the
port's tables are the reference's, value for value and byte for byte. The
reference builds string columns as Python lists, one string a row; here
they are built vectorized, straight into Arrow-layout offsets + bytes
(``HostStrings``), which is what ``createDataFrame`` uploads. No pyarrow.

Output of ``TableSpec.generate``: a dict name → numpy array (int32/int64/
float64/bool, ``datetime64[D]`` for dates) or ``HostStrings``, with an
optional ``validity`` dict for columns with nulls.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .columnar.vector import HostStrings


def _cell_rng(seed: int, table: str, column: str,
              part: int) -> np.random.Generator:
    """One stable stream a (seed, table, column, partition): a content
    hash, never Python's salted ``hash()``."""
    key = zlib.crc32(f"{seed}|{table}|{column}|{part}".encode())
    return np.random.default_rng((seed << 32) ^ key)


def _strings_from_words(words: Sequence[str], idx: np.ndarray) -> HostStrings:
    """``words[idx]`` as offsets + bytes, without a Python loop over rows:
    the words as a zero-padded byte matrix, one row a pick, then the
    bytes inside each word's length."""
    enc = [w.encode() for w in words]
    wlen = np.array([len(e) for e in enc], np.int64)
    width = max(int(wlen.max()), 1)
    mat = np.zeros((len(enc), width), np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, np.uint8)
    lens = wlen[idx]
    offsets = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    chars = mat[idx][np.arange(width)[None, :] < lens[:, None]]
    return HostStrings(offsets.astype(np.int32), chars)


def _keep_rows(col: HostStrings, keep: np.ndarray) -> HostStrings:
    """The strings of the rows where ``keep``, the others empty."""
    offs = col.offsets.astype(np.int64)
    lens = np.diff(offs) * keep
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    byte_row = np.repeat(np.arange(len(lens)), np.diff(offs))
    return HostStrings(offsets.astype(np.int32),
                       col.chars[keep[byte_row]] if len(byte_row)
                       else col.chars)


class ColumnSpec:
    """One column: ``kind`` is seq/key/int/long/double/bool/date/string/
    choice/derive, with the reference's parameters."""

    def __init__(self, name: str, kind: str, *,
                 cardinality: Optional[int] = None, skew: float = 0.0,
                 min_val=None, max_val=None, null_prob: float = 0.0,
                 alphabet: str = "abcdefghij", max_len: int = 12,
                 values: Optional[Sequence[str]] = None,
                 sequential: bool = False, modulo: Optional[int] = None,
                 repeat: int = 1, derive=None):
        self.name = name
        self.kind = kind
        self.cardinality = cardinality
        self.skew = skew
        self.min_val = min_val
        self.max_val = max_val
        self.null_prob = null_prob
        self.alphabet = alphabet
        self.max_len = max_len
        self.values = list(values) if values is not None else None
        self.sequential = sequential
        self.modulo = modulo
        self.repeat = repeat
        # derive: fn(cols_so_far, rng, n, offset) -> numpy column
        self.derive = derive

    def _zipf_or_uniform(self, rng, k: int, n: int) -> np.ndarray:
        if self.skew > 0:
            ranks = np.arange(1, k + 1, dtype=np.float64)
            w = ranks ** (-self.skew)
            w /= w.sum()
            return rng.choice(k, size=n, p=w)
        return rng.integers(0, k, n)

    def generate(self, rng: np.random.Generator, n: int, offset: int = 0):
        """(values, validity or None), drawing from ``rng`` in the
        reference's order."""
        if self.kind == "seq":
            vals = np.arange(offset, offset + n, dtype=np.int64) // self.repeat
            if self.modulo:
                vals = vals % self.modulo
            return vals, None
        if self.kind == "choice":
            if self.sequential:
                idx = np.arange(offset, offset + n) % len(self.values)
            else:
                idx = self._zipf_or_uniform(rng, len(self.values), n)
            return self._with_nulls(_strings_from_words(self.values, idx),
                                    rng, n)
        if self.kind in ("key", "int", "long"):
            if self.cardinality:
                vals = self._zipf_or_uniform(rng, self.cardinality, n)
            else:
                lo = self.min_val if self.min_val is not None else 0
                hi = self.max_val if self.max_val is not None else 2**31 - 1
                vals = rng.integers(lo, hi + 1, n, dtype=np.int64)
            vals = vals.astype(np.int64 if self.kind == "long" else np.int32)
        elif self.kind == "double":
            lo = self.min_val if self.min_val is not None else 0.0
            hi = self.max_val if self.max_val is not None else 1.0
            vals = rng.random(n) * (hi - lo) + lo
        elif self.kind == "bool":
            vals = rng.integers(0, 2, n).astype(bool)
        elif self.kind == "date":
            lo = self.min_val if self.min_val is not None else 8000
            hi = self.max_val if self.max_val is not None else 12000
            vals = rng.integers(lo, hi, n).astype(np.int32).astype(
                "datetime64[D]")
        elif self.kind == "string":
            vals = self._strings(rng, n)
        else:
            raise ValueError(f"unknown column kind {self.kind}")
        return self._with_nulls(vals, rng, n)

    def _strings(self, rng: np.random.Generator, n: int) -> HostStrings:
        alpha = np.frombuffer(self.alphabet.encode(), np.uint8)
        card = self.cardinality or 0
        if card:
            # a dictionary of `card` words from its own stream, then picks
            dict_rng = np.random.default_rng(card * 7919 + 13)
            lens = dict_rng.integers(1, self.max_len + 1, card)
            words = ["".join(self.alphabet[c] for c in
                             dict_rng.integers(0, len(self.alphabet), l))
                     for l in lens]
            return _strings_from_words(words, rng.integers(0, card, n))
        lens = rng.integers(0, self.max_len + 1, n)
        chars = rng.integers(0, len(self.alphabet), int(lens.sum()))
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return HostStrings(offsets.astype(np.int32), alpha[chars])

    def _with_nulls(self, vals, rng: np.random.Generator, n: int):
        if self.null_prob <= 0:
            return vals, None
        valid = ~(rng.random(n) < self.null_prob)
        if isinstance(vals, HostStrings):
            vals = _keep_rows(vals, valid)
        else:
            vals = np.where(valid, vals, np.zeros((), vals.dtype))
        return vals, valid


class TableSpec:
    def __init__(self, name: str, columns: Sequence[ColumnSpec]):
        self.name = name
        self.columns = list(columns)

    def generate_partition(self, seed: int, part: int, rows: int,
                           offset: int = 0) -> Tuple[Dict, Dict]:
        cols: Dict[str, object] = {}
        valid: Dict[str, np.ndarray] = {}
        for c in self.columns:
            rng = _cell_rng(seed, self.name, c.name, part)
            if c.kind == "derive":
                cols[c.name] = c.derive(cols, rng, rows, offset)
                continue
            vals, v = c.generate(rng, rows, offset=offset)
            cols[c.name] = vals
            if v is not None:
                valid[c.name] = v
        return cols, valid

    def generate(self, seed: int, rows: int, partitions: int = 1):
        """The table as one host dict (partitions concatenated in order,
        each ``rows // partitions`` rows, the first ``rows % partitions``
        one more), plus the validity of columns with nulls. The split is
        the one ``createDataFrame(..., num_partitions=partitions)`` cuts."""
        per = rows // partitions
        parts: List[Tuple[Dict, Dict]] = []
        offset = 0
        for p in range(partitions):
            n = per + (1 if p < rows % partitions else 0)
            parts.append(self.generate_partition(seed, p, n, offset=offset))
            offset += n
        out, valid = {}, {}
        for c in self.columns:
            pieces = [cols[c.name] for cols, _ in parts]
            if isinstance(pieces[0], HostStrings):
                out[c.name] = HostStrings.concat(pieces)
            else:
                out[c.name] = np.concatenate(pieces)
            if any(c.name in v for _, v in parts):
                valid[c.name] = np.concatenate(
                    [v.get(c.name, np.ones(len(cols[c.name]), np.bool_))
                     for cols, v in parts])
        return out, valid


# --- the TPC-H schema at a given scale (rows ~ SF * base) -------------------

_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
            "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
            "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
            "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
            "UNITED KINGDOM", "UNITED STATES"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "blanched", "blue", "blush", "brown", "burlywood", "burnished",
           "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
           "cream", "cyan", "dark", "green", "forest", "frosted", "gainsboro",
           "ghost", "goldenrod", "honeydew", "hot", "indian", "ivory"]
_TYPES = [f"{a} {b} {c}"
          for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                    "PROMO")
          for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
          for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
_BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
_CONTAINERS = [f"{a} {b}"
               for a in ("SM", "MED", "LG", "JUMBO", "WRAP")
               for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                         "DRUM")]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_SUPPLIER_COMMENTS = [
    "quick deliveries", "ironic packages", "silent deposits",
    "Customer not Complaints noted", "regular accounts",
    "slyly final Customer Complaints", "bold requests"]
N_NATIONS = len(_NATIONS)
N_REGIONS = len(_REGIONS)


def tpch_lineitem(scale_rows: int) -> TableSpec:
    n_supp = max(scale_rows // 100, 1)

    def _li_suppkey(cols, rng, n, offset=0):
        # the supplier is one of the part's four partsupp suppliers
        pk = cols["l_partkey"].astype(np.int64)
        j = rng.integers(0, 4, n)
        return (31 * pk + 7 * j) % n_supp

    return TableSpec("lineitem", [
        ColumnSpec("l_orderkey", "key", cardinality=max(scale_rows // 4, 1)),
        ColumnSpec("l_partkey", "key", cardinality=max(scale_rows // 20, 1)),
        ColumnSpec("l_suppkey", "derive", derive=_li_suppkey),
        ColumnSpec("l_quantity", "int", min_val=1, max_val=50),
        ColumnSpec("l_extendedprice", "double", min_val=900.0,
                   max_val=105000.0),
        ColumnSpec("l_discount", "double", min_val=0.0, max_val=0.1),
        ColumnSpec("l_tax", "double", min_val=0.0, max_val=0.08),
        ColumnSpec("l_returnflag", "string", cardinality=3, max_len=1,
                   alphabet="RAN"),
        ColumnSpec("l_linestatus", "string", cardinality=2, max_len=1,
                   alphabet="OF"),
        ColumnSpec("l_shipdate", "date", min_val=8035, max_val=10590),
        ColumnSpec("l_commitdate", "date", min_val=8035, max_val=10590),
        ColumnSpec("l_receiptdate", "date", min_val=8035, max_val=10590),
        ColumnSpec("l_shipmode", "choice", values=_SHIPMODES),
        ColumnSpec("l_shipinstruct", "choice", values=_SHIPINSTRUCT),
    ])


def tpch_orders(scale_rows: int) -> TableSpec:
    return TableSpec("orders", [
        ColumnSpec("o_orderkey", "seq"),
        # 2/3 of the customer domain: a third of customers order nothing
        ColumnSpec("o_custkey", "key",
                   cardinality=max(2 * scale_rows // 30, 1)),
        ColumnSpec("o_orderdate", "date", min_val=8035, max_val=10590),
        ColumnSpec("o_totalprice", "double", min_val=800.0, max_val=600000.0),
        ColumnSpec("o_orderpriority", "choice", values=_PRIORITIES),
        ColumnSpec("o_orderstatus", "choice", values=["O", "F", "P"]),
    ])


def tpch_customer(scale_rows: int) -> TableSpec:
    return TableSpec("customer", [
        ColumnSpec("c_custkey", "seq"),
        ColumnSpec("c_name", "string", max_len=18),
        ColumnSpec("c_mktsegment", "choice", values=_SEGMENTS),
        ColumnSpec("c_acctbal", "double", min_val=-1000.0, max_val=10000.0),
        ColumnSpec("c_nationkey", "seq", modulo=N_NATIONS),
        ColumnSpec("c_phone", "string", alphabet="0123456789-", max_len=15),
    ])


def tpch_supplier(scale_rows: int) -> TableSpec:
    return TableSpec("supplier", [
        ColumnSpec("s_suppkey", "seq"),
        ColumnSpec("s_name", "string", max_len=18),
        ColumnSpec("s_nationkey", "seq", modulo=N_NATIONS),
        ColumnSpec("s_acctbal", "double", min_val=-1000.0, max_val=10000.0),
        # a minority of comments carry q16's exclusion phrase
        ColumnSpec("s_comment", "choice", values=_SUPPLIER_COMMENTS),
    ])


def tpch_part(scale_rows: int) -> TableSpec:
    return TableSpec("part", [
        ColumnSpec("p_partkey", "seq"),
        ColumnSpec("p_name", "choice", values=[
            f"{a} {b}" for a in _COLORS for b in ("metal", "steel", "satin")]),
        ColumnSpec("p_mfgr", "choice", values=[
            f"Manufacturer#{i}" for i in range(1, 6)]),
        ColumnSpec("p_type", "choice", values=_TYPES),
        ColumnSpec("p_brand", "choice", values=_BRANDS),
        ColumnSpec("p_container", "choice", values=_CONTAINERS),
        ColumnSpec("p_size", "int", min_val=1, max_val=50),
        ColumnSpec("p_retailprice", "double", min_val=900.0, max_val=2000.0),
    ])


def tpch_partsupp(n_parts: int, n_suppliers: int) -> TableSpec:
    """Four suppliers a part: ps_partkey = (row // 4) % n_parts, inside
    part's key domain for any row count; ps_suppkey is the affine layout
    that lineitem's ``l_suppkey`` mirrors, so every lineitem (part,
    supplier) pair exists here."""
    n_s = max(n_suppliers, 1)

    def _ps_suppkey(cols, rng, n, offset=0):
        pk = cols["ps_partkey"].astype(np.int64)
        j = np.arange(offset, offset + n) % 4
        return (31 * pk + 7 * j) % n_s

    return TableSpec("partsupp", [
        ColumnSpec("ps_partkey", "seq", repeat=4, modulo=max(n_parts, 1)),
        ColumnSpec("ps_suppkey", "derive", derive=_ps_suppkey),
        ColumnSpec("ps_availqty", "int", min_val=1, max_val=9999),
        ColumnSpec("ps_supplycost", "double", min_val=1.0, max_val=1000.0),
    ])


def tpch_nation() -> TableSpec:
    return TableSpec("nation", [
        ColumnSpec("n_nationkey", "seq"),
        ColumnSpec("n_name", "choice", values=_NATIONS, sequential=True),
        ColumnSpec("n_regionkey", "seq", modulo=N_REGIONS),
    ])


def tpch_region() -> TableSpec:
    return TableSpec("region", [
        ColumnSpec("r_regionkey", "seq"),
        ColumnSpec("r_name", "choice", values=_REGIONS, sequential=True),
    ])


#: every TPC-H table, in ``benchmarks/tpch.py``'s order
TPCH_TABLES = ("lineitem", "orders", "customer", "supplier", "part",
               "partsupp", "nation", "region")


def tpch_specs(rows: int, parts: int = 4) -> Dict[str, Tuple]:
    """Each table's (spec, rows, partitions) at lineitem-row scale
    ``rows``, at ``benchmarks/tpch.py``'s ratios (``load_tables``): orders
    rows/4, customer rows/40, supplier rows/100, part rows/20, partsupp
    four a part, 25 nations and 5 regions; lineitem and orders in
    ``parts`` partitions, the others in one."""
    n_orders = max(rows // 4, 1)
    n_cust = max(rows // 40, 1)
    n_supp = max(rows // 100, 1)
    n_part = max(rows // 20, 1)
    return {
        "lineitem": (tpch_lineitem(rows), rows, parts),
        "orders": (tpch_orders(n_orders), n_orders, parts),
        "customer": (tpch_customer(n_cust), n_cust, 1),
        "supplier": (tpch_supplier(n_supp), n_supp, 1),
        "part": (tpch_part(n_part), n_part, 1),
        "partsupp": (tpch_partsupp(n_part, n_supp), n_part * 4, 1),
        "nation": (tpch_nation(), N_NATIONS, 1),
        "region": (tpch_region(), N_REGIONS, 1),
    }


def tpch_host_tables(rows: int, parts: int = 4,
                     names: Sequence[str] = TPCH_TABLES) -> Dict[str, Tuple]:
    """The TPC-H tables ``names`` (all eight by default) at lineitem-row
    scale ``rows`` as the reference's benchmark loads them
    (``benchmarks/tpch.py`` ``load_tables``, seed 42; ``tpch_specs``).
    Each table as (host columns, validity, partitions)."""
    specs = tpch_specs(rows, parts)
    return {name: specs[name][0].generate(42, specs[name][1],
                                          specs[name][2])
            + (specs[name][2],) for name in names}


def tpch_frames(session, host: Dict[str, Tuple],
                parts: Optional[int] = None):
    """``tpch_host_tables``' tables as the session's DataFrames, each in
    its own partition count or, given ``parts``, in that many."""
    return {name: session.createDataFrame(
        cols, num_partitions=parts or p, validity=valid)
        for name, (cols, valid, p) in host.items()}


def tpch_tables(session, rows: int, parts: int = 4):
    """``tpch_host_tables`` as the session's DataFrames."""
    return tpch_frames(session, tpch_host_tables(rows, parts))


# the names these had when q3 was their only reader
q3_host_tables = tpch_host_tables
q3_frames = tpch_frames
q3_tables = tpch_tables


# --- the TPC-DS schema (``benchmarks/tpcds.py``'s 22 tables) ----------------

TPCDS_BASE_DATE = "1998-01-01"
TPCDS_DAYS = 2557  # 7 years, 1998-2004


def tpcds_date_dim(n_days: int = TPCDS_DAYS) -> Tuple[Dict, Dict]:
    """The calendar dimension: d_date_sk 0..n-1 are the days from
    ``TPCDS_BASE_DATE``, with year, month and day columns from the numpy
    calendar. (host columns, validity), as ``TableSpec.generate`` gives."""
    sk = np.arange(n_days, dtype=np.int64)
    d = (np.datetime64(TPCDS_BASE_DATE)
         + sk.astype("timedelta64[D]")).astype("datetime64[D]")
    years = d.astype("datetime64[Y]").astype(np.int64) + 1970
    months = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    dow = (d.astype(np.int64) + 4) % 7  # 1970-01-01 was a Thursday
    day_names = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                 "Friday", "Saturday"]
    return {
        "d_date_sk": sk,
        "d_date": d,
        "d_year": years.astype(np.int32),
        "d_moy": months.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((months - 1) // 3 + 1).astype(np.int32),
        "d_dow": dow.astype(np.int32),
        "d_day_name": _strings_from_words(day_names, dow),
        "d_week_seq": (d.astype(np.int64) + 4) // 7,
        "d_month_seq": (years - 1970) * 12 + months - 1,
    }, {}


_DS_CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Men", "Music",
                  "Shoes", "Sports", "Women", "Children"]
_DS_STATES = ["TN", "CA", "TX", "NY", "GA", "OH", "IL", "WA", "MI", "VA"]
_DS_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
                 "4 yr Degree", "Advanced Degree", "Unknown"]
_DS_MARITAL = ["M", "S", "D", "W", "U"]
_DS_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                     "0-500", "Unknown"]
_DS_CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]


def tpcds_item(n: int) -> TableSpec:
    return TableSpec("item", [
        ColumnSpec("i_item_sk", "seq"),
        ColumnSpec("i_item_id", "string", cardinality=max(n // 2, 1),
                   alphabet="ABCDEFGHIJKLMNOP", max_len=16),
        ColumnSpec("i_category", "choice", values=_DS_CATEGORIES),
        ColumnSpec("i_class", "choice", values=[
            f"class{i:02d}" for i in range(20)]),
        ColumnSpec("i_brand", "choice", values=[
            f"brand{i:02d}" for i in range(50)]),
        ColumnSpec("i_brand_id", "int", min_val=1000, max_val=10000),
        ColumnSpec("i_manufact_id", "int", min_val=1, max_val=1000),
        ColumnSpec("i_manager_id", "int", min_val=1, max_val=100),
        ColumnSpec("i_current_price", "double", min_val=0.5, max_val=300.0),
        ColumnSpec("i_wholesale_cost", "double", min_val=0.2, max_val=90.0),
        ColumnSpec("i_color", "choice", values=_COLORS),
        ColumnSpec("i_size", "choice", values=[
            "small", "medium", "large", "extra large", "petite", "N/A"]),
    ])


def tpcds_store(n: int = 12) -> TableSpec:
    return TableSpec("store", [
        ColumnSpec("s_store_sk", "seq"),
        ColumnSpec("s_store_id", "string", cardinality=n, max_len=8,
                   alphabet="STORE0123456789"),
        ColumnSpec("s_store_name", "choice", values=[
            f"store_{i}" for i in range(n)], sequential=True),
        ColumnSpec("s_state", "choice", values=_DS_STATES),
        ColumnSpec("s_county", "choice", values=[
            f"county{i}" for i in range(8)]),
        ColumnSpec("s_city", "choice", values=[
            f"city{i}" for i in range(20)]),
        ColumnSpec("s_gmt_offset", "double", min_val=-8.0, max_val=-5.0),
        ColumnSpec("s_number_employees", "int", min_val=200, max_val=300),
    ])


def tpcds_customer(n: int, n_addr: int, n_cdemo: int,
                   n_hdemo: int) -> TableSpec:
    return TableSpec("customer", [
        ColumnSpec("c_customer_sk", "seq"),
        ColumnSpec("c_customer_id", "string", cardinality=max(n, 1),
                   alphabet="CUSTID0123456789", max_len=16),
        ColumnSpec("c_current_addr_sk", "key", cardinality=max(n_addr, 1)),
        ColumnSpec("c_current_cdemo_sk", "key", cardinality=max(n_cdemo, 1)),
        ColumnSpec("c_current_hdemo_sk", "key", cardinality=max(n_hdemo, 1)),
        ColumnSpec("c_first_name", "string", cardinality=200, max_len=10,
                   alphabet="abcdefghijklmnop"),
        ColumnSpec("c_last_name", "string", cardinality=300, max_len=12,
                   alphabet="abcdefghijklmnop"),
        ColumnSpec("c_birth_year", "int", min_val=1930, max_val=2000),
        ColumnSpec("c_birth_country", "choice", values=_NATIONS),
    ])


def tpcds_customer_address(n: int) -> TableSpec:
    return TableSpec("customer_address", [
        ColumnSpec("ca_address_sk", "seq"),
        ColumnSpec("ca_state", "choice", values=_DS_STATES),
        ColumnSpec("ca_county", "choice", values=[
            f"county{i}" for i in range(8)]),
        ColumnSpec("ca_city", "choice", values=[
            f"city{i}" for i in range(20)]),
        ColumnSpec("ca_zip", "choice", values=[
            f"{z:05d}" for z in range(10000, 10080)]),
        ColumnSpec("ca_country", "choice", values=["United States"]),
        ColumnSpec("ca_gmt_offset", "double", min_val=-8.0, max_val=-5.0),
    ])


def tpcds_customer_demographics(n: int = 1000) -> TableSpec:
    return TableSpec("customer_demographics", [
        ColumnSpec("cd_demo_sk", "seq"),
        ColumnSpec("cd_gender", "choice", values=["M", "F"]),
        ColumnSpec("cd_marital_status", "choice", values=_DS_MARITAL),
        ColumnSpec("cd_education_status", "choice", values=_DS_EDUCATION),
        ColumnSpec("cd_purchase_estimate", "int", min_val=500, max_val=10000),
        ColumnSpec("cd_credit_rating", "choice", values=_DS_CREDIT),
        ColumnSpec("cd_dep_count", "int", min_val=0, max_val=6),
    ])


def tpcds_household_demographics(n: int = 720) -> TableSpec:
    return TableSpec("household_demographics", [
        ColumnSpec("hd_demo_sk", "seq"),
        ColumnSpec("hd_buy_potential", "choice", values=_DS_BUY_POTENTIAL),
        ColumnSpec("hd_dep_count", "int", min_val=0, max_val=9),
        ColumnSpec("hd_vehicle_count", "int", min_val=-1, max_val=4),
        ColumnSpec("hd_income_band_sk", "key", cardinality=20),
    ])


def tpcds_promotion(n: int = 30) -> TableSpec:
    return TableSpec("promotion", [
        ColumnSpec("p_promo_sk", "seq"),
        ColumnSpec("p_channel_email", "choice", values=["Y", "N"]),
        ColumnSpec("p_channel_event", "choice", values=["Y", "N"]),
        ColumnSpec("p_channel_tv", "choice", values=["Y", "N"]),
        ColumnSpec("p_channel_dmail", "choice", values=["Y", "N"]),
    ])


def tpcds_warehouse(n: int = 6) -> TableSpec:
    return TableSpec("warehouse", [
        ColumnSpec("w_warehouse_sk", "seq"),
        ColumnSpec("w_warehouse_name", "choice", values=[
            f"warehouse_{i}" for i in range(n)], sequential=True),
        ColumnSpec("w_state", "choice", values=_DS_STATES),
    ])


def tpcds_time_dim(n: int = 86400) -> TableSpec:
    return TableSpec("time_dim", [
        ColumnSpec("t_time_sk", "seq"),
        ColumnSpec("t_hour", "seq", repeat=3600, modulo=24),
        ColumnSpec("t_minute", "seq", repeat=60, modulo=60),
    ])


def tpcds_web_site(n: int = 8) -> TableSpec:
    return TableSpec("web_site", [
        ColumnSpec("web_site_sk", "seq"),
        ColumnSpec("web_name", "choice", values=[
            f"site_{i}" for i in range(n)], sequential=True),
    ])


def tpcds_ship_mode(n: int = 10) -> TableSpec:
    return TableSpec("ship_mode", [
        ColumnSpec("sm_ship_mode_sk", "seq"),
        ColumnSpec("sm_type", "choice", values=[
            "EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]),
        ColumnSpec("sm_carrier", "choice", values=[
            "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"]),
    ])


def tpcds_reason(n: int = 35) -> TableSpec:
    return TableSpec("reason", [
        ColumnSpec("r_reason_sk", "seq"),
        ColumnSpec("r_reason_desc", "choice",
                   values=[f"reason {i:02d}" for i in range(n)],
                   sequential=True),
    ])


def tpcds_call_center(n: int = 4) -> TableSpec:
    return TableSpec("call_center", [
        ColumnSpec("cc_call_center_sk", "seq"),
        ColumnSpec("cc_name", "choice",
                   values=[f"call_center_{i}" for i in range(n)],
                   sequential=True),
        ColumnSpec("cc_manager", "choice",
                   values=[f"manager_{i}" for i in range(8)]),
    ])


def tpcds_income_band(n: int = 20) -> TableSpec:
    def _lower(cols, rng, m, offset=0):
        return np.arange(offset, offset + m, dtype=np.int64) * 10000

    def _upper(cols, rng, m, offset=0):
        return (np.arange(offset, offset + m, dtype=np.int64) + 1) \
            * 10000 - 1

    return TableSpec("income_band", [
        ColumnSpec("ib_income_band_sk", "seq"),
        ColumnSpec("ib_lower_bound", "derive", derive=_lower),
        ColumnSpec("ib_upper_bound", "derive", derive=_upper),
    ])


def _sales_money_cols(p: str) -> List[ColumnSpec]:
    return [
        ColumnSpec(f"{p}_quantity", "int", min_val=1, max_val=100,
                   null_prob=0.02),
        ColumnSpec(f"{p}_wholesale_cost", "double", min_val=1.0,
                   max_val=100.0),
        ColumnSpec(f"{p}_list_price", "double", min_val=1.0, max_val=300.0),
        ColumnSpec(f"{p}_sales_price", "double", min_val=0.0, max_val=300.0,
                   null_prob=0.02),
        ColumnSpec(f"{p}_ext_discount_amt", "double", min_val=0.0,
                   max_val=1000.0),
        ColumnSpec(f"{p}_ext_sales_price", "double", min_val=0.0,
                   max_val=30000.0),
        ColumnSpec(f"{p}_ext_wholesale_cost", "double", min_val=1.0,
                   max_val=10000.0),
        ColumnSpec(f"{p}_ext_list_price", "double", min_val=1.0,
                   max_val=30000.0),
        ColumnSpec(f"{p}_ext_tax", "double", min_val=0.0, max_val=3000.0),
        ColumnSpec(f"{p}_coupon_amt", "double", min_val=0.0, max_val=500.0),
        ColumnSpec(f"{p}_net_paid", "double", min_val=0.0, max_val=30000.0),
        ColumnSpec(f"{p}_net_profit", "double", min_val=-5000.0,
                   max_val=10000.0),
    ]


def tpcds_store_sales(rows: int, n_items: int, n_cust: int, n_stores: int,
                      n_cdemo: int, n_hdemo: int, n_addr: int,
                      n_promo: int) -> TableSpec:
    """Item and customer are functions of the row and its ticket (item =
    (17·row + 5) mod n_items, customer = 13·ticket mod n_cust), so
    store_returns rows name real sales."""
    ni, nc = max(n_items, 1), max(n_cust, 1)

    def _ss_item(cols, rng, n, offset=0):
        return (17 * np.arange(offset, offset + n, dtype=np.int64) + 5) % ni

    def _ss_cust(cols, rng, n, offset=0):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        return (13 * (idx // 4)) % nc

    return TableSpec("store_sales", [
        ColumnSpec("ss_sold_date_sk", "key", cardinality=TPCDS_DAYS,
                   null_prob=0.01),
        ColumnSpec("ss_sold_time_sk", "key", cardinality=86400),
        ColumnSpec("ss_item_sk", "derive", derive=_ss_item),
        ColumnSpec("ss_customer_sk", "derive", derive=_ss_cust),
        ColumnSpec("ss_cdemo_sk", "key", cardinality=max(n_cdemo, 1)),
        ColumnSpec("ss_hdemo_sk", "key", cardinality=max(n_hdemo, 1)),
        ColumnSpec("ss_addr_sk", "key", cardinality=max(n_addr, 1)),
        ColumnSpec("ss_store_sk", "key", cardinality=max(n_stores, 1)),
        ColumnSpec("ss_promo_sk", "key", cardinality=max(n_promo, 1)),
        ColumnSpec("ss_ticket_number", "seq", repeat=4),
        *_sales_money_cols("ss"),
    ])


def tpcds_store_returns(rows: int, n_items: int, n_cust: int, n_stores: int,
                        n_tickets: int) -> TableSpec:
    """Each return names a real sale: a random ticket, and the item and
    customer re-derived from it by store_sales' layout."""
    ni, nc = max(n_items, 1), max(n_cust, 1)

    def _sr_item(cols, rng, n, offset=0):
        t = cols["sr_ticket_number"].astype(np.int64)
        j = rng.integers(0, 4, n)
        return (17 * (4 * t + j) + 5) % ni

    def _sr_cust(cols, rng, n, offset=0):
        return (13 * cols["sr_ticket_number"].astype(np.int64)) % nc

    return TableSpec("store_returns", [
        ColumnSpec("sr_returned_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("sr_ticket_number", "key", cardinality=max(n_tickets, 1)),
        ColumnSpec("sr_item_sk", "derive", derive=_sr_item),
        ColumnSpec("sr_customer_sk", "derive", derive=_sr_cust),
        ColumnSpec("sr_store_sk", "key", cardinality=max(n_stores, 1)),
        ColumnSpec("sr_reason_sk", "key", cardinality=35),
        ColumnSpec("sr_return_quantity", "int", min_val=1, max_val=40),
        ColumnSpec("sr_return_amt", "double", min_val=0.0, max_val=5000.0),
        ColumnSpec("sr_net_loss", "double", min_val=0.0, max_val=3000.0),
    ])


def tpcds_catalog_sales(rows: int, n_items: int, n_cust: int, n_cdemo: int,
                        n_hdemo: int, n_addr: int, n_promo: int,
                        n_wh: int) -> TableSpec:
    return TableSpec("catalog_sales", [
        ColumnSpec("cs_sold_date_sk", "key", cardinality=TPCDS_DAYS,
                   null_prob=0.01),
        ColumnSpec("cs_ship_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("cs_item_sk", "key", cardinality=max(n_items, 1)),
        ColumnSpec("cs_bill_customer_sk", "key", cardinality=max(n_cust, 1)),
        ColumnSpec("cs_bill_cdemo_sk", "key", cardinality=max(n_cdemo, 1)),
        ColumnSpec("cs_bill_hdemo_sk", "key", cardinality=max(n_hdemo, 1)),
        ColumnSpec("cs_bill_addr_sk", "key", cardinality=max(n_addr, 1)),
        ColumnSpec("cs_promo_sk", "key", cardinality=max(n_promo, 1)),
        ColumnSpec("cs_warehouse_sk", "key", cardinality=max(n_wh, 1)),
        ColumnSpec("cs_ship_mode_sk", "key", cardinality=10),
        ColumnSpec("cs_call_center_sk", "key", cardinality=4),
        ColumnSpec("cs_order_number", "seq", repeat=3),
        ColumnSpec("cs_sold_time_sk", "key", cardinality=86400),
        *_sales_money_cols("cs"),
    ])


def tpcds_catalog_returns(rows: int, n_items: int, n_orders: int,
                          n_cust: int = 100) -> TableSpec:
    return TableSpec("catalog_returns", [
        ColumnSpec("cr_returned_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("cr_item_sk", "key", cardinality=max(n_items, 1)),
        ColumnSpec("cr_order_number", "key", cardinality=max(n_orders, 1)),
        ColumnSpec("cr_return_quantity", "int", min_val=1, max_val=40),
        ColumnSpec("cr_return_amount", "double", min_val=0.0,
                   max_val=5000.0),
        ColumnSpec("cr_net_loss", "double", min_val=0.0, max_val=3000.0),
        ColumnSpec("cr_returning_customer_sk", "key",
                   cardinality=max(n_cust, 1)),
        ColumnSpec("cr_call_center_sk", "key", cardinality=4),
    ])


def tpcds_web_sales(rows: int, n_items: int, n_cust: int, n_addr: int,
                    n_sites: int, n_promo: int, n_wh: int = 6) -> TableSpec:
    return TableSpec("web_sales", [
        ColumnSpec("ws_sold_date_sk", "key", cardinality=TPCDS_DAYS,
                   null_prob=0.01),
        ColumnSpec("ws_ship_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("ws_sold_time_sk", "key", cardinality=86400),
        ColumnSpec("ws_item_sk", "key", cardinality=max(n_items, 1)),
        ColumnSpec("ws_bill_customer_sk", "key", cardinality=max(n_cust, 1)),
        ColumnSpec("ws_bill_addr_sk", "key", cardinality=max(n_addr, 1)),
        ColumnSpec("ws_web_site_sk", "key", cardinality=max(n_sites, 1)),
        ColumnSpec("ws_ship_mode_sk", "key", cardinality=10),
        ColumnSpec("ws_promo_sk", "key", cardinality=max(n_promo, 1)),
        ColumnSpec("ws_order_number", "seq", repeat=3),
        ColumnSpec("ws_warehouse_sk", "key", cardinality=max(n_wh, 1)),
        *_sales_money_cols("ws"),
    ])


def tpcds_web_returns(rows: int, n_items: int, n_orders: int,
                      n_cust: int = 100) -> TableSpec:
    return TableSpec("web_returns", [
        ColumnSpec("wr_returned_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("wr_item_sk", "key", cardinality=max(n_items, 1)),
        ColumnSpec("wr_order_number", "key", cardinality=max(n_orders, 1)),
        ColumnSpec("wr_return_quantity", "int", min_val=1, max_val=40),
        ColumnSpec("wr_return_amt", "double", min_val=0.0, max_val=5000.0),
        ColumnSpec("wr_net_loss", "double", min_val=0.0, max_val=3000.0),
        ColumnSpec("wr_returning_customer_sk", "key",
                   cardinality=max(n_cust, 1)),
        ColumnSpec("wr_reason_sk", "key", cardinality=35),
    ])


def tpcds_inventory(rows: int, n_items: int, n_wh: int) -> TableSpec:
    return TableSpec("inventory", [
        ColumnSpec("inv_date_sk", "key", cardinality=TPCDS_DAYS),
        ColumnSpec("inv_item_sk", "key", cardinality=max(n_items, 1)),
        ColumnSpec("inv_warehouse_sk", "key", cardinality=max(n_wh, 1)),
        ColumnSpec("inv_quantity_on_hand", "int", min_val=0, max_val=1000,
                   null_prob=0.02),
    ])


#: every TPC-DS table, in ``benchmarks/tpcds.py``'s order
TPCDS_TABLES = (
    "date_dim", "item", "store", "customer", "customer_address",
    "customer_demographics", "household_demographics", "promotion",
    "warehouse", "web_site", "ship_mode", "reason", "call_center",
    "income_band", "time_dim", "store_sales", "store_returns",
    "catalog_sales", "catalog_returns", "web_sales", "web_returns",
    "inventory")


def tpcds_specs(rows: int, parts: int = 4) -> Dict[str, Tuple]:
    """Each table's (spec, rows, partitions) at store_sales-row scale
    ``rows``, at ``benchmarks/tpcds.py``'s ratios (``load_tables``): items
    rows/50, customers rows/40, addresses half the customers, catalog
    sales rows/2, web sales and inventory rows/4, store returns rows/10,
    catalog and web returns a tenth of their sales; the six fact tables in
    ``parts`` partitions, the dimensions in one. date_dim's spec is None
    (``tpcds_date_dim`` builds it)."""
    n_items = max(rows // 50, 30)
    n_cust = max(rows // 40, 50)
    n_addr = max(n_cust // 2, 25)
    n_cdemo, n_hdemo, n_stores, n_promo, n_wh, n_sites = 400, 144, 12, 30, \
        6, 8
    n_cs = max(rows // 2, 1)
    n_ws = max(rows // 4, 1)
    n_sr = max(rows // 10, 1)
    n_cr = max(n_cs // 10, 1)
    n_wr = max(n_ws // 10, 1)
    n_inv = max(rows // 4, 1)
    return {
        "date_dim": (None, TPCDS_DAYS, 1),
        "item": (tpcds_item(n_items), n_items, 1),
        "store": (tpcds_store(), n_stores, 1),
        "customer": (tpcds_customer(n_cust, n_addr, n_cdemo, n_hdemo),
                     n_cust, 1),
        "customer_address": (tpcds_customer_address(n_addr), n_addr, 1),
        "customer_demographics": (tpcds_customer_demographics(), n_cdemo, 1),
        "household_demographics": (tpcds_household_demographics(), n_hdemo,
                                   1),
        "promotion": (tpcds_promotion(), n_promo, 1),
        "warehouse": (tpcds_warehouse(), n_wh, 1),
        "web_site": (tpcds_web_site(), n_sites, 1),
        "ship_mode": (tpcds_ship_mode(), 10, 1),
        "reason": (tpcds_reason(), 35, 1),
        "call_center": (tpcds_call_center(), 4, 1),
        "income_band": (tpcds_income_band(), 20, 1),
        "time_dim": (tpcds_time_dim(), 86400, 1),
        "store_sales": (tpcds_store_sales(rows, n_items, n_cust, n_stores,
                                          n_cdemo, n_hdemo, n_addr, n_promo),
                        rows, parts),
        "store_returns": (tpcds_store_returns(n_sr, n_items, n_cust,
                                              n_stores, max(rows // 4, 1)),
                          n_sr, parts),
        "catalog_sales": (tpcds_catalog_sales(n_cs, n_items, n_cust, n_cdemo,
                                              n_hdemo, n_addr, n_promo, n_wh),
                          n_cs, parts),
        "catalog_returns": (tpcds_catalog_returns(
            n_cr, n_items, max(n_cs // 3, 1), n_cust), n_cr, parts),
        "web_sales": (tpcds_web_sales(n_ws, n_items, n_cust, n_addr, n_sites,
                                      n_promo, n_wh), n_ws, parts),
        "web_returns": (tpcds_web_returns(n_wr, n_items, max(n_ws // 3, 1),
                                          n_cust), n_wr, parts),
        "inventory": (tpcds_inventory(n_inv, n_items, n_wh), n_inv, parts),
    }


def tpcds_host_tables(rows: int, parts: int = 4,
                      names: Sequence[str] = TPCDS_TABLES
                      ) -> Dict[str, Tuple]:
    """The TPC-DS tables ``names`` (all 22 by default) at store_sales-row
    scale ``rows`` as the reference's benchmark loads them
    (``benchmarks/tpcds.py`` ``load_tables``, seed 42; ``tpcds_specs``),
    each as (host columns, validity, partitions)."""
    specs = tpcds_specs(rows, parts)
    out = {}
    for name in names:
        spec, n, p = specs[name]
        cols = tpcds_date_dim(n) if spec is None else spec.generate(42, n, p)
        out[name] = cols + (p,)
    return out


def tpcds_tables(session, rows: int, parts: int = 4):
    """``tpcds_host_tables`` as the session's DataFrames."""
    return tpch_frames(session, tpcds_host_tables(rows, parts))


# ---------------------------------------------------------------------------
# lineitem with decimal(12, 2) measures (Spark's TPC-H schema)
# ---------------------------------------------------------------------------

#: the measures Spark's TPC-H schema declares decimal(12, 2)
DECIMAL_MEASURES = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def lineitem_decimal(n: int, seed: int = 42) -> Dict[str, np.ndarray]:
    """bench.py's Q1-shaped lineitem draws (``chip_smoke.lineitem``: the
    same generator calls, seed 42) with the four measures rounded to cents
    and held as their unscaled int64 (decimal(12, 2)): quantity 1–50,
    price 900.00–100,000.00, discount 0.00–0.10, tax 0.00–0.08. Flags are
    bytes, ``l_shipdate`` int32 day numbers."""
    rng = np.random.default_rng(seed)
    cents = lambda x: np.rint(x * 100.0).astype(np.int64)  # noqa: E731
    return {
        "l_returnflag": np.array([b"A", b"N", b"R"])[rng.integers(0, 3, n)],
        "l_linestatus": np.array([b"F", b"O"])[rng.integers(0, 2, n)],
        "l_quantity": cents(rng.uniform(1, 50, n)),
        "l_extendedprice": cents(rng.uniform(900, 100000, n)),
        "l_discount": cents(rng.uniform(0, 0.1, n)),
        "l_tax": cents(rng.uniform(0, 0.08, n)),
        "l_shipdate": rng.integers(8766, 10957, n).astype(np.int32),
    }


def decimal_lineitem_arrow(cols: Dict[str, np.ndarray], start: int = 0,
                           stop: Optional[int] = None):
    """Rows [start, stop) of ``lineitem_decimal``'s columns as an Arrow
    table, the measures decimal128(12, 2) built from their unscaled
    values (no per-row Python)."""
    import pyarrow as pa
    from .columnar.vector import decimal_to_arrow
    from .types import DecimalType
    from .columnar.vector import strings_to_buffers
    out = {}
    for name, v in cols.items():
        v = v[start:stop]
        if name in DECIMAL_MEASURES:
            out[name] = decimal_to_arrow(v, DecimalType(12, 2), None)
        elif v.dtype.kind == "S":
            offs, chars, _ = strings_to_buffers(v)
            out[name] = pa.StringArray.from_buffers(
                len(v), pa.py_buffer(offs), pa.py_buffer(chars))
        else:
            out[name] = pa.array(v)
    return pa.table(out)
