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
