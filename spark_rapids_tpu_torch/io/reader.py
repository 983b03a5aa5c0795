"""DataFrameReader: lazy file-source scans (port of
``spark_rapids_tpu/io/reader.py``). ``session.read.parquet(path)``,
``.orc``, ``.csv``, ``.json`` and ``session.read.format(fmt).load(path)``
plan a ``FileScan``; a directory reads its data files, and ``key=value``
subdirectories become partition columns. ``schema`` takes a
``StructType`` or a DDL string (``"a INT, b STRING"``). Avro, Hive text,
Delta and Iceberg raise "not yet ported (A9)".
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional


_DATA_EXTS = ("parquet", "orc", "csv", "json", "avro", "txt")


def _dir_files(d: str) -> List[str]:
    out: List[str] = []
    for ext in _DATA_EXTS:
        out.extend(sorted(
            f for f in _glob.glob(os.path.join(d, f"*.{ext}"))
            # Spark convention: _metadata, _SUCCESS and .hidden are not data
            if not os.path.basename(f).startswith(("_", "."))))
    return out


def _discover(d: str, parts: dict, files: List[str], pvals: dict) -> None:
    """Hive-layout discovery: key=value subdirectories become partition
    columns attached per file."""
    for f in _dir_files(d):
        files.append(f)
        pvals[f] = dict(parts)
    for sub in sorted(os.listdir(d)):
        full = os.path.join(d, sub)
        if os.path.isdir(full) and "=" in sub:
            k, _, v = sub.partition("=")
            _discover(full, {**parts, k: v}, files, pvals)


def _expand(paths):
    """Data files of the paths, the partition columns in discovery order,
    and each file's partition values."""
    out: List[str] = []
    pvals: dict = {}
    for p in paths:
        if os.path.isdir(p):
            direct = _dir_files(p)
            if direct:
                out.extend(direct)
            else:
                _discover(p, {}, out, pvals)
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files for {paths}")
    pcols: List[str] = []
    for f in out:
        for k in pvals.get(f, {}):
            if k not in pcols:
                pcols.append(k)
    return out, pcols, pvals


def _partition_attr_types(pcols, pvals):
    """bigint when every value of a partition column parses as an int,
    string otherwise (Spark's inference, its two common cases)."""
    from ..types import LongT, StringT
    types = {}
    for c in pcols:
        vals = [v.get(c) for v in pvals.values() if v.get(c) is not None]
        try:
            for v in vals:
                int(v)
            types[c] = LongT
        except (TypeError, ValueError):
            types[c] = StringT
    return types


class DataFrameReader:
    def __init__(self, session):
        self._session = session
        self._options = {}
        self._schema = None

    def option(self, key, value) -> "DataFrameReader":
        self._options[str(key)] = value
        return self

    def options(self, **kw) -> "DataFrameReader":
        self._options.update({str(k): v for k, v in kw.items()})
        return self

    def schema(self, schema) -> "DataFrameReader":
        """A user schema: a ``StructType`` or a DDL string."""
        from ..types import StructType, parse_ddl
        self._schema = schema if isinstance(schema, StructType) \
            else parse_ddl(str(schema))
        return self

    def format(self, fmt: str) -> "DataFrameReader":
        self._options["__format__"] = fmt
        return self

    def load(self, path: str):
        fmt = self._options.pop("__format__", "parquet")
        if fmt not in ("parquet", "orc", "csv", "json"):
            self._not_ported(fmt)
        return self._scan([path], fmt)

    def _scan(self, paths, fmt: str):
        from ..config import FILECACHE_ENABLED
        from ..expressions.base import AttributeReference
        from ..plan.logical import FileScan
        from ..session import DataFrame
        conf = self._session._rapids_conf()
        if conf.get(FILECACHE_ENABLED):
            raise NotImplementedError(
                f"the file cache not yet ported ({FILECACHE_ENABLED.key}"
                "=true)")
        files, pcols, pvals = _expand(paths)
        # per-scan copy: partition metadata must not leak into later loads
        # through the same reader object
        scan_options = dict(self._options)
        if pcols:
            scan_options["__partition_cols__"] = list(
                _partition_attr_types(pcols, pvals).items())
            scan_options["__partition_values__"] = pvals
        schema_attrs = None
        if self._schema is not None:
            scan_options["__user_schema__"] = self._schema
            schema_attrs = [AttributeReference(f.name, f.data_type, f.nullable)
                            for f in self._schema.fields]
            schema_attrs += [AttributeReference(c, t, True) for c, t in
                             scan_options.get("__partition_cols__", ())]
        return DataFrame(FileScan(files, fmt, schema_attrs=schema_attrs,
                                  options=scan_options), self._session)

    def parquet(self, *paths: str):
        return self._scan(paths, "parquet")

    def _not_ported(self, fmt: str):
        raise NotImplementedError(f"{fmt} reads not yet ported (A9)")

    def csv(self, path: str, header: Optional[bool] = None,
            inferSchema: Optional[bool] = None, sep: Optional[str] = None,
            schema=None, **kw):
        """CSV: ``header`` (default false), ``sep``, a user schema; types
        are inferred without one."""
        if header is not None:
            self._options["header"] = str(bool(header)).lower()
        if sep is not None:
            self._options["sep"] = sep
        if schema is not None:
            self.schema(schema)
        return self._scan([path], "csv")

    def json(self, path: str):
        """JSON lines: one object a line."""
        return self._scan([path], "json")

    def orc(self, path: str):
        return self._scan([path], "orc")

    def avro(self, path: str):
        self._not_ported("avro")

    def delta(self, path: str):
        self._not_ported("delta")

    def iceberg(self, path: str):
        self._not_ported("iceberg")

    def hive_text(self, path: str, schema=None):
        self._not_ported("hive_text")
