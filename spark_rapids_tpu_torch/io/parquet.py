"""File scans (port of the parquet, ORC, CSV and JSON part of
``spark_rapids_tpu/io/parquet.py``).

``CpuFileScanExec`` is the planner's node: it reads on the host with
pyarrow and yields host batches, so a plan whose scan stays on the CPU
(``spark.rapids.sql.format.parquet.enabled=false``) runs through the
usual upload. ``TorchFileScanExec`` is its device counterpart:

* with ``spark.rapids.tpu.parquet.deviceDecode.enabled`` (the default) the
  files of a partition decode on the device a row group at a time
  (``io/device_decode.py``), row groups that footer statistics exclude
  skipped; a file the device decode cannot take (legacy calendar, an
  unreadable footer) is read on the host, a row group whose pages fail the
  host-side checks is re-read on the host, and each is counted;
* otherwise the host reads (PERFILE with the chunked reader, COALESCING or
  MULTITHREADED, reference GpuMultiFileReader) feed one upload a table.

Before a partition's first upload or device decode, its task takes a
permit of the device semaphore (reference parquet.py:625-671).
ORC, CSV and JSON files always read on the host (``read_host_file``:
ORC with the pushed filters as a dataset expression, CSV with ``header``,
``sep`` and a user schema whose column count may differ from the file's
(Spark's PERMISSIVE mode), JSON lines) and upload a table at a time.
Hive-partitioned directories (``key=value``) add their partition columns
as constants. Bucket pruning, deletion vectors, dynamic partition pruning
and the Avro and Hive text formats wait for later slices (A9); pyarrow is
imported only when a scan runs.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Iterator, List, Optional, Sequence

from ..config import (MULTITHREAD_READ_NUM_THREADS, PARQUET_CHUNK_BYTES,
                      PARQUET_DEVICE_DECODE_ENABLED,
                      PARQUET_REBASE_MODE_READ, PARQUET_READER_TYPE)
from ..execs.base import (DEBUG, ESSENTIAL, MODERATE, CpuExec, TaskContext,
                          TorchExec)
from ..obs import tracer as _obs
from ..expressions.base import AttributeReference, Expression
from .base_scan import arrow_filter_from_condition, rg_excluded
from .device_decode import (DeviceDecodeError, DeviceFileDecoder,
                            ParquetEncryptedException, PinnedStaging,
                            ScanTimes, bump,
                            detect_encryption, encrypted_message,
                            import_pyarrow, normalize_arrow_column)


def _partition_value(raw, dtype):
    """A raw hive partition-directory value at the column's type (one rule
    for the host attach and the device attach)."""
    from ..types import LongType
    if raw is None or raw == "__HIVE_DEFAULT_PARTITION__":
        return None
    return int(raw) if isinstance(dtype, LongType) else raw


def _split_files(paths: List[str], n: int) -> List[List[str]]:
    out: List[List[str]] = [[] for _ in range(n)]
    for i, p in enumerate(paths):
        out[i % n].append(p)
    return out


def _read_parquet_table(path: str, columns=None, filters=None):
    """``pq.read_table`` with the clean encrypted-file message instead of
    pyarrow's 'magic bytes not found'."""
    import_pyarrow()
    import pyarrow.parquet as pq
    try:
        return pq.read_table(path, columns=columns, filters=filters)
    except Exception:
        reason = detect_encryption(path)
        if reason is not None:
            raise ParquetEncryptedException(
                encrypted_message(path, reason)) from None
        raise


def _postprocess_parquet(t, path: str, conf, kv_metadata=None):
    """A file's parity passes (reference GpuParquetScan.scala:446):
    nanosecond timestamps (INT96 among them) truncate to microseconds, and
    legacy hybrid-calendar files rebase their dates and timestamps."""
    pa = import_pyarrow()
    import pyarrow.parquet as pq

    from .rebase import needs_rebase, rebase_scope, rebase_table
    for i, f in enumerate(t.schema):
        if pa.types.is_timestamp(f.type) and f.type.unit == "ns":
            t = t.set_column(i, f.name, t.column(i).cast(
                pa.timestamp("us", tz=f.type.tz), safe=False))
    mode = conf.get(PARQUET_REBASE_MODE_READ) if conf is not None \
        else "CORRECTED"
    if not any(pa.types.is_date32(f.type) or pa.types.is_timestamp(f.type)
               for f in t.schema):
        return t
    kv = kv_metadata
    if kv is None:
        try:
            kv = pq.ParquetFile(path).metadata.metadata
        except Exception:  # noqa: BLE001 — no footer: assume modern
            kv = None
    if not needs_rebase(kv, mode):
        return t
    # each legacy marker rebases its own encoding's columns only
    try:
        int96 = {c.name for c in pq.ParquetFile(path).schema
                 if c.physical_type == "INT96"}
    except Exception:  # noqa: BLE001
        int96 = None
    ts_names = [f.name for f in t.schema if pa.types.is_timestamp(f.type)]
    dates, tss = rebase_scope(kv, mode, int96_cols=int96, ts_cols=ts_names)
    return rebase_table(t, rebase_dates=dates, rebase_timestamps=tss)


def _read_parquet_chunks(path: str, columns, arrow_filter, conf,
                         chunk_bytes: int):
    """Row groups in chunks whose compressed size stays under
    ``chunk_bytes`` (the reference's chunked reader), pruned by footer
    statistics."""
    import_pyarrow()
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path)
    md = pf.metadata
    group, group_bytes = [], 0
    for i in range(md.num_row_groups):
        rg = md.row_group(i)
        if rg_excluded(rg, arrow_filter):
            continue
        group.append(i)
        group_bytes += rg.total_byte_size
        if group_bytes >= chunk_bytes:
            yield _postprocess_parquet(
                pf.read_row_groups(group, columns=columns), path, conf,
                kv_metadata=md.metadata)
            group, group_bytes = [], 0
    if group:
        yield _postprocess_parquet(pf.read_row_groups(group, columns=columns),
                                   path, conf, kv_metadata=md.metadata)
    elif md.num_row_groups == 0:
        yield _postprocess_parquet(pf.read(columns=columns), path, conf,
                                   kv_metadata=md.metadata)


#: file bytes a row when a file's footer cannot be read
FILE_ROW_BYTES = 100.0


def file_scan_rows(paths) -> float:
    """A parquet scan's rows from its footers, else its file sizes over
    FILE_ROW_BYTES (reference ``estimate_logical_rows``)."""
    import os
    try:
        import pyarrow.parquet as pq
        return float(sum(pq.ParquetFile(p).metadata.num_rows
                         for p in paths))
    except Exception:  # noqa: BLE001 — no pyarrow or an unreadable footer
        pass
    total = 0
    for p in paths:
        try:
            total += os.path.getsize(p)
        except OSError:
            total += 1 << 20
    return max(1.0, total / FILE_ROW_BYTES)


def read_schema(path: str, fmt: str = "parquet", options=None):
    """A file's Arrow schema (parquet and ORC from the footer, CSV and JSON
    from a read of the file), with the clean encrypted-file message where
    pyarrow cannot read a parquet footer."""
    import_pyarrow()
    import pyarrow.parquet as pq
    options = options or {}
    if fmt == "orc":
        import pyarrow.orc as paorc
        return paorc.ORCFile(path).schema
    if fmt == "csv":
        import pyarrow.csv as pacsv
        return pacsv.read_csv(path, read_options=pacsv.ReadOptions(
            autogenerate_column_names=not _csv_header(options)),
            parse_options=pacsv.ParseOptions(
                delimiter=_csv_sep(options))).schema
    if fmt == "json":
        import pyarrow.json as pajson
        return pajson.read_json(path).schema
    if fmt != "parquet":
        raise NotImplementedError(f"{fmt} reads not yet ported (A9)")
    try:
        return pq.read_schema(path)
    except Exception:
        # an encrypted file fails here first (GpuParquetScan.scala:590)
        reason = detect_encryption(path)
        if reason is not None:
            raise ParquetEncryptedException(
                encrypted_message(path, reason)) from None
        raise


def _csv_header(options) -> bool:
    return str(options.get("header", "false")).lower() == "true"


def _csv_sep(options) -> str:
    return options.get("sep", options.get("delimiter", ","))


def read_host_file(path: str, fmt: str, columns, arrow_filter, options):
    """One ORC, CSV or JSON file as an Arrow table on the host (reference
    ``io/parquet._read_one``, :89-157)."""
    pa = import_pyarrow()
    if fmt == "orc":
        import pyarrow.orc as paorc
        from .base_scan import dataset_filter_expr
        expr = dataset_filter_expr(arrow_filter) if arrow_filter else None
        if expr is not None:
            try:
                import pyarrow.dataset as pads
                return pads.dataset(path, format="orc").to_table(
                    columns=columns, filter=expr)
            except Exception:  # noqa: BLE001 — a filter the dataset
                pass  # cannot take: the plain read below is exact too
        return paorc.read_table(path, columns=columns)
    if fmt == "csv":
        t = _read_csv(pa, path, options)
    elif fmt == "json":
        import pyarrow.json as pajson
        t = pajson.read_json(path)
    else:
        raise NotImplementedError(f"{fmt} reads not yet ported (A9)")
    if columns:
        t = t.select([c for c in columns if c in t.column_names])
    return t


def _read_csv(pa, path: str, options):
    """A CSV file at the user schema's names and types where one is given
    (reference GpuCSVScan's cast pass): a file whose column count differs
    reads PERMISSIVE, extra file columns dropped and missing ones null
    (Spark's CSV default mode)."""
    import pyarrow.csv as pacsv
    from ..types import to_arrow
    header = _csv_header(options)
    popts = pacsv.ParseOptions(delimiter=_csv_sep(options))
    ddl = options.get("__user_schema__")
    if ddl is None:
        return pacsv.read_csv(path, read_options=pacsv.ReadOptions(
            autogenerate_column_names=not header), parse_options=popts)
    names = [f.name for f in ddl.fields]
    try:
        return pacsv.read_csv(
            path, read_options=pacsv.ReadOptions(
                column_names=names, skip_rows=1 if header else 0),
            parse_options=popts,
            convert_options=pacsv.ConvertOptions(column_types={
                f.name: to_arrow(f.data_type) for f in ddl.fields}))
    except pa.lib.ArrowInvalid:
        raw = pacsv.read_csv(path, read_options=pacsv.ReadOptions(
            autogenerate_column_names=not header), parse_options=popts)
    out = {}
    for i, f in enumerate(ddl.fields):
        at = to_arrow(f.data_type)
        if header and f.name in raw.column_names:
            src = raw.column(f.name)
        elif not header and i < raw.num_columns:
            src = raw.column(i)
        else:
            src = None
        out[f.name] = pa.nulls(raw.num_rows, at) if src is None \
            else src.cast(at)
    return pa.table(out)


class FileScanBase:
    def _init_scan(self, paths: List[str], fmt: str,
                   output: List[AttributeReference],
                   pushed_filters: Sequence[Expression], options: dict,
                   num_partitions: Optional[int]):
        self.paths = list(paths)
        self.fmt = fmt
        self._output_attrs = list(output)
        self.pushed_filters = list(pushed_filters)
        self.options = dict(options or {})
        self._n_parts = num_partitions or max(1, min(len(self.paths), 8))
        self._arrow_filter = arrow_filter_from_condition(self.pushed_filters)

    @property
    def output(self):
        return self._output_attrs

    def num_partitions(self) -> int:
        return self._n_parts

    def node_desc(self) -> str:
        pf = f", pushed={len(self.pushed_filters)}" \
            if self.pushed_filters else ""
        cols = ", ".join(a.name for a in self._output_attrs)
        return (f"{type(self).__name__}[{self.fmt}, {len(self.paths)} files"
                f"{pf}, cols=[{cols}]]")

    def _partition_columns(self):
        return self.options.get("__partition_cols__", ())

    def _attach_partition_cols(self, table, f: str):
        """The file's hive-partition values as constant columns."""
        pcols = self._partition_columns()
        if not pcols:
            return table
        pa = import_pyarrow()
        from ..types import to_arrow
        vals = self.options.get("__partition_values__", {}).get(f, {})
        for name, dtype in pcols:
            py = _partition_value(vals.get(name), dtype)
            table = table.append_column(
                name, pa.array([py] * table.num_rows, type=to_arrow(dtype)))
        return table

    def _prune_by_partition_values(self, files):
        """Files whose partition values cannot satisfy a pushed filter
        drop before any read."""
        pcols = dict(self._partition_columns())
        if not pcols or not self._arrow_filter:
            return files
        pvals = self.options.get("__partition_values__", {})
        checks = {"==": lambda v, x: v == x, "<": lambda v, x: v < x,
                  "<=": lambda v, x: v <= x, ">": lambda v, x: v > x,
                  ">=": lambda v, x: v >= x}

        def file_ok(f):
            vals = pvals.get(f, {})
            for name, op, lit in self._arrow_filter:
                if name not in pcols:
                    continue
                v = _partition_value(vals.get(name), pcols[name])
                if v is None:
                    return False  # a null partition matches no comparison
                try:
                    if not checks[op](v, lit):
                        return False
                except TypeError:
                    continue
            return True

        return [f for f in files if file_ok(f)]

    def _partition_files(self, idx: int):
        """One partition's files after partition pruning, the data columns
        to read, and the pushed leaves on data columns."""
        files = self._prune_by_partition_values(
            _split_files(self.paths, self._n_parts)[idx])
        part_names = {n for n, _ in self._partition_columns()}
        cols = [a.name for a in self._output_attrs
                if a.name not in part_names]
        row_filter = None
        if self._arrow_filter:
            row_filter = [leaf for leaf in self._arrow_filter
                          if leaf[0] not in part_names] or None
        return files, cols, row_filter

    def _read_one(self, f: str, cols, row_filter, conf):
        if self.fmt != "parquet":
            return self._attach_partition_cols(read_host_file(
                f, self.fmt, cols, row_filter, self.options), f)
        return self._attach_partition_cols(_postprocess_parquet(
            _read_parquet_table(f, columns=cols, filters=row_filter), f,
            conf), f)

    def _partition_tables(self, idx: int, ctx: TaskContext) -> Iterator:
        """Host reads of one partition under the selected strategy."""
        files, cols, row_filter = self._partition_files(idx)
        if not files:
            return
        conf = ctx.conf
        strategy = str(conf.get(PARQUET_READER_TYPE)).upper()
        if strategy == "AUTO":
            strategy = "COALESCING" if len(files) > 1 else "PERFILE"
        if strategy == "MULTITHREADED":
            n_threads = conf.get(MULTITHREAD_READ_NUM_THREADS)
            # the reader threads' records nest under this thread's span
            parent = _obs.current_span()

            def read(f):
                with _obs.inherit(parent):
                    return self._read_one(f, cols, row_filter, conf)

            with _fut.ThreadPoolExecutor(max_workers=n_threads) as pool:
                futs = [(f, pool.submit(read, f)) for f in files]
                for f, fut in futs:
                    t = fut.result()
                    if t.num_rows:
                        ctx.eval_ctx.set_input_file(f)
                        yield t
        elif strategy == "COALESCING":
            pa = import_pyarrow()
            tables = [self._read_one(f, cols, row_filter, conf)
                      for f in files]
            tables = [t for t in tables if t.num_rows] or tables[:1]
            # a coalesced batch spans files: it names the first (as the
            # reference's coalescing reader does)
            ctx.eval_ctx.set_input_file(files[0])
            yield pa.concat_tables(tables, promote_options="permissive")
        else:  # PERFILE
            chunk_bytes = conf.get(PARQUET_CHUNK_BYTES) \
                if self.fmt == "parquet" else 0
            for f in files:
                ctx.eval_ctx.set_input_file(f)
                if chunk_bytes > 0:
                    for t in _read_parquet_chunks(f, cols, row_filter, conf,
                                                  chunk_bytes):
                        t = self._attach_partition_cols(t, f)
                        if t.num_rows:
                            yield t
                    continue
                t = self._read_one(f, cols, row_filter, conf)
                if t.num_rows:
                    yield t

    def _arrow_schema(self):
        pa = import_pyarrow()
        from ..types import to_arrow
        return pa.schema([(a.name, to_arrow(a.dtype))
                          for a in self._output_attrs])

    def _host_batch(self, t, schema):
        """An Arrow table at the scan's output schema, as a host batch."""
        from ..columnar.batch import TorchColumnarBatch
        pa = import_pyarrow()
        t = t.select([a.name for a in self._output_attrs])
        t = pa.table({a.name: normalize_arrow_column(t.column(a.name),
                                                     a.dtype)
                      for a in self._output_attrs}, schema=schema)
        return TorchColumnarBatch.from_arrow(t)


class CpuFileScanExec(FileScanBase, CpuExec):
    """The planner's file scan: host reads into host batches."""

    def __init__(self, paths, fmt, output, pushed_filters=(), options=None,
                 num_partitions=None):
        CpuExec.__init__(self, [])
        self._init_scan(paths, fmt, output, pushed_filters, options,
                        num_partitions)

    def execute_partition(self, idx: int, ctx: TaskContext) -> Iterator:
        schema = self._arrow_schema()
        for t in self._partition_tables(idx, ctx):
            yield self._host_batch(t, schema)


class TorchFileScanExec(FileScanBase, TorchExec):
    """The device file scan: the device page decode, or host reads and an
    upload (reference GpuFileSourceScanExec over GpuParquetScan). Its time
    split lands in the session's counters: ``scan.stageMs`` (host page
    walk and decompression), ``scan.uploadMs`` and ``scan.deviceDecodeMs``
    (device time, CUDA events), ``scan.hostDecodeMs`` (pyarrow), with
    ``scan.rowGroups`` and ``scan.files``."""

    def __init__(self, paths, fmt, output, pushed_filters=(), options=None,
                 num_partitions=None):
        TorchExec.__init__(self, [])
        self._init_scan(paths, fmt, output, pushed_filters, options,
                        num_partitions)

    def additional_metrics(self):
        return {"scanTime": ESSENTIAL, "uploadTime": MODERATE,
                "filesRead": DEBUG, "decodeTime": MODERATE,
                "hostDecodeTime": MODERATE, "decodeDispatches": DEBUG,
                "decodeFallbackColumns": DEBUG}

    def internal_do_execute_columnar(self, idx: int,
                                     ctx: TaskContext) -> Iterator:
        times = ScanTimes(ctx.device)
        try:
            if self.fmt == "parquet" \
                    and ctx.conf.get(PARQUET_DEVICE_DECODE_ENABLED):
                yield from self._execute_device(idx, ctx, times)
            else:
                yield from self._execute_host(idx, ctx, times)
        finally:
            times.flush(ctx.counters, self.metrics)

    def _upload(self, t, schema, ctx: TaskContext, times: ScanTimes):
        from ..memory.semaphore import TorchSemaphore
        with times.host("hostDecode"):
            host = self._host_batch(t, schema)
        # admission control before taking device memory (reference
        # parquet.py:625, the semaphore pattern)
        TorchSemaphore.get(ctx.conf).acquire_if_necessary(ctx)
        with times.device("upload"):
            return host.to_device(ctx.device)

    def _execute_host(self, idx: int, ctx: TaskContext,
                      times: ScanTimes) -> Iterator:
        schema = self._arrow_schema()
        it = self._partition_tables(idx, ctx)
        while True:
            with times.host("hostDecode"):
                t = next(it, None)
            if t is None:
                return
            ctx.counters["scan.files"] += 1
            self.metrics["filesRead"].add(1)
            yield self._upload(t, schema, ctx, times)

    def _execute_device(self, idx: int, ctx: TaskContext,
                        times: ScanTimes) -> Iterator:
        """The device decode, a row group at a time; a file or row group it
        cannot take is read on the host, and counted."""
        from ..memory.semaphore import TorchSemaphore
        files, cols, row_filter = self._partition_files(idx)
        part_names = {n for n, _ in self._partition_columns()}
        attrs = [a for a in self._output_attrs if a.name not in part_names]
        schema = self._arrow_schema()
        staging = PinnedStaging() if ctx.device.type == "cuda" else None
        for f in files:
            ctx.counters["scan.files"] += 1
            self.metrics["filesRead"].add(1)
            ctx.eval_ctx.set_input_file(f)
            try:
                with times.host("stage"):
                    dec = DeviceFileDecoder(f, attrs, ctx.conf, ctx.device,
                                            ctx.counters, staging)
            except DeviceDecodeError:
                bump("fallback_files", 1, ctx.counters)
                with times.host("hostDecode"):
                    t = self._read_one(f, cols, row_filter, ctx.conf)
                if t.num_rows:
                    yield self._upload(t, schema, ctx, times)
                continue
            try:
                for rgi in dec.row_groups(row_filter):
                    ctx.counters["scan.rowGroups"] += 1
                    # the device decode runs under the semaphore
                    # (reference device_decode.py:1376)
                    TorchSemaphore.get(ctx.conf).acquire_if_necessary(ctx)
                    try:
                        demoted = ctx.counters["fallback_columns"]
                        batch = self._attach_partition_vectors(
                            dec.decode_row_group(rgi, times), f, ctx)
                        self.metrics["decodeDispatches"].add(1)
                        self.metrics["decodeFallbackColumns"].add(
                            ctx.counters["fallback_columns"] - demoted)
                    except DeviceDecodeError:
                        bump("fallback_row_groups", 1, ctx.counters)
                        with times.host("hostDecode"):
                            t = self._attach_partition_cols(
                                _postprocess_parquet(
                                    dec.pf.read_row_groups([rgi],
                                                           columns=cols),
                                    f, ctx.conf,
                                    kv_metadata=dec.md.metadata), f)
                        batch = self._upload(t, schema, ctx, times)
                    yield batch
            finally:
                dec.close()

    def _attach_partition_vectors(self, batch, f: str, ctx: TaskContext):
        """The file's hive-partition values as constant device columns, in
        the scan's output order."""
        pcols = self._partition_columns()
        names = [a.name for a in self._output_attrs]
        if not pcols:
            return batch.rename(names)
        from ..columnar.batch import TorchColumnarBatch
        from ..columnar.vector import TorchColumnVector
        vals = self.options.get("__partition_values__", {}).get(f, {})
        by = dict(zip(batch.names, batch.columns))
        for name, dtype in pcols:
            by[name] = TorchColumnVector.from_scalar(
                _partition_value(vals.get(name), dtype), dtype,
                batch.num_rows, batch.capacity, ctx.device)
        return TorchColumnarBatch([by[n] for n in names], batch.num_rows,
                                  names)
