"""DataFrameWriter: the columnar file writers (port of
``spark_rapids_tpu/io/writer.py``; reference ColumnarOutputWriter,
GpuParquetFileFormat, GpuOrcFileFormat, GpuFileFormatDataWriter).

A write plans the query, puts a ``CpuDataWritingCommandExec`` at its root
and hands the plan to the override engine, which converts it to
``TorchDataWritingCommandExec`` over a device child. The writer runs the
physical plan's partitions itself (no scheduler admission, as the
reference's) and removes the plan's shuffle blocks when it ends, also when
it fails. One file a partition (``part-NNNNN-<job>.<ext>``) in Spark's
layout, ``partitionBy`` directories, ``bucketBy`` files with a
``_bucket_spec.json`` sidecar; pyarrow writes the bytes: parquet (snappy
unless ``compression`` says otherwise), ORC, CSV (header unless
``header=false``), JSON lines. An empty result still leaves one file with
the schema. Delta, Avro and Hive text writes wait for A9.
"""

from __future__ import annotations

import json as _json
import os
import shutil
from typing import List


class DataFrameWriter:
    def __init__(self, df):
        self._df = df
        self._mode = "errorifexists"
        self._options = {}
        self._partition_by: List[str] = []
        self._bucket_by: List[str] = []
        self._num_buckets = 0

    def mode(self, m: str) -> "DataFrameWriter":
        """errorifexists (``error``), overwrite, append or ignore."""
        self._mode = m.lower()
        return self

    def option(self, key, value) -> "DataFrameWriter":
        self._options[str(key)] = value
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def bucketBy(self, num_buckets: int, *cols: str) -> "DataFrameWriter":
        """Hash-bucketed output: each task's rows split into
        ``num_buckets`` files by pmod(murmur3(cols), n), with a
        ``_bucket_spec.json`` sidecar for the read side."""
        self._bucket_by = list(cols)
        self._num_buckets = int(num_buckets)
        return self

    def format(self, fmt: str) -> "DataFrameWriter":
        self._options["__format__"] = str(fmt).lower()
        return self

    def save(self, path: str) -> None:
        fmt = self._options.pop("__format__", "parquet")
        writers = {"parquet": self.parquet, "orc": self.orc, "csv": self.csv,
                   "json": self.json, "delta": self.delta, "avro": self.avro,
                   "hivetext": self.hive_text}
        if fmt not in writers:
            raise ValueError(f"unknown write format {fmt}")
        return writers[fmt](path)

    def _prepare_dir(self, path: str) -> bool:
        """Apply the save mode; False when ``ignore`` skips the write (the
        reference writes into the existing path: ROADMAP C-ref-23)."""
        if os.path.exists(path):
            if self._mode == "overwrite":
                shutil.rmtree(path)
            elif self._mode == "ignore":
                return False
            elif self._mode != "append":
                raise FileExistsError(
                    f"path {path} exists (mode={self._mode})")
        os.makedirs(path, exist_ok=True)
        return True

    def _bucket_spec(self, path: str, conf):
        """(bucket columns, buckets) after the bucketing switch, with the
        sidecar written; an append under another spec raises."""
        from ..config import BUCKETING_WRITE_ENABLED
        if not self._num_buckets or not conf.get(BUCKETING_WRITE_ENABLED):
            return [], 0
        spec_path = os.path.join(path, "_bucket_spec.json")
        if self._mode == "append" and os.path.exists(spec_path):
            # files hashed under two moduli behind one sidecar would make
            # read-side pruning drop rows (Spark rejects it in its catalog)
            with open(spec_path) as f:
                old = _json.load(f)
            if (old.get("numBuckets") != self._num_buckets
                    or old.get("bucketColumns") != self._bucket_by):
                raise ValueError(
                    f"append to {path} with bucket spec "
                    f"({self._num_buckets}, {self._bucket_by}) conflicts "
                    f"with existing ({old.get('numBuckets')}, "
                    f"{old.get('bucketColumns')})")
        with open(spec_path, "w") as f:
            _json.dump({"numBuckets": self._num_buckets,
                        "bucketColumns": self._bucket_by}, f)
        return list(self._bucket_by), self._num_buckets

    def _write(self, path: str, ext: str, write_fn) -> None:
        """Run the write as a data-writing command at the plan's root."""
        import pyarrow as pa
        from ..execs.base import TaskContext
        from ..execs.write import CpuDataWritingCommandExec, WriteSpec
        from ..plan.optimizer import optimize_logical
        from ..plan.overrides import TorchOverrides
        from ..plan.planner import plan_physical
        from ..profiling import snapshot_plan_metrics
        from ..serving.scheduler import _plan_tree_snapshot
        from ..types import to_arrow
        session = self._df.session
        if session._stopped:
            raise RuntimeError(
                f"TorchSession {session._session_id} is stopped")
        if not self._prepare_dir(path):
            return
        conf = session._rapids_conf()
        bucket_by, num_buckets = self._bucket_spec(path, conf)
        optimized, _ = optimize_logical(self._df._plan, conf)
        spec = WriteSpec(ext, path, ext, write_fn, list(self._partition_by),
                         dict(self._options), bucket_by=bucket_by,
                         num_buckets=num_buckets)
        final = TorchOverrides.apply(
            CpuDataWritingCommandExec(plan_physical(optimized, conf), spec),
            conf)
        try:
            for p in range(final.num_partitions()):
                ctx = TaskContext(p, conf, session.device, session.counters)
                try:
                    for _ in final.execute_partition(p, ctx):
                        pass
                finally:
                    ctx.complete()
        finally:
            # the write's shuffle blocks leave the device with it, as a
            # query's do
            for node in final.collect_nodes():
                if hasattr(node, "cleanup_shuffle"):
                    node.cleanup_shuffle()
            # the write's metrics, as a collect leaves its query's
            session._last_metrics_snapshot = snapshot_plan_metrics(final)
            session._last_plan_tree = _plan_tree_snapshot(final)
        if not any(files for _, _, files in os.walk(path)):
            # an empty result still records the schema (any file there,
            # the bucket sidecar too, counts as written, as the
            # reference's)
            schema = pa.schema([(a.name, to_arrow(a.dtype))
                                for a in self._df._plan.output])
            write_fn(schema.empty_table(),
                     os.path.join(path, f"part-00000.{ext}"))

    def parquet(self, path: str) -> None:
        import pyarrow.parquet as pq
        compression = self._options.get("compression", "snappy")
        self._write(path, "parquet",
                    lambda t, p: pq.write_table(t, p,
                                                compression=compression))

    def orc(self, path: str) -> None:
        import pyarrow.orc as paorc
        self._write(path, "orc", lambda t, p: paorc.write_table(t, p))

    def csv(self, path: str) -> None:
        import pyarrow.csv as pacsv
        header = str(self._options.get("header", "true")).lower() == "true"
        opts = pacsv.WriteOptions(include_header=header)
        self._write(path, "csv",
                    lambda t, p: pacsv.write_csv(t, p, write_options=opts))

    def json(self, path: str) -> None:
        def write_json(t, p):
            with open(p, "w") as f:
                for row in t.to_pylist():
                    f.write(_json.dumps(row, default=str) + "\n")
        self._write(path, "json", write_json)

    def _not_ported(self, fmt: str):
        raise NotImplementedError(f"{fmt} writes not yet ported (A9)")

    def delta(self, path: str) -> None:
        self._not_ported("delta")

    def avro(self, path: str) -> None:
        self._not_ported("avro")

    def hive_text(self, path: str) -> None:
        self._not_ported("hive_text")
