"""DataFrameWriter, Parquet only (the port's counterpart of
``spark_rapids_tpu.io.writers``).

One file per non-empty output batch, named ``part-<task>-<uuid>.parquet``,
written by ``pyarrow.parquet.write_table`` with snappy by default, then a
``_SUCCESS`` marker. Save modes as Spark's. ``partitionBy`` and the ORC,
CSV and JSON writers are not ported yet.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Dict

from spark_rapids_tpu_torch.columnar.host import HostBatch


class DataFrameWriter:
    def __init__(self, df):
        self._df = df
        self._format = "parquet"
        self._mode = "errorifexists"
        self._options: Dict[str, Any] = {}

    def format(self, fmt: str) -> "DataFrameWriter":
        self._format = fmt.lower()
        return self

    def mode(self, m: str) -> "DataFrameWriter":
        m = m.lower()
        if m not in ("overwrite", "append", "ignore", "error",
                     "errorifexists"):
            raise ValueError(f"unknown save mode {m}")
        self._mode = m
        return self

    def option(self, key: str, value: Any) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameWriter":
        self._options.update(opts)
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        raise NotImplementedError(
            "partitionBy is not ported yet to spark_rapids_tpu_torch")

    def parquet(self, path: str) -> None:
        self.format("parquet").save(path)

    def save(self, path: str) -> None:
        if self._format != "parquet":
            raise NotImplementedError(
                f"writing {self._format} is not ported yet to "
                "spark_rapids_tpu_torch")
        if os.path.exists(path):
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(
                    f"path {path} already exists (mode=errorIfExists)")
            if self._mode == "ignore":
                return
            if self._mode == "overwrite":
                shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)

        task_id = 0
        for thunk in self._df.session.host_partitions(self._df.plan):
            for batch in thunk():
                if batch.num_rows == 0:
                    continue
                self._write_file(batch, path, task_id)
                task_id += 1
        # commit marker, Hadoop-committer style
        open(os.path.join(path, "_SUCCESS"), "w").close()

    def _write_file(self, batch: HostBatch, directory: str,
                    task_id: int) -> None:
        import pyarrow.parquet as pq

        from spark_rapids_tpu_torch.io.arrow_convert import \
            host_batch_to_arrow
        name = f"part-{task_id:05d}-{uuid.uuid4().hex[:12]}.parquet"
        codec = str(self._options.get("compression", "snappy"))
        pq.write_table(host_batch_to_arrow(batch),
                       os.path.join(directory, name), compression=codec)
