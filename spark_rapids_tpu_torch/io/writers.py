"""DataFrameWriter: Parquet, ORC, CSV and JSON writes with save modes and
``partitionBy`` (the port's counterpart of ``spark_rapids_tpu.io.writers``).

One file per non-empty output batch, named ``part-<task>-<uuid>.<ext>``,
then a ``_SUCCESS`` marker. Parquet (snappy by default), ORC and CSV are
encoded by pyarrow; JSON is one ``json.dumps`` line a row. Under
``partitionBy`` a batch's rows are grouped by their partition values, in
the order each value first appears, and each group's data columns are
written to a file under its ``k=v`` directories (``__HIVE_DEFAULT_PARTITION__``
for null, values URL-escaped as Spark's PartitioningUtils.escapePathName
does), rows in their batch order.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Dict, List

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.io.readers import HIVE_DEFAULT_PARTITION
from spark_rapids_tpu_torch.sql import types as T

_EXTENSIONS = {"parquet": "parquet", "orc": "orc", "csv": "csv",
               "json": "json"}


class DataFrameWriter:
    def __init__(self, df):
        self._df = df
        self._format = "parquet"
        self._mode = "errorifexists"
        self._options: Dict[str, Any] = {}
        self._partition_by: List[str] = []

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
        self._partition_by = list(cols)
        return self

    def parquet(self, path: str) -> None:
        self.format("parquet").save(path)

    def orc(self, path: str) -> None:
        self.format("orc").save(path)

    def csv(self, path: str, header=None, sep=None) -> None:
        if header is not None:
            self.option("header", str(header).lower())
        if sep is not None:
            self.option("sep", sep)
        self.format("csv").save(path)

    def json(self, path: str) -> None:
        self.format("json").save(path)

    def save(self, path: str) -> None:
        if self._format not in _EXTENSIONS:
            raise ValueError(f"unknown file format {self._format!r}")
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
                if self._partition_by:
                    self._write_partitioned(batch, path, task_id)
                else:
                    self._write_file(batch, path, task_id)
                task_id += 1
        # commit marker, Hadoop-committer style
        open(os.path.join(path, "_SUCCESS"), "w").close()

    def _write_partitioned(self, batch: HostBatch, root: str,
                           task_id: int) -> None:
        """Dynamic partitioning: one file per distinct tuple of partition
        values, in the order the tuples first appear in the batch."""
        from urllib.parse import quote
        schema = batch.schema
        part_idx = [schema.field_index(c) for c in self._partition_by]
        data_idx = [i for i in range(batch.num_cols) if i not in part_idx]
        dschema = T.StructType([schema.fields[i] for i in data_idx])
        first, inverse = _group_rows(
            [_group_codes(batch.columns[i]) for i in part_idx])
        # each group's rows in batch order, the groups by first appearance
        by_group = np.argsort(inverse, kind="stable")
        bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(inverse, minlength=len(first)))])
        for g in np.argsort(first, kind="stable"):
            rows = by_group[bounds[g]:bounds[g + 1]]
            sub = batch.take(rows)
            values = [batch.columns[i].take(first[g:g + 1]).to_pylist()[0]
                      for i in part_idx]
            subdir = os.path.join(root, *[
                f"{c}={HIVE_DEFAULT_PARTITION if v is None else quote(str(v), safe='')}"
                for c, v in zip(self._partition_by, values)])
            os.makedirs(subdir, exist_ok=True)
            self._write_file(
                HostBatch(dschema, [sub.columns[i] for i in data_idx],
                          sub.num_rows), subdir, task_id)

    def _write_file(self, batch: HostBatch, directory: str,
                    task_id: int) -> None:
        from spark_rapids_tpu_torch.io.arrow_convert import \
            host_batch_to_arrow
        name = (f"part-{task_id:05d}-{uuid.uuid4().hex[:12]}."
                f"{_EXTENSIONS[self._format]}")
        fpath = os.path.join(directory, name)
        tbl = host_batch_to_arrow(batch)
        if self._format == "parquet":
            import pyarrow.parquet as pq
            codec = str(self._options.get("compression", "snappy"))
            pq.write_table(tbl, fpath, compression=codec)
        elif self._format == "orc":
            import pyarrow.orc as po
            po.write_table(tbl, fpath)
        elif self._format == "csv":
            import pyarrow.csv as pc
            header = str(self._options.get("header",
                                           "false")).lower() == "true"
            sep = str(self._options.get("sep", ","))
            pc.write_csv(tbl, fpath, write_options=pc.WriteOptions(
                include_header=header, delimiter=sep))
        else:
            with open(fpath, "w") as f:
                f.write(json_lines(tbl))


def json_lines(tbl) -> str:
    """``json.dumps(row, default=str) + "\\n"`` of each row of an Arrow
    table, byte for byte, built a column at a time: strings, integers,
    booleans, dates and UTC microsecond timestamps are encoded with
    numpy, every other column value by value through ``json.dumps``."""
    import json
    from json.encoder import encode_basestring_ascii
    names = tbl.column_names
    if len(set(names)) != len(names):
        # a row's dict keeps one of each name: as json.dumps sees it
        return "".join(json.dumps(r, default=str) + "\n"
                       for r in tbl.to_pylist())
    if not names or not tbl.num_rows:
        return "{}\n" * tbl.num_rows
    from itertools import chain, repeat
    parts = []
    for i, name in enumerate(names):
        parts.append(repeat(("{" if i == 0 else ", ")
                            + encode_basestring_ascii(name) + ": "))
        parts.append(_json_values(tbl.column(i)).tolist())
    parts.append(repeat("}\n"))
    # one join over each row's pieces in order
    return "".join(chain.from_iterable(zip(*parts)))


def _json_values(col) -> np.ndarray:
    """Each value of an Arrow column as ``json.dumps(v, default=str)``
    writes it, as an object array of str."""
    import json
    from json.encoder import encode_basestring_ascii

    import pyarrow as pa
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    at = arr.type
    valid = np.asarray(arr.is_valid()) if arr.null_count else None
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        # each distinct value encoded once
        d = arr.fill_null("").dictionary_encode()
        enc = np.frompyfunc(encode_basestring_ascii, 1, 1)(
            d.dictionary.to_numpy(zero_copy_only=False))
        out = enc[np.asarray(d.indices)]
    elif pa.types.is_boolean(at):
        out = np.where(np.asarray(arr.fill_null(False)), "true",
                       "false").astype(object)
    elif pa.types.is_integer(at):
        out = np.asarray(arr.fill_null(0)).astype(str).astype(object)
    elif pa.types.is_date32(at):
        days = np.asarray(arr.cast(pa.int32()).fill_null(0))
        out = np.add(np.add('"', np.datetime_as_string(
            days.astype("datetime64[D]")), dtype=object), '"',
            dtype=object)
    elif pa.types.is_timestamp(at) and at.unit == "us" and at.tz == "UTC":
        us = np.asarray(arr.cast(pa.int64()).fill_null(0))
        # str(datetime): the fraction only where it is not zero
        text = np.char.replace(np.datetime_as_string(
            us.astype("datetime64[us]"), unit="us"), "T", " ")
        text = np.where(us % 1_000_000 == 0, text.astype("<U19"), text)
        out = np.add(np.add('"', text, dtype=object), '+00:00"',
                     dtype=object)
    else:
        return np.array([json.dumps(v, default=str) for v in arr.to_pylist()]
                        + [None], dtype=object)[:-1]
    if valid is not None:
        out[~valid] = "null"
    return out


def _group_codes(col: HostColumn) -> np.ndarray:
    """One int64 code per row in ``[-1, distinct)``, equal exactly where
    the rows' values are equal as Python values: -1 for null, -0.0 equal
    to 0.0, the NaNs one value."""
    valid = col.validity
    data = col.data
    codes = np.full(len(valid), -1, dtype=np.int64)
    if data is not None and data.dtype != object and data.ndim == 1:
        vals = data[valid]
        if vals.dtype.kind == "f":
            vals = np.where(vals == 0, np.zeros((), vals.dtype), vals)
        if len(vals):
            codes[valid] = np.unique(vals, return_inverse=True)[1] \
                .reshape(-1)
        return codes
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import host_column_to_arrow
    enc = host_column_to_arrow(col).filter(
        pa.array(valid)).dictionary_encode()
    codes[valid] = np.asarray(enc.indices, dtype=np.int64)
    return codes


def _group_rows(codes: List[np.ndarray]):
    """The groups of equal code tuples: each group's first row, and each
    row's group."""
    radix = [int(c.max(initial=-1)) + 2 for c in codes]
    if float(np.prod(radix, dtype=np.float64)) < 2.0 ** 62:
        key = np.zeros(len(codes[0]), dtype=np.int64)
        for c, r in zip(codes, radix):
            key = key * r + (c + 1)
        _k, first, inverse = np.unique(key, return_index=True,
                                       return_inverse=True)
    else:
        _k, first, inverse = np.unique(np.stack(codes, axis=1), axis=0,
                                       return_index=True,
                                       return_inverse=True)
    return first, inverse.reshape(-1)
