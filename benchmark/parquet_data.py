"""A configuration's tables: generated from the seed by the generator
the configuration names (``generators/<generator>.py``), written as
Parquet the way Spark writes it, and measured from the files' footers.

Each table is a directory of ``files`` files, each one row group,
snappy, with decimals of precision up to 18 stored as INT32 or INT64
(Spark's ``writeLegacyFormat=false``), dates as DATE (INT32) and
strings as UTF-8 BYTE_ARRAY.
"""

from __future__ import annotations

import importlib.util
import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_DECIMAL = re.compile(r"decimal\((\d+),(\d+)\)$")


def load_module(kind: str, name: str):
    """``<benchmark>/<kind>/<name>.py`` as a module: how the harness
    finds a generator, an entry, a reference or a metric by its name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise LookupError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generate(config: dict, seed: int, scale: float = 1.0) -> dict:
    """``{table: {column: array}}`` from the configuration's generator.
    ``scale`` multiplies the counts named in ``scale_params`` (tests
    only: every run uses 1)."""
    params = dict(config["params"])
    for k in config["scale_params"] if scale != 1.0 else ():
        params[k] = max(8, int(params[k] * scale))
    gen = load_module("generators", config["generator"])
    return gen.generate(params, np.random.default_rng([seed, 0]))


def spark_width(type_name: str, values=None) -> float:
    """Logical bytes a value of ``type_name``: what Spark keeps of it
    with nothing padded. A decimal of precision up to 9 in 4 bytes and up
    to 18 in 8; a string its UTF-8 bytes (the mean over ``values``)."""
    m = _DECIMAL.match(type_name)
    if m:
        return 4.0 if int(m.group(1)) <= 9 else 8.0
    if type_name == "string":
        if values is None or len(values) == 0:
            return 0.0
        return float(np.mean([len(v.encode()) for v in values]))
    return {"int": 4.0, "date": 4.0, "long": 8.0}[type_name]


def _arrow_type(pa, type_name: str):
    m = _DECIMAL.match(type_name)
    if m:
        return pa.decimal128(int(m.group(1)), int(m.group(2)))
    return {"int": pa.int32(), "long": pa.int64(), "date": pa.date32(),
            "string": pa.string()}[type_name]


def _arrow_column(pa, type_name: str, values: np.ndarray):
    at = _arrow_type(pa, type_name)
    if pa.types.is_decimal(at):
        # unscaled int64 -> decimal128 without a per-row Python loop
        raw = np.zeros((len(values), 2), dtype=np.int64)
        raw[:, 0] = values
        raw[:, 1] = np.where(values < 0, -1, 0)
        return pa.Array.from_buffers(at, len(values),
                                     [None, pa.py_buffer(raw.tobytes())])
    if type_name == "date":
        return pa.array(values.astype(np.int32), type=pa.int32()).cast(at)
    if type_name == "string":
        return pa.array(values, type=at)
    return pa.array(values, type=at)


def write_tables(config: dict, data: dict, root: str) -> dict:
    """Each table of ``config`` under ``root/<table>/part-NNNNN.parquet``;
    returns ``{table: directory}``."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    out = {}
    for table, spec in config["tables"].items():
        cols = data[table]
        n = len(next(iter(cols.values())))
        names = [c for c, _t in spec["columns"]]
        arrays = [_arrow_column(pa, t, cols[c]) for c, t in spec["columns"]]
        tbl = pa.Table.from_arrays(arrays, names=names)
        d = os.path.join(root, table)
        os.makedirs(d, exist_ok=True)
        bounds = np.linspace(0, n, int(spec["files"]) + 1).astype(int)
        for i in range(int(spec["files"])):
            part = tbl.slice(bounds[i], bounds[i + 1] - bounds[i])
            pq.write_table(part, os.path.join(d, f"part-{i:05d}.parquet"),
                           compression="snappy",
                           row_group_size=max(1, part.num_rows),
                           store_decimal_as_integer=True)
        out[table] = d
    return out


def scan_bytes(directory: str, columns, max_rows: int = None) -> dict:
    """What reading ``columns`` of every row group under ``directory``
    touches: ``{"compressed": the column chunks' compressed bytes from the
    footers, "rows": rows}``; with ``max_rows``, of the row groups of at
    most that many rows only."""
    import pyarrow.parquet as pq
    compressed, rows = 0, 0
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".parquet"):
            continue
        md = pq.ParquetFile(os.path.join(directory, f)).metadata
        index = {md.schema.column(j).name: j for j in range(md.num_columns)}
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            if max_rows is not None and rg.num_rows > max_rows:
                continue
            rows += rg.num_rows
            compressed += sum(rg.column(index[c]).total_compressed_size
                              for c in columns)
    return {"compressed": compressed, "rows": rows}
