"""Worker-process entry point.

Runs in a separate process with no torch or engine imports: the loop
receives (mode, pickled-functions, Arrow-IPC bytes) frames, applies the
UDFs with pandas, and returns Arrow-IPC bytes — the same
stream-of-record-batches contract the reference's GpuArrowPythonRunner
speaks over its socket (GpuArrowEvalPythonExec.scala:353). Errors
travel back as formatted tracebacks and re-raise engine-side.
"""

from __future__ import annotations

import io
import traceback


def _read_table(ipc_bytes: bytes):
    import pyarrow as pa
    with pa.ipc.open_stream(io.BytesIO(ipc_bytes)) as rd:
        return rd.read_all()


def _write_table(tbl) -> bytes:
    import pyarrow as pa
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, tbl.schema) as wr:
        wr.write_table(tbl)
    return sink.getvalue()


def _apply_scalar(fns, arg_idxs, tbl, out_schema):
    """SQL_SCALAR_PANDAS_UDF: fns[i] gets its input columns (by index
    into ``tbl``) as pandas Series and returns a Series/scalar of
    len(tbl); outputs conform to out_schema's field types."""
    import pandas as pd
    import pyarrow as pa
    cols = []
    for i, (fn, idxs) in enumerate(zip(fns, arg_idxs)):
        args = [tbl.column(j).to_pandas() for j in idxs]
        out = fn(*args)
        if not isinstance(out, pd.Series):
            out = pd.Series([out] * tbl.num_rows)
        arr = pa.Array.from_pandas(out, type=out_schema.field(i).type)
        if len(arr) != tbl.num_rows:
            raise ValueError(
                f"pandas_udf returned {len(arr)} rows for a "
                f"{tbl.num_rows}-row batch")
        cols.append(arr)
    return pa.Table.from_arrays(cols, schema=out_schema)


def _apply_map(fn, tbl, out_schema):
    """mapInPandas: fn(iterator of DataFrames) -> iterator of DataFrames."""
    import pandas as pd
    import pyarrow as pa
    outs = []
    for df in fn(iter([tbl.to_pandas()])):
        if not isinstance(df, pd.DataFrame):
            raise TypeError("mapInPandas function must yield DataFrames")
        outs.append(pa.Table.from_pandas(df, schema=out_schema,
                                         preserve_index=False))
    if outs:
        return pa.concat_tables(outs)
    return out_schema.empty_table()


def _read_frame(stream) -> bytes:
    hdr = stream.read(4)
    if len(hdr) < 4:
        raise EOFError
    n = int.from_bytes(hdr, "big")
    buf = stream.read(n)
    if len(buf) < n:
        raise EOFError
    return buf


def _write_frame(stream, payload: bytes) -> None:
    stream.write(len(payload).to_bytes(4, "big"))
    stream.write(payload)
    stream.flush()


def main() -> None:
    """Serve length-prefixed frames over stdin/stdout until EOF (the
    reference's worker speaks the same framed-stream shape over its
    socket, GpuArrowPythonRunner:353). Frame (engine->worker): pickle of
    (mode, payload, ipc_bytes); reply: pickle of ('ok', ipc_bytes) or
    ('err', traceback_string). ``payload`` carries cloudpickled
    functions plus an Arrow-IPC-encoded OUTPUT schema (an empty table —
    the IPC stream is the one type encoding both sides already speak)."""
    import pickle
    import sys

    import cloudpickle

    rd = sys.stdin.buffer
    # claim fd 1: anything the UDF prints must not corrupt the frame
    # stream (Spark's worker redirects the same way)
    wr = sys.stdout.buffer
    sys.stdout = sys.stderr
    while True:
        try:
            msg = _read_frame(rd)
        except EOFError:
            return
        try:
            mode, payload, ipc = pickle.loads(msg)
            tbl = _read_table(ipc)
            if mode == "scalar":
                fn_blobs, arg_idxs, schema_ipc = payload
                fns = [cloudpickle.loads(b) for b in fn_blobs]
                out_schema = _read_table(schema_ipc).schema
                out = _apply_scalar(fns, arg_idxs, tbl, out_schema)
            elif mode == "map":
                fn_blob, schema_ipc = payload
                fn = cloudpickle.loads(fn_blob)
                out_schema = _read_table(schema_ipc).schema
                out = _apply_map(fn, tbl, out_schema)
            else:
                raise ValueError(f"unknown mode {mode!r}")
            _write_frame(wr, pickle.dumps(("ok", _write_table(out))))
        except Exception:
            _write_frame(wr, pickle.dumps(("err", traceback.format_exc())))


if __name__ == "__main__":
    main()
