"""The cross-process shuffle leg over SRTB files (the counterpart of
``spark_rapids_tpu.parallel.external_shuffle``; SRTB is the serialized
batch format of ``columnar/serde.py``).

Map tasks write each output partition as SRTB blocks into a shared
directory (``map{m}_part{p}.srtb`` and a ``map{m}.done`` commit marker,
the shuffle-file contract of Spark's sort shuffle), and reduce tasks, in
any process, read every committed map's block for their partition.
Atomicity comes from write-to-temp and rename; the compression codec
(``spark.rapids.shuffle.compression.codec``) rides in each SRTB header,
so a reader needs no configuration. The files are byte-compatible with
the JAX package's: either package reads what the other wrote.

``spark.rapids.shuffle.mode=external`` routes every device exchange
through this leg (``exec/exchange.py`` ``_external_roundtrip``: the
partitions downloaded and serialized after the device split, read back
and uploaded on the reduce side). In one process that is a loopback
through the filesystem: the transport skeleton a multi-host backend
plugs into, tested with a real second process.
"""

from __future__ import annotations

import os
import tempfile
import uuid
from typing import List, Optional

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.columnar.serde import (
    deserialize_batch, serialize_batch)


def write_map_output(shuffle_dir: str, map_id: str,
                     parts: List[List[HostBatch]],
                     codec: str = "none") -> None:
    """Persist one map task's output: one SRTB file per non-empty
    partition, committed atomically (temp + rename) so concurrent
    readers never observe torn files."""
    os.makedirs(shuffle_dir, exist_ok=True)
    for pid, batches in enumerate(parts):
        batches = [b for b in batches if b.num_rows]
        if not batches:
            continue
        payload = b"".join(
            len(blk).to_bytes(4, "little") + blk
            for blk in (serialize_batch(b, codec) for b in batches))
        final = os.path.join(shuffle_dir, f"map{map_id}_part{pid}.srtb")
        tmp = final + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, final)
    marker = os.path.join(shuffle_dir, f"map{map_id}.done")
    tmp = marker + ".tmp"
    with open(tmp, "w") as f:
        f.write("ok")
    os.replace(tmp, marker)


def map_outputs_done(shuffle_dir: str) -> List[str]:
    """Committed map ids in the directory."""
    if not os.path.isdir(shuffle_dir):
        return []
    return sorted(f[3:-5] for f in os.listdir(shuffle_dir)
                  if f.startswith("map") and f.endswith(".done"))


def read_partition(shuffle_dir: str, pid: int,
                   map_ids: Optional[List[str]] = None
                   ) -> List[HostBatch]:
    """Every committed map's blocks for partition ``pid``, in map id
    order (the RapidsCachingReader remote-fetch role over files)."""
    out: List[HostBatch] = []
    for mid in (map_ids if map_ids is not None
                else map_outputs_done(shuffle_dir)):
        path = os.path.join(shuffle_dir, f"map{mid}_part{pid}.srtb")
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            ln = int.from_bytes(data[off:off + 4], "little")
            off += 4
            out.append(deserialize_batch(data[off:off + ln]))
            off += ln
    return out


def new_shuffle_dir(base: Optional[str] = None) -> str:
    """A fresh directory for one exchange's files, under ``base`` (the
    process's temporary directory by default)."""
    root = base or os.path.join(tempfile.gettempdir(), "srt-shuffle")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix="exch-", dir=root)
