"""The program's ``deviceDecodeTime`` (the Parquet scan's host half:
reads, decompression, page headers and decode plans,
``io/device_decode.py``) as milliseconds a window query: summed over
each query's scans, or over the server's plans through its metrics
verb."""

import summary


def read(run):
    return summary.counter_ms_per_query(run, "deviceDecodeTime")
