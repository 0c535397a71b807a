"""decodeFused's share of its memory roofline over the device trace.

Least time: the logical bytes of every row group the traced queries
(``summary.traced``) scanned that the program decodes on the card, at
the card's HBM peak: the compressed bytes of the column chunks read
(from the files' footers) plus rows x the Spark width of each column
read. Nothing of the kernel's staged or padded input is counted. A row group of more rows than the
conf's reader cap is host-decoded by the program, never by the kernel,
so it is left out. Kernel time: the device time of the CUDA kernels
below, from the profiler."""

import parquet_data
import summary

# the CUDA kernels of csrc/decode_fused.cu
SYMBOLS = ("decode_tiles", "scan_blocks", "scan_sums")
# the reader's cap on a device-decoded row group, and its documented
# default in the program's conf
READER_CAP_KEY = "spark.rapids.sql.reader.batchSizeRows"
READER_CAP_DEFAULT = 1 << 20


def read(run):
    per_query = 0.0
    for table, columns in run.reference.SCANS.items():
        scanned = parquet_data.scan_bytes(
            run.views[table], columns,
            int(run.config["conf"].get(READER_CAP_KEY, READER_CAP_DEFAULT)))
        per_query += (scanned["compressed"] + scanned["rows"]
                      * summary.column_widths(run, columns))
    n = len(summary.traced(run))
    return summary.roofline_pct(run, SYMBOLS, n * per_query)
