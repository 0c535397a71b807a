"""groupbyHash's share of its memory roofline over the device trace.

Least time: for every traced query (``summary.traced``), the rows
entering the partial aggregate (the reference counts them for the
query's binding) x the Spark widths of its key columns and the columns
it aggregates, plus its groups x (the key widths and 8 bytes an
aggregate output), at the card's HBM peak. Kernel time: the device time of the CUDA kernels below, from
the profiler."""

import summary

# the CUDA kernels of csrc/groupby_hash.cu
SYMBOLS = ("groupby_kernel", "init_tables")


def read(run):
    ref = run.reference
    keys = summary.column_widths(run, ref.AGG_KEYS)
    row = keys + summary.column_widths(run, ref.AGG_INPUTS)
    total = 0.0
    for q in summary.traced(run):
        a = ref.agg_input(run.reference_state, q.binding)
        total += a["rows"] * row + a["groups"] * (keys + 8 * ref.AGG_OUTPUTS)
    return summary.roofline_pct(run, SYMBOLS, total)
