"""The 90th percentile latency: submission to last row on the client,
over every query that ended inside the (traced) window. A per-layer
metric: across runs it spreads too far for a bound."""

import summary


def read(run):
    return summary.latency_quantile(run, 0.9)
