"""The median latency, submission to last row on the client, of every
query that ended inside the window."""

import summary


def read(run):
    return summary.latency_quantile(run, 0.5)
