"""The program's ``semaphoreWaitTime`` (the permits, ``resource.py``)
as milliseconds a window query: summed over each query's plan, or over
the server's plans through its metrics verb."""

import summary


def read(run):
    return summary.counter_ms_per_query(run, "semaphoreWaitTime")
