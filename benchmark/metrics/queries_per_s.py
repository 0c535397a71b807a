"""Queries a second over the window: every query that returned inside it
counts 1, and one still running at its close counts the share of its
latency that fell inside it (so the rate is not quantized to whole
queries a window; the query is waited for and checked all the same)."""


def read(run):
    done = 0.0
    for q in run.window:
        if q.t1 is None or q.error is not None:
            continue
        done += 1.0 if q.t1 <= run.t_close else \
            max(0.0, run.t_close - q.t0) / (q.t1 - q.t0)
    return done / run.seconds
