"""The mean ``queueWaitMs`` of the response headers of the window's
queries: the wait for the server's admission (``serve/scheduler.py``)."""


def read(run):
    vals = [q.extras["queueWaitMs"] for q in run.window
            if q.extras.get("queueWaitMs") is not None]
    return sum(vals) / len(vals) if vals else None
