"""The share of the traced window in which no kernel, copy or memset ran
on the card: 100 x (1 - union of their intervals / window)."""


def read(run):
    dt = run.device_trace
    if dt is None:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
