"""device_idle_share (%): the share of the traced window in which no
operation ran on the card (``torch.profiler``'s device events, merged)."""


def read(run):
    if run.trace is None or not run.trace.marked or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
