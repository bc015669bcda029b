"""qps (queries/s): queries answered inside the window, all clients
together, over the window's length (host clock)."""


def read(run):
    n = sum(1 for r in run.in_window() if r.answered and r.t_done <= run.t_end)
    return n / run.seconds
