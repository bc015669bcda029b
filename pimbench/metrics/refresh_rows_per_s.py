"""refresh_rows_per_s (rows/s): rows inserted plus rows deleted by the
refresh functions acknowledged inside the window, counted by the
benchmark's own copy of the tables, over the window (host clock)."""


def read(run):
    if not run.refreshes:
        return None
    rows = sum(r.n_rows for r in run.refreshes
               if r.t_ack is not None and r.t_ack <= run.t_end)
    return rows / run.seconds
