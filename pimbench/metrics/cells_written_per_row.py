"""cells_written_per_row (cells/row): ``cells_written`` over ``n_rows`` of
``PimDatabase.apply``'s returned stats, over the refreshes acknowledged in
the window."""


def read(run):
    cells = rows = 0
    for r in run.refreshes:
        if r.stats and r.t_ack is not None and r.t_ack <= run.t_end:
            for st in r.stats.values():
                cells += st["cells_written"]
                rows += st["n_rows"]
    return cells / rows if rows else None
