"""window_mfu (%): the least time the card could take for all the
window's queries (the fused_program and materialize bounds) over the
traced window's length: the whole window's share of the card's peak."""


def read(run):
    if run.trace is None or not run.trace.marked or run.trace.window_s <= 0:
        return None
    bound = run.fused_bound_s() + run.materialize_bound_s()
    return 100.0 * bound / run.trace.window_s if bound > 0 else None
