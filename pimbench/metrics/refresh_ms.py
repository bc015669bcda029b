"""refresh_ms (ms): the mean of the benchmark's own span around each
``QueryService.apply`` of a refresh function acknowledged in the
window."""


def read(run):
    vals = [r.t_ack - r.t_call for r in run.refreshes
            if r.t_ack is not None and r.t_ack <= run.t_end]
    return 1e3 * sum(vals) / len(vals) if vals else None
