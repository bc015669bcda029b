"""p95_ms (ms): the 95th percentile (linear between ranks) of the latency
of every query of the window that reached the program, from the client's
submit (an open loop's due time) to its answer, cache hits included (host
clock). Queries an open loop dropped at the close are not in it."""
import numpy as np


def read(run):
    lat = [r.t_done - r.t_submit for r in run.in_window() if r.answered]
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
