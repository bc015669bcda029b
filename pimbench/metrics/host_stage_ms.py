"""host_stage_ms (ms): the mean ``QueryResult.host_s`` (the program's span
of ``db/exec.py``'s host stage) of the end-to-end queries the program
computed."""


def read(run):
    vals = [r.result.host_s for r in run.dispatched()
            if r.q.scope == "end_to_end"]
    return 1e3 * sum(vals) / len(vals) if vals else None
