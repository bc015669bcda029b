"""scrub_ms (ms): the mean time of one fault round's scrub on the dispatch
thread, ``FaultManager.scrub``: every guarded relation's parity diff, the
repairs and the republish (the program's ``faults.scrub`` spans that start
in the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.spans() if s.name == "faults.scrub"
           and run.t_start <= s.start < run.t_end]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len(sel)
