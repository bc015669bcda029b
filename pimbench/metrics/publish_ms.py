"""publish_ms (ms): the mean time of ``PimDatabase.publish`` in a refresh:
new versions and the live rows of each mutated relation
(``live_columns``), the program's ``dml.publish`` spans cut to the
window."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.clip(spans.spans(), run.t_start, run.t_end)
           if s.name == "dml.publish"]
    if not sel:
        return None
    return 1e3 * sum(s.seconds for s in sel) / len(sel)
