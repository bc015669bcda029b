"""repair_ms (ms): the mean time a scrub that found faults spends
repairing them: its relations' rewrites and remaps (the ``faults.repair``
children of the program's ``faults.scrub`` spans that start in the
window). The republish that follows is ``dml.publish``, not read here."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    recorded = spans.spans()
    scrubs = {s.id for s in recorded if s.name == "faults.scrub"
              and run.t_start <= s.start < run.t_end}
    per_scrub = {}
    for s in recorded:
        if s.parent in scrubs and s.name == "faults.repair":
            per_scrub[s.parent] = per_scrub.get(s.parent, 0.0) + s.seconds
    if not per_scrub:
        return None
    return 1e3 * sum(per_scrub.values()) / len(per_scrub)
