"""recover_ms (ms): the mean time to recover from a fault round: from the
start of its injection (``faults.inject``) to the end of the first
``dispatch.window`` that ran FUSED (``degraded`` false) and started after
the round's last degraded window's EAGER run (``dispatch.eager``). A
round's EAGER runs are those that start before the next round's
injection; rounds that injected in the window and recovered count, the
program's spans read whole."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    recorded = spans.spans()
    inject = sorted((s for s in recorded if s.name == "faults.inject"
                     and run.t_start <= s.start < run.t_end),
                    key=lambda s: s.start)
    eager = [s for s in recorded if s.name == "dispatch.eager"]
    fused = sorted((s for s in recorded if s.name == "dispatch.window"
                    and not s.attrs.get("degraded")), key=lambda s: s.start)
    times = []
    for i, s in enumerate(inject):
        nxt = inject[i + 1].start if i + 1 < len(inject) else float("inf")
        ends = [e.end for e in eager if s.start <= e.start < nxt]
        if not ends:
            continue
        after = [w for w in fused if w.start >= max(ends)]
        if after:
            times.append(after[0].end - s.start)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
