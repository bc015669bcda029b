"""scrub_readback_bytes (bytes/scrub): the mean bytes one fault round's
scrub copies off the card, parity rows and the written words its repairs
read back (the ``bytes`` of the program's ``faults.scrub`` spans that
start in the window)."""


def read(run):
    try:
        from repro_torch.core import spans
    except ImportError:          # a program without spans
        return None
    sel = [s for s in spans.spans() if s.name == "faults.scrub"
           and run.t_start <= s.start < run.t_end and "bytes" in s.attrs]
    if not sel:
        return None
    return sum(s.attrs["bytes"] for s in sel) / len(sel)
