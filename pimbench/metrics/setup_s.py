"""setup_s (s): from the start of the process's benchmark code to the
window's start: generating the tables, loading them onto the card (the
kernels' build on a checkout's first run) and the warm-up (host clock)."""


def read(run):
    return run.setup_s
