"""tape_cache_hit_share (%): hits of the program's compiled-tape cache
over its lookups during the window (``program_cache_stats()``, the
difference across the window)."""


def read(run):
    n = run.tape["hits"] + run.tape["misses"]
    return 100.0 * run.tape["hits"] / n if n else None
