"""result_cache_hit_share (%): the window's service's result-cache hits
over its lookups (``QueryService.stats()["cache"]``)."""


def read(run):
    c = run.service["cache"]
    n = c["hits"] + c["misses"]
    return 100.0 * c["hits"] / n if n else None
