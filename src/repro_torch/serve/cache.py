"""Version-keyed result cache for the query service.

The counterpart of ``repro.serve.cache``, equal to it apart from this
note and its import lines.

The key of a (spec, engine) request is built from the *canonical*
program structure — every filter predicate canonicalized
(``db.compiler.canonicalize``) and digested with
``db.compiler.canonical_hash`` — plus the aggregate/group/host-plan
structure and, crucially, the ``(relation, version)`` pair of every PIM
relation the spec's array stage touches.  Structurally-equal requests
hit regardless of spec naming or predicate spelling; any relation
mutation bumps its ``PimRelation.version`` and every dependent entry
misses from then on — the cache is correct by construction, no
invalidation walk needed.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from repro_torch.db import compiler as C
from repro_torch.db import database as D
from repro_torch.db import queries as Q


def spec_cache_key(db: "D.PimDatabase", spec: Q.QuerySpec,
                   engine: "D.Engine") -> Tuple:
    """Canonical cache key of one request against the db's CURRENT
    relation versions.  Two specs that compile to the same per-relation
    programs over the same relation contents share a key."""
    pred_keys = tuple(
        (rel, C.canonical_hash(C.canonicalize(pred)))
        for rel, pred in sorted(spec.filters.items()))
    agg_key = _digest(repr((spec.kind, spec.agg_relation,
                            tuple(spec.aggregates),
                            tuple(spec.groups or ()))))
    host_key = _digest(repr(spec.host)) if spec.host is not None else None
    versions = tuple(
        (rel, db.relations[rel].version) for rel in spec.pim_relations())
    return (engine.value, pred_keys, agg_key, host_key, versions)


def _digest(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()[:16]


class ResultCache:
    """Thread-safe LRU over :func:`spec_cache_key` -> QueryResult.

    Entries never go stale (versions are part of the key); ``capacity``
    only bounds memory, evicting least-recently-hit entries — which
    naturally ages out keys referring to superseded relation versions.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Tuple, D.QueryResult]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple) -> Optional["D.QueryResult"]:
        with self._lock:
            res = self._entries.get(key)
            if res is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return res

    def put(self, key: Tuple, result: "D.QueryResult") -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = result
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._entries),
                "capacity": self.capacity}
