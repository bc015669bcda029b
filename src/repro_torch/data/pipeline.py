"""Training data pipeline, with example selection by a bulk-bitwise filter.

The counterpart of ``repro.data.pipeline``: this is where the paper's
technique meets the LM stack. Corpus-selection predicates (length,
quality, domain filters) are scan-heavy analytics over a large metadata
table: the table is bit-sliced onto the device once, and each epoch's
admission predicate runs there as one bulk-bitwise filter giving a packed
admission mask (the eager engine: ``InSet`` terms through the ``eq_imm``
kernel, ``ge`` terms through ``cmp_imm``). The token loader then draws
from the admitted stream.

The token source is synthetic (a seeded numpy stream, the reference's bit
for bit): the boundary is batch arrays, so a real tokenised corpus is a
reader change only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..core import engine
from ..db.compiler import And, Cmp, Col, Compiler, InSet, Lit
from ..models.lm import require_cuda


@dataclasses.dataclass
class CorpusMeta:
    """Per-example metadata columns (the device-resident selection table)."""
    n_examples: int
    length: np.ndarray          # tokens per example
    quality: np.ndarray         # 0-100 quality score
    domain: np.ndarray          # dict-encoded domain id
    dedup_bucket: np.ndarray    # near-dup cluster id

    @classmethod
    def synthetic(cls, n: int, seed: int = 0) -> "CorpusMeta":
        rng = np.random.default_rng(seed)
        return cls(n,
                   rng.integers(32, 8192, n),
                   rng.integers(0, 101, n),
                   rng.integers(0, 24, n),
                   rng.integers(0, max(8, n // 4), n))


def default_selection(min_len: int = 128, min_quality: int = 60,
                      domains=(0, 1, 2, 3, 5, 8, 13)):
    return And(Cmp("ge", Col("length"), Lit(min_len)),
               Cmp("ge", Col("quality"), Lit(min_quality)),
               InSet(Col("domain"), tuple(domains)))


class PimDataSelector:
    """Bit-sliced metadata table on ``device`` (default ``"cuda"``) and the
    bulk-bitwise admission filter over it."""

    def __init__(self, meta: CorpusMeta, device="cuda"):
        require_cuda(device)
        self.meta = meta
        self.rel = engine.PimRelation.from_columns("corpus", {
            "length": meta.length, "quality": meta.quality,
            "domain": meta.domain, "dedup_bucket": meta.dedup_bucket,
        }, device=device)

    def admit(self, predicate=None) -> np.ndarray:
        """The admission mask (n_examples,) bool of ``predicate`` (default
        ``default_selection()``)."""
        predicate = predicate or default_selection()
        c = Compiler(self.rel)
        mask_reg = c.compile_filter(predicate)
        eng = engine.Engine(self.rel)
        eng.run(c.program)
        return eng.read_mask(mask_reg)[: self.meta.n_examples]

    def admission_stats(self, predicate=None) -> Dict[str, float]:
        m = self.admit(predicate)
        return {"admitted": float(m.mean()), "n": int(m.sum())}


class TokenBatcher:
    """Deterministic, resumable batch stream over admitted examples.

    Determinism + explicit epoch/cursor state make restarts exact: the
    loader state (epoch, cursor) is saved with the checkpoint, so a
    restored run sees the same token stream a failure-free run would.
    Batches are numpy (``tokens``/``labels`` (batch, seq) int32, ``extra``
    None); the trainer moves them to the model's device.
    """

    def __init__(self, vocab: int, batch: int, seq: int,
                 admitted: Optional[np.ndarray] = None, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.admitted = admitted
        self.epoch = 0
        self.cursor = 0
        self.seed = seed

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor}

    def load_state(self, st: Dict[str, int]):
        self.epoch, self.cursor = st["epoch"], st["cursor"]

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.cursor))
        tokens = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                              dtype=np.int32)
        self.cursor += 1
        if self.cursor >= 1 << 16:
            self.cursor = 0
            self.epoch += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                "extra": None}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
