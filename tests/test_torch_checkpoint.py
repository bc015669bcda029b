"""Port: checkpointing (``repro_torch.checkpoint``), held against the
reference.

The reference's roundtrip (bf16 and ``None`` leaves), manifest atomicity
and GC-keeps-newest cases through the port; the manifest's leaves (paths,
shapes, dtypes) equal the reference's for the same numpy tree, and its
other keys are the reference's; an async save joined before the restore,
whose snapshot an in-place update after ``save`` returns cannot tear; a
checkpoint the reference wrote restores in the port and the other way
round; ``restore`` onto the default device raises where there is no card.
"""
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt


class Pair(NamedTuple):
    m: object
    v: object


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16), "d": None},
            "e": (torch.zeros((2, 2)), torch.full((1,), 7.0)),
            "s": Pair(torch.tensor(3, dtype=torch.int32),
                      torch.full((2, 3), -1.5, dtype=torch.bfloat16))}


def _leaves(tree):
    return [(k, v) for k, v in ckpt._flatten(tree).items()]


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if b is None:
            assert a is None, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree)
    step, back = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 3
    assert isinstance(back["s"], Pair) and isinstance(back["e"], tuple)
    _assert_same(back, tree)


def test_manifest_atomicity(tmp_path):
    """A checkpoint directory without MANIFEST.json is invisible."""
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "shard_0.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    step, _ = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 1


def test_gc_keeps_newest(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.complete_steps(str(tmp_path)) == [4, 5]
    assert not list(tmp_path.glob(".tmp_step_*"))


def _np_tree(rng):
    return {"params": {"blocks": {"w": rng.normal(size=(2, 3, 4))
                                  .astype(np.float32)},
                       "embed": {"table": rng.normal(size=(5, 3))
                                 .astype(np.float32)},
                       "tail": None},
            "opt": (np.int32(4), [rng.integers(0, 9, (3,)).astype(np.int32),
                                  np.zeros((1,), np.float32)])}


def test_manifest_equals_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpoint import checkpoint as ref
    tree = _np_tree(np.random.default_rng(0))
    ckpt.save(tmp_path / "port", 7, tree)
    ref.save(str(tmp_path / "ref"), 7, tree)
    mp, mr = (json.loads((tmp_path / side / "step_00000007" /
                          "MANIFEST.json").read_text())
              for side in ("port", "ref"))
    assert mp["leaves"] == mr["leaves"]
    assert list(mp["leaves"]) == list(mr["leaves"])
    assert (mp["step"], mp["n_hosts"]) == (mr["step"], mr["n_hosts"]) == \
        (7, 1)
    assert sorted(mp) == sorted(mr)
    for a, b in ((ckpt, ref), (ref, ckpt)):
        src = tmp_path / ("port" if a is ckpt else "ref")
        kw = {"device": "cpu"} if b is ckpt else {}
        step, back = b.restore(str(src), tree, **kw)
        assert step == 7
        got = dict(_leaves(back))
        assert sorted(got) == sorted(dict(_leaves(tree)))
        for k, y in _leaves(tree):
            if y is None:
                assert got[k] is None, k
            else:
                np.testing.assert_array_equal(np.asarray(got[k]), y,
                                              err_msg=k)


def test_async_save_joined_before_restore(tmp_path):
    """``save(blocking=False)`` returns the writer thread; the leaves were
    copied before it returned, so updating them in place does not reach
    the files."""
    tree = _tree()
    want = {"a": tree["a"].clone(), "b": {"c": tree["b"]["c"].clone(),
                                          "d": None},
            "e": tuple(t.clone() for t in tree["e"]),
            "s": Pair(*(t.clone() for t in tree["s"]))}
    t = ckpt.save(tmp_path, 9, tree, blocking=False)
    tree["a"].add_(100.0)
    tree["b"]["c"].mul_(3)
    tree["s"].v.zero_()
    t.join(timeout=60)
    assert not t.is_alive()
    step, back = ckpt.restore(str(tmp_path), want, device="cpu")
    assert step == 9
    _assert_same(back, want)


def test_restore_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(str(tmp_path), tree)
