"""Port: the LM serving driver (``repro_torch.launch.serve``: ``serve``,
``greedy_decode``, ``--mode lm``) and the analytics-guided serving
example, held against the reference.

With the reference's weights carried across in float32 (its
``serve``'s ``init(PRNGKey(0))``), the port's greedy loop from the
reference loop's first tokens gives the reference's whole token sequence
exactly (qwen2, and gemma2 past its window). ``--mode lm --smoke``
decodes on the CPU, ``--mode db`` still replays, the example admits
exactly the requests numpy and the reference's engine admit, and the
default device raises where there is no card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _lm_parity import np_tree
from repro_torch.configs import get_smoke_config
from repro_torch.examples import analytics_guided_serving as example
from repro_torch.launch import serve as launch
from repro_torch.models import LM, load_reference_params


@pytest.mark.parametrize("arch,gen_len", [("qwen2-0.5b", 8),
                                          ("gemma2-9b", 20)])
def test_greedy_loop_equals_reference_serve(arch, gen_len):
    jax = pytest.importorskip("jax")
    from repro.launch.serve import serve as ref_serve
    from repro.models.lm import LM as RefLM
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    want, _ = ref_serve(cfg, batch=3, prompt_len=1, gen_len=gen_len)
    model = LM(cfg, device="cpu")
    load_reference_params(model, np_tree(
        jax.jit(RefLM(cfg).init)(jax.random.PRNGKey(0))))
    got, tps = launch.greedy_decode(model, torch.from_numpy(want[:, :1]),
                                    1 + gen_len)
    assert got.shape == want.shape == (3, 1 + gen_len)
    assert np.array_equal(got, want)
    assert tps > 0


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "whisper-small",
                                  "zamba2-7b"))
def test_serve_on_cpu(arch):
    """``serve`` from seeded random weights: the shape, ids in range, and
    the same sequence from the same seed."""
    cfg = get_smoke_config(arch)
    seq, tps = launch.serve(cfg, 2, 1, 6, device="cpu")
    assert seq.shape == (2, 7) and tps > 0
    assert ((seq >= 0) & (seq < cfg.vocab)).all()
    again, _ = launch.serve(cfg, 2, 1, 6, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert np.array_equal(seq, again)


def test_serve_cli_lm_smoke_decodes(capsys):
    launch.main(["--mode", "lm", "--smoke", "--device", "cpu",
                 "--gen-len", "4"])
    assert "decoded (4, 5) at" in capsys.readouterr().out


def test_serve_cli_db_still_replays(capsys):
    launch.main(["--mode", "db", "--sf", "0.001", "--device", "cpu",
                 "--trace", "Q1,Q6"])
    out = capsys.readouterr().out
    assert "replaying 2 queries" in out and "served 2 queries" in out


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.serve(cfg, 2, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--smoke"])


@pytest.fixture(scope="module")
def example_run():
    return example.main(["--device", "cpu"])


def test_example_admits_numpy_count(example_run):
    q = example.make_queue()
    want = (np.isin(q["tier"], (2, 3)) & (q["prompt_len"] <= 4096)
            & (q["rate_bucket"] < 80))
    assert example_run["admitted"] == int(want.sum())
    assert example_run["shape"] == (4, 13)


def test_example_admission_equals_reference_engine(example_run):
    """The reference example's policy on its own engine and the same
    queue (``default_rng(0)``) admits the same count."""
    pytest.importorskip("jax")
    from repro.core import engine
    from repro.db.compiler import And, Cmp, Col, Compiler, InSet, Lit
    rel = engine.PimRelation.from_columns("queue", example.make_queue())
    c = Compiler(rel)
    reg = c.compile_filter(And(InSet(Col("tier"), (2, 3)),
                               Cmp("le", Col("prompt_len"), Lit(4096)),
                               Cmp("lt", Col("rate_bucket"), Lit(80))))
    eng = engine.Engine(rel)
    eng.run(c.program)
    assert int(eng.read_mask(reg)[:example.N_REQ].sum()) == \
        example_run["admitted"]


def test_example_decodes_what_serve_decodes(example_run):
    seq, _ = launch.serve(get_smoke_config("qwen2-0.5b"), 4, 1, 12,
                          device="cpu")
    assert np.array_equal(example_run["seq"], seq)
