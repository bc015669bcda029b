"""Port: 3 train steps of each of the ten smoke configs on the (2, 4) CPU
mesh (``launch.steps.build_train_step(..., mesh=)``: parameters and
optimizer state as the reference plan's pieces), in float32 with the
reference's weights carried across, against the port's single-device
step within 1e-5 (losses and grad norms relative, parameters x max(1,
max|p|)) and against the reference's train step composed from its parts
within 1e-4 x max(1, max|ref|); the sharder recorded the reference's
call sites at the global batch.
"""
import dataclasses

import numpy as np
import pytest

from _lm_parity import np_tree, ref_params
from _mesh_parity import (assert_trees_close, batches_of, cpu_mesh,
                          mesh_steps, port_model, ref_steps, single_steps)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import sharding as S


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_train_steps_equal_single_device_and_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.lm import LM as RefLM
    cfg_r = dataclasses.replace(ref_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = ref_params(RefLM(cfg_r))
    batches = batches_of(cfg)
    single, p_single = single_steps(cfg, port_model(cfg, params), batches)
    mesh, p_mesh, step, _ = mesh_steps(cfg, port_model(cfg, params), batches,
                                       cpu_mesh())
    np.testing.assert_allclose(mesh, single, rtol=1e-5)
    assert_trees_close(p_mesh, p_single, 1e-5, f"{arch} mesh vs single")
    ref, p_ref = ref_steps(cfg_r, params, batches)
    for (ml, mg), (rl, rg) in zip(mesh, ref):
        assert abs(ml - rl) <= 1e-4 * max(1.0, abs(rl)), (arch, ml, rl)
        assert abs(mg - rg) <= 1e-4 * max(1.0, abs(rg)), (arch, mg, rg)
    assert_trees_close(p_mesh, np_tree(p_ref), 1e-4, f"{arch} mesh vs ref")
    # the sharder saw the reference's two call sites of LM at the global
    # batch (and MoE's where the pattern has one)
    specs = step.mm.sharder.last_specs
    assert "logits" in specs
    if cfg.block_pattern != "encdec":        # the encoder embeds directly
        assert S.entry_axes(specs["hidden"][0]) == ("data",)
    if cfg.moe is not None:
        assert {"moe_buf", "moe_buf3"} <= set(specs)
