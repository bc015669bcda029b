"""Elastic scaling and failure recovery: re-mesh and re-shard a checkpoint.

The counterpart of ``repro.launch.elastic``. A pod (or a host) is lost
mid-run; the controller
  1. builds a mesh over the surviving devices
     (``mesh.make_mesh_for_devices``),
  2. computes the sharding rules for the new mesh,
  3. restores the newest complete checkpoint straight into the new
     mesh's pieces (checkpoints hold whole leaves, so re-slicing is a cut
     of each host copy), and
  4. resumes with the global batch kept (each dp slice grows).
A straggler is handled the same way: evicted, and the run re-meshes
without it.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from ..checkpoint import checkpoint as ckpt
from ..distributed.sharded_steps import MeshModel, opt_state_shardings
from .mesh import make_mesh_for_devices


def remesh_and_restore(ckpt_dir: str, cfg, shape, n_surviving: int,
                       example_params, example_opt,
                       model_parallel: Optional[int] = None,
                       device="cuda", devices: Optional[Sequence] = None
                       ) -> Tuple[int, Any, Any, Any]:
    """Returns (step, params, opt_state, new mesh): the checkpoint's
    ``params`` and ``opt`` trees (the layout ``launch.train`` saves) as
    pieces of the new mesh's plan, the parameters' with
    ``_fsdp_augment``."""
    mesh = make_mesh_for_devices(n_surviving, model_parallel, device=device,
                                 devices=devices)
    mm = MeshModel(cfg, mesh)
    o_shard = opt_state_shardings(mm.rules, mm.p_shard, example_opt)
    step, tree = ckpt.restore(
        ckpt_dir, {"params": example_params, "opt": example_opt},
        shardings={"params": mm.p_shard, "opt": o_shard})
    return step, tree["params"], tree["opt"], mesh
