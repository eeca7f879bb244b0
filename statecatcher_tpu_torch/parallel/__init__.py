"""Multi-GPU training: the ('data', 'model') mesh of ranks (mesh.py) and the
process start-up and cross-rank plumbing over torch.distributed
(distributed.py); dryrun.py drives one train step per parallel mode."""

from statecatcher_tpu_torch.parallel.mesh import MeshPlan, make_mesh_plan

__all__ = ["MeshPlan", "make_mesh_plan"]
