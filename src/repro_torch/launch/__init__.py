"""Launch tools of the port: the serving and training launchers, the meshes
(:mod:`.mesh`), the sharding rules (:mod:`.shardings`) and the dry-runs."""

from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_debug_mesh"]
