from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_debug_mesh"]
