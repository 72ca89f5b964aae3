from deepim_tpu_torch.render.mesh import Mesh, MeshBank, make_icosphere, make_test_cube
from deepim_tpu_torch.render.rasterizer import RasterConfig, csr_dropped_pairs, rasterize, render_mask

__all__ = [
    "Mesh", "MeshBank", "make_icosphere", "make_test_cube",
    "RasterConfig", "csr_dropped_pairs", "rasterize", "render_mask",
]
