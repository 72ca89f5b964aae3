"""Card tests of the port's CUDA kernels: each skips (inside the test)
where torch.cuda.is_available() is false.  This file imports neither JAX
nor deepim_tpu, so it also runs on a GPU host without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from deepim_tpu_torch.engine.refine import Observation, refine
from deepim_tpu_torch.engine.scene import build_scene
from deepim_tpu_torch.models import FlowNetDeepIM
from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.render import raster_kernels as rk
from deepim_tpu_torch.render.rasterizer import KERNELS, RasterConfig, kernel_inputs, rasterize

torch.set_num_threads(2)

K96 = np.array([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]], np.float32)
K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
TWINS = {"csr_raster": rk.csr_raster_plain, "tile_raster": rk.tile_raster_plain}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build csrc/raster.cu)")
    return torch.device("cuda")


@pytest.mark.parametrize("binning", ["dense", "csr"])
def test_kernel_equals_twin_on_card(binning):
    """Kernel and plain twin on the same card inputs: bit-equal outputs."""
    dev = _need_card()
    sc = build_scene(3, 96, 128, K96, num_iters=1, mesh_detail=3, device=dev)
    cfg = RasterConfig(**{**sc.ecfg.raster.__dict__, "binning": binning})
    m = sc.meshes
    for name, args in kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                                    torch.from_numpy(sc.pose0), torch.from_numpy(K96), cfg,
                                    device=dev):
        assert name == ("csr_raster" if binning == "csr" else "tile_raster")
        before = KERNELS[name].launches
        out = KERNELS[name](*args)
        assert KERNELS[name].launches == before + 1
        ref = TWINS[name](*args)
        torch.cuda.synchronize()
        assert (out[:, 0] > 0).any()
        assert torch.equal(out, ref)


def test_card_render_and_refine_equal_cpu():
    """rasterize and a 2-iteration refine on the card equal the CPU path."""
    dev = _need_card()
    sc = build_scene(2, 64, 64, K64, num_iters=2, device="cpu")
    m = sc.meshes
    args = (m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0),
            torch.from_numpy(K64), sc.ecfg.raster)
    rgb_g, depth_g = rasterize(*args, device=dev)
    rgb_c, depth_c = rasterize(*args, device="cpu")
    assert torch.equal(depth_g.cpu() > 0, depth_c > 0)
    torch.testing.assert_close(depth_g.cpu(), depth_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(rgb_g.cpu(), rgb_c, atol=5e-3, rtol=0)
    model = FlowNetDeepIM(input_hw=(64, 64), generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.trans.weight.normal_(0.0, 1e-3, generator=torch.Generator().manual_seed(1))
    obs = Observation(sc.image, box_fill(sc.mask), None, None, torch.from_numpy(K64))
    _, poses_c = refine(model.eval(), obs, sc.meshes, torch.from_numpy(sc.pose0), sc.ecfg, device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 convolutions, as on the CPU
    try:
        _, poses_g = refine(model.to(dev), obs, sc.meshes, torch.from_numpy(sc.pose0), sc.ecfg, device=dev)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(poses_g.cpu(), poses_c, atol=1e-4, rtol=0)


def test_wrappers_validate_card_inputs():
    """The CUDA wrappers refuse what the kernels do not take."""
    dev = _need_card()
    rec = torch.zeros((4, 32), device=dev)
    ids = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    cnt = torch.ones(2, dtype=torch.int32, device=dev)
    xy = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        rk.tile_raster(rec, ids.long(), cnt, xy, 8, 16)
    with pytest.raises(ValueError):
        rk.tile_raster(rec, ids.t().contiguous().t(), cnt, xy, 8, 16)
    with pytest.raises(ValueError):
        rk.tile_raster(rec, ids, cnt, xy, 64, 32)  # 2048-pixel tile
    with pytest.raises(ValueError):
        rk.csr_raster(rec, cnt, cnt, cnt, xy, cnt.cpu(), 4, 8)
