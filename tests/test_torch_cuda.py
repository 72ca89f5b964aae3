"""Card tests of the port's CUDA kernels: each skips (inside the test)
where torch.cuda.is_available() is false.  This file imports neither JAX
nor deepim_tpu, so it also runs on a GPU host without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import dataclasses

from deepim_tpu_torch.config import TrainConfig, TrainIterConfig
from deepim_tpu_torch.engine import TrainState, make_optimizer, make_train_step, warmup_multifactor_schedule
from deepim_tpu_torch.engine.refine import MeshBuffers, Observation, refine
from deepim_tpu_torch.engine.scene import LINEMOD_K, build_scene, train_batch
from deepim_tpu_torch.models import FlowNetDeepIM
from deepim_tpu_torch.ops.masks import box_fill
from deepim_tpu_torch.render import raster_kernels as rk
from deepim_tpu_torch.render.rasterizer import KERNELS, RasterConfig, kernel_inputs, rasterize
from deepim_tpu_torch.render.stress import stress_tile_list, stress_work_list

torch.set_num_threads(2)

K96 = np.array([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]], np.float32)
K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
TWINS = {"csr_raster": rk.csr_raster_plain, "csr_planes_raster": rk.csr_planes_raster_plain,
         "tile_raster": rk.tile_raster_plain}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build csrc/raster.cu)")
    return torch.device("cuda")


_KERNEL_OF = {("dense", "slots8"): "tile_raster", ("csr", "slots8"): "csr_raster",
              ("csr", "planes64"): "csr_planes_raster"}


@pytest.mark.parametrize("binning,csr_kernel", list(_KERNEL_OF))
def test_kernel_equals_twin_on_card(binning, csr_kernel):
    """Kernel and plain twin on the same card inputs: bit-equal outputs."""
    dev = _need_card()
    sc = build_scene(3, 96, 128, K96, num_iters=1, mesh_detail=3, device=dev)
    cfg = RasterConfig(**{**sc.ecfg.raster.__dict__, "binning": binning, "csr_kernel": csr_kernel})
    m = sc.meshes
    for name, args in kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid,
                                    torch.from_numpy(sc.pose0), torch.from_numpy(K96), cfg,
                                    device=dev):
        assert name == _KERNEL_OF[binning, csr_kernel]
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


def test_planes_kernel_equals_slots8_kernel_on_card():
    """csr_planes_raster (raw pack, planes derived in the kernel) and
    csr_raster (prebuilt records) on the same render: equal outputs, and
    equal images through rasterize."""
    dev = _need_card()
    sc = build_scene(2, 96, 128, K96, num_iters=1, mesh_detail=4, device=dev)
    m = sc.meshes
    args = (m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0), torch.from_numpy(K96))
    outs, images = [], []
    for kern in ("planes64", "slots8"):
        cfg = dataclasses.replace(sc.ecfg.raster, csr_kernel=kern)
        (name, kargs), = kernel_inputs(*args, cfg, device=dev)
        outs.append(KERNELS[name](*kargs))
        images.append(rasterize(*args, cfg, device=dev))
    torch.cuda.synchronize()
    assert (outs[0][:, 0] > 0).any()
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*images):
        assert torch.equal(a, b)


def test_train_step_card_equals_cpu():
    """One 2-inner-iteration train step of the 64x64 scene on the card and
    on the CPU, same weights: losses rtol 1e-4 and parameters within 1e-6
    plus 1% of each tensor's update (cuDNN's fp32 convolutions sum in
    another order than the CPU's; TF32 off)."""
    dev = _need_card()
    sc = build_scene(2, 64, 64, K64, num_iters=2, update_mask="box_gt", device="cpu")
    batch = train_batch(sc, K64, 16)
    ticfg = TrainIterConfig(SE3_PM_LOSS=True, LW_PM=0.1, NUM_3D_SAMPLE=16, LW_FLOW=0.25, LW_MASK=0.03)
    model0 = FlowNetDeepIM(input_hw=(64, 64), generator=torch.Generator().manual_seed(0), device="cpu")
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in ("cpu", dev):
            model = FlowNetDeepIM(input_hw=(64, 64), device=d)
            model.load_state_dict(model0.state_dict())
            opt = make_optimizer(model.parameters(), TrainConfig(), warmup_multifactor_schedule(1e-3, (1000,)))
            state, metrics, pose = make_train_step(sc.ecfg, ticfg, "viz", device=d)(
                TrainState(model, opt), batch, sc.bank_arrays)
            results.append(({k: v.cpu() for k, v in metrics.items()},
                             {k: v.cpu() for k, v in model.state_dict().items()}, pose.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (m_c, p_c, pose_c), (m_g, p_g, pose_g) = results
    for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
        torch.testing.assert_close(m_g[key], m_c[key], rtol=1e-4, atol=0)
    p0 = model0.state_dict()
    for key in p_c:
        delta = float((p_c[key] - p0[key]).abs().max())
        torch.testing.assert_close(p_g[key], p_c[key], rtol=0, atol=1e-6 + 1e-2 * delta)
    torch.testing.assert_close(pose_g, pose_c, rtol=0, atol=1e-5)


def test_mesh_gather_on_card_tensors():
    """MeshBuffers.gather takes a bank and class indices already on the card."""
    dev = _need_card()
    sc = build_scene(2, 64, 64, K64, num_iters=1, device="cpu")
    bank = {k: torch.as_tensor(v).to(dev) for k, v in sc.bank_arrays.items()}
    got = MeshBuffers.gather(bank, torch.as_tensor(sc.cls_idx).to(dev), device=dev)
    ref = MeshBuffers.gather(sc.bank_arrays, sc.cls_idx, device="cpu")
    for a, b in zip(got, ref):
        assert (a is None and b is None) or (a.device.type == "cuda" and torch.equal(a.cpu(), b))
    assert got.normals is None and got.uv is None and got.textures is None


def test_planes_wrapper_validates_card_inputs():
    """csr_planes_raster refuses what its kernel does not take."""
    dev = _need_card()
    raw = torch.zeros((8, 32), device=dev)
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    xy = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    csr = (torch.zeros(4, dtype=torch.int32, device=dev), i32, i32, xy, i32)
    with pytest.raises(TypeError):
        rk.csr_planes_raster(raw.double(), *csr, 4, 8)
    with pytest.raises(ValueError):
        rk.csr_planes_raster(raw[:, :20].contiguous(), *csr, 4, 8)  # not 32 lanes
    with pytest.raises(ValueError):
        rk.csr_planes_raster(raw.reshape(-1)[1:1 + 7 * 32].view(7, 32), *csr, 4, 8)  # misaligned
    with pytest.raises(ValueError):
        rk.csr_planes_raster(raw, *csr[:4], i32.cpu(), 4, 8)
    with pytest.raises(ValueError):
        rk.csr_planes_raster(raw, *csr, 4, 3)  # tile_w must divide 128


@pytest.mark.parametrize("pack,tile_w", [(1, 8), (4, 8), (1, 16), (4, 16), (4, 128), (1, 2)])
def test_csr_kernels_equal_twins_on_stress_list(pack, tile_w):
    """Both CSR kernels on the hand-built stress list (one tile of 1,328
    faces: six passes of a block, the last partial; exact copies at higher
    face ids; degenerate and invalid faces; empty items), with 4x4 cull
    blocks (tile_w 8, 16) and the general block shapes (128, 2): bit-equal
    to the twin, ties to the smallest id."""
    dev = _need_card()
    n = 1328
    records, raw, csr = stress_work_list(pack, tile_w, n_faces=n, device=dev)
    ref = rk.csr_raster_plain(records, *csr)
    hit = ref[:, 0] > 0
    fid = ref[:, 1][hit].long() % n
    assert hit.any() and (fid < n // 4).any() and not (fid >= n - n // 4).any()
    for kernel, table in ((rk.csr_raster, records), (rk.csr_planes_raster, raw)):
        before = kernel.launches
        out = kernel(table, *csr)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(out, ref), kernel.__name__


@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (16, 16), (8, 16), (8, 4), (1, 32), (16, 6)])
def test_tile_kernel_equals_twin_on_stress_list(tile_h, tile_w):
    """tile_raster on the hand-built dense stress list (lists of 512 faces:
    two passes of a block; descending and shuffled ids with exact 1/z ties
    that the first in the list must win; lists of 0, 1, 128, 129, 256 and
    257 faces; tile-filling, degenerate and invalid faces; -1 padding behind a guard
    face), with 4x4 cull blocks and the general shapes (16x1 for the 1x32
    tile, 2x8 for 16x6): bit-equal to the twin."""
    dev = _need_card()
    args = stress_tile_list(tile_h, tile_w, 512, device=dev)
    ref = rk.tile_raster_plain(*args)
    hit = ref[:, 0] > 0
    assert hit.any() and float(ref[:, 0].max()) < 3.0  # the guard face is in no list
    assert not torch.equal(ref[0, 1:], ref[2, 1:])      # ascending and descending lists: other tie winners
    before = rk.tile_raster.launches
    out = rk.tile_raster(*args)
    torch.cuda.synchronize()
    assert rk.tile_raster.launches == before + 1
    assert torch.equal(out, ref)


def test_tile_kernel_equals_twin_on_heavy_scene():
    """tile_raster at the dense path's heavy shape (480x640, batch 16,
    1,280-face icospheres, lists of up to 512 faces): no list reaches the
    cap, and the kernel equals the twin bit for bit."""
    dev = _need_card()
    sc = build_scene(16, 480, 640, LINEMOD_K, num_iters=4, mesh_detail=3, max_faces_per_tile=512, device=dev)
    m = sc.meshes
    (name, args), = kernel_inputs(m.vertices, m.colors, m.faces, m.face_valid, torch.from_numpy(sc.pose0),
                                  torch.from_numpy(LINEMOD_K), sc.ecfg.raster, corners=m.corners,
                                  corner_colors=m.corner_colors, device=dev)
    assert name == "tile_raster" and 128 < int(args[2].max()) < 512
    out = rk.tile_raster(*args)
    ref = rk.tile_raster_plain(*args)
    torch.cuda.synchronize()
    assert (out[:, 0] > 0).any()
    assert torch.equal(out, ref)


def _explicit_precision():
    """set_explicit_precision for one test; returns a restore callable."""
    from deepim_tpu_torch.device import set_explicit_precision

    names = ("allow_tf32", "allow_tf32", "allow_bf16_reduced_precision_reduction")
    owners = (torch.backends.cudnn, torch.backends.cuda.matmul, torch.backends.cuda.matmul)
    saved = [getattr(o, n) for o, n in zip(owners, names)]
    set_explicit_precision()

    def restore():
        for o, n, v in zip(owners, names, saved):
            setattr(o, n, v)
    return restore


def test_bf16_network_card_equals_cpu():
    """The bf16 network (cuDNN/cuBLAS bf16 layers) against its plain CPU
    version (float32 products of the bf16-rounded operands, rounded once) on
    the same weights and input: rot and trans within one bf16 ulp of the
    tensor's largest value, flow and mask logits within twice the CPU's own
    bf16-vs-float32 gap (cuDNN sums in another order, so roundings flip, as
    between the port and JAX on the CPU, tests/test_torch_bf16.py)."""
    dev = _need_card()
    restore = _explicit_precision()
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.rand((2, 8, 96, 128), generator=g)
        outs = {}
        for name, d, dt in (("cpu", "cpu", torch.bfloat16), ("f32", "cpu", torch.float32),
                            ("card", dev, torch.bfloat16)):
            model = FlowNetDeepIM(input_hw=(96, 128), dtype=dt, generator=torch.Generator().manual_seed(3),
                                  device=d)
            with torch.no_grad():
                trans = torch.randn(model.trans.weight.shape, generator=torch.Generator().manual_seed(4)) * 0.05
                model.trans.weight.copy_(trans)
                outs[name] = {k: v.float().cpu() for k, v in model.eval()(x.to(d)).items()}
    finally:
        restore()
    for key in ("rot", "trans"):
        ref = outs["cpu"][key]
        ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())) - 7)
        torch.testing.assert_close(outs["card"][key], ref, rtol=0, atol=float(ulp))
    for key in ("flow", "mask_logit"):
        err = float((outs["card"][key] - outs["cpu"][key]).abs().max())
        gap = float((outs["cpu"][key] - outs["f32"][key]).abs().max())
        assert err <= 2 * gap, (key, err, gap)


def test_bf16_zoom_card_equals_cpu():
    """affine_sample and zoom_images on bf16 images, card against CPU: the
    bf16-rounded weights and the float32 intermediate on both, so each
    value within one bf16 ulp."""
    from deepim_tpu_torch.ops.sampler import ZoomFactor, affine_sample
    from deepim_tpu_torch.ops.zoom import zoom_images

    dev = _need_card()
    restore = _explicit_precision()
    try:
        g = torch.Generator().manual_seed(5)
        img = (torch.rand((3, 3, 96, 128), generator=g) * 255.0 - 120.0).to(torch.bfloat16)
        wx = torch.rand(3, generator=g) * 0.9 + 0.3
        zf = ZoomFactor(wx, wx.clone(), torch.rand(3, generator=g) - 0.5, torch.rand(3, generator=g) - 0.5)
        pm = torch.tensor([123.68, 116.779, 103.939])
        cpu = [affine_sample(img, zf), *zoom_images(img, img.flip(0), zf, pm)]
        zf_d = ZoomFactor(*(v.to(dev) for v in zf))
        card = [affine_sample(img.to(dev), zf_d), *zoom_images(img.to(dev), img.flip(0).to(dev), zf_d, pm.to(dev))]
    finally:
        restore()
    for a, b in zip(card, cpu):
        assert a.dtype == torch.bfloat16
        ulp = 2.0 ** (torch.floor(torch.log2(b.float().abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((a.float().cpu() - b.float()).abs() <= ulp).all())


def _uv_lit_scene(attr: str, n_lat: int, n_lon: int, dev):
    """Vertices, per-vertex attributes and the rest of a b=2 render of a
    textured uv sphere on `dev`, the attributes being the kernels' new
    inputs: 'uv' the texture coordinates (u, v, 0) of rasterize_textured,
    'lit' the colours lit by a point light at the render's poses."""
    from deepim_tpu_torch.render.lighting import lit_vertex_colors
    from deepim_tpu_torch.render.mesh import MeshBank, make_uv_sphere, smooth_texture

    mesh = make_uv_sphere(0.05, n_lat, n_lon, smooth_texture(64))
    bank = MeshBank.from_meshes([mesh], pad_multiple=64, keep_textures=True).with_normals([mesh])
    rep = [torch.from_numpy(np.repeat(a, 2, 0)).to(dev)
           for a in (bank.vertices, bank.colors, bank.faces, bank.face_valid, bank.uv, bank.normals)]
    verts, cols, faces, valid, uv, normals = rep
    pose = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    pose[:, :3, :3] = np.array([[[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.eye(3)], np.float32)
    pose[:, 2, 3] = (0.5, 0.6)
    pose = torch.from_numpy(pose).to(dev)
    if attr == "uv":
        attrs = torch.cat([uv, torch.zeros_like(uv[..., :1])], -1)
    else:
        attrs = lit_vertex_colors(verts, normals, cols, pose, torch.tensor([0.1, -0.2, -0.4], device=dev),
                                  torch.tensor([1.1, 0.9, 1.0], device=dev), torch.tensor([0.4, 0.2], device=dev))
    return verts, attrs, faces, valid, pose, bank


@pytest.mark.parametrize("attr", ["uv", "lit"])
@pytest.mark.parametrize("binning,csr_kernel", list(_KERNEL_OF))
def test_kernel_equals_twin_on_uv_and_lit_attributes(binning, csr_kernel, attr):
    """Each kernel and its plain twin on the same card inputs when the
    attributes are texture coordinates in [0, 1] or lit colours: bit-equal
    outputs."""
    dev = _need_card()
    verts, attrs, faces, valid, pose, _ = _uv_lit_scene(attr, 16, 32, dev)
    cfg = RasterConfig(height=96, width=128, znear=0.05, zfar=10.0, binning=binning, csr_kernel=csr_kernel)
    for name, args in kernel_inputs(verts, attrs, faces, valid, pose, torch.from_numpy(K96).to(dev), cfg,
                                    device=dev):
        assert name == _KERNEL_OF[binning, csr_kernel]
        out = KERNELS[name](*args)
        ref = TWINS[name](*args)
        torch.cuda.synchronize()
        assert (out[:, 0] > 0).any()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("n_lat,n_lon", [(16, 32), (24, 48)])
def test_rasterize_textured_card_equals_cpu(n_lat, n_lon):
    """rasterize_textured on the card (tile_raster for 1,024 faces,
    csr_raster for 2,304) against the CPU: hit masks exact, depth atol
    1e-5, rgb atol 5e-3."""
    from deepim_tpu_torch.render.rasterizer import rasterize_textured

    dev = _need_card()
    verts, _, faces, valid, pose, bank = _uv_lit_scene("uv", n_lat, n_lon, "cpu")
    args = (verts, torch.from_numpy(np.repeat(bank.uv, 2, 0)), torch.from_numpy(np.repeat(bank.textures, 2, 0)),
            faces, valid, pose, torch.from_numpy(K96),
            RasterConfig(height=96, width=128, znear=0.05, zfar=10.0, bin_pairs=n_lat * n_lon * 8))
    rgb_g, depth_g = rasterize_textured(*args, device=dev)
    rgb_c, depth_c = rasterize_textured(*args, device="cpu")
    assert torch.equal(depth_g.cpu() > 0, depth_c > 0) and (depth_c > 0).sum() > 1000
    torch.testing.assert_close(depth_g.cpu(), depth_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(rgb_g.cpu(), rgb_c, atol=5e-3, rtol=0)


def _bench_scene(kind: str, batch: int, dev, z_range=(0.6, 1.1), **raster):
    """A LINEMOD stand-in bank (synth_data.linemod_standin_bank: "all" the
    13 padded mixed-detail meshes, "ape" the ape's icosphere) at 480x640
    with LINEMOD K, the budget tune_raster_for_bank sizes for it (`raster`
    fields first), and a refinement batch's initial poses over z_range
    (synth_data.linemod_refine_poses, seed 1), each sample's class mesh."""
    from deepim_tpu_torch.engine.refine import EngineConfig, tune_raster_for_bank
    from deepim_tpu_torch.tools.synth_data import linemod_refine_poses, linemod_standin_bank

    bank = linemod_standin_bank(kind)
    arrs = tuple(bank[key] for key in ("vertices", "colors", "faces", "face_valid"))
    cfg = tune_raster_for_bank(EngineConfig(raster=RasterConfig(height=480, width=640, **raster)), arrs,
                               LINEMOD_K).raster
    cls, _, pose0 = linemod_refine_poses(batch, len(arrs[0]), 1, z_range)
    mesh = [torch.from_numpy(np.ascontiguousarray(a[cls])).to(dev) for a in arrs]
    return (*mesh, torch.from_numpy(pose0).to(dev), torch.from_numpy(LINEMOD_K).to(dev), cfg)


def _bin_case(case: str, dev):
    """(vertices, colors, faces, face_valid, poses, k, cfg) of a binning case."""
    from deepim_tpu_torch.engine.refine import EngineConfig, tune_raster_for_bank
    from deepim_tpu_torch.render.mesh import MeshBank, make_mixed_detail_mesh

    if case == "lm6d_all":
        return _bench_scene("all", 32, dev)
    if case == "ape":
        return _bench_scene("ape", 32, dev, (0.6, 1.0))
    if case.startswith("pack"):
        return _bench_scene("ape", 8, dev, (0.6, 1.0), csr_pack=int(case[4:]))
    if case == "tiered":
        # test_csr_tiers_match_uniform_on_mixed_mesh's scene.
        bank = MeshBank.from_meshes([make_mixed_detail_mesh(0)], pad_multiple=64)
        arrs = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
        cfg = RasterConfig(height=96, width=128, znear=0.05, chunk=16)
        k = np.array([[300.0, 0, 64.0], [0, 300.0, 48.0], [0, 0, 1]], np.float32)
        cfg = tune_raster_for_bank(EngineConfig(height=96, width=128, raster=cfg), arrs, k, z_min=0.45).raster
        assert len(cfg.csr_tiers) >= 2
        from scipy.spatial.transform import Rotation

        pose = np.concatenate([Rotation.random(4, random_state=5).as_matrix().astype(np.float32),
                               np.zeros((4, 3, 1), np.float32)], 2)
        pose[:, 2, 3] = (0.55, 0.7, 0.5, 1.2)
        mesh = [torch.from_numpy(np.repeat(a, 4, 0)).to(dev) for a in arrs]
        return (*mesh, torch.from_numpy(pose).to(dev), torch.from_numpy(k).to(dev), cfg)
    if case in ("near", "invalid"):
        # near: a budget sized for z >= 2.5 m at 0.26-0.35 m, so units drop
        # pairs; invalid: sample 1 has no valid face, sample 2 lies behind
        # the camera.
        *scene, pose, k, cfg = _bench_scene("ape", 4, dev, (0.6, 1.0))
        if case == "near":
            bank = tuple(x[:1].cpu().numpy() for x in scene[:4])
            cfg = tune_raster_for_bank(EngineConfig(raster=dataclasses.replace(cfg, bin_pairs=0)), bank,
                                       LINEMOD_K, z_min=2.5).raster
            pose = pose.clone()
            pose[:, 2, 3] = torch.tensor([0.26, 0.29, 0.32, 0.35], device=dev)
        else:
            scene[3] = scene[3].clone()
            scene[3][1] = False
            pose = pose.clone()
            pose[2, 2, 3] = -0.8
        return (*scene, pose, k, cfg)
    assert case == "long"
    # 5,000 overlapping triangles of 30-120 px around the image's centre in
    # two samples: segments over 2,048 units (ordered in device memory)
    # and up to 2,048 (shared memory).
    g = np.random.default_rng(7)
    n = 5000
    centre = g.uniform(-0.02, 0.02, (2, n, 1, 2))
    corners = centre + g.uniform(-0.05, 0.05, (2, n, 3, 2))
    z = g.uniform(0.5, 0.9, (2, n, 3, 1))
    verts = np.concatenate([corners * z / 0.5, z], -1).reshape(2, 3 * n, 3).astype(np.float32)
    cols = g.uniform(0, 255, verts.shape).astype(np.float32)
    faces = np.tile(np.arange(3 * n, dtype=np.int32).reshape(1, n, 3), (2, 1, 1))
    pose = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    cfg = RasterConfig(height=480, width=640, binning="csr", csr_pack=1, bin_pairs=n * 30 * 80)
    mesh = [torch.from_numpy(a).to(dev) for a in (verts, cols, faces, np.ones((2, n), bool))]
    return (*mesh, torch.from_numpy(pose).to(dev), torch.from_numpy(LINEMOD_K).to(dev), cfg)


@pytest.mark.parametrize("case", ["lm6d_all", "ape", "tiered", "near", "pack1", "pack2", "pack4",
                                  "invalid", "long"])
def test_csr_bin_kernels_equal_plain_binning(case, monkeypatch):
    """The binning kernels (raster_kernels.csr_bin, rasterizer.csr_segments'
    route for CUDA tensors) against bin_faces_csr on the same card tensors:
    offsets, counts and dropped equal and every live segment equal element
    for element; no host sync (sync debug mode "error"); four launches a
    render and no other kernel in the trace (no sort over the budget); and
    rasterize's rgb and depth bit-identical through either route."""
    from torch.profiler import ProfilerActivity, profile

    from deepim_tpu_torch.render import rasterizer
    from deepim_tpu_torch.render.rasterizer import (
        _expand_k, _face_validity, bin_faces_csr, csr_segments, expand_corners, project_vertices)

    dev = _need_card()
    verts, cols, faces, fvalid, pose, k, cfg = _bin_case(case, dev)
    b, nf, _ = faces.shape
    corners, _ = expand_corners(verts, cols, faces)
    u, v, z = project_vertices(corners.reshape(b, nf * 3, 3), pose, _expand_k(k, b))
    fu, fv, fz = (x.reshape(b, nf, 3) for x in (u, v, z))
    valid = _face_validity(fu, fv, fz, fvalid, cfg)
    th, tw = cfg.csr_tile_h, cfg.csr_tile_w
    csr_segments(fu, fv, valid, cfg, th, tw)  # builds the library
    torch.cuda.synchronize()
    before = rk.csr_bin.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = csr_segments(fu, fv, valid, cfg, th, tw)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rk.csr_bin.launches == before + rk.BIN_KERNELS
    kernels = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memset", "Memcpy"))}
    assert len(kernels) == rk.BIN_KERNELS and all("csr_bin_" in name for name in kernels), kernels
    ref = bin_faces_csr(fu, fv, valid, cfg, th, tw)
    assert got[0].shape == ref[0].shape and got[0].dtype == ref[0].dtype
    for name, x, y in zip(("offsets", "counts", "dropped"), got[1:], ref[1:]):
        assert torch.equal(x, y), name
    counts = got[2]
    live = torch.arange(got[0].shape[1], device=dev)[None, :] < counts.sum(1, keepdim=True)
    assert torch.equal(got[0][live], ref[0][live])
    assert int(counts.sum()) > 0
    if case == "near":
        assert int(got[3].sum()) > 0
    if case == "invalid":
        assert int(counts[1].sum()) == 0 and int(counts[2].sum()) == 0 and int(counts[0].sum()) > 0
    if case == "long":
        assert int(counts.max()) > 2048 and int(((counts > 32) & (counts <= 2048)).sum()) > 0

    args = (verts, cols, faces, fvalid, pose, k, cfg)
    before = rk.csr_bin.launches
    rgb_k, depth_k, dropped_k = rasterize(*args, with_stats=True, device=dev)
    assert rk.csr_bin.launches == before + rk.BIN_KERNELS
    monkeypatch.setattr(rasterizer, "csr_segments", bin_faces_csr)
    rgb_p, depth_p, dropped_p = rasterize(*args, with_stats=True, device=dev)
    assert rk.csr_bin.launches == before + rk.BIN_KERNELS
    torch.cuda.synchronize()
    assert (depth_k > 0).any()
    assert torch.equal(rgb_k, rgb_p) and torch.equal(depth_k, depth_p) and torch.equal(dropped_k, dropped_p)
