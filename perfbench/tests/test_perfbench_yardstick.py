"""The frozen yardstick: operation counts, the render's work, the trace
arithmetic, the traffic generator and the plain renderer."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference.render import render
from perfbench.yardstick import flops, meshes, trace, traffic, work


def test_eval_call_flops_match_chip_smoke():
    # chip_smoke's convolution count of a batch-16 eval call (4 iterations,
    # FAST_TEST) and of a batch-4 x TIS-4 training step.
    conv, total = flops.call_flops((480, 640), 8, 16, 4, train=False)
    assert round(conv / 1e12, 2) == 2.49
    assert total > conv
    conv_t, _ = flops.call_flops((480, 640), 8, 4, 4, train=True)
    assert round(conv_t / 1e12, 2) == 1.99


def test_render_work_one_triangle():
    # One triangle with corners at pixels (2, 2), (9, 2), (2, 9) at z = 1,
    # K the identity: it covers the 36 pixels (x, y) with x, y >= 2 and
    # x + y <= 11 (edges inclusive).
    verts = torch.tensor([[[2.0, 2.0, 1.0], [9.0, 2.0, 1.0], [2.0, 9.0, 1.0]]])
    cols = torch.full((1, 3, 3), 100.0)
    faces = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    valid = torch.ones((1, 1), dtype=torch.bool)
    pose = torch.eye(3, 4)[None]
    stats: dict = {}
    rgb, depth = render(verts, cols, faces, valid, pose, torch.eye(3), 16, 16, 0.25, 6.0, stats)
    assert stats == {"faces_in_view": 1, "covered_pairs": 36, "pixels_covered": 36}
    assert int((depth > 0).sum()) == 36 and torch.allclose(rgb[:, :, depth[0, 0] > 0], torch.tensor(100.0))
    bytes_ = 1 * 18 * 4 + 36 * 4 * 4
    assert work.raster_bound_s(stats) == pytest.approx(max(bytes_ / 3.35e12, 36 * 22 / 67e12))


def test_trace_reading_arithmetic():
    dev = [((0.0, 10.0), "csr_raster_kernel(float const*)"), ((5.0, 20.0), "sm90_xmma_fprop_implicit_gemm"),
           ((30.0, 40.0), "elementwise_kernel"), ((40.0, 41.0), "Memcpy DtoH"), ((60.0, 70.0), "DeviceRadixSortOnesweep")]
    assert trace.family("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n") == "matmuls"
    assert trace.family("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>") == "other"
    assert trace.family("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized>") == "convolutions"
    assert trace.family("leaky_relu_backward_kernel") == "other"
    host = [((20.0, 31.0), "aten::nonzero"), ((0.0, 100.0), "call"), ((41.0, 60.0), "aten::item")]
    r = trace.read(dev, host, 100e-6, 2)
    assert r["busy_s"] == pytest.approx(41e-6) and r["launches"] == 4
    assert r["family_s"]["raster"] == pytest.approx(10e-6)
    assert r["family_s"]["convolutions"] == pytest.approx(15e-6)
    assert r["family_s"]["sort_scan"] == pytest.approx(10e-6)
    assert r["family_s"]["other"] == pytest.approx(11e-6)
    assert r["idle_gaps"] == [["aten::item", pytest.approx(19e-6)], ["aten::nonzero", pytest.approx(10e-6)]]


def test_traffic_same_seed_same_pool_and_same_sizes_across_seeds():
    t = {"pool": 2, "z_m": [0.6, 1.0], "center_px": [[200, 440], [150, 330]], "classes": "uniform",
         "perturb": {"rot_std_deg": 15.0, "rot_max_deg": 45.0, "trans_std_m": [0.01, 0.01, 0.05]}}
    k = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    a, b = traffic.make_pool(t, 8, 3, k, 2**31 + 7), traffic.make_pool(t, 8, 3, k, 2**31 + 7)
    c = traffic.make_pool(t, 8, 3, k, 5)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[key], y[key]) for key in x)
    for x, y in zip(a, c):
        # One depth in each eighth of the range, and the same classes.
        assert np.array_equal(np.sort(np.floor((x["pose_gt"][:, 2, 3] - 0.6) / 0.05)), np.arange(8))
        assert not np.allclose(x["pose_gt"], y["pose_gt"])
    assert sorted(np.concatenate([p["class_index"] for p in a])) == sorted(np.concatenate([p["class_index"] for p in c]))


def test_meshes_diameter_and_faces():
    bank, nv = meshes.make_bank({"kind": "mixed", "fine_subdiv": [3, 2], "diameter_mm": [100.0, 250.0]}, 3)
    verts, _, faces, valid = bank
    assert valid.sum(1).tolist() == [1280 + 320 + 80, 320 + 320 + 80]
    for i, d in enumerate((0.1, 0.25)):
        v = verts[i, :nv[i]]
        span = np.linalg.norm(v[:, None] - v[None], axis=-1).max()
        assert 0.97 * d < span <= d * 1.0001
    ape, nv1 = meshes.make_bank({"kind": "icosphere", "subdiv": 2, "diameter_mm": [102.099]}, 3)
    assert ape[3].sum() == 320 and nv1.tolist() == [162]


def test_reference_render_equals_the_ports(tmp_path):
    # The plain renderer against the port's on its CSR path (plain twins on
    # the CPU, bit-equal to the CUDA kernels): equal pixel for pixel.
    from deepim_tpu_torch.engine.refine import EngineConfig, MeshBuffers, render_at_pose
    from deepim_tpu_torch.render.rasterizer import RasterConfig

    bank, _ = meshes.make_bank({"kind": "mixed", "fine_subdiv": [4], "diameter_mm": [150.0, 200.0]}, 11)
    k = torch.tensor([[57.24, 0, 32.0], [0, 57.36, 32.0], [0, 0, 1.0]])
    rng = np.random.default_rng(0)
    from scipy.spatial.transform import Rotation
    rot = Rotation.random(4, random_state=rng).as_matrix()
    t = np.array([[0.0, 0.0, 0.7], [0.02, -0.01, 0.9], [-0.03, 0.02, 0.6], [0.0, 0.01, 1.1]])
    pose = torch.tensor(np.concatenate([rot, t[:, :, None]], -1), dtype=torch.float32)
    cls = np.array([0, 1, 0, 1])
    ecfg = EngineConfig(height=64, width=64, raster=RasterConfig(height=64, width=64))
    from deepim_tpu_torch.engine.refine import tune_raster_for_bank
    ecfg = tune_raster_for_bank(ecfg, bank, k.numpy())
    mb = MeshBuffers.gather(bank, cls, device="cpu")
    rgb_p, depth_p, _ = render_at_pose(mb, pose, k, ecfg, device="cpu")
    v, c, f, fv = (torch.from_numpy(a[cls]) for a in bank)
    rgb_r, depth_r = render(v, c, f, fv, pose, k, 64, 64, 0.25, 6.0)
    assert int((depth_r > 0).sum()) > 250
    assert torch.equal(depth_p, depth_r) and torch.equal(rgb_p, rgb_r)
