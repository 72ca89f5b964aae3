"""Parity of the port's data-preparation toolkit (deepim_tpu_torch/toolkit/)
with the JAX package's (deepim_tpu/toolkit/) on the CPU.

tests/test_toolkit.py's miniature devkit (64x64, K_MAT, a cube and an
80-face icosphere, the same generate_dataset call) is extended with a
BOP-format source (millimetre PLYs, rgb/depth/mask PNGs, scene_gt.json and
scene_gt_info.json, one frame with two overlapping instances) and PoseCNN
predictions in both layouts (text for the cube, .mat for the sphere, one
frame of each without a detection).  It is copied into two roots; the JAX
toolkit runs every stage on one, the port (device="cpu") on the other.

Tolerances: every text file byte-equal (pose files, rendered-pose lines,
the train_/my_val_/PoseCNN_val_ pair sets, points.xyz, extents.txt,
models_info.txt, textured.obj, observed set lists); gen_poses's pickle and
the -meta.mat arrays exactly equal; PNGs after decoding (cv2 for the JAX
files): labels exact, depth exact except at most 0.1% of pixels at one
level, rgb within 1 level (lit renders included: a render that differs in
the last ulp can flip a truncated level where a value sits on an integer);
stat_se3's mean and std to 1e-5, stat_depth within one level, check's
report equal.
"""
import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.toolkit._common as j_common  # noqa: E402
import deepim_tpu.toolkit.adapt_devkit as j_adapt  # noqa: E402
import deepim_tpu.toolkit.gen_gt_observed as j_gt  # noqa: E402
import deepim_tpu.toolkit.gen_posecnn_rendered as j_posecnn  # noqa: E402
import deepim_tpu.toolkit.gen_rendered as j_rendered  # noqa: E402
import deepim_tpu.toolkit.gen_rendered_pose as j_pose  # noqa: E402
import deepim_tpu.toolkit.stats as j_stats  # noqa: E402
import deepim_tpu.toolkit.syn_poses as j_syn  # noqa: E402
from deepim_tpu.data.pairdb import PairDB as JPairDB  # noqa: E402
from deepim_tpu.data.pairdb import load_pose_file  # noqa: E402
from deepim_tpu.render.mesh import make_icosphere, make_test_cube  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_dataset  # noqa: E402
from deepim_tpu_torch.data.pairdb import PairDB as TPairDB  # noqa: E402
from deepim_tpu_torch.toolkit import _common as t_common  # noqa: E402
from deepim_tpu_torch.toolkit import adapt_devkit as t_adapt  # noqa: E402
from deepim_tpu_torch.toolkit import gen_gt_observed as t_gt  # noqa: E402
from deepim_tpu_torch.toolkit import gen_posecnn_rendered as t_posecnn  # noqa: E402
from deepim_tpu_torch.toolkit import gen_rendered as t_rendered  # noqa: E402
from deepim_tpu_torch.toolkit import gen_rendered_pose as t_pose  # noqa: E402
from deepim_tpu_torch.toolkit import stats as t_stats  # noqa: E402
from deepim_tpu_torch.toolkit import syn_poses as t_syn  # noqa: E402
from deepim_tpu_torch.utils.png import read_png  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K_MAT = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
RCFG = JRasterConfig(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128,
                     chunk=16, znear=0.05, zfar=10.0)
CLASSES = ["cube", "sphere"]  # toolkit ids 1, 2 (outside the LINEMOD table: their place + 1)
KW = dict(k=K_MAT, width=W, height=H)
JAX = {"adapt": j_adapt, "gt": j_gt, "posecnn": j_posecnn, "rendered": j_rendered,
       "pose": j_pose, "stats": j_stats, "syn": j_syn, "pairdb": JPairDB}
PORT = {"adapt": t_adapt, "gt": t_gt, "posecnn": t_posecnn, "rendered": t_rendered,
        "pose": t_pose, "stats": t_stats, "syn": t_syn, "pairdb": TPairDB}
PRED_SEED = 7


def write_ply_mm(path, mesh) -> None:
    """An ascii PLY in millimetres with vertex colours (the BOP model format)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {mesh.num_vertices}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {mesh.num_faces}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v, c in zip(mesh.vertices * 1000.0, mesh.colors):
            f.write(f"{v[0]} {v[1]} {v[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
        for tri in mesh.faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def _bbox(mask: np.ndarray) -> list:
    ys, xs = np.nonzero(mask)
    return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]


def write_bop_source(devkit: str, bop: Path, meshes: dict) -> dict:
    """models/obj_00000<i>.ply and test/00000<i>/ (frames 0-2 of each
    class's observed set) from the devkit; frame 0 of the cube's scene also
    holds the sphere of the sphere's frame 0.  Returns (mask, z) of each
    instance of that frame."""
    (bop / "models").mkdir(parents=True)
    two = {}
    for obj, cls in enumerate(CLASSES, start=1):
        write_ply_mm(bop / "models" / f"obj_{obj:06d}.ply", meshes[cls])
        scene = bop / "test" / f"{obj:06d}"
        for sub in ("rgb", "depth", "mask"):
            (scene / sub).mkdir(parents=True)
        gt, info = {}, {}
        for i in range(3):
            obs = os.path.join(devkit, "data", "observed", cls)
            depth = cv2.imread(os.path.join(obs, f"{i:06d}-depth.png"), cv2.IMREAD_UNCHANGED)
            cv2.imwrite(str(scene / "rgb" / f"{i:06d}.png"), cv2.imread(os.path.join(obs, f"{i:06d}-color.png")))
            cv2.imwrite(str(scene / "depth" / f"{i:06d}.png"), depth)
            insts = [(obj, cls, i, depth)]
            if obj == 1 and i == 0:
                other = cv2.imread(os.path.join(devkit, "data", "observed", "sphere", "000000-depth.png"),
                                   cv2.IMREAD_UNCHANGED)
                insts.append((2, "sphere", 0, other))
            gt[str(i)], info[str(i)] = [], []
            for ins, (o, c, frame, d) in enumerate(insts):
                mask = d > 0
                cv2.imwrite(str(scene / "mask" / f"{i:06d}_{ins:06d}.png"), mask.astype(np.uint8) * 255)
                pose = load_pose_file(os.path.join(devkit, "data", "gt_observed", c, f"{frame:06d}-pose.txt"))
                gt[str(i)].append({"obj_id": o, "cam_R_m2c": pose[:, :3].flatten().tolist(),
                                   "cam_t_m2c": (pose[:, 3] * 1000.0).tolist()})
                info[str(i)].append({"bbox_visib": _bbox(mask)})
                if obj == 1 and i == 0:
                    two[o] = (mask, float(pose[2, 3]))
        with open(scene / "scene_gt.json", "w") as f:
            json.dump(gt, f)
        with open(scene / "scene_gt_info.json", "w") as f:
            json.dump(info, f)
    return two


def write_predictions(devkit: str, pred_dir: Path) -> None:
    """PoseCNN predictions for the test frames (000004, 000005): each gt
    perturbed as gen_rendered_pose perturbs; the cube's as a text file, the
    sphere's in the reference's per-frame .mat layout; the second frame of
    each has no detection."""
    rng = np.random.RandomState(PRED_SEED)
    pred_dir.mkdir()
    preds = {}
    for cls in CLASSES:
        gt = load_pose_file(os.path.join(devkit, "data", "gt_observed", cls, "000004-pose.txt"))
        pose, _, _ = j_pose.sample_rendered_pose(gt, rng, K_MAT, W, H)
        icp, _, _ = j_pose.sample_rendered_pose(gt, rng, K_MAT, W, H)
        preds[cls] = (pose, icp)
    with open(pred_dir / "cube_poses.txt", "w") as f:
        f.write(j_pose.pose_to_line(preds["cube"][0]) + "\n" + " ".join(["-1"] * 7) + "\n")
    with open(pred_dir / "cube_poses_icp.txt", "w") as f:
        f.write(j_pose.pose_to_line(preds["cube"][1]) + "\n" + " ".join(["-1"] * 7) + "\n")
    (pred_dir / "sphere").mkdir()
    vec = [np.array([float(x) for x in j_pose.pose_to_line(p).split()]) for p in preds["sphere"]]
    sio.savemat(str(pred_dir / "sphere" / "0000.mat"),
                {"rois": np.array([[0.0, 1.0, 10, 10, 40, 40, 0.9]]), "poses": vec[0][None],
                 "poses_icp": vec[1][None]})
    sio.savemat(str(pred_dir / "sphere" / "0001.mat"),
                {"rois": np.array([[0.0, -1.0, 0, 0, 0, 0, 0]]), "poses": np.zeros((1, 7)),
                 "poses_icp": np.zeros((1, 7))})


def run_pipeline(pkg: dict, root: str, port: bool) -> dict:
    """Every toolkit stage on `root` with one package; returns the numbers
    the stages return."""
    dev = {"device": "cpu"} if port else {}
    out = {}
    pkg["gt"].gen_gt_observed(root, CLASSES, "all", batch=4, **KW, **dev)
    pkg["pose"].gen_rendered_pose(root, CLASSES, "all", per_observed=2, **KW)
    pkg["rendered"].gen_rendered(root, CLASSES, "all", per_observed=2, batch=4, **KW, **dev)
    pkg["posecnn"].gen_posecnn_rendered(root, os.path.join(root, "preds"), CLASSES, batch=4, **KW, **dev)

    syn = os.path.join(root, "syn")
    pkg["syn"].gen_poses(root, syn, CLASSES, num_images=6, margin=8, **KW)
    os.symlink(os.path.join(root, "models"), os.path.join(syn, "models"))
    pkg["syn"].gen_observed(syn, CLASSES, batch=4, **KW, **dev)
    pkg["pose"].gen_rendered_pose(syn, CLASSES, "all", per_observed=1, **KW)
    pkg["rendered"].gen_rendered(syn, CLASSES, "all", per_observed=1, batch=4, **KW, **dev)
    out["check"] = pkg["syn"].check(syn, CLASSES, image_set="train", vis_dir=os.path.join(root, "vis"))

    db = pkg["pairdb"](name="LM6D_REFINE", devkit_path=root, image_set="train_cube", cur_class="cube",
                       cache_dir=os.path.join(root, "..", f"cache_{'port' if port else 'jax'}"))
    pairdb = db.gt_pairdb()
    out["se3"] = pkg["stats"].stat_se3(pairdb, **dev)
    out["depth"] = pkg["stats"].stat_depth(pairdb)

    adapted = os.path.join(root, "adapted")
    pkg["adapt"].rescale_models(os.path.join(root, "bop", "models"), os.path.join(adapted, "models"), CLASSES)
    out["extents"] = pkg["adapt"].calc_extents(os.path.join(adapted, "models"), CLASSES)
    pkg["adapt"].adapt_images(os.path.join(root, "bop", "test"), adapted, CLASSES)
    pkg["gt"].gen_gt_observed(adapted, CLASSES, "all", batch=4, **KW, **dev)
    pkg["pose"].gen_rendered_pose(adapted, CLASSES, "all", per_observed=2, **KW)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("toolkit_parity")
    src = base / "src"
    meshes = {"cube": make_test_cube(0.08), "sphere": make_icosphere(0.05, 1)}
    generate_dataset(str(src), meshes, K_MAT, n_train=4, n_val=2, height=H, width=W,
                     z_range=(0.45, 0.6), raster_cfg=RCFG)
    obs_set = src / "image_set" / "observed"
    obs_set.mkdir(parents=True)
    for cls in CLASSES:
        indices = [f"{cls}/{i:06d}" for i in range(6)]
        for name, sel in (("all", indices), ("train", indices[:4]), ("test", indices[4:])):
            (obs_set / f"{cls}_{name}.txt").write_text("\n".join(sel) + "\n")
    two = write_bop_source(str(src), src / "bop", meshes)
    write_predictions(str(src), src / "preds")
    roots = {"jax": str(base / "jax"), "port": str(base / "port")}
    for side in roots.values():
        shutil.copytree(src, side)
    results = {"jax": run_pipeline(JAX, roots["jax"], port=False),
               "port": run_pipeline(PORT, roots["port"], port=True)}
    return {"roots": roots, "results": results, "two": two}


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


# Which stage wrote each output file, by path; inputs copied from the source are left out.
STAGE_FILES = {
    "gen_gt_observed": lambda p: p.startswith(("data/gt_observed/", "adapted/data/gt_observed/")),
    "gen_rendered_pose": lambda p: p.startswith(("rendered_poses/", "adapted/rendered_poses/",
                                                 "syn/rendered_poses/")),
    "gen_rendered": lambda p: (p.startswith(("data/rendered/", "syn/data/rendered/"))
                               or p.split("/")[-1].startswith(("train_", "my_val_"))),
    "gen_posecnn_rendered": lambda p: (p.startswith("data/rendered_val_PoseCNN/")
                                       or p.startswith("image_set/PoseCNN_val_")),
    "syn_poses": lambda p: p.startswith(("syn/poses/", "syn/data/observed/", "syn/data/gt_observed/",
                                         "syn/image_set/observed/", "vis/")),
    "adapt_devkit": lambda p: p.startswith(("adapted/models/", "adapted/data/observed/",
                                            "adapted/image_set/observed/")),
}


def _stage_of(path: str) -> list[str]:
    return [s for s, pred in STAGE_FILES.items() if pred(path)]


def test_outputs_listing(runs):
    """Both packages write the same files, and each output belongs to one stage."""
    jax_files, port_files = (_files(runs["roots"][s]) for s in ("jax", "port"))
    assert jax_files == port_files
    src_files = set(_files(os.path.join(os.path.dirname(runs["roots"]["jax"]), "src")))
    outputs = [p for p in jax_files if p not in src_files]
    assert len(outputs) > 250
    for p in outputs:
        assert len(_stage_of(p)) == 1, p


def _decode_jax(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def _compare_png(rel: str, a_path: str, b_path: str) -> tuple:
    """-> (kind, pixels that differ, pixels) of a PNG pair."""
    a, b = _decode_jax(a_path), read_png(b_path)
    assert a.shape == b.shape and a.dtype == b.dtype, rel
    pixels = a.shape[0] * a.shape[1]
    if rel.endswith("-label.png"):
        np.testing.assert_array_equal(b, a, err_msg=rel)
        return "label", 0, pixels
    if rel.endswith("-depth.png"):
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (rel, int(diff.max()), float((diff > 0).mean()))
        return "depth", int((diff > 0).sum()), pixels
    if rel.endswith("_check.png"):
        # observed | rendered | |difference| of the package's own files
        for img in (a, b):
            wdt = img.shape[1] // 3
            assert np.abs(img[:, 2 * wdt:].astype(np.int16)
                          - np.abs(img[:, :wdt].astype(np.int16) - img[:, wdt:2 * wdt])).max() == 0, rel
        assert np.abs(a[:, :2 * (a.shape[1] // 3)].astype(np.int16) - b[:, :2 * (b.shape[1] // 3)]).max() <= 1
        return "check", 0, 0
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1, rel
    return "rgb", int(diff.any(-1).sum()), pixels


def _compare_file(rel: str, a_path: str, b_path: str, apart: dict) -> str:
    """Compare one output file; a PNG's differing and total pixels are
    added to apart[kind]."""
    if rel.endswith(".png"):
        kind, off, pixels = _compare_png(rel, a_path, b_path)
        apart[kind] = [x + y for x, y in zip(apart.get(kind, (0, 0)), (off, pixels))]
        return "png"
    if rel.endswith(".mat"):
        ma, mb = sio.loadmat(a_path), sio.loadmat(b_path)
        keys = sorted(k for k in ma if not k.startswith("__"))
        assert keys == sorted(k for k in mb if not k.startswith("__")), rel
        for k in keys:
            assert ma[k].dtype == mb[k].dtype and np.array_equal(ma[k], mb[k]), (rel, k)
        return "mat"
    if rel.endswith(".pkl"):
        with open(a_path, "rb") as fa, open(b_path, "rb") as fb:
            da, db = pickle.load(fa), pickle.load(fb)
        assert sorted(da) == sorted(db), rel
        for k in da:
            assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), (rel, k)
        return "pkl"
    with open(a_path, "rb") as fa, open(b_path, "rb") as fb:
        assert fa.read() == fb.read(), rel
    return "text"


@pytest.mark.parametrize("stage", sorted(STAGE_FILES))
def test_stage_outputs(runs, stage, record_property):
    """Every file a stage wrote, the port's against JAX's: text and pickles
    byte- or array-equal, -meta.mat arrays equal, PNGs after decoding (the
    pixels a level apart of each kind go to the junit report)."""
    roots = runs["roots"]
    rels = [p for p in _files(roots["jax"]) if stage in _stage_of(p)]
    apart = {}
    kinds = [_compare_file(rel, os.path.join(roots["jax"], rel), os.path.join(roots["port"], rel), apart)
             for rel in rels]
    assert "text" in kinds and ("png" in kinds or stage == "gen_rendered_pose"), (stage, set(kinds))
    for kind, (off, pixels) in apart.items():
        record_property(f"{kind}_pixels_apart", f"{off} of {pixels}")


def test_stage_numbers(runs):
    """stat_se3 to 1e-5, stat_depth within one level, extents and the
    check report equal."""
    j, t = runs["results"]["jax"], runs["results"]["port"]
    for a, b in zip(j["se3"], t["se3"]):
        assert b.shape == (7,)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    assert np.abs(np.subtract(j["depth"], t["depth"])).max() <= 1
    np.testing.assert_array_equal(t["extents"], j["extents"])
    assert t["check"] == j["check"]
    assert t["check"]["pairs"] == 12 and not t["check"]["missing"] and not t["check"]["label_mismatch"]


def test_adapt_images_depth_sorted_label(runs):
    """Frame 1 of the cube's scene holds two overlapping instances: the
    label keeps, at each pixel, the nearer instance's object id, and the
    -meta.mat holds both poses (mm -> m) and boxes."""
    two = runs["two"]
    (m1, z1), (m2, z2) = two[1], two[2]
    overlap = m1 & m2
    assert overlap.sum() > 10
    want = np.zeros(m1.shape, np.uint8)
    want[m1] = 1
    want[m2 & (~m1 | (z2 < z1))] = 2
    for side in ("jax", "port"):
        obs = os.path.join(runs["roots"][side], "adapted", "data", "observed", "01")
        label = _decode_jax(os.path.join(obs, "000001-label.png")) if side == "jax" else read_png(
            os.path.join(obs, "000001-label.png"))
        np.testing.assert_array_equal(label, want)
        meta = sio.loadmat(os.path.join(obs, "000001-meta.mat"))
        assert meta["poses"].shape == (3, 4, 2) and meta["cls_indexes"].tolist() == [[1, 2]]
        np.testing.assert_allclose(meta["poses"][2, 3], [z1, z2], atol=1e-6)


def test_calc_extents_sorted_names(runs, tmp_path):
    """calc_extents writes one row a class in the order of the sorted class
    names, whatever order --classes gives."""
    for side, mod in (("jax", j_adapt), ("port", t_adapt)):
        shutil.copytree(os.path.join(runs["roots"]["port"], "adapted", "models"), tmp_path / side)
        mod.calc_extents(str(tmp_path / side), ["sphere", "cube"])
    text = [(tmp_path / side / "extents.txt").read_bytes() for side in ("jax", "port")]
    assert text[0] == text[1]
    rows = np.loadtxt(tmp_path / "port" / "extents.txt")
    np.testing.assert_allclose(rows[0], [0.08, 0.08, 0.08], atol=1e-5)  # the cube's row first


def test_pose_line_round_trip():
    """pose_to_line writes JAX's string; line_to_pose inverts it."""
    rng = np.random.RandomState(3)
    from scipy.spatial.transform import Rotation as R

    for _ in range(8):
        pose = np.concatenate([R.random(random_state=rng).as_matrix(), rng.uniform(-0.1, 1, (3, 1))], 1)
        pose = pose.astype(np.float32)
        line = t_pose.pose_to_line(pose)
        assert line == j_pose.pose_to_line(pose)
        np.testing.assert_allclose(t_pose.line_to_pose(line), pose, atol=1e-6)
        np.testing.assert_array_equal(t_pose.line_to_pose(line), j_pose.line_to_pose(line))


def test_posecnn_mat_predictions(runs):
    """The reference's per-frame .mat layout: a detected frame's pose and
    ICP pose, a frame whose rois label is -1 as no detection."""
    pred_dir = os.path.join(runs["roots"]["port"], "preds")
    got = t_posecnn._load_predictions(pred_dir, "sphere", 2)
    want = j_posecnn._load_predictions(pred_dir, "sphere", 2)
    assert got[1] == (None, None) and want[1] == (None, None)
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(b, a)
    out = os.path.join(runs["roots"]["port"], "data", "rendered_val_PoseCNN", "sphere")
    np.testing.assert_allclose(load_pose_file(os.path.join(out, "000004_0-pose_icp.txt")), got[0][1], atol=1e-6)
    with open(os.path.join(runs["roots"]["port"], "image_set", "PoseCNN_val_sphere.txt")) as f:
        assert f.read() == "sphere/000004 sphere/000004_0\n"


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_batch_renderer_padding(runs, monkeypatch, lit):
    """n = 5 poses at batch 4: two rasterize calls of 4 poses each (the
    second padded with its last pose), five frames, each equal to JAX's
    render at the raster tolerance (depth 1e-5, rgb 5e-3)."""
    model_dir = os.path.join(runs["roots"]["port"], "models", "sphere")
    poses = np.stack([load_pose_file(os.path.join(runs["roots"]["port"], "data", "gt_observed", "sphere",
                                                  f"{i:06d}-pose.txt")) for i in range(5)])
    calls = []
    real = t_common.rasterize

    def counting(vertices, colors, faces, face_valid, p, *args, **kw):
        calls.append(p.clone())
        return real(vertices, colors, faces, face_valid, p, *args, **kw)

    monkeypatch.setattr(t_common, "rasterize", counting)
    light = (np.tile([[0.3, 0.2, 0.1]], (5, 1)), np.tile([[1.0, 0.5, 0.8]], (5, 1)),
             np.full(5, 0.3, np.float32))
    port = t_common.BatchRenderer(model_dir, **KW, batch=4, device="cpu")
    jax_r = j_common.BatchRenderer(model_dir, **KW, batch=4)
    got = list(port.render_many_lit(poses, *light) if lit else port.render_many(poses))
    want = list(jax_r.render_many_lit(poses, *light) if lit else jax_r.render_many(poses))
    assert len(got) == len(want) == 5
    assert len(calls) == 2 and all(c.shape == (4, 3, 4) for c in calls)
    np.testing.assert_array_equal(calls[1].numpy(), np.repeat(poses[4:5], 4, axis=0).astype(np.float32))
    for (rgb, depth), (j_rgb, j_depth) in zip(got, want):
        j_rgb, j_depth = np.asarray(j_rgb), np.asarray(j_depth)
        np.testing.assert_array_equal(depth > 0, j_depth > 0)
        np.testing.assert_allclose(depth, j_depth, atol=1e-5)
        np.testing.assert_allclose(rgb, j_rgb, atol=5e-3)


def test_sample_syn_pose_impossible_margin():
    """A margin that leaves no acceptance region raises, as in JAX."""
    stat = {"trans_mean": np.array([0.0, 0.0, 0.5]), "trans_std": np.full(3, 0.01),
            "pz_mean": np.array([0.0, 0.0, 1.0]), "angle_max": 30.0}
    for mod in (t_syn, j_syn):
        with pytest.raises(ValueError, match="no acceptance region"):
            mod.sample_syn_pose(stat, np.random.RandomState(0), K_MAT, W, H, margin=32)
    pose = t_syn.sample_syn_pose(stat, np.random.RandomState(0), K_MAT, W, H, margin=8)
    np.testing.assert_array_equal(pose, j_syn.sample_syn_pose(stat, np.random.RandomState(0), K_MAT, W, H,
                                                              margin=8))


def test_cli_chain_cpu(runs, tmp_path):
    """Every CLI through its main(argv) with --device cpu, in the README's
    order, on the cube of the BOP source (the CLIs render at 480x640 with
    LINEMOD intrinsics): the layout PairDB reads, a clean check, finite
    statistics."""
    from deepim_tpu_torch.toolkit import adapt_devkit, gen_gt_observed, gen_posecnn_rendered, gen_rendered
    from deepim_tpu_torch.toolkit import gen_rendered_pose, stats, syn_poses

    bop = os.path.join(runs["roots"]["port"], "bop")
    dk, syn, preds = (str(tmp_path / d) for d in ("dk", "syn", "preds"))
    cls = ["--classes", "cube", "--device", "cpu"]
    adapt_devkit.main(["rescale-models", "--origin-models", f"{bop}/models", "--out-models", f"{dk}/models", *cls])
    adapt_devkit.main(["calc-extents", "--models-dir", f"{dk}/models", *cls])
    adapt_devkit.main(["adapt-images", "--origin-root", f"{bop}/test", "--out-root", dk, *cls])
    obs_set = Path(dk, "image_set", "observed")
    assert (obs_set / "cube_all.txt").read_text() == "01/000001\n01/000002\n01/000003\n"
    (obs_set / "cube_train.txt").write_text("01/000001\n01/000002\n")
    (obs_set / "cube_test.txt").write_text("01/000003\n")
    gen_gt_observed.main(["--root", dk, *cls])
    gen_rendered_pose.main(["--root", dk, "--per-observed", "2", *cls])
    gen_rendered.main(["--root", dk, "--per-observed", "2", *cls])
    os.makedirs(preds)
    gt = load_pose_file(f"{dk}/data/gt_observed/cube/000003-pose.txt")
    Path(preds, "cube_poses.txt").write_text(t_pose.pose_to_line(gt) + "\n")
    gen_posecnn_rendered.main(["--root", dk, "--pred-dir", preds, *cls])
    assert syn_poses.main(["gen-poses", "--real-root", dk, "--syn-root", syn, "--num-images", "2", *cls]).endswith(".pkl")
    syn_poses.main(["gen-observed", "--syn-root", syn, "--models-root", f"{dk}/models", *cls])
    os.symlink(f"{dk}/models", f"{syn}/models")
    gen_rendered_pose.main(["--root", syn, "--per-observed", "1", *cls])
    gen_rendered.main(["--root", syn, "--per-observed", "1", *cls])
    report = syn_poses.main(["check", "--syn-root", syn, *cls])
    assert report == {"pairs": 2, "missing": [], "label_mismatch": []}
    out = stats.main(["--root", dk, "--image-set", "train_cube", "--cls", "cube", "--device", "cpu"])
    assert np.isfinite(out["se3"][0]).all() and out["se3"][0][0] > 0.8 and out["depth"][0] > 0

    for image_set, n in (("train_cube", 4), ("my_val_cube", 1), ("PoseCNN_val_cube", 1)):
        recs = TPairDB(name="LM6D_REFINE", devkit_path=dk, image_set=image_set, cur_class="cube").gt_pairdb()
        assert len(recs) == n
        for rec in recs:
            for key in ("image_observed", "image_rendered", "depth_observed", "depth_gt_observed",
                        "depth_rendered", "mask_gt_observed"):
                rendered = key in ("image_rendered", "depth_rendered", "depth_gt_observed")
                assert read_png(rec[key]).shape[:2] == ((480, 640) if rendered else (H, W)), (image_set, key)
    np.testing.assert_allclose(load_pose_file(f"{dk}/data/rendered_val_PoseCNN/cube/000003_0-pose.txt"), gt,
                               atol=1e-6)


MAIN_ARGV = {
    "adapt_devkit": ["calc-extents", "--models-dir", "{root}/models"],
    "gen_gt_observed": ["--root", "{root}"],
    "gen_posecnn_rendered": ["--root", "{root}", "--pred-dir", "{root}/preds"],
    "gen_rendered": ["--root", "{root}"],
    "gen_rendered_pose": ["--root", "{root}"],
    "stats": ["--root", "{root}", "--image-set", "train_cube", "--cls", "cube"],
    "syn_poses": ["check", "--syn-root", "{root}"],
}


@pytest.mark.parametrize("name", sorted(MAIN_ARGV))
def test_main_needs_a_card_or_cpu(tmp_path, monkeypatch, name):
    """Each CLI defaults to --device cuda and raises, writing nothing,
    where there is no card; none falls back to the CPU on its own."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"deepim_tpu_torch.toolkit.{name}")
    argv = [a.format(root=tmp_path) for a in MAIN_ARGV[name]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())
