"""Parity of the port's training driver (data/preprocess.py's train half,
data/loader.py:TrainLoader, tools/train_net.py, tools/train_test.py and
test_deepim(model=)) with the JAX package's on the CPU, on a 64x64
LINEMOD-layout devkit written by the JAX generate_dataset (a cube and an
80-face icosphere, 4 training pairs a class, read both as LM6D_REFINE and
as LM6D_REFINE_SYN, so an epoch is 16 pairs and half of them take the
data_syn branch).

Tolerances: training samples and loader batches exactly equal; one epoch
of train_net (4 steps of batch 4, TRAIN_ITER_SIZE 2, fp32 networks in
both packages from the same weights): every step's learning rate exact,
every inner iteration's losses to rtol 1e-3, the parameters after the
epoch within 4 ulp of their magnitude plus 2% of the tensor's largest
update (the rule of tests/test_torch_train.py:test_train_step_matches_jax;
measured on the CPU: losses 2.7e-6 relative, parameters 1.2e-6 of the
update); resuming from a checkpoint bit for bit; test_deepim(model=) equal to
test_deepim from the checkpoint, bit for bit."""
import os
import random
import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import deepim_tpu.tools.train_net as j_train_net  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import update_config_dict as j_update  # noqa: E402
from deepim_tpu.data import loader as j_loader  # noqa: E402
from deepim_tpu.data import preprocess as j_pre  # noqa: E402
from deepim_tpu.render import mesh as j_mesh  # noqa: E402
from deepim_tpu.render.rasterizer import RasterConfig as JRasterConfig  # noqa: E402
from deepim_tpu.tools.synth_data import generate_dataset as j_generate  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.data import loader as t_loader  # noqa: E402
from deepim_tpu_torch.data import preprocess as t_pre  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.tools import train_net as t_train_net  # noqa: E402
from deepim_tpu_torch.tools import train_test as t_train_test  # noqa: E402
from deepim_tpu_torch.tools.test_net import test_deepim as t_test_deepim  # noqa: E402
from deepim_tpu_torch.utils.logger import logger as t_logger  # noqa: E402
from test_torch_eval import _write_yaml  # noqa: E402

torch.set_num_threads(2)

H = W = 64
K64 = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
CLASSES = ("cube", "sphere")
PREFIX = "deepim_synth"
N_TRAIN = 4
_J_BUILD_MODEL = j_train_net.build_model
_T_BUILD_MODEL = t_train_net.build_model


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("LM6d_refine_train"))
    j_generate(path, {"cube": j_mesh.make_test_cube(0.08), "sphere": j_mesh.make_icosphere(0.05, 1)}, K64,
               n_train=N_TRAIN, n_val=2, height=H, width=W, z_range=(0.45, 0.6),
               raster_cfg=JRasterConfig(height=H, width=W, tile_h=16, tile_w=16, max_faces_per_tile=128,
                                        chunk=16, znear=0.05, zfar=10.0))
    return path


def _cfg_dict(devkit_path, train=None, **kw):
    d = {
        "SCALES": [H, W],
        "output_path": os.path.join(devkit_path, "output"),
        "dataset": {
            "dataset": "LM6D_REFINE+LM6D_REFINE_SYN", "dataset_path": devkit_path, "root_path": devkit_path,
            "image_set": "train_+train_", "test_image_set": "val_",
            "model_dir": os.path.join(devkit_path, "models"), "class_name": list(CLASSES),
            "INTRINSIC_MATRIX": K64.flatten().tolist(), "NORMALIZE_FLOW": 20.0, "ZNEAR": 0.05, "ZFAR": 10.0,
        },
        "network": {"INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True, "TRAIN_ITER": True,
                    "TRAIN_ITER_SIZE": 2, "PIXEL_MEANS": [123.68, 116.779, 103.939]},
        "train_iter": {"SE3_PM_LOSS": True, "LW_PM": 0.1, "NUM_3D_SAMPLE": 16, "LW_FLOW": 0.25, "LW_MASK": 0.03},
        "TRAIN": {"BATCH_PAIRS": 4, "end_epoch": 1, "warmup": True, "warmup_lr": 1e-5, "warmup_step": 3,
                  "lr": 1e-4, "INIT_MASK": "box_gt", "UPDATE_MASK": "box_gt", "MASK_DILATE": True,
                  "FLOW_WEIGHT_TYPE": "viz", "model_prefix": PREFIX, **(train or {})},
        "TEST": {"test_iter": 2, "test_epoch": 1, "FAST_TEST": True},
    }
    for key, value in kw.items():
        d[key] = {**d[key], **value}
    return d


def _cfgs(devkit_path, train=None, **kw):
    d = _cfg_dict(devkit_path, train, **kw)
    return j_update(JConfig(), d), update_config_dict(Config(), d)


def _pairdbs(jc, tc):
    """Both packages' merged training pair lists (equal records)."""
    (j_dbs, j_recs), (t_dbs, t_recs) = j_train_net.load_pairdbs(jc), t_train_net.load_pairdbs(tc)
    assert len(j_recs) == len(t_recs) == 2 * len(CLASSES) * N_TRAIN
    assert [r["data_syn"] for r in t_recs] == [r["data_syn"] for r in j_recs] == [False] * 8 + [True] * 8
    points = {c: t_dbs[0].points(c) for c in CLASSES}
    np.testing.assert_array_equal(points["sphere"], j_dbs[0].points("sphere"))
    return j_recs, t_recs, points


def _assert_sample_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# -- samples ---------------------------------------------------------------------

@pytest.mark.parametrize("init_mask", ["mask_gt", "box_gt", "box_rendered"])
@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("syn", [False, True])
def test_make_train_sample_equal(devkit, init_mask, dilate, syn):
    """make_train_sample equals the JAX package's exactly for each
    INIT_MASK x MASK_DILATE x data_syn, with the same generators, an empty
    VOC list and a DecodeCache (each record is built twice, the second
    time from the cache)."""
    jc, tc = _cfgs(devkit, {"INIT_MASK": init_mask, "MASK_DILATE": dilate})
    j_recs, t_recs, points = _pairdbs(jc, tc)
    j_voc, t_voc = j_pre.VOCBackgrounds(devkit), t_pre.VOCBackgrounds(devkit)
    j_cache, t_cache = j_pre.DecodeCache(), t_pre.DecodeCache()
    recs = [r for r in t_recs if r["data_syn"] == syn]
    for rep in range(2):
        for i, rec in enumerate(recs):
            pts = points[rec["gt_class"]]
            a = j_pre.make_train_sample(rec, jc, pts, random.Random(i), np.random.RandomState(i), j_voc, j_cache)
            b = t_pre.make_train_sample(rec, tc, pts, random.Random(i), np.random.RandomState(i), t_voc, t_cache)
            _assert_sample_equal(a, b)
    assert t_cache.misses == j_cache.misses and t_cache.hits == j_cache.hits > 0
    assert b["points_weights"].sum() == 16 and b["mask_observed"].sum() > 0


@pytest.mark.parametrize("syn", [False, True])
def test_make_train_sample_background_ratio_draws(devkit, syn):
    """REPLACE_OBSERVED_BG_RATIO > 0 over an empty VOC list: the JAX package
    draws rng.random() for a pair that is not data_syn before the dilation's
    draws, and the port draws it in the same place, so the dilated masks
    are equal; without the voc pool neither draws."""
    jc, tc = _cfgs(devkit, {"REPLACE_OBSERVED_BG_RATIO": 0.5, "MASK_DILATE": True})
    _, t_recs, points = _pairdbs(jc, tc)
    for voc in (True, False):
        for i, rec in enumerate(r for r in t_recs if r["data_syn"] == syn):
            pts = points[rec["gt_class"]]
            a = j_pre.make_train_sample(rec, jc, pts, random.Random(i), np.random.RandomState(i),
                                        j_pre.VOCBackgrounds(devkit) if voc else None)
            b = t_pre.make_train_sample(rec, tc, pts, random.Random(i), np.random.RandomState(i),
                                        t_pre.VOCBackgrounds(devkit) if voc else None)
            _assert_sample_equal(a, b)


def test_sample_model_points_equal():
    pts = np.random.RandomState(3).rand(40, 3).astype(np.float32)
    for n in (16, 40, 64):
        for a, b in zip(j_pre.sample_model_points(pts, n, np.random.RandomState(n)),
                        t_pre.sample_model_points(pts, n, np.random.RandomState(n))):
            np.testing.assert_array_equal(a, b)


def test_voc_backgrounds_list(devkit, tmp_path):
    """The VOC list is read as the JAX class reads it; only label-1 ids
    count, so a list without them is a no-op.  A listed id whose JPEG is
    missing leaves the image as the JAX package's cv2.imread -> None does,
    after the same draw, also through make_train_sample's data_syn
    branch."""
    main = tmp_path / "VOCdevkit" / "VOC2012" / "ImageSets" / "Main"
    main.mkdir(parents=True)
    (main / "diningtable_trainval.txt").write_text("2008_000001 -1\n2008_000002  0\n")
    voc = t_pre.VOCBackgrounds(str(tmp_path))
    assert voc.bg_list == j_pre.VOCBackgrounds(str(tmp_path)).bg_list == []
    im = np.zeros((4, 4, 3), np.float32)
    assert voc.replace_background(im, np.ones((4, 4), np.float32), random.Random(0)) is im
    (main / "diningtable_trainval.txt").write_text("2008_000001 1\n2008_000002 -1\n2008_000003 1\n")
    voc = t_pre.VOCBackgrounds(str(tmp_path))
    j_voc = j_pre.VOCBackgrounds(str(tmp_path))
    assert voc.bg_list == j_voc.bg_list == ["2008_000001", "2008_000003"]
    rng, j_rng = random.Random(0), random.Random(0)
    assert voc.replace_background(im, np.ones((4, 4), np.float32), rng) is im
    assert j_voc.replace_background(im, np.ones((4, 4), np.float32), j_rng) is im
    assert rng.random() == j_rng.random()
    jc, tc = _cfgs(devkit, {"MASK_DILATE": True})
    _, t_recs, points = _pairdbs(jc, tc)
    assert t_recs[-1]["data_syn"]
    a = j_pre.make_train_sample(t_recs[-1], jc, points["sphere"], random.Random(0), np.random.RandomState(0), j_voc)
    b = t_pre.make_train_sample(t_recs[-1], tc, points["sphere"], random.Random(0), np.random.RandomState(0), voc)
    _assert_sample_equal(a, b)


def test_decode_cache_shared_by_threads():
    """Sixteen threads (more than the cores) on one DecodeCache with a short
    switch interval: no lookup is lost from the counts, each key is kept
    once and the byte count is exact."""
    cache = t_pre.DecodeCache(budget_mb=1)
    keys, per_thread = 20, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(seed):
            rng = random.Random(seed)
            for _ in range(per_thread):
                k = rng.randrange(keys)
                cache.get(("k", k), lambda: np.full(256, k, np.float32))
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert cache.hits + cache.misses == 16 * per_thread and cache.misses >= keys
    assert len(cache.data) == keys and cache.bytes == keys * 256 * 4
    assert all(not v.flags.writeable and v[0] == k for (_, k), v in cache.data.items())


# -- loader ----------------------------------------------------------------------

def _j_batches(jc, recs, points, epoch):
    loader = j_loader.TrainLoader(recs, jc, points, 4, process_index=0, process_count=1)
    return list(loader.epoch(epoch))


def _assert_batch_equal(j, t, rows=slice(None)):
    for name in t._fields:
        a, b = getattr(j, name), getattr(t, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a, b = np.asarray(a), b.numpy()
        if name != "k":
            a = a[rows]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("shuffle,cache_mb,workers", [(True, 8192, 2), (False, 8192, 2), (True, 0, 1),
                                                      (True, 8192, 4)])
def test_train_loader_batches_equal(devkit, monkeypatch, shuffle, cache_mb, workers):
    """TrainLoader batches equal the JAX TrainLoader's exactly for epochs 0
    and 1 (shuffle, dilation and point draws keyed by seed, epoch and
    slot), whatever the decode cache and the number of workers; the batch
    is CPU tensors and k a tensor."""
    jc, tc = _cfgs(devkit, {"SHUFFLE": shuffle})
    j_recs, t_recs, points = _pairdbs(jc, tc)
    monkeypatch.setattr(t_loader, "NUM_WORKERS", workers)
    monkeypatch.setattr(t_loader, "DECODE_CACHE_MB", cache_mb)
    loader = t_loader.TrainLoader(t_recs, tc, points, 4, process_index=0, process_count=1)
    assert loader.epoch_size == 4 and (loader.cache is None) == (cache_mb == 0)
    for epoch in (0, 1):
        tb = list(loader.epoch(epoch))
        jb = _j_batches(jc, j_recs, points, epoch)
        assert len(tb) == len(jb) == 4
        for a, b in zip(jb, tb):
            _assert_batch_equal(a, b)
    if cache_mb:
        assert loader.cache.hits > 0


def test_train_loader_process_halves(devkit):
    """With process_count 2 each process assembles its half of every
    global batch, and the halves are the JAX single-process batch.  The
    two values come together; without them (no torch.distributed) the
    loader is process 0 of 1."""
    jc, tc = _cfgs(devkit)
    j_recs, t_recs, points = _pairdbs(jc, tc)
    jb = _j_batches(jc, j_recs, points, 1)
    for index in (0, 1):
        tb = list(t_loader.TrainLoader(t_recs, tc, points, 4, process_index=index, process_count=2).epoch(1))
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            _assert_batch_equal(a, b, rows=slice(2 * index, 2 * index + 2))
    with pytest.raises(ValueError, match="not divisible"):
        t_loader.TrainLoader(t_recs, tc, points, 4, process_index=0, process_count=3)
    for given in ({"process_index": 1}, {"process_count": 2}):
        with pytest.raises(ValueError, match="together"):
            t_loader.TrainLoader(t_recs, tc, points, 4, **given)
    default = t_loader.TrainLoader(t_recs, tc, points, 4)
    assert (default.process_index, default.process_count, default.local_batch_size) == (0, 1, 4)


def test_train_loader_raises_producer_errors(devkit):
    """A sample that fails to build raises in the consumer, not a hang."""
    jc, tc = _cfgs(devkit)
    _, t_recs, points = _pairdbs(jc, tc)
    broken = [dict(r, image_observed=r["image_observed"] + ".missing") for r in t_recs]
    with pytest.raises(FileNotFoundError):
        list(t_loader.TrainLoader(broken, tc, points, 4, process_index=0, process_count=1).epoch(0))


# -- train_net against the JAX package --------------------------------------------

def _recorders(store: dict):
    """A Speedometer that hears every batch (frequent 1) and a TBLogger that
    keeps each step's learning rate: stand-ins for both packages' drivers."""

    class Speedo:
        def __init__(self, batch_size, frequent=20):
            self.frequent = 1

        def __call__(self, epoch, nbatch, metrics=None):
            store.setdefault("metrics", []).append(dict(metrics))

    class TB:
        enabled = True

        def __init__(self, log_dir, enabled=True):
            pass

        def scalars(self, metrics, step, prefix="train"):
            store.setdefault("lr", []).append((int(step), float(metrics["lr"])))

        def weight_norms(self, *args):
            pass

        def flush(self):
            pass

        def close(self):
            pass

    return Speedo, TB


@pytest.fixture(scope="module")
def one_epoch(devkit, tmp_path_factory):
    """One epoch of each package's train_net from the same initial weights
    (the JAX package's fp32 build_model draw), fp32 networks in both (each
    package's build_model patched: both build bf16 by default)."""
    out = tmp_path_factory.mktemp("train")
    jc, tc = _cfgs(devkit)
    _, params = _J_BUILD_MODEL(jc, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    init = state_dict_from_flax(params)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("jax", j_train_net), ("port", t_train_net)):
            store = {}
            speedo, tb = _recorders(store)
            mp.setattr(mod, "Speedometer", speedo)
            mp.setattr(mod, "TBLogger", tb)
            store["dir"] = str(out / name)
            if name == "jax":
                mp.setattr(mod, "build_model", lambda cfg: _J_BUILD_MODEL(cfg, dtype=jnp.float32))
                state = j_train_net.train_net(jc, output_dir=store["dir"], n_devices=1, init_params=params)
                store["params"] = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
                store["step"] = int(state.step)
            else:
                mp.setattr(mod, "build_model",
                           lambda cfg, device: _T_BUILD_MODEL(cfg, dtype=torch.float32, device=device))
                state = t_train_net.train_net(tc, output_dir=store["dir"], device="cpu", init_state_dict=init)
                store["params"] = {k: v.detach() for k, v in state.model.state_dict().items()}
                store["step"] = state.step
                store["state"] = state
            runs[name] = store
    runs["init"] = init
    return runs


def test_train_net_one_epoch_matches_jax(one_epoch):
    """One epoch of train_net (4 steps of batch 4, 2 inner iterations):
    equal learning rates per step, losses per inner iteration to rtol 1e-3,
    parameters by the rule in the module docstring, no dropped pairs.  The
    port's state records every step's metrics, the values its Speedometer
    heard."""
    j, t, init = one_epoch["jax"], one_epoch["port"], one_epoch["init"]
    assert t["step"] == j["step"] == 8 and t["state"].optimizer.count == 8
    assert t["lr"] == j["lr"] and [s for s, _ in t["lr"]] == [2, 4, 6, 8]
    assert len(t["metrics"]) == len(j["metrics"]) == 4
    for step, (jm, tm) in enumerate(zip(j["metrics"], t["metrics"])):
        assert set(tm) == set(jm)
        for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
            for it in range(2):
                name = f"{key}/iter{it}"
                assert np.isfinite(tm[name])
                np.testing.assert_allclose(tm[name], jm[name], rtol=1e-3, err_msg=f"step {step} {name}")
        assert tm["raster_dropped"] == jm["raster_dropped"] == 0
    recorded = t["state"].epochs[0]["metrics"]
    assert set(recorded) == {k for k in t["metrics"][0] if "/" not in k}
    for key, values in recorded.items():
        assert values.shape == (4, 2)
        heard = [[tm[f"{key}/iter{it}"] for it in range(2)] for tm in t["metrics"]]
        np.testing.assert_array_equal(values, np.asarray(heard, np.float32), err_msg=key)
    moved = 0
    for name, p in t["params"].items():
        ref, p0 = j["params"][name].numpy(), init[name].numpy()
        delta = float(np.abs(ref - p0).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2e-2 * delta
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        moved += delta > 0
    assert moved == len(init)
    assert os.path.exists(os.path.join(t["dir"], f"{PREFIX}_ckpt", "1"))


def test_train_net_resume_is_exact(devkit, one_epoch, tmp_path, monkeypatch):
    """Two epochs in one run equal one epoch, then RESUME from its
    checkpoint with begin_epoch 1, bit for bit: parameters, the optimizer's
    momentum, update count and step (fp32 networks, as the one_epoch run
    whose checkpoint is resumed).  Each epoch records its figures on the
    returned state."""
    monkeypatch.setattr(t_train_net, "build_model",
                        lambda cfg, device: _T_BUILD_MODEL(cfg, dtype=torch.float32, device=device))
    jc, tc = _cfgs(devkit, {"end_epoch": 2})
    whole = t_train_net.train_net(tc, output_dir=str(tmp_path), device="cpu", init_state_dict=one_epoch["init"])
    assert [e["epoch"] for e in whole.epochs] == [1, 2]
    for e in whole.epochs:
        assert e["samples"] == 16 and e["nonfinite_losses"] == e["raster_dropped"] == 0
        assert e["loop_s"] >= e["wait_s"] + e["step_s"] and e["checkpoint_s"] > 0
        assert e["metrics"]["total"].shape == (4, 2)
    assert whole.epochs[0]["cache_misses"] > 0 and whole.epochs[1]["cache_misses"] == 0
    resume_dir = str(tmp_path / "resume")
    shutil.copytree(os.path.join(one_epoch["port"]["dir"], f"{PREFIX}_ckpt"),
                    os.path.join(resume_dir, f"{PREFIX}_ckpt"))
    _, tc2 = _cfgs(devkit, {"end_epoch": 2, "begin_epoch": 1, "RESUME": True})
    resumed = t_train_net.train_net(tc2, output_dir=resume_dir, device="cpu")
    assert resumed.step == whole.step == 16
    assert resumed.optimizer.count == whole.optimizer.count == 16
    for (name, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = whole.optimizer.inner.state_dict(), resumed.optimizer.inner.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["momentum_buffer"], sb["state"][i]["momentum_buffer"]), i


def _tables_equal(a: dict, b: dict):
    for table in ("pose", "add", "arp_2d"):
        assert a[table].keys() == b[table].keys()
        for cls in a[table]:
            for it, row in a[table][cls].items():
                for key, v in row.items():
                    np.testing.assert_array_equal(np.asarray(b[table][cls][it][key]), np.asarray(v),
                                                  err_msg=f"{table} {cls} {it} {key}")


def test_test_deepim_model_equals_checkpoint(devkit, one_epoch, tmp_path):
    """test_deepim(model=) on the trained network gives the tables that
    test_deepim gives from the epoch's checkpoint, and reads none."""
    _, tc = _cfgs(devkit)
    model = one_epoch["port"]["state"].model
    handed = t_test_deepim(tc, output_dir=str(tmp_path / "handed"), batch_size=4, device="cpu", model=model)
    shutil.copytree(os.path.join(one_epoch["port"]["dir"], f"{PREFIX}_ckpt"),
                    str(tmp_path / "ckpt" / f"{PREFIX}_ckpt"))
    loaded = t_test_deepim(tc, output_dir=str(tmp_path / "ckpt"), batch_size=4, device="cpu")
    _tables_equal(handed, loaded)
    assert handed["run"]["pairs"] == 4 and "model_s" in handed["run"]


# -- front doors -------------------------------------------------------------------

@pytest.fixture
def own_log_files():
    """Closes the run-directory log files an entry point attaches to the
    port's logger."""
    before = list(t_logger.handlers)
    yield
    for h in [h for h in t_logger.handlers if h not in before]:
        t_logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("entry", ["train_test", "train_net"])
def test_front_doors(devkit, tmp_path, entry, own_log_files):
    """python -m deepim_tpu_torch.tools.train_test / train_net with
    --device cpu train from a YAML file (train_test then tests the trained
    network); without --device, on a host with no CUDA device, they raise."""
    # warmup_lr 0: the YAML subset has no exponent form for 1e-5.
    d = _cfg_dict(devkit, {"BATCH_PAIRS": 8, "model_prefix": f"cli_{entry}", "warmup_lr": 0.0})
    d["dataset"] = {**d["dataset"], "dataset": "LM6D_REFINE", "image_set": "train_"}
    d["output_path"] = str(tmp_path / "out")
    cfg_file = tmp_path / "cfg.yaml"
    _write_yaml(cfg_file, d)
    main = t_train_test.main if entry == "train_test" else t_train_net.main
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(["--cfg", str(cfg_file)])
    res = main(["--cfg", str(cfg_file), "--device", "cpu"])
    run_dir = tmp_path / "out" / f"cli_{entry}"
    assert (run_dir / "train_" / f"cli_{entry}_ckpt" / "1").exists()
    if entry == "train_test":
        assert res["run"]["pairs"] == 4 and (run_dir / "val_" / "results_pose.pkl").exists()
    else:
        assert res.step == 2


def test_pretrained_raises(devkit, tmp_path):
    """A network.pretrained that names no file raises (the reference's
    <prefix>-0000.params is looked for, as the reference's load_param
    reads it) instead of training from the seeded weights."""
    _, tc = _cfgs(devkit, network={"pretrained": str(tmp_path / "flownet")})
    with pytest.raises(FileNotFoundError, match="flownet-0000.params"):
        t_train_net.train_net(tc, output_dir=str(tmp_path), device="cpu")
