"""Parity of the port's rasterizer (deepim_tpu_torch.render) with the JAX
package's, on the CPU, at test_csr_raster.py's 96x128 BASE.

The JAX side runs its Pallas kernels in interpret mode (use_pallas=True),
so the port's dense path is held to the dense tile kernel and its CSR path
to the slots8 kernel, or to the planes64 kernel with csr_kernel="planes64";
on the CPU the port runs the kernels' plain twins.
Tolerances are the JAX package's own cross-path ones
(test_csr_raster.py:58-70): hit masks exact, depth atol 1e-5, rgb atol
5e-3, dropped-pair counts equal."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp

from deepim_tpu.engine.refine import EngineConfig as JEngineConfig
from deepim_tpu.engine.refine import tune_raster_for_bank as j_tune
from deepim_tpu.render import rasterizer as jr
from deepim_tpu.render.mesh import MeshBank as JMeshBank
from deepim_tpu.render.mesh import make_icosphere as j_ico
from deepim_tpu.render.mesh import make_mixed_detail_mesh as j_mixed
from deepim_tpu.render.mesh import make_test_cube as j_cube
from deepim_tpu_torch.engine.refine import EngineConfig as TEngineConfig
from deepim_tpu_torch.engine.refine import tune_raster_for_bank as t_tune
from deepim_tpu_torch.render import mesh as tmesh
from deepim_tpu_torch.render import raster_kernels as tk
from deepim_tpu_torch.render import rasterizer as tr

torch.set_num_threads(2)

BASE = dict(
    height=96, width=128, tile_h=8, tile_w=128, max_faces_per_tile=512,
    chunk=16, znear=0.05, zfar=10.0, active_tiles=0,
)
K_MAT = np.array([[300.0, 0, 64.0], [0, 300.0, 48.0], [0, 0, 1.0]], np.float32)
N_FINE = (96 // 16) * (128 // 8)


def _cfgs(**kw):
    """Matching (JAX, port) RasterConfigs; JAX runs its Pallas kernels."""
    return jr.RasterConfig(**{**BASE, "use_pallas": True, **kw}), tr.RasterConfig(**{**BASE, **kw})


def _scene(mesh, b=3, seed=0, pad=64):
    bank = JMeshBank.from_meshes([mesh], pad_multiple=pad)
    rng = np.random.RandomState(seed)
    rot = R.random(b, random_state=rng).as_matrix().astype(np.float32)
    pose = np.concatenate([rot, np.zeros((b, 3, 1), np.float32)], 2)
    pose[:, 2, 3] = 0.5
    pose[:, 0, 3] = rng.uniform(-0.05, 0.05, b)
    pose[:, 1, 3] = rng.uniform(-0.03, 0.03, b)
    tile = lambda x: np.tile(x, (b,) + (1,) * (x.ndim - 1))  # noqa: E731
    return [tile(bank.vertices), tile(bank.colors), tile(bank.faces), tile(bank.face_valid), pose]


def _jax_render(arrs, jcfg):
    out = jr.rasterize(*(jnp.asarray(x) for x in arrs), jnp.asarray(K_MAT), jcfg, with_stats=True)
    return [np.asarray(x) for x in out]


def _torch_render(arrs, tcfg):
    out = tr.rasterize(*(torch.from_numpy(x) for x in arrs), torch.from_numpy(K_MAT), tcfg,
                       with_stats=True, device="cpu")
    return [x.numpy() for x in out]


def _render_both(arrs, jcfg, tcfg):
    return _jax_render(arrs, jcfg), _torch_render(arrs, tcfg)


_MESHES = {
    "cube": lambda: j_cube(0.08),
    "ico2": lambda: j_ico(0.05, 2),
    "ico3": lambda: j_ico(0.05, 3),
    "ico4": lambda: j_ico(0.05, 4),
}


@functools.lru_cache(maxsize=None)
def _reference(mesh_name, binning):
    """(scene arrays, JAX render) of a default-config scene, shared by the
    tests below (each JAX compile of an interpreted kernel costs seconds)."""
    arrs = _scene(_MESHES[mesh_name](), b=2 if mesh_name == "ico4" else 3)
    kw = {"binning": binning}
    if binning == "csr" and mesh_name == "cube":
        kw["bin_pairs"] = N_FINE * arrs[2].shape[1]  # giant faces: exact budget
    return arrs, kw, _jax_render(arrs, _cfgs(**kw)[0])


def _assert_images(t, j, min_cover=0.05):
    np.testing.assert_array_equal(t[1] > 0, j[1] > 0, err_msg="hit mask")
    np.testing.assert_allclose(t[1], j[1], atol=1e-5, rtol=0, err_msg="depth")
    np.testing.assert_allclose(t[0], j[0], atol=5e-3, rtol=0, err_msg="rgb")
    assert int(t[2]) == int(j[2]), ("dropped", int(t[2]), int(j[2]))
    assert (t[1] > 0).mean() > min_cover


@pytest.mark.parametrize(
    "mesh_name,binning",
    [("cube", "dense"), ("ico3", "dense"), ("ico3", "csr"), ("ico4", "csr"), ("cube", "csr")],
)
def test_rasterize_matches_jax(mesh_name, binning):
    arrs, kw, j = _reference(mesh_name, binning)
    _assert_images(_torch_render(arrs, _cfgs(**kw)[1]), j)


def test_padded_cube_tuned_csr_path():
    """The big-face cube padded past 2048 faces (test_csr_raster.py:121-173):
    both tuners size the same budget, and the CSR renders agree with 0
    dropped pairs."""
    bank = JMeshBank.from_meshes([j_cube(0.08)], pad_multiple=2560)
    bank_arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    jcfg, tcfg = _cfgs(active_tiles=128)
    j_e = j_tune(JEngineConfig(height=96, width=128, raster=jcfg),
                 tuple(jnp.asarray(x) for x in bank_arrays), K_MAT)
    t_e = t_tune(TEngineConfig(height=96, width=128, raster=tcfg), bank_arrays, K_MAT)
    assert (t_e.raster.bin_pairs, t_e.raster.csr_tiers) == (j_e.raster.bin_pairs, j_e.raster.csr_tiers)
    arrs = _scene(j_cube(0.08), b=2, seed=3, pad=2560)
    j, t = _render_both(arrs, j_e.raster, t_e.raster)
    _assert_images(t, j)
    assert int(t[2]) == 0


def test_mixed_mesh_tiers_match_jax():
    """Heavy-tailed mesh: the tuner emits the same multi-tier budget as the
    JAX tuner and the tiered CSR render agrees with JAX's."""
    mesh = j_mixed(0)
    bank = JMeshBank.from_meshes([mesh], pad_multiple=64)
    bank_arrays = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    jcfg, tcfg = _cfgs(active_tiles=128)
    j_e = j_tune(JEngineConfig(height=96, width=128, raster=jcfg),
                 tuple(jnp.asarray(x) for x in bank_arrays), K_MAT, z_min=0.45)
    t_e = t_tune(TEngineConfig(height=96, width=128, raster=tcfg), bank_arrays, K_MAT, z_min=0.45)
    assert len(t_e.raster.csr_tiers) >= 2
    assert (t_e.raster.bin_pairs, t_e.raster.csr_tiers) == (j_e.raster.bin_pairs, j_e.raster.csr_tiers)
    arrs = _scene(mesh, b=2, seed=5)
    arrs[4][:, 2, 3] = 0.55
    j, t = _render_both(arrs, j_e.raster, t_e.raster)
    _assert_images(t, j)


def test_csr_pack4_matches_pack1_and_jax():
    """Quad packing is a scheduling change: pack 4 and pack 1 give the same
    image bit for bit in the port, and match JAX's pack-4 render."""
    arrs, _, j = _reference("ico3", "csr")
    t4 = _torch_render(arrs, _cfgs(binning="csr", csr_pack=4)[1])
    t1 = _torch_render(arrs, _cfgs(binning="csr", csr_pack=1)[1])
    np.testing.assert_array_equal(t1[1], t4[1])
    np.testing.assert_array_equal(t1[0], t4[0])
    _assert_images(t4, j)


@pytest.mark.parametrize("binning", ["dense", "csr"])
def test_backface_cull_matches_jax(binning):
    """Culling backfaces of the closed ico3 leaves JAX's image unchanged."""
    arrs, kw, j = _reference("ico3", binning)
    _assert_images(_torch_render(arrs, _cfgs(**kw, backface_cull=-1)[1]), j)


@pytest.mark.parametrize("binning", ["dense", "csr"])
def test_raster_batch_chunk(binning):
    """Sub-batches (3 = 2 + 1) give the single-shot image exactly and match
    JAX's render."""
    arrs, kw, j = _reference("ico3", binning)
    t = _torch_render(arrs, _cfgs(**kw, raster_batch_chunk=2)[1])
    t_one = _torch_render(arrs, _cfgs(**kw)[1])
    np.testing.assert_array_equal(t[1], t_one[1])
    np.testing.assert_array_equal(t[0], t_one[0])
    _assert_images(t, j)


def test_dropped_pairs_equal_jax():
    """A starved CSR budget (1 tile per face on giant cube faces) drops the
    same pair count in the port's render, the port's csr_dropped_pairs and
    the JAX package's csr_dropped_pairs."""
    arrs = _scene(j_cube(0.08), b=2)
    f = arrs[2].shape[1]
    jcfg, tcfg = _cfgs(binning="csr", bin_pairs=f, csr_pack=1)
    t = _torch_render(arrs, tcfg)
    v, _, faces, fvalid, pose = arrs
    t_q = tr.csr_dropped_pairs(*(torch.from_numpy(x) for x in (v, faces, fvalid, pose, K_MAT)),
                               tcfg, device="cpu")
    j_q = jr.csr_dropped_pairs(*(jnp.asarray(x) for x in (v, faces, fvalid, pose, K_MAT)), jcfg)
    assert int(t[2]) == int(t_q) == int(j_q) > 0


def test_bin_faces_csr_matches_jax(rng):
    """CSR pair lists (unit ids, offsets, counts, dropped) equal JAX's for
    random triangles, at pack 1 and 4 and under a starved budget."""
    b, f = 2, 64
    fu = rng.uniform(-20, 148, (b, f, 3)).astype(np.float32)
    fv = rng.uniform(-20, 116, (b, f, 3)).astype(np.float32)
    valid = rng.rand(b, f) > 0.2
    for kw in (dict(csr_pack=1, bin_pairs=N_FINE * f), dict(csr_pack=4), dict(csr_pack=1, bin_pairs=2 * f)):
        jcfg, tcfg = _cfgs(**kw)
        t_out = tr.bin_faces_csr(torch.from_numpy(fu), torch.from_numpy(fv), torch.from_numpy(valid),
                                 tcfg, th=16, tw=8)
        j_out = jax.vmap(lambda a, c, d: jr.bin_faces_csr(a, c, d, jcfg, th=16, tw=8))(
            jnp.asarray(fu), jnp.asarray(fv), jnp.asarray(valid))
        for name, x, y in zip(("sorted_unit", "offsets", "counts", "dropped"), t_out, j_out):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"{kw} {name}")


@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("mesh_name", ["ico4", "mixed"])
def test_csr_budget_caps_and_capacity(mesh_name, pack):
    """csr_budget, the budget as the card's binning kernels take it, over a
    tuned uniform (icosphere) or tiered (mixed-detail) bank at packs 1, 2
    and 4: each unit's cap is the number of tiles JAX's bin_faces_csr keeps
    for it when its faces span the whole image, the drops are the rest,
    and the capacity is the tuner's bin_pairs and the width of both
    packages' pair lists."""
    mesh = j_ico(0.05, 4) if mesh_name == "ico4" else j_mixed(0)
    bank = JMeshBank.from_meshes([mesh], pad_multiple=64)
    arrs = (bank.vertices, bank.colors, bank.faces, bank.face_valid)
    jcfg, tcfg = _cfgs(binning="csr", csr_pack=pack)
    tcfg = t_tune(TEngineConfig(height=96, width=128, raster=tcfg), arrs, K_MAT, z_min=0.45).raster
    jcfg = dataclasses.replace(jcfg, bin_pairs=tcfg.bin_pairs, csr_tiers=tcfg.csr_tiers)
    assert (len(tcfg.csr_tiers) >= 2) == (mesh_name == "mixed")
    f = bank.faces.shape[1]
    n_units = f // pack
    tiers, capacity = tr.csr_budget(tcfg, n_units, N_FINE)
    caps = np.repeat([s for _, s in tiers], np.diff([0] + [e for e, _ in tiers]))
    assert len(caps) == n_units and capacity == tcfg.bin_pairs == int(caps.sum())
    fu = np.tile(np.float32([-500.0, 5000.0, -500.0]), (1, f, 1))
    fv = np.tile(np.float32([-500.0, -500.0, 5000.0]), (1, f, 1))
    valid = np.ones((1, f), bool)
    j_unit, _, _, j_dropped = (np.asarray(x) for x in jr.bin_faces_csr(
        jnp.asarray(fu[0]), jnp.asarray(fv[0]), jnp.asarray(valid[0]), jcfg, th=16, tw=8))
    assert j_unit.shape == (capacity,)
    np.testing.assert_array_equal(np.bincount(j_unit[j_unit < n_units], minlength=n_units), caps)
    assert int(j_dropped) == int((N_FINE - caps).sum())
    t_unit = tr.bin_faces_csr(torch.from_numpy(fu), torch.from_numpy(fv), torch.from_numpy(valid), tcfg,
                              th=16, tw=8)[0]
    assert t_unit.shape == (1, capacity)


def test_bin_faces_dense_matches_jax(rng):
    b, f = 2, 40
    fu = rng.uniform(-20, 148, (b, f, 3)).astype(np.float32)
    fv = rng.uniform(-20, 116, (b, f, 3)).astype(np.float32)
    valid = rng.rand(b, f) > 0.2
    jcfg, tcfg = _cfgs(max_faces_per_tile=16, tile_h=16, tile_w=32)
    tf, cnt = tr.bin_faces(torch.from_numpy(fu), torch.from_numpy(fv), torch.from_numpy(valid), tcfg)
    jtf, jcnt = jax.vmap(lambda a, c, d: jr.bin_faces(a, c, d, jcfg))(
        jnp.asarray(fu), jnp.asarray(fv), jnp.asarray(valid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jtf))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_worklist_stable_sort_equals_topk(rng):
    """The port's work list (torch.sort(-counts, stable=True)) is exactly
    jax.lax.top_k's order on tie-heavy counts."""
    counts = rng.randint(0, 4, 300).astype(np.int32)
    neg, order = torch.sort(-torch.from_numpy(counts), stable=True)
    j_vals, j_ids = jax.lax.top_k(jnp.asarray(counts), 120)
    np.testing.assert_array_equal(order[:120].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal((-neg[:120]).numpy(), np.asarray(j_vals))


def test_face_records_and_projection_match_jax(rng):
    b, v = 2, 50
    verts = rng.uniform(-0.05, 0.05, (b, v, 3)).astype(np.float32)
    pose = _scene(j_cube(0.08), b=b)[4]
    kb = np.broadcast_to(K_MAT, (b, 3, 3)).copy()
    t_uvz = tr.project_vertices(*(torch.from_numpy(x) for x in (verts, pose, kb)))
    j_uvz = jr.project_vertices(*(jnp.asarray(x) for x in (verts, pose, kb)))
    for x, y in zip(t_uvz, j_uvz):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-4)
    n = 30
    fu = rng.uniform(0, 128, (n, 3)).astype(np.float32)
    fv = rng.uniform(0, 96, (n, 3)).astype(np.float32)
    fq = rng.uniform(1.5, 2.5, (n, 3)).astype(np.float32)
    fcol = rng.uniform(0, 255, (n, 3, 3)).astype(np.float32)
    valid = rng.rand(n) > 0.2
    t_rec = tr.build_face_records(*(torch.from_numpy(x) for x in (fu, fv, fq, fcol, valid)))
    j_rec = jr.build_face_records(*(jnp.asarray(x) for x in (fu, fv, fq, fcol, valid)))
    np.testing.assert_allclose(t_rec.numpy(), np.asarray(j_rec), rtol=1e-5, atol=1e-3)


def test_mesh_builders_match_jax():
    for tm, jm in [(tmesh.make_test_cube(0.08), j_cube(0.08)),
                   (tmesh.make_icosphere(0.05, 3), j_ico(0.05, 3)),
                   (tmesh.make_mixed_detail_mesh(1), j_mixed(1))]:
        for name in ("vertices", "faces", "colors"):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    tb = tmesh.MeshBank.from_meshes([tmesh.make_test_cube(0.08), tmesh.make_icosphere(0.05, 2)], 128)
    jb = JMeshBank.from_meshes([j_cube(0.08), j_ico(0.05, 2)], 128)
    for name in ("vertices", "colors", "faces", "face_valid", "num_vertices", "num_faces"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))


@pytest.mark.parametrize("mesh_name", ["cube", "ico3"])
def test_planes64_matches_jax_planes64(mesh_name):
    """csr_kernel="planes64" (the csr_planes_raster twin) against JAX's
    interpreted planes64 kernel on test_csr_raster.py's scenes (full pair
    budget, as test_planes64_matches_xla): hits exact, depth 1e-5, rgb
    5e-3; and bit-equal to the port's slots8 render."""
    arrs = _scene(_MESHES[mesh_name]())
    kw = dict(binning="csr", bin_pairs=N_FINE * arrs[2].shape[1], csr_kernel="planes64")
    j, t = _render_both(arrs, *_cfgs(**kw))
    _assert_images(t, j)
    slots8 = _torch_render(arrs, _cfgs(**{**kw, "csr_kernel": "slots8"})[1])
    for a, b in zip(t, slots8):
        np.testing.assert_array_equal(a, b)


def test_planes64_group_and_chunk_splits():
    """JAX's planes64 under forced multi-chunk tiles and a multi-group scan
    (csr_chunk=32, csr_group=7; test_planes64_group_and_chunk_splits)
    against the port with the same knobs, which only change the TPU
    schedule: the port's image is the unsplit one, bit for bit."""
    arrs, _, _ = _reference("ico3", "csr")
    kw = dict(binning="csr", csr_kernel="planes64")
    j_split = _jax_render(arrs, _cfgs(**kw, csr_chunk=32, csr_group=7)[0])
    t_split = _torch_render(arrs, _cfgs(**kw, csr_chunk=32, csr_group=7)[1])
    _assert_images(t_split, j_split)
    t_one = _torch_render(arrs, _cfgs(**kw)[1])
    for a, b in zip(t_split, t_one):
        np.testing.assert_array_equal(a, b)


def test_raw_pack_and_planes_twin(rng):
    """build_raw_pack equals JAX's; the planes twin on a raw pack equals the
    slots8 twin on build_face_records of the same corners, bit for bit,
    including faces that are invalid or degenerate."""
    n = 40
    fu = rng.uniform(0, 128, (n, 3)).astype(np.float32)
    fv = rng.uniform(0, 96, (n, 3)).astype(np.float32)
    fv[:4] = fv[:4, :1]  # zero-area faces
    fq = rng.uniform(1.5, 2.5, (n, 3)).astype(np.float32)
    fcol = rng.uniform(0, 255, (n, 3, 3)).astype(np.float32)
    valid = rng.rand(n) > 0.2
    args = [torch.from_numpy(x) for x in (fu, fv, fq, fcol, valid)]
    raw = tr.build_raw_pack(*args)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jr.build_raw_pack(*map(jnp.asarray, (fu, fv, fq, fcol, valid)))))
    records = tr.build_face_records(*args)
    w_items, pack = 12, 4
    sorted_unit = torch.from_numpy(rng.randint(0, n // pack, 60).astype(np.int32))
    seg_count = torch.from_numpy(rng.randint(0, 6, w_items).astype(np.int32))
    seg_start = torch.from_numpy(rng.randint(0, 54, w_items).astype(np.int32))
    tile_xy = torch.from_numpy(np.stack([rng.randint(0, 16, w_items) * 8, rng.randint(0, 6, w_items) * 16],
                                        1).astype(np.int32))
    unit_base = torch.zeros(w_items, dtype=torch.int32)
    csr = (sorted_unit, seg_start, seg_count, tile_xy, unit_base, pack, 8)
    tk.reset_launch_counts()
    out = tk.csr_planes_raster(raw, *csr)
    assert torch.equal(out, tk.csr_raster_plain(records, *csr))
    assert (out[:, 0] > 0).any() and tk.csr_planes_raster.launches == 0
    with pytest.raises(ValueError):
        tk.csr_planes_raster(raw.to("meta"), *(x.to("meta") for x in csr[:5]), pack, 8)


def test_unknown_csr_kernel_raises():
    arrs, kw, _ = _reference("ico3", "csr")
    with pytest.raises(NotImplementedError):
        _torch_render(arrs, _cfgs(**kw, csr_kernel="slots16")[1])


def test_wrappers_dispatch_on_device():
    """CPU tensors take the plain twin (no launch counted); other devices
    are refused rather than silently computed elsewhere."""
    tk.reset_launch_counts()
    rec = torch.zeros((4, 32))
    rec[:, 4] = -1e30
    out = tk.tile_raster(rec, torch.zeros((2, 4), dtype=torch.int32),
                         torch.tensor([1, 0], dtype=torch.int32),
                         torch.zeros((2, 2), dtype=torch.int32), 8, 16)
    assert out.shape == (2, 4, 128) and (out[:, 0] == -1e30).all()
    out = tk.csr_raster(rec, torch.zeros(4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                        torch.tensor([1, 0], dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), 4, 8)
    assert out.shape == (2, 5, 128) and (out[:, 1] == 1e30).all()
    assert tk.csr_raster.launches == 0 and tk.tile_raster.launches == 0
    with pytest.raises(ValueError):  # a unit holds at least one face
        tk.csr_raster(rec, torch.zeros(4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                      torch.tensor([1, 0], dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), 0, 8)
    with pytest.raises(ValueError):
        tk.tile_raster(rec.to("meta"), torch.zeros((2, 4), dtype=torch.int32, device="meta"),
                       torch.zeros(2, dtype=torch.int32, device="meta"),
                       torch.zeros((2, 2), dtype=torch.int32, device="meta"), 8, 16)


def test_csr_segments_dispatch_on_device(rng):
    """csr_segments on CPU tensors is bin_faces_csr (no binning launch
    counted); the binning kernels' wrapper refuses any tensor off the card."""
    b, f = 2, 64
    fu = torch.from_numpy(rng.uniform(-20, 148, (b, f, 3)).astype(np.float32))
    fv = torch.from_numpy(rng.uniform(-20, 116, (b, f, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(b, f) > 0.2)
    cfg = _cfgs(csr_pack=4)[1]
    tk.reset_launch_counts()
    got = tr.csr_segments(fu, fv, valid, cfg, th=16, tw=8)
    for x, y in zip(got, tr.bin_faces_csr(fu, fv, valid, cfg, th=16, tw=8)):
        assert torch.equal(x, y)
    assert tk.csr_bin.launches == 0
    tiers, capacity = tr.csr_budget(cfg, f // 4, N_FINE)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tk.csr_bin(fu.to(dev), fv.to(dev), valid.to(dev), tiers, capacity, 4, 16, 8, 96, 128)



@pytest.mark.parametrize("kind", ["ape", "all"])
def test_linemod_standin_banks_and_poses(kind):
    """synth_data's LINEMOD stand-ins, whose banks the card's binning cases
    and chip_smoke bin: each class at its diameter, the bank padded to 256
    faces, and the budget regime each stands for (the ape's uniform 15
    tiles a unit; the padded mixed bank's uniform fallback of 762, a budget
    ~700x its real pairs); a refinement batch's poses: reproducible from the
    seed, classes even, one depth in each 1/B slice of the range, centres
    projected into the image's middle."""
    from scipy.spatial import ConvexHull
    from scipy.spatial.distance import pdist

    from deepim_tpu_torch.engine.scene import LINEMOD_K
    from deepim_tpu_torch.tools import synth_data as sd

    bank = sd.linemod_standin_bank(kind)
    n = 1 if kind == "ape" else 13
    real = [20480] if kind == "ape" else [20880 if i % 2 == 0 else 5520 for i in range(n)]
    assert bank["faces"].shape == (n, 20480 if kind == "ape" else 20992, 3)
    np.testing.assert_array_equal(bank["face_valid"].sum(1), real)
    for i in range(n):
        v = bank["vertices"][i][:int(bank["faces"][i][bank["face_valid"][i]].max()) + 1]
        span = pdist(v[ConvexHull(v).vertices].astype(np.float64)).max()
        np.testing.assert_allclose(span, sd.LINEMOD_DIAMETERS_MM[i] / 1000.0, rtol=1e-5)
    cfg = t_tune(TEngineConfig(raster=tr.RasterConfig(height=480, width=640)), bank, LINEMOD_K).raster
    assert not cfg.csr_tiers and cfg.csr_pack == 4
    assert cfg.bin_pairs == (76800 if kind == "ape" else 3998976)

    z_range = (0.6, 1.0) if kind == "ape" else (0.6, 1.1)
    cls, gt, pose0 = sd.linemod_refine_poses(32, n, 7, z_range)
    again = sd.linemod_refine_poses(32, n, 7, z_range)
    for x, y in zip((cls, gt, pose0), again):
        np.testing.assert_array_equal(x, y)
    assert cls.dtype == np.int64 and gt.dtype == pose0.dtype == np.float32
    assert np.bincount(cls, minlength=n).max() - np.bincount(cls, minlength=n).min() <= 1
    z = gt[:, 2, 3].astype(np.float64)
    np.testing.assert_array_equal(np.sort(np.floor((z - z_range[0]) / (z_range[1] - z_range[0]) * 32)),
                                  np.arange(32))
    uv = gt[:, :, 3] @ LINEMOD_K.T
    u, v = uv[:, 0] / uv[:, 2], uv[:, 1] / uv[:, 2]
    assert (u > 199.99).all() and (u < 440.01).all() and (v > 149.99).all() and (v < 330.01).all()
    r = pose0[:, :, :3]
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape), atol=1e-5)
    assert np.abs(pose0 - gt).max() > 0

def test_cuda_required_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    arrs = _scene(j_cube(0.08), b=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.rasterize(*(torch.from_numpy(x) for x in arrs), torch.from_numpy(K_MAT),
                     tr.RasterConfig(**BASE))


def test_engine_configs_copy_across():
    """Config objects copy field for field between the two packages."""
    assert [f.name for f in dataclasses.fields(tr.RasterConfig)] == [
        f.name for f in dataclasses.fields(jr.RasterConfig)]
    assert [f.name for f in dataclasses.fields(TEngineConfig)] == [
        f.name for f in dataclasses.fields(JEngineConfig)]


# --- The CSR kernels' cull (edge_maxima_plain is its plain version) ---

CULL_TILE_WS = [4, 8, 16, 32, 128]


def _item_faces(sorted_unit, seg_start, seg_count, tile_xy, unit_base, pack, tile_w):
    """A CSR work list as dense (W, C) global face ids in list order and
    their live mask."""
    faces = seg_count.long() * pack
    pos = torch.arange(max(int(faces.max()), 1))
    live = pos[None, :] < faces[:, None]
    unit = sorted_unit[(seg_start.long()[:, None] + pos[None, :] // pack).clamp(max=sorted_unit.numel() - 1)]
    gf = (unit_base.long()[:, None] + unit.long()) * pack + pos[None, :] % pack
    return torch.where(live, gf, torch.zeros_like(gf)), live


def _rect_pixels(rect, tile_w):
    """Indices (into a tile's row-major pixels) of a cull rectangle."""
    x_lo, x_hi, y_lo, y_hi = rect
    return torch.tensor([y * tile_w + x for y in range(y_lo, y_hi + 1) for x in range(x_lo, x_hi + 1)])


def _culls(records, gf, tile_xy, tile_w, tile_h=None):
    """For each of the tile's 16-pixel blocks (8 of a CSR tile, tile_h *
    tile_w / 16 of a dense one): (pixel indices, rejected (W, C))."""
    rec = records[gf]
    x0, y0 = tile_xy[:, 0:1], tile_xy[:, 1:2]
    for rect in tk.cull_rectangles(tile_w, tile_h=tile_h):
        x_lo, x_hi, y_lo, y_hi = rect
        maxima = tk.edge_maxima_plain(rec, x0 + x_lo, x0 + x_hi, y0 + y_lo, y0 + y_hi)
        yield _rect_pixels(rect, tile_w), (maxima < 0).any(-1)


def _assert_cull_is_exact(records, gf, live, tile_xy, tile_w, tile_h=None):
    """rejected => no pixel of the rectangle passes the inside test.
    Returns the share of live (face, 16-pixel block) pairs the cull rejects."""
    pixels = tk.CSR_TILE_PIXELS if tile_h is None else tile_h * tile_w
    px, py = tk._pixel_coords(tile_xy, pixels, tile_w)
    inside, _ = tk._coverage(records[gf], px, py)
    n_rej = 0
    for pix, rejected in _culls(records, gf, tile_xy, tile_w, tile_h):
        covered = inside[:, :, pix].any(-1)
        assert not (covered & rejected & live).any(), f"tile_w {tile_w}: a culled face covers a pixel"
        n_rej += int((rejected & live).sum())
    return n_rej / (pixels // 16 * int(live.sum()))


@pytest.mark.parametrize("tile_w", CULL_TILE_WS + [1, 2, 64])
def test_cull_rectangles_tile_the_tile(tile_w):
    """8 blocks of 16 pixels that cover each pixel of the tile once."""
    rects = tk.cull_rectangles(tile_w)
    blocks = [_rect_pixels(r, tile_w).tolist() for r in rects]
    assert len(blocks) == 8 and all(len(b) == 16 for b in blocks)
    assert sorted(sum(blocks, [])) == list(range(128))
    if tile_w in (4, 8, 16, 32):
        assert all(r[1] - r[0] == 3 and r[3] - r[2] == 3 for r in rects)
    with pytest.raises(ValueError):
        tk.cull_rectangles(3)


def _base_csr_inputs(tile_w):
    """Kernel inputs of the ico4 BASE scene binned over 128-pixel tiles of
    width tile_w (CPU)."""
    arrs, _, _ = _reference("ico4", "csr")
    cfg = _cfgs(binning="csr", csr_tile_w=tile_w, csr_tile_h=128 // tile_w)[1]
    (name, args), = tr.kernel_inputs(*(torch.from_numpy(x) for x in arrs), torch.from_numpy(K_MAT), cfg,
                                     device="cpu")
    assert name == "csr_raster"
    return args


@pytest.mark.parametrize("tile_w", CULL_TILE_WS)
def test_cull_rule_on_base_scene(tile_w):
    """On the BASE CSR scene's own work list: a face the cull rejects for
    one of the tile's blocks covers none of that block's pixels, and the
    cull rejects most (face, block) pairs of a fine mesh."""
    records, *csr = _base_csr_inputs(tile_w)
    gf, live = _item_faces(*csr)
    assert _assert_cull_is_exact(records, gf, live, csr[3], tile_w) > 0.5


def _random_records(rng, n):
    """(n, 32) numpy records: anchors on and off the image, edge planes
    with ordinary, zero, tiny, huge and overflowing coefficients, a fifth
    of the faces flagged invalid (ar = -1e30)."""
    pool = np.array([0.0, -0.0, 1e-30, -1e-30, 1e15, -1e15, 1e36, -1e36], np.float32)

    def coeffs(shape):
        plain = rng.uniform(-3, 3, shape).astype(np.float32)
        special = pool[rng.randint(0, len(pool), shape)]
        return np.where(rng.rand(*shape) < 0.35, special, plain)

    rec = np.zeros((n, 32), np.float32)
    rec[:, 0] = rng.uniform(-60, 200, n)
    rec[:, 1] = rng.uniform(-60, 160, n)
    rec[:, [2, 3, 5, 6, 7, 8]] = coeffs((n, 6))
    rec[:, 4] = np.where(rng.rand(n) < 0.2, -1e30, rng.uniform(-50, 400, n))
    rec[:, 13] = 1.0
    return rec


@pytest.mark.parametrize("tile_w", CULL_TILE_WS)
def test_cull_rule_on_random_records(rng, tile_w):
    """Random records with zero (and -0.0), tiny, ordinary, huge and
    overflowing coefficients, negative-area flags and off-grid anchors."""
    n = 3000
    rec = _random_records(rng, n)
    records = torch.from_numpy(rec)
    tile_h = 128 // tile_w
    origins = [(tx * tile_w, ty * tile_h) for tx in range(0, 128 // tile_w, max(1, 32 // tile_w))
               for ty in range(0, 96 // tile_h, max(1, 24 // tile_h))][:12]
    tile_xy = torch.tensor(origins, dtype=torch.int32)
    gf = torch.arange(n)[None, :].expand(len(origins), n)
    share = _assert_cull_is_exact(records, gf, torch.ones_like(gf, dtype=torch.bool), tile_xy, tile_w)
    assert 0.2 < share < 1.0
    # Every negative-area flag rejects its face everywhere.
    flagged = torch.from_numpy(rec[:, 4] == -1e30) & torch.isfinite(records[:, 2:4]).all(-1) \
        & (records[:, 2:4].abs() < 1e30).all(-1)
    for _, rejected in _culls(records, gf, tile_xy, tile_w):
        assert rejected[:, flagged].all()


@pytest.mark.parametrize("tile_w", [4, 8, 32])
def test_culled_lists_give_the_full_lists_output(tile_w):
    """csr_raster_plain fed, for each of the tile's blocks, only the faces
    the cull keeps for that block equals csr_raster_plain on the full
    lists on that block's pixels, bit for bit (winners, face ids and
    colours)."""
    records, *csr = _base_csr_inputs(tile_w)
    full = tk.csr_raster_plain(records, *csr)
    assert (full[:, 0] > 0).any()
    gf, live = _item_faces(*csr)
    tile_xy = csr[3]
    for pix, rejected in _culls(records, gf, tile_xy, tile_w):
        keep = live & ~rejected
        counts = keep.sum(1)
        kept = torch.cat([gf[w][keep[w]] for w in range(gf.shape[0])]).int()
        start = (torch.cumsum(counts, 0) - counts).int()
        out = tk.csr_raster_plain(records, kept, start, counts.int(), tile_xy,
                                  torch.zeros_like(start), 1, tile_w)
        assert torch.equal(out[:, :, pix], full[:, :, pix])


@pytest.mark.parametrize("pack,tile_w", [(1, 8), (4, 8), (1, 16), (4, 16), (4, 128), (1, 2)])
def test_stress_list_twins(pack, tile_w):
    """The hand-built stress work list (stress.py) through both twins: the
    planes twin equals the slots8 twin, empty items keep their constants,
    exact copies at higher ids lose their ties, and the segment separators
    are never read."""
    from deepim_tpu_torch.render.stress import stress_work_list

    n = 272
    records, raw, csr = stress_work_list(pack, tile_w, n_faces=n)
    out = tk.csr_raster_plain(records, *csr)
    assert torch.equal(tk.csr_planes_raster_plain(raw, *csr), out)
    count = csr[2]
    assert (out[count == 0][:, 0] == tk.NEG).all() and (out[count == 0][:, 1] == tk.BIG).all()
    hit = out[:, 0] > 0
    assert hit[count * pack >= 100].any(1).all()
    fid = out[:, 1][hit].long() % n
    assert (fid < n // 4).any() and not (fid >= n - n // 4).any()
    gf, live = _item_faces(*csr)
    assert int(gf[live].max()) < 2 * n and int(live[0].sum()) == n


# --- The dense kernel's cull and its stress list ---

DENSE_TILES = [(8, 128), (16, 16), (8, 16), (8, 4), (1, 32)]


def _dense_inputs(mesh_name, tile_h, tile_w):
    """tile_raster's arguments for a BASE scene binned over tile_h x tile_w
    tiles (CPU), every tile kept."""
    arrs = _scene(_MESHES[mesh_name](), b=2, seed=1)
    cfg = _cfgs(binning="dense", tile_h=tile_h, tile_w=tile_w)[1]
    (name, args), = tr.kernel_inputs(*(torch.from_numpy(x) for x in arrs), torch.from_numpy(K_MAT), cfg,
                                     device="cpu")
    assert name == "tile_raster" and args[4:] == (tile_h, tile_w)
    return args


def _list_faces(tf_global, counts):
    """A dense work list's (W, K) face rows and their live mask."""
    live = torch.arange(tf_global.shape[1])[None, :] < counts[:, None]
    return tf_global.long().clamp(min=0), live


@pytest.mark.parametrize("tile_h,tile_w", DENSE_TILES + [(16, 6), (32, 3), (8, 12)])
def test_dense_cull_rectangles_tile_the_tile(tile_h, tile_w):
    """tile_h * tile_w / 16 blocks of 16 pixels that cover each pixel of a
    dense tile once, 4 x 4 where both sides are multiples of 4."""
    rects = tk.cull_rectangles(tile_w, tile_h=tile_h)
    blocks = [_rect_pixels(r, tile_w).tolist() for r in rects]
    assert len(blocks) == tile_h * tile_w // 16 and all(len(b) == 16 for b in blocks)
    assert sorted(sum(blocks, [])) == list(range(tile_h * tile_w))
    if tile_h % 4 == 0 and tile_w % 4 == 0:
        assert all(r[1] - r[0] == 3 and r[3] - r[2] == 3 for r in rects)
    if tile_h * tile_w == 128 and 128 % tile_w == 0:
        assert rects == tk.cull_rectangles(tile_w)
    for bad_w, bad_h in ((tile_w, 0), (3, 5)):  # no rows; 15 pixels
        with pytest.raises(ValueError):
            tk.cull_rectangles(bad_w, tile_h=bad_h)
    with pytest.raises(TypeError):  # the height goes by name: every other API here is (h, w)
        tk.cull_rectangles(tile_w, tile_h)


@pytest.mark.parametrize("tile_h,tile_w", DENSE_TILES)
@pytest.mark.parametrize("mesh_name", ["ico2", "ico3"])
def test_dense_cull_rule_on_scene(mesh_name, tile_h, tile_w):
    """On a scene's own dense work list: a face the cull rejects for a
    16-pixel block of the tile covers none of that block's pixels, and some
    (face, block) pairs are rejected."""
    records, tf_global, counts, tile_xy, _, _ = _dense_inputs(mesh_name, tile_h, tile_w)
    keep = counts > 0  # the work list is sorted: the tiles with faces come first
    assert 0 < int(counts.max()) < tf_global.shape[1]
    gf, live = _list_faces(tf_global[keep], counts[keep])
    gf, live = gf[:, :int(counts.max())], live[:, :int(counts.max())]
    share = _assert_cull_is_exact(records, gf, live, tile_xy[keep], tile_w, tile_h)
    assert share > (0.5 if tile_h * tile_w >= 128 else 0.0)


@pytest.mark.parametrize("tile_h,tile_w", DENSE_TILES)
def test_dense_cull_rule_on_random_records(rng, tile_h, tile_w):
    """The random records of test_cull_rule_on_random_records against the
    blocks of dense tiles."""
    n = 1500
    records = torch.from_numpy(_random_records(rng, n))
    origins = [(tx * tile_w, ty * tile_h) for tx in range(0, 128 // tile_w, max(1, 32 // tile_w))
               for ty in range(0, 96 // tile_h, max(1, 24 // tile_h))][:4]
    tile_xy = torch.tensor(origins, dtype=torch.int32)
    gf = torch.arange(n)[None, :].expand(len(origins), n)
    share = _assert_cull_is_exact(records, gf, torch.ones_like(gf, dtype=torch.bool), tile_xy, tile_w, tile_h)
    assert 0.2 < share < 1.0


@pytest.mark.parametrize("tile_h,tile_w", DENSE_TILES)
def test_dense_culled_lists_give_the_full_lists_output(tile_h, tile_w):
    """tile_raster_plain fed, for each 16-pixel block of the tile, only the
    faces the cull keeps for that block (in list order) equals
    tile_raster_plain on the full lists on that block's pixels, bit for
    bit."""
    records, tf_global, counts, tile_xy, _, _ = _dense_inputs("ico3", tile_h, tile_w)
    keep = counts > 0
    tf_global, counts, tile_xy = tf_global[keep], counts[keep], tile_xy[keep]
    full = tk.tile_raster_plain(records, tf_global, counts, tile_xy, tile_h, tile_w)
    assert (full[:, 0] > 0).any()
    gf, live = _list_faces(tf_global, counts)
    for pix, rejected in _culls(records, gf, tile_xy, tile_w, tile_h):
        kept = live & ~rejected
        order = torch.sort((~kept).int(), dim=1, stable=True).indices  # kept faces first, in list order
        ids = torch.where(torch.gather(kept, 1, order), torch.gather(tf_global, 1, order), -1)
        out = tk.tile_raster_plain(records, ids.int(), kept.sum(1).int(), tile_xy, tile_h, tile_w)
        assert torch.equal(out[:, :, pix], full[:, :, pix])


@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (16, 16)])
def test_stress_tile_list_matches_jax(tile_h, tile_w):
    """The dense stress list (stress.py) through tile_raster's twin and
    through the JAX package's interpreted dense kernel, fed the gathered
    (W, K, 32) records: hits exact, q to 1e-5, rgb to 5e-3
    (test_csr_raster.py:58-70).  The list is what it says: the guard row is
    never drawn, the descending list gives its ties to other faces than the
    ascending one, empty items keep (-1e30, 0, 0, 0)."""
    from deepim_tpu.render.pallas_raster import pallas_visibility_shade
    from deepim_tpu_torch.render.stress import stress_tile_list

    k_cap = 160
    records, tf_global, counts, tile_xy, _, _ = args = stress_tile_list(tile_h, tile_w, k_cap)
    assert sorted(set(counts.tolist())) == [0, 1, k_cap // 2, 128, 129, k_cap]
    assert (tf_global[torch.arange(k_cap)[None, :] >= counts[:, None]] == -1).all()
    tk.reset_launch_counts()
    out = tk.tile_raster(*args)
    assert tk.tile_raster.launches == 0
    empty = counts == 0
    assert (out[empty][:, 0] == tk.NEG).all() and (out[empty][:, 1:] == 0).all()
    hit = out[:, 0] > 0
    assert hit[counts >= 128].any(1).all() and float(out[:, 0].max()) < 3.0
    assert torch.equal(out[0, 0], out[2, 0]) and not torch.equal(out[0, 1:], out[2, 1:])

    gathered = records[tf_global.long().clamp(min=0)].numpy()  # (W, K, 32)
    j_q, j_rgbq = pallas_visibility_shade(jnp.asarray(gathered), jnp.asarray(counts.numpy()),
                                          jnp.asarray(tile_xy.numpy()), tile_h, tile_w, interpret=True)
    j_q, j_rgbq = np.asarray(j_q)[~empty.numpy()], np.asarray(j_rgbq)[~empty.numpy()]
    t = out[~empty].numpy()
    t_hit = t[:, 0] > 0
    np.testing.assert_array_equal(t_hit, j_q > 0, err_msg="hit mask")
    np.testing.assert_allclose(t[:, 0][t_hit], j_q[t_hit], atol=1e-5, rtol=0, err_msg="q")
    t_rgb = (t[:, 1:4] / np.where(t_hit, t[:, 0], 1.0)[:, None]).transpose(0, 2, 1)
    j_rgb = j_rgbq / np.where(t_hit, j_q, 1.0)[..., None]
    np.testing.assert_allclose(t_rgb[t_hit], j_rgb[t_hit], atol=5e-3, rtol=0, err_msg="rgb")
