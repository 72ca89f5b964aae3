"""Parity of the port's flow colouring (utils/flow_vis.py),
visualize_minibatch (utils/visualize.py), visibility masks
(utils/visibility.py) and directional mask dilation (ops/masks.py) with
the JAX package's, on the CPU: every output equal, byte for byte or value
for value.  jax.random's draws cannot come from a torch generator, so the
port's mask_dilate takes the codes and thicknesses JAX's
mask_dilate_random draws from its key splits."""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.ops.masks import mask_dilate_random as j_mask_dilate_random  # noqa: E402
from deepim_tpu.utils import visibility as jvis  # noqa: E402
from deepim_tpu.utils.flow_vis import flow_to_color as j_flow_to_color  # noqa: E402
from deepim_tpu.utils.visualize import visualize_minibatch as j_visualize_minibatch  # noqa: E402
from deepim_tpu_torch.ops.masks import mask_dilate, mask_dilate_random  # noqa: E402
from deepim_tpu_torch.utils import visibility as tvis  # noqa: E402
from deepim_tpu_torch.utils.flow_vis import flow_to_color  # noqa: E402
from deepim_tpu_torch.utils.png import read_png  # noqa: E402
from deepim_tpu_torch.utils.visualize import visualize_minibatch  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("max_flow", [None, 3.0])
def test_flow_to_color_byte_equal(rng, max_flow):
    """Random flow (magnitudes past max_flow too), zero flow and a
    single-direction frame."""
    for flow in (rng.randn(32, 40, 2).astype(np.float32) * 4, np.zeros((4, 4, 2), np.float32),
                 np.dstack([np.full((8, 8), 2.0), np.zeros((8, 8))]).astype(np.float32)):
        got, ref = flow_to_color(flow, max_flow), j_flow_to_color(flow, max_flow)
        assert got.dtype == ref.dtype == np.uint8
        assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_visualize_minibatch_equals_jax(rng, tmp_path, layout):
    """tests/test_logging_vis.py's inputs (3 samples of 32x40 images and
    flow, 2 drawn): the port's PNG decodes to the grid JAX's cv2 PNG
    decodes to."""
    b, h, w = 3, 32, 40
    obs = rng.rand(b, 3, h, w).astype(np.float32) * 255
    rend = rng.rand(b, 3, h, w).astype(np.float32) * 255
    flow = rng.randn(b, 2, h, w).astype(np.float32) * 5
    if layout == "hwc":
        obs, rend, flow = (x.transpose(0, 2, 3, 1) for x in (obs, rend, flow))
    p_t, p_j = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    visualize_minibatch(p_t, {"obs": obs, "rend": rend}, flow=flow, max_samples=2)
    j_visualize_minibatch(p_j, {"obs": obs, "rend": rend}, flow=flow, max_samples=2)
    got = read_png(p_t)
    assert got.shape == (2 * h, 3 * w, 3)
    np.testing.assert_array_equal(got, cv2.imread(p_j)[:, :, ::-1])
    visualize_minibatch(p_t, {"obs": obs}, max_samples=4)
    assert read_png(p_t).shape == (3 * h, w, 3)


def _visibility_cases(rng):
    """tests/test_mesh_io.py's 2x3 case, and random depths with holes,
    some within and some beyond delta of each other, one in float64."""
    yield (np.asarray([[0.5, 0.5, 0.0], [0.5, 0.5, 0.5]], np.float32),
           np.asarray([[0.49, 0.6, 0.5], [0.0, 0.5, 0.52]], np.float32), 0.02)
    d_test = np.where(rng.rand(2, 24, 32) > 0.2, rng.uniform(0.5, 1.0, (2, 24, 32)), 0)
    d_model = np.where(rng.rand(2, 24, 32) > 0.2, d_test + rng.uniform(-0.04, 0.04, (2, 24, 32)), 0)
    yield d_test.astype(np.float32), d_model.astype(np.float32), 0.015
    yield d_test, d_model, 0.015


def test_visibility_masks_equal_jax(rng):
    """estimate_visib_mask, _gt and _est (with the gt-visible mask from
    _gt) equal JAX's."""
    for d_test, d_model, delta in _visibility_cases(rng):
        d_est = np.where(rng.rand(*d_test.shape) > 0.3, d_model + 0.01, 0).astype(d_model.dtype)
        t_args = (torch.from_numpy(d_test), torch.from_numpy(d_model))
        j_args = (jnp.asarray(d_test), jnp.asarray(d_model))
        vis = tvis.estimate_visib_mask(*t_args, delta)
        assert vis.dtype == torch.bool
        np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis.estimate_visib_mask(*j_args, delta)))
        gt_t = tvis.estimate_visib_mask_gt(*t_args, delta)
        gt_j = jvis.estimate_visib_mask_gt(*j_args, delta)
        np.testing.assert_array_equal(gt_t.numpy(), np.asarray(gt_j))
        np.testing.assert_array_equal(
            tvis.estimate_visib_mask_est(t_args[0], torch.from_numpy(d_est), gt_t, delta).numpy(),
            np.asarray(jvis.estimate_visib_mask_est(j_args[0], jnp.asarray(d_est), gt_j, delta)))
    d_test, d_model, delta = next(_visibility_cases(rng))
    np.testing.assert_array_equal(tvis.estimate_visib_mask(torch.from_numpy(d_test), torch.from_numpy(d_model),
                                                           delta).numpy(),
                                  np.array([[True, False, False], [False, True, True]]))


def _masks(rng, b=6, h=24, w=32):
    m = np.zeros((b, h, w), np.float32)
    for i in range(b):
        y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 10)
        m[i, y0:y0 + rng.randint(3, 8), x0:x0 + rng.randint(3, 10)] = 1
    m[0, :2, :3] = 1  # touches two borders
    m[1, 5, :] = 0
    m[1, 5, 7] = 1  # a lone pixel
    return m


@pytest.mark.parametrize("seed,max_thickness", [(0, 10), (1, 10), (2, 3)])
def test_mask_dilate_equals_jax(rng, seed, max_thickness):
    """The port's mask_dilate on the direction codes and thicknesses JAX's
    mask_dilate_random draws from its key (its five key splits) equals
    JAX's output."""
    m = _masks(rng)
    key = jax.random.PRNGKey(seed)
    kd, k0, k1, k2, k3 = jax.random.split(key, 5)
    b = m.shape[0]
    direction = np.array(jax.random.randint(kd, (b,), 0, 10))
    thickness = np.stack([np.array(jax.random.randint(k, (b,), 1, max_thickness + 1)) for k in (k0, k1, k2, k3)])
    ref = np.asarray(j_mask_dilate_random(jnp.asarray(m), key, max_thickness))
    got = mask_dilate(torch.from_numpy(m), torch.from_numpy(direction), torch.from_numpy(thickness)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= m).all() and (got > m).any()


def test_mask_dilate_each_code(rng, monkeypatch):
    """Every direction code against JAX's branch for it: codes 0-9 on ten
    copies of one mask, thicknesses 1-4 a direction."""
    m = np.repeat(_masks(rng, b=2)[1:], 10, axis=0)
    direction = np.arange(10)
    thickness = np.stack([np.full(10, t) for t in (1, 2, 3, 4)])
    got = mask_dilate(torch.from_numpy(m), torch.from_numpy(direction), torch.from_numpy(thickness)).numpy()

    def j_draws(key, shape, lo, hi):
        j_draws.calls += 1
        return jnp.asarray(direction if j_draws.calls == 1 else thickness[j_draws.calls - 2])

    j_draws.calls = 0
    monkeypatch.setattr(jax.random, "randint", j_draws)
    ref = np.asarray(j_mask_dilate_random(jnp.asarray(m), jax.random.PRNGKey(0), 4))
    np.testing.assert_array_equal(got, ref)
    assert len({got[i].tobytes() for i in range(10)}) >= 8


def test_mask_dilate_random_reseeds():
    """mask_dilate_random draws 5 B integers from the generator: equal
    outputs from equal seeds, the draws of mask_dilate's arguments."""
    m = torch.from_numpy(_masks(np.random.RandomState(4)))
    a = mask_dilate_random(m, torch.Generator().manual_seed(11))
    b = mask_dilate_random(m, torch.Generator().manual_seed(11))
    c = mask_dilate_random(m, torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(11)
    direction = torch.randint(0, 10, (m.shape[0],), generator=g)
    thickness = torch.randint(1, 11, (4, m.shape[0]), generator=g)
    assert torch.equal(a, mask_dilate(m, direction, thickness))
