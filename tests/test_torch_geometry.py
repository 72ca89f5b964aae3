"""Parity of the port's geometry (deepim_tpu_torch.geometry) with the JAX
package's: the same seeded numpy inputs through both, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepim_tpu.geometry import projection as jproj
from deepim_tpu.geometry import rotations as jrot
from deepim_tpu.geometry import se3 as jse3
from deepim_tpu_torch.geometry import projection as tproj
from deepim_tpu_torch.geometry import rotations as trot
from deepim_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(2)
ATOL = 1e-6


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=0, atol=atol)


def _poses(rng, b=6):
    q = rng.randn(b, 4).astype(np.float32)
    r = np.asarray(jrot.quat2mat(jnp.asarray(q)))
    t = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b), rng.uniform(0.4, 1.0, b)], 1)
    return np.concatenate([r, t[..., None]], 2).astype(np.float32)


def test_quat2mat_and_normalize(rng):
    q = rng.randn(16, 4).astype(np.float32)
    q[3] = 0.0  # degenerate quaternion -> identity
    _close(trot.quat2mat(torch.from_numpy(q)), jrot.quat2mat(jnp.asarray(q)))
    _close(trot.quat_normalize(torch.from_numpy(q)), jrot.quat_normalize(jnp.asarray(q)))


def test_mat2quat(rng):
    r = _poses(rng, 16)[:, :, :3]
    _close(trot.mat2quat(torch.from_numpy(r)), jrot.mat2quat(jnp.asarray(r)))


def test_euler2mat(rng):
    a = rng.uniform(-np.pi, np.pi, (3, 10)).astype(np.float32)
    _close(trot.euler2mat(*map(torch.from_numpy, a)), jrot.euler2mat(*map(jnp.asarray, a)))


def test_make_pose_inverse_mul(rng):
    pa, pb = _poses(rng), _poses(rng)
    ta, tb = torch.from_numpy(pa), torch.from_numpy(pb)
    _close(tse3.make_pose(ta[..., :3], ta[..., 3]), jse3.make_pose(jnp.asarray(pa[..., :3]), jnp.asarray(pa[..., 3])))
    _close(tse3.se3_inverse(ta), jse3.se3_inverse(jnp.asarray(pa)))
    _close(tse3.se3_mul(ta, tb), jse3.se3_mul(jnp.asarray(pa), jnp.asarray(pb)))


@pytest.mark.parametrize("rot_coord", ["MODEL", "CAMERA", "CAMERA_NEW"])
def test_r_t_transform(rng, rot_coord):
    p = _poses(rng)
    rd = _poses(rng)[:, :, :3]
    td = rng.uniform(-0.05, 0.05, (6, 3)).astype(np.float32)
    means, stds = np.float32([0.01, -0.02, 0.0]), np.float32([0.5, 0.5, 0.2])
    _close(
        tse3.R_transform(torch.from_numpy(p[..., :3]), torch.from_numpy(rd), rot_coord),
        jse3.R_transform(jnp.asarray(p[..., :3]), jnp.asarray(rd), rot_coord),
    )
    _close(
        tse3.T_transform(torch.from_numpy(p[..., 3]), torch.from_numpy(td),
                         torch.from_numpy(means), torch.from_numpy(stds), rot_coord),
        jse3.T_transform(jnp.asarray(p[..., 3]), jnp.asarray(td), jnp.asarray(means),
                         jnp.asarray(stds), rot_coord),
    )


@pytest.mark.parametrize("rot_coord", ["MODEL", "CAMERA", "CAMERA_NEW", "NAIVE"])
@pytest.mark.parametrize("rot_dim", [3, 4])
def test_rt_transform(rng, rot_coord, rot_dim):
    p = _poses(rng)
    rot = rng.randn(6, rot_dim).astype(np.float32) * (0.2 if rot_dim == 3 else 1.0)
    td = rng.uniform(-0.05, 0.05, (6, 3)).astype(np.float32)
    _close(
        tse3.RT_transform(torch.from_numpy(p), torch.from_numpy(rot), torch.from_numpy(td),
                          rot_coord=rot_coord),
        jse3.RT_transform(jnp.asarray(p), jnp.asarray(rot), jnp.asarray(td), rot_coord=rot_coord),
    )


def test_rt_transform_rejects_bad_inputs():
    p = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        tse3.RT_transform(p, torch.zeros(1, 5), torch.zeros(1, 3))
    with pytest.raises(ValueError):
        tse3.RT_transform(p, torch.zeros(1, 4), torch.zeros(1, 3), rot_coord="WORLD")


def test_project_points(rng):
    pts = np.stack([rng.uniform(-0.2, 0.2, 20), rng.uniform(-0.2, 0.2, 20),
                    rng.uniform(0.3, 2.0, 20)], 1).astype(np.float32)
    pts[0, 2] = 0.0
    k = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    t_out = tproj.project_points(torch.from_numpy(pts), torch.from_numpy(k))
    j_out = jproj.project_points(jnp.asarray(pts), jnp.asarray(k))
    # Pixel coordinates of a few hundred: one float32 ulp is 3e-5 there, so
    # the 1e-6 bound is relative (the einsum's rounding may differ by 1 ulp).
    np.testing.assert_allclose(t_out.numpy()[1:], np.asarray(j_out)[1:], rtol=1e-6, atol=ATOL)
    assert np.isfinite(t_out.numpy()[0]).all() == np.isfinite(np.asarray(j_out)[0]).all()
