"""Parity of the port's zoom and mask ops (deepim_tpu_torch.ops) with the
JAX package's: box_fill and the zoomed masks exactly, zoom factors to atol
1e-5, zoomed [0, 255] images to the bounds explained in
test_affine_sample_and_zoom_images, zoom_trans forward and backward against
jax.vjp."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepim_tpu.ops import masks as jmasks
from deepim_tpu.ops import sampler as jsamp
from deepim_tpu.ops import zoom as jzoom
from deepim_tpu_torch.ops import masks as tmasks
from deepim_tpu_torch.ops import sampler as tsamp
from deepim_tpu_torch.ops import zoom as tzoom

torch.set_num_threads(2)
H, W = 48, 64


def _blob_masks(rng, b=4, empty=1):
    """(B, 1, H, W) masks: random ellipses plus speckle, `empty` blank."""
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.zeros((b, 1, H, W), np.float32)
    for i in range(b - empty):
        cy, cx = rng.uniform(5, H - 5), rng.uniform(5, W - 5)
        ry, rx = rng.uniform(3, 15), rng.uniform(3, 20)
        out[i, 0] = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) | (rng.rand(H, W) > 0.995)
    return out


def _zf(rng, b=4):
    wx = rng.uniform(0.3, 1.2, b).astype(np.float32)
    return [wx, wx.copy(), rng.uniform(-0.5, 0.5, b).astype(np.float32),
            rng.uniform(-0.5, 0.5, b).astype(np.float32)]


def _pair(zf):
    return jsamp.ZoomFactor(*map(jnp.asarray, zf)), tsamp.ZoomFactor(*map(torch.from_numpy, zf))


def test_box_fill_exact(rng):
    m = _blob_masks(rng)
    np.testing.assert_array_equal(tmasks.box_fill(torch.from_numpy(m)).numpy(),
                                  np.asarray(jmasks.box_fill(jnp.asarray(m))))
    np.testing.assert_array_equal(tmasks.box_fill(torch.from_numpy(m[:, 0])).numpy(),
                                  np.asarray(jmasks.box_fill(jnp.asarray(m[:, 0]))))


def test_mask_bbox(rng):
    m = _blob_masks(rng)[:, 0]
    for x, y in zip(tzoom.mask_bbox(torch.from_numpy(m)), jzoom.mask_bbox(jnp.asarray(m))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_zoom_factor_from_masks(rng):
    b = 4
    m_obs, m_gt = _blob_masks(rng, b), _blob_masks(rng, b, empty=0)
    m_rend = _blob_masks(rng, b, empty=2) * rng.uniform(0.1, 1.0, (b, 1, 1, 1)).astype(np.float32)
    pose = np.zeros((b, 3, 4), np.float32)
    pose[:, :, :3] = np.eye(3)
    pose[:, :, 3] = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                              rng.uniform(0.4, 0.8, b)], 1)
    k = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
    args = (m_obs, m_gt, m_rend, pose, k)
    t_zf = tzoom.zoom_factor_from_masks(*map(torch.from_numpy, args))
    j_zf = jzoom.zoom_factor_from_masks(*map(jnp.asarray, args))
    np.testing.assert_allclose(t_zf.as_array().numpy(), np.asarray(j_zf.as_array()), atol=1e-5, rtol=0)


def _affine_sample_f64(img, zf, out_hw):
    """Float64 evaluation of the same separable bilinear map."""
    b, c, h, w = img.shape
    ho, wo = out_hw
    wx, wy, tx, ty = (np.float64(z)[:, None] for z in zf)
    sx = (wx * np.linspace(-1, 1, wo)[None] + tx + 1.0) * (w - 1) / 2
    sy = (wy * np.linspace(-1, 1, ho)[None] + ty + 1.0) * (h - 1) / 2
    mx = np.maximum(0.0, 1.0 - np.abs(sx[..., None] - np.arange(w)))
    my = np.maximum(0.0, 1.0 - np.abs(sy[..., None] - np.arange(h)))
    return np.einsum("bciw,bjw->bcij", np.einsum("bih,bchw->bciw", my, img.astype(np.float64)), mx)


@pytest.mark.parametrize("out_hw", [(H, W), (30, 40)])
def test_affine_sample_and_zoom_images(rng, out_hw):
    """Zoomed [0, 255] images against the JAX package as the engine runs it
    (under jit) to atol 2 ulp(255), and against a float64 evaluation of the
    map to atol 255 * 4 * ulp(W).

    Under jit, XLA's CPU compiler contracts the sample coordinate
    wx * g + tx into one FMA; the port rounds it the same way (float64
    product and sum, rounded once), so both build bit-identical
    interpolation weights.  What remains is the resample matmuls' rounding
    of a two-term sum (fused or not): at most 1 ulp of the [0, 255] value
    per matmul.  Against float64, a 1-ulp change of a float32 coordinate
    near W moves a bilinear weight by ulp(W), so an output by up to
    255 ulp(W) on these noise images."""
    zf = _zf(rng)
    jz, tz = _pair(zf)
    obs = (rng.rand(4, 3, H, W) * 255).astype(np.float32)
    rend = (rng.rand(4, 3, H, W) * 255).astype(np.float32)
    pm = np.float32([120.0, 110.0, 100.0])
    if out_hw == (H, W):
        t_out = tzoom.zoom_images(torch.from_numpy(obs - pm[:, None, None]),
                                  torch.from_numpy(rend - pm[:, None, None]), tz, torch.from_numpy(pm))
        j_out = jax.jit(jzoom.zoom_images)(jnp.asarray(obs - pm[:, None, None]),
                                           jnp.asarray(rend - pm[:, None, None]), jz, jnp.asarray(pm))
        refs = [_affine_sample_f64(x, zf, out_hw) - pm[:, None, None] for x in (obs, rend)]
    else:
        t_out = [tsamp.affine_sample(torch.from_numpy(obs), tz, out_hw)]
        j_out = [jax.jit(jsamp.affine_sample, static_argnums=2)(jnp.asarray(obs), jz, out_hw)]
        refs = [_affine_sample_f64(obs, zf, out_hw)]
    atol_f64 = 255 * 4 * float(np.spacing(np.float32(W)))
    atol_jax = 2 * float(np.spacing(np.float32(255)))
    for x, y, r in zip(t_out, j_out, refs):
        np.testing.assert_allclose(x.numpy(), r, atol=atol_f64, rtol=0)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=atol_jax, rtol=0)


def test_zoom_masks_exact(rng):
    zf = _zf(rng)
    jz, tz = _pair(zf)
    masks = (_blob_masks(rng), _blob_masks(rng, empty=0),
             _blob_masks(rng) * np.float32(0.5))
    t_out = tzoom.zoom_masks(*map(torch.from_numpy, masks), tz)
    j_out = jzoom.zoom_masks(*map(jnp.asarray, masks), jz)
    for x, y in zip(t_out, j_out):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("inverse", [False, True])
def test_zoom_mask_exact(rng, inverse):
    zf = _zf(rng)
    jz, tz = _pair(zf)
    m = _blob_masks(rng) * np.float32(0.7)
    np.testing.assert_array_equal(
        tzoom.zoom_mask(torch.from_numpy(m), tz, inverse=inverse).numpy(),
        np.asarray(jzoom.zoom_mask(jnp.asarray(m), jz, inverse=inverse)),
    )


def test_invert_zoom_factor(rng):
    jz, tz = _pair(_zf(rng))
    np.testing.assert_allclose(tsamp.invert_zoom_factor(tz, H, W).as_array().numpy(),
                               np.asarray(jsamp.invert_zoom_factor(jz, H, W).as_array()),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("zoom_grad", [False, True])
def test_zoom_trans_forward_backward(rng, inverse, zoom_grad):
    td = rng.randn(5, 3).astype(np.float32)
    zf = np.stack(_zf(rng, 5), 1)
    g = rng.randn(5, 3).astype(np.float32)
    j_out, vjp = jax.vjp(lambda t, z: jzoom.zoom_trans(t, z, inverse, zoom_grad),
                         jnp.asarray(td), jnp.asarray(zf))
    j_gt, j_gz = vjp(jnp.asarray(g))
    t_td = torch.from_numpy(td).requires_grad_(True)
    t_zf = torch.from_numpy(zf).requires_grad_(True)
    t_out = tzoom.zoom_trans(t_td, t_zf, inverse, zoom_grad)
    t_out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_td.grad.numpy(), np.asarray(j_gt), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(t_zf.grad.numpy(), np.asarray(j_gz))
