"""Parity of the port's matching network (deepim_tpu_torch.models) with the
JAX package's FlowNetDeepIM through the state_dict_from_flax weight bridge,
in float32: rot and trans to atol 1e-5, flow and mask logits to atol
1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepim_tpu.models import FlowNetDeepIM as JFlowNet
from deepim_tpu.models import assemble_input as j_assemble
from deepim_tpu.models import fixed_bilinear_upsample as j_upsample
from deepim_tpu.models.flownet import _bilinear_matrix as j_bilinear
from deepim_tpu_torch.models import FlowNetDeepIM as TFlowNet
from deepim_tpu_torch.models import assemble_input as t_assemble
from deepim_tpu_torch.models import fixed_bilinear_upsample as t_upsample
from deepim_tpu_torch.models import state_dict_from_flax
from deepim_tpu_torch.models.flownet import _bilinear_matrix as t_bilinear

torch.set_num_threads(2)


def jax_params(hw, seed=0, in_ch=8):
    """Full-model JAX parameters (numpy) with a random nonzero trans head,
    so the comparison is not identity against identity."""
    model = JFlowNet(pred_flow=True, pred_mask=True)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, in_ch)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    return params


def torch_model(params, hw, pred_flow, pred_mask, in_ch=8):
    model = TFlowNet(in_channels=in_ch, input_hw=hw, pred_flow=pred_flow, pred_mask=pred_mask,
                     device="cpu")
    sd = state_dict_from_flax(params)
    own = model.state_dict()
    missing = set(own) - set(sd)
    assert not missing, missing
    model.load_state_dict({k: sd[k] for k in own})
    return model.eval()


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
@pytest.mark.parametrize("full", [True, False], ids=["full", "fast_test"])
def test_flownet_matches_jax(rng, hw, full):
    params = jax_params(hw)
    x = rng.rand(2, *hw, 8).astype(np.float32)
    j_out = JFlowNet(pred_flow=full, pred_mask=full).apply(params, jnp.asarray(x))
    with torch.no_grad():
        t_out = torch_model(params, hw, full, full)(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert sorted(t_out) == sorted(j_out)
    np.testing.assert_allclose(t_out["rot"].numpy(), np.asarray(j_out["rot"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_out["trans"].numpy(), np.asarray(j_out["trans"]), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(j_out["trans"])).max() > 1e-3
    for key in ("flow", "mask_logit"):
        if key in j_out:
            np.testing.assert_allclose(t_out[key].permute(0, 2, 3, 1).numpy(), np.asarray(j_out[key]),
                                       atol=1e-4, rtol=0, err_msg=key)


def test_flow_only_and_mask_only_heads(rng):
    """Each decoder head alone loads its own subset of the bridged weights."""
    hw = (64, 64)
    params = jax_params(hw, seed=1)
    x = rng.rand(1, *hw, 8).astype(np.float32)
    for pf, pm in [(True, False), (False, True)]:
        j_out = JFlowNet(pred_flow=pf, pred_mask=pm).apply(params, jnp.asarray(x))
        with torch.no_grad():
            t_out = torch_model(params, hw, pf, pm)(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        assert sorted(t_out) == sorted(j_out)
        np.testing.assert_allclose(t_out["rot"].numpy(), np.asarray(j_out["rot"]), atol=1e-5, rtol=0)


def test_bridge_layouts():
    """Conv (kh,kw,in,out) -> (out,in,kh,kw); Dense transposed; deconv
    spatially flipped and laid out (in,out,kh,kw)."""
    params = jax_params((64, 64))
    sd = state_dict_from_flax(params)
    p = params["params"]
    np.testing.assert_array_equal(sd["convs.conv2.weight"].numpy(),
                                  p["Conv_1"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc7.weight"].numpy(), p["fc7"]["kernel"].T)
    k = p["deconv5"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(sd["deconv5.deconv.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_bilinear_upsample_matches_jax(rng):
    for args in [(4, 64, 16, 8), (6, 96, 16, 8), (8, 128, 16, 8)]:
        np.testing.assert_array_equal(t_bilinear(*args), j_bilinear(*args))
    x = rng.rand(2, 6, 8, 2).astype(np.float32)
    t = t_upsample(torch.from_numpy(x).permute(0, 3, 1, 2), 96, 128).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(t, np.asarray(j_upsample(jnp.asarray(x), 96, 128)), atol=1e-5, rtol=0)


def test_assemble_input_matches_jax(rng):
    obs, rend = (rng.rand(2, 3, 16, 16) * 255).astype(np.float32), (rng.rand(2, 3, 16, 16) * 255).astype(np.float32)
    mo, mr = (rng.rand(2, 1, 16, 16) > 0.5).astype(np.float32), (rng.rand(2, 1, 16, 16) > 0.5).astype(np.float32)
    t = t_assemble(*map(torch.from_numpy, (obs, rend)), mask_observed=torch.from_numpy(mo),
                   mask_rendered=torch.from_numpy(mr))
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    j = j_assemble(nhwc(obs), nhwc(rend), mask_observed=nhwc(mo), mask_rendered=nhwc(mr))
    np.testing.assert_array_equal(t.permute(0, 2, 3, 1).numpy(), np.asarray(j))


def test_seeded_init_is_reproducible_and_near_identity(rng):
    """The port's own init: a seeded torch.Generator gives the same weights
    twice, the quaternion head starts near identity and the translation
    head at zero, like the JAX model's init."""
    mk = lambda: TFlowNet(input_hw=(64, 64), pred_flow=False, pred_mask=False,  # noqa: E731
                          generator=torch.Generator().manual_seed(3), device="cpu")
    a, b = mk(), mk()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with torch.no_grad():
        out = a(torch.from_numpy(rng.rand(2, 8, 64, 64).astype(np.float32)))
    assert (out["rot"][:, 0] > 0.5).all()
    assert torch.count_nonzero(out["trans"]) == 0
