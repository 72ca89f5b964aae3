"""The port in bf16 against the JAX package in bf16, on the CPU: the
matching network, the bf16 image zoom, refine_step and a 4-iteration
refine, and a training step; and the precision that every entry point sets.

Both packages compute a bf16 layer as float32 products of bf16-rounded
operands, rounded once to bf16, with the bf16 bias added after (XLA's CPU
compiler does exactly that for flax's layers, transposed convolutions
included).  Bit-equality is not reached all the same: the float32 sums of
a convolution run in another order (oneDNN's against XLA's), so a few of
its outputs in 1e5 round to the neighbouring bf16 value
(test_bf16_layers_round_as_xla), and the flips grow through the encoder,
while the dense layers and the x16 upsample agree bit for bit, as do
LeakyReLU and the zoom.  The port's bf16 results therefore differ from
JAX's bf16 results by about as much as JAX's bf16 results differ from its
float32 ones.  Each tolerance below is stated in bf16 ulps, or as twice
the JAX package's own bf16-vs-float32 gap on the same inputs, whichever
the test names; the measured values go to the test report
(record_property)."""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from __graft_entry__ import _build_scene  # noqa: E402
from deepim_tpu.config import Config as JConfig  # noqa: E402
from deepim_tpu.config import TrainIterConfig as JTIC  # noqa: E402
from deepim_tpu.engine import Observation as JObservation  # noqa: E402
from deepim_tpu.engine import TrainState as JTrainState  # noqa: E402
from deepim_tpu.engine import make_train_step as j_make_train_step  # noqa: E402
from deepim_tpu.engine import refine as j_refine  # noqa: E402
from deepim_tpu.engine import refine_step as j_refine_step  # noqa: E402
from deepim_tpu.engine import lr_schedule as jlr  # noqa: E402
from deepim_tpu.engine import train as jtrain  # noqa: E402
from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.ops import sampler as jsamp  # noqa: E402
from deepim_tpu.ops import zoom as jzoom  # noqa: E402
from deepim_tpu.ops.masks import box_fill as j_box_fill  # noqa: E402
from deepim_tpu_torch import device as t_device  # noqa: E402
from deepim_tpu_torch.config import TrainConfig, TrainIterConfig  # noqa: E402
from deepim_tpu_torch.engine import TrainState  # noqa: E402
from deepim_tpu_torch.engine import lr_schedule as tlr  # noqa: E402
from deepim_tpu_torch.engine import refine as t_refine  # noqa: E402
from deepim_tpu_torch.engine import refine_step as t_refine_step  # noqa: E402
from deepim_tpu_torch.engine import train as ttrain  # noqa: E402
from deepim_tpu_torch.engine.refine import Observation as TObservation  # noqa: E402
from deepim_tpu_torch.engine.scene import build_scene  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM as TFlowNet  # noqa: E402
from deepim_tpu_torch.models import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.ops import sampler as tsamp  # noqa: E402
from deepim_tpu_torch.ops import zoom as tzoom  # noqa: E402
from deepim_tpu_torch.tools import test_net as t_test_net  # noqa: E402
from deepim_tpu_torch.tools import train_net as t_train_net  # noqa: E402
from deepim_tpu_torch.tools import train_test as t_train_test  # noqa: E402
from test_torch_train import TICFG, _batches, _setup  # noqa: E402

torch.set_num_threads(2)
BF16 = torch.bfloat16
K64 = np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
_FLAGS = ("cudnn.allow_tf32", "cuda.matmul.allow_tf32", "cuda.matmul.allow_bf16_reduced_precision_reduction")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x).astype(np.float32), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@functools.lru_cache(maxsize=None)
def _params(hw, seed=0):
    """Full-model JAX parameters (numpy) with a random nonzero trans head."""
    params = JFlowNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 8)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed + 7)
    params["params"]["trans"]["kernel"] = (rng.randn(256, 3) * 0.05).astype(np.float32)
    params["params"]["trans"]["bias"] = (rng.randn(3) * 0.01).astype(np.float32)
    return params


def _port(params, hw, full=True, dtype=BF16):
    model = TFlowNet(input_hw=hw, pred_flow=full, pred_mask=full, dtype=dtype, device="cpu")
    sd = state_dict_from_flax(params)
    model.load_state_dict({k: sd[k] for k in model.state_dict()})
    return model.eval()


# --- precision on the card ---------------------------------------------------


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


def _set_flags(values):
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = values


@pytest.fixture
def loose_flags():
    """Every flag set to the permissive value (cuDNN's and cuBLAS's
    defaults: TF32 convolutions, bf16 split-K reductions), restored after."""
    saved = _flags()
    _set_flags((True, True, True))
    yield
    _set_flags(saved)


def test_set_explicit_precision(loose_flags):
    """The helper turns TF32 and the bf16 reduced-precision reduction off."""
    assert _flags() == (True, True, True)
    t_device.set_explicit_precision()
    assert dict(zip(_FLAGS, _flags())) == dict.fromkeys(_FLAGS, False)


@pytest.mark.parametrize("entry", ["test_deepim", "train_net", "train_test", "track_video", "gen_video"])
def test_entry_points_set_precision(loose_flags, tmp_path, monkeypatch, entry):
    """Each entry point that builds a network sets the flags before it
    builds one: build_model and FlowNetDeepIM are replaced by a probe that
    records the flags and stops the run."""
    seen = []

    class Built(Exception):
        pass

    def probe(*args, **kwargs):
        seen.append(_flags())
        raise Built

    from deepim_tpu_torch.config import Config

    cfg = Config()
    for mod in (t_train_net, t_test_net):
        monkeypatch.setattr(mod, "build_model", probe)
    monkeypatch.setattr(t_test_net, "FlowNetDeepIM", probe)
    db = type("DB", (), {"points": lambda self, cls: None})()
    monkeypatch.setattr(t_train_net, "load_pairdbs", lambda cfg: ([db], []))
    monkeypatch.setattr(t_train_net, "build_mesh_bank", lambda cfg: None)
    monkeypatch.setattr(t_train_net, "TrainLoader", lambda *a, **kw: type("L", (), {"epoch_size": 1})())
    if entry == "test_deepim":
        call = lambda: t_test_net.test_deepim(cfg, output_dir=str(tmp_path), device="cpu")  # noqa: E731
    elif entry == "train_net":
        call = lambda: t_train_net.train_net(cfg, output_dir=str(tmp_path), device="cpu")  # noqa: E731
    elif entry == "train_test":
        monkeypatch.setattr(t_train_test, "load_config", lambda path: cfg)
        monkeypatch.setattr(t_train_test, "train_net", lambda cfg, device: probe())
        call = lambda: t_train_test.main(["--cfg", "unused.yaml", "--device", "cpu"])  # noqa: E731
    else:  # the tracking and video CLIs
        import deepim_tpu_torch.toolkit.gen_video as mod
        import deepim_tpu_torch.tools.track_video as t_track_video

        if entry == "track_video":
            mod = t_track_video
        monkeypatch.setattr(mod, "load_config", lambda path: cfg)
        monkeypatch.setattr(mod, "build_model", probe)
        argv = ["--cfg", "unused.yaml", "--cls", "cube", "--device", "cpu"]
        call = lambda: mod.main(argv + ([] if entry == "track_video" else ["--out", "v.avi"]))  # noqa: E731
    with pytest.raises(Built):
        call()
    assert seen == [(False, False, False)]


# --- the network --------------------------------------------------------------


@pytest.mark.parametrize("layer", ["conv", "deconv", "dense", "upsample"])
def test_bf16_layers_round_as_xla(layer, record_property):
    """One bf16 layer of each kind against flax's under jit, from the same
    float32 weights: the 7x7 stride-2 convolution (conv1's shape), the
    4x4 stride-2 transposed convolution, a dense layer over 20,480 inputs
    and the x16 bilinear upsample.  Dense and upsample bit-equal; the two
    convolutions at least 99.9% of outputs bit-equal and the rest within
    one bf16 ulp of the layer's largest output (their float32 sums run in
    another order: a product rounds to its neighbour, then the bias is
    added)."""
    import flax.linen as fnn

    from deepim_tpu.models.flownet import fixed_bilinear_upsample as j_up
    from deepim_tpu_torch.models import flownet as tf

    rng = np.random.RandomState(4)
    bf = jnp.bfloat16
    if layer == "upsample":
        x = rng.randn(2, 6, 8, 2).astype(np.float32)
        ref = jax.jit(lambda v: j_up(v.astype(bf), 96, 128))(x)
        got = tf.fixed_bilinear_upsample(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16), 96, 128)
        got = got.permute(0, 2, 3, 1)
    else:
        x = {"conv": rng.rand(2, 64, 64, 8), "deconv": rng.randn(2, 4, 5, 64),
             "dense": rng.rand(4, 20480) * 0.1}[layer].astype(np.float32)
        jl = {"conv": fnn.Conv(64, (7, 7), strides=(2, 2), padding=((3, 3), (3, 3)), dtype=bf),
              "deconv": fnn.ConvTranspose(32, (4, 4), strides=(2, 2), padding="VALID", dtype=bf),
              "dense": fnn.Dense(256, dtype=bf)}[layer]
        params = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(0), x))
        params["params"]["bias"] = (rng.randn(*params["params"]["bias"].shape) * 0.05).astype(np.float32)
        ref = jax.jit(jl.apply)(params, x)
        kernel, bias = params["params"]["kernel"], torch.from_numpy(params["params"]["bias"])
        xt = torch.from_numpy(x)
        if layer == "dense":
            mod = torch.nn.Linear(x.shape[1], 256)
            weight = torch.from_numpy(kernel.T.copy())
        elif layer == "conv":
            mod = torch.nn.Conv2d(8, 64, 7, stride=2, padding=3)
            weight, xt = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), xt.permute(0, 3, 1, 2)
        else:
            mod = torch.nn.ConvTranspose2d(64, 32, 4, stride=2)
            weight = torch.from_numpy(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
            xt = xt.permute(0, 3, 1, 2)
        with torch.no_grad():
            mod.weight.copy_(weight)
            mod.bias.copy_(bias)
            if layer == "dense":
                got = tf.dense(mod, xt.to(BF16))
            elif layer == "conv":
                got = tf.conv(mod, xt.contiguous().to(BF16)).permute(0, 2, 3, 1)
            else:
                got = tf._layer(mod, xt.contiguous().to(BF16), F.conv_transpose2d, stride=mod.stride)
                got = got.permute(0, 2, 3, 1)
    assert got.dtype == BF16
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    equal = float((got == ref).mean())
    record_property("bit_equal_fraction", equal)
    assert float(np.abs(got - ref).max()) <= float(_bf16_ulp(np.abs(ref).max()))
    assert equal == 1.0 if layer in ("dense", "upsample") else equal >= 0.999


@functools.lru_cache(maxsize=None)
def _jax_outputs(hw):
    """JAX's bf16 full and FAST_TEST networks and its float32 full network
    on a seeded (2, H, W, 8) input (jitted, as the package runs them)."""
    params = _params(hw)
    x = np.random.RandomState(1).rand(2, *hw, 8).astype(np.float32)
    out = {}
    for name, kw in (("bf16", dict(dtype=jnp.bfloat16)), ("f32", {}),
                     ("fast", dict(pred_flow=False, pred_mask=False, dtype=jnp.bfloat16))):
        res = jax.jit(JFlowNet(**kw).apply)(params, jnp.asarray(x))
        out[name] = {k: np.asarray(v) for k, v in res.items()}
    return x, out


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_bf16_network_matches_jax(hw, record_property):
    """The bf16 network against JAX's bf16 network on the same weights and
    input.  FAST_TEST rot and trans: within one bf16 ulp of the tensor's
    largest value (each a bf16 value in JAX, rot then normalised in
    float32).  Full heads: flow and mask logits within twice JAX's own
    bf16-vs-float32 gap."""
    x, j = _jax_outputs(hw)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        fast = _port(_params(hw), hw, full=False)(xt)
        full = _port(_params(hw), hw)(xt)
    assert sorted(fast) == ["rot", "trans"] and all(v.dtype == torch.float32 for v in full.values())
    for key in ("rot", "trans"):
        ref = j["fast"][key]
        tol = float(_bf16_ulp(np.abs(ref).max()))
        record_property(f"{key}_ulps_of_max", float(np.abs(fast[key].numpy() - ref).max()) / tol)
        np.testing.assert_allclose(fast[key].numpy(), ref, atol=tol, rtol=0, err_msg=key)
        np.testing.assert_array_equal(full[key].numpy(), fast[key].numpy())
    assert np.abs(j["fast"]["trans"]).max() > 1e-3
    for key in ("flow", "mask_logit"):
        got = full[key].permute(0, 2, 3, 1).numpy()
        err = float(np.abs(got - j["bf16"][key]).max())
        gap = float(np.abs(j["bf16"][key] - j["f32"][key]).max())
        record_property(f"{key}_err_over_jax_gap", err / gap)
        assert 0 < err <= 2 * gap, (key, err, gap)


def test_leaky_bf16_slope_and_gradient():
    """LeakyReLU in bf16 multiplies by bf16(0.1), as JAX's weak-typed
    constant, forward and backward, and keeps the derivative 1 at 0."""
    from deepim_tpu_torch.models.flownet import leaky

    x = np.random.RandomState(2).randn(4096).astype(np.float32)
    x[:4] = 0.0
    xb = torch.from_numpy(x).to(BF16).requires_grad_()
    y = leaky(xb)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, vjp = jax.vjp(lambda v: jax.nn.leaky_relu(v, 0.1), jx)
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)))
    g = np.random.RandomState(3).randn(4096).astype(np.float32)
    y.backward(torch.from_numpy(g).to(BF16))
    (jg,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    np.testing.assert_array_equal(xb.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)))
    assert torch.equal(xb.grad[:4], torch.from_numpy(g[:4]).to(BF16))


# --- the bf16 image zoom ---------------------------------------------------------


def test_bf16_zoom_matches_jax(rng):
    """affine_sample and zoom_images on bf16 images against jitted JAX: the
    weights rounded to bf16, the first product's float32 result kept,
    the output rounded once, so at most one bf16 ulp apart (measured: every
    value equal on this input)."""
    b, h, w = 3, 48, 64
    img = (rng.rand(b, 3, h, w) * 255.0 - 120.0).astype(np.float32)
    zf = [rng.uniform(0.3, 1.2, b).astype(np.float32)]
    zf = zf + [zf[0].copy(), rng.uniform(-0.5, 0.5, b).astype(np.float32),
               rng.uniform(-0.5, 0.5, b).astype(np.float32)]
    jzf, tzf = jsamp.ZoomFactor(*map(jnp.asarray, zf)), tsamp.ZoomFactor(*map(torch.from_numpy, zf))
    pm = np.array([123.68, 116.779, 103.939], np.float32)
    jb = jnp.asarray(img).astype(jnp.bfloat16)
    tb = torch.from_numpy(img).to(BF16)
    j_s = np.asarray(jax.jit(jsamp.affine_sample)(jb, jzf).astype(jnp.float32))
    t_s = tsamp.affine_sample(tb, tzf)
    assert t_s.dtype == BF16
    j_o, j_r = jax.jit(jzoom.zoom_images)(jb, jb[::-1], jzf, jnp.asarray(pm))
    t_o, t_r = tzoom.zoom_images(tb, tb.flip(0), tzf, torch.from_numpy(pm))
    for got, ref in ((t_s, j_s), (t_o, np.asarray(j_o.astype(jnp.float32))),
                     (t_r, np.asarray(j_r.astype(jnp.float32)))):
        got = got.float().numpy()
        assert (np.abs(got - ref) <= _bf16_ulp(ref)).all(), float(np.abs(got - ref).max())
    # float32 images are unchanged by the bf16 weight rounding (a no-op there).
    np.testing.assert_allclose(tsamp.affine_sample(torch.from_numpy(img), tzf).numpy(),
                               np.asarray(jax.jit(jsamp.affine_sample)(jnp.asarray(img), jzf)),
                               atol=1e-3, rtol=0)


# --- refine_step and refine ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _refine_setup():
    js = _build_scene(2, 64, 64, K64, num_iters=4, update_mask="box_rendered")
    t = build_scene(2, 64, 64, K64, num_iters=4, update_mask="box_rendered", device="cpu")
    img, mask = t.image.numpy(), t.mask.numpy()
    box = np.array(j_box_fill(jnp.asarray(mask)))
    j_obs = JObservation(jnp.asarray(img), jnp.asarray(box), jnp.asarray(mask), None, jnp.asarray(K64))
    t_obs = TObservation(torch.from_numpy(img), torch.from_numpy(box), torch.from_numpy(mask), None,
                         torch.from_numpy(K64))
    return js, t, j_obs, t_obs


@functools.lru_cache(maxsize=None)
def _refine_both():
    """refine_step and 4-iteration refine in both packages: bf16 networks
    and the bf16 image zoom on both sides, plus JAX's float32 run."""
    js, t, j_obs, t_obs = _refine_setup()
    params = _params((64, 64))
    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        j_ecfg = dataclasses.replace(js[0], zoom_dtype="bfloat16" if name == "bf16" else "float32")
        jm = JFlowNet(dtype=dt)
        step = jax.jit(lambda p, o, m, x: j_refine_step(p, jm, o, m, x, j_ecfg, iter_index=jnp.int32(0)))
        run = jax.jit(lambda p, o, m, x: j_refine(p, jm, o, m, x, j_ecfg))
        out[name] = (np.asarray(step(params, j_obs, js[3], jnp.asarray(t.pose0))[0]),
                     np.asarray(run(params, j_obs, js[3], jnp.asarray(t.pose0))[1]))
    ecfg = dataclasses.replace(t.ecfg, zoom_dtype="bfloat16")
    model = _port(params, (64, 64))
    with torch.no_grad():
        pose, aux = t_refine_step(model, t_obs, t.meshes, torch.from_numpy(t.pose0), ecfg, iter_index=0,
                                  device="cpu")
    _, poses = t_refine(model, t_obs, t.meshes, torch.from_numpy(t.pose0), ecfg, device="cpu")
    out["port"] = (pose.numpy(), poses.numpy(), aux)
    return out


def test_bf16_refine_step_matches_jax(record_property):
    """One refine_step in bf16 (network and image zoom) on both sides: the
    zoomed images bf16 in both, the new pose within twice JAX's own
    bf16-vs-float32 pose gap."""
    res = _refine_both()
    pose, _, aux = res["port"]
    assert aux["zoom_image_observed"].dtype == BF16
    err = float(np.abs(pose - res["bf16"][0]).max())
    gap = float(np.abs(res["bf16"][0] - res["f32"][0]).max())
    record_property("err_over_jax_gap", err / gap)
    assert err <= 2 * gap, (err, gap)
    assert np.abs(pose - _refine_setup()[1].pose0).max() > 1e-4


def test_bf16_refine_matches_jax(record_property):
    """refine, 4 iterations, in bf16 on both sides: every iteration's pose
    within twice JAX's own bf16-vs-float32 gap at that iteration."""
    res = _refine_both()
    poses, j16, j32 = res["port"][1], res["bf16"][1], res["f32"][1]
    assert poses.shape == (4, 2, 3, 4)
    for it in range(4):
        err = float(np.abs(poses[it] - j16[it]).max())
        gap = float(np.abs(j16[it] - j32[it]).max())
        record_property(f"iter{it}_err_over_jax_gap", err / gap)
        assert err <= 2 * gap, (it, err, gap)


# --- a training step ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _train_bf16():
    """One 2-inner-iteration train step on the dense scene of
    tests/test_torch_train.py: JAX bf16, JAX float32 and the port in bf16,
    from the same weights (the reference SGD recipe, lr 1e-3)."""
    from test_torch_train import _params as train_params

    j_ecfg, t_ecfg, bank_np, arrs = _setup("dense")
    jb, tb = _batches(arrs)
    params = train_params()
    sched = jlr.warmup_multifactor_schedule(1e-3, (10000,))
    tx = jtrain.make_optimizer(JConfig(), sched)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    j = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        jstate = JTrainState(jparams, tx.init(jparams), jnp.zeros((), jnp.int32))
        jstep = jax.jit(j_make_train_step(JFlowNet(dtype=dt), tx, j_ecfg, JTIC(**TICFG), "viz"))
        jstate, metrics, _ = jstep(jstate, jb, tuple(map(jnp.asarray, bank_np)))
        j[name] = (state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)),
                   {k: np.asarray(v) for k, v in metrics.items()})
    model = _port(params, (t_ecfg.height, t_ecfg.width))
    state = TrainState(model, ttrain.make_optimizer(model.parameters(), TrainConfig(),
                                                    tlr.warmup_multifactor_schedule(1e-3, (10000,))))
    step = ttrain.make_train_step(t_ecfg, TrainIterConfig(**TICFG), "viz", device="cpu")
    state, metrics, _ = step(state, tb, bank_np)
    return j, state, {k: v.numpy() for k, v in metrics.items()}, state_dict_from_flax(params)


def test_bf16_train_step_matches_jax(record_property):
    """A bf16 training step (losses float32, gradients to float32
    parameters) against JAX's bf16 step: every inner iteration's losses to
    rtol 1e-2, and each tensor's parameters after the step within twice
    JAX's own bf16-vs-float32 difference of that tensor plus 4 ulp of its
    magnitude."""
    j, state, t_m, sd0 = _train_bf16()
    (j16, m16), (j32, _) = j["bf16"], j["f32"]
    for key in ("pm_loss", "flow_loss", "mask_loss", "total"):
        assert np.isfinite(t_m[key]).all()
        record_property(f"{key}_rel_err", float(np.abs(t_m[key] / m16[key] - 1).max()))
        np.testing.assert_allclose(t_m[key], m16[key], rtol=1e-2, err_msg=key)
    assert not t_m["raster_dropped"].any()
    moved, worst = 0, 0.0
    for name, p in state.model.state_dict().items():
        assert p.dtype == torch.float32
        ref = j16[name].numpy()
        gap = float(np.abs(ref - j32[name].numpy()).max())
        atol = 4 * float(np.spacing(np.float32(np.abs(ref).max()))) + 2 * gap
        worst = max(worst, float(np.abs(p.numpy() - ref).max()) / max(gap, 1e-30))
        np.testing.assert_allclose(p.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        moved += not np.array_equal(p.numpy(), sd0[name].numpy())
    record_property("worst_param_err_over_jax_gap", worst)
    assert moved == len(sd0)
