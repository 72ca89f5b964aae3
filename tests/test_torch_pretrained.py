"""Pretrained weights in the port on the CPU: utils/mxnet_io.py,
models/import_mxnet.py, tools/convert_mxnet_checkpoint.py and
tools/train_net.py:init_pretrained against the JAX package's
counterparts.

Tolerances: .params files cross both ways bit for bit (and each package
writes the same bytes); the import equals state_dict_from_flax(flax_from_mxnet(...))
and the export equals mxnet_from_flax, array for array, bit for bit, at
64x64 (conv6 1x1, fc6's permutation the identity) and 128x192 (conv6 2x3);
the forwards agree in fp32 at tests/test_torch_flownet.py's tolerance (rot
and trans 1e-5, flow and mask logits 1e-4), with JAX's and with an
emulation of MXNet's operators on the raw arrays and BGR input."""
import functools
import os
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

from deepim_tpu.models import FlowNetDeepIM as JFlowNet  # noqa: E402
from deepim_tpu.models.import_mxnet import flax_from_mxnet, mxnet_from_flax  # noqa: E402
from deepim_tpu.tools.convert_mxnet_checkpoint import save_npz_params  # noqa: E402
from deepim_tpu.utils import mxnet_io as j_io  # noqa: E402
from deepim_tpu_torch.config import Config, update_config_dict  # noqa: E402
from deepim_tpu_torch.models import FlowNetDeepIM, state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.models.flownet import conv6_hw  # noqa: E402
from deepim_tpu_torch.models.import_mxnet import bilinear_kernel, mxnet_from_state_dict  # noqa: E402
from deepim_tpu_torch.models.import_mxnet import state_dict_from_mxnet  # noqa: E402
from deepim_tpu_torch.tools import convert_mxnet_checkpoint as t_convert  # noqa: E402
from deepim_tpu_torch.tools import train_net as t_train_net  # noqa: E402
from deepim_tpu_torch.utils import mxnet_io as t_io  # noqa: E402

torch.set_num_threads(2)

SIZES = [(64, 64), (128, 192)]
HEADS = ("fc6", "fc7", "rot", "trans", "mask_conv3")  # the layers a vanilla FlowNetS lacks
_CONVS = {"flow_conv1": (64, None, 7), "conv2": (128, 64, 5), "conv3": (256, 128, 5), "conv3_1": (256, 256, 3),
          "conv4": (512, 256, 3), "conv4_1": (512, 512, 3), "conv5": (512, 512, 3), "conv5_1": (512, 512, 3),
          "conv6": (1024, 512, 3), "conv6_1": (1024, 1024, 3), "Convolution1": (2, 1024, 3),
          "Convolution2": (2, 1026, 3), "Convolution3": (2, 770, 3), "mask_conv3": (1, 770, 3)}
_DECONVS = {"deconv5": (1024, 512), "deconv4": (1026, 256), "upsample_flow6to5": (2, 2), "upsample_flow5to4": (2, 2)}


@functools.lru_cache(maxsize=None)
def mx_params(hw, in_ch=8, heads=True, seed=0) -> dict:
    """Reference-named arrays with the reference's shapes at `hw`, drawn
    with fan-in scaled normals (a trained network's scale, so activations
    stay O(1) through the ladder) and small biases.  Without `heads`, a
    vanilla FlowNetS: no fc6/fc7/rot/trans, no mask head, but its frozen
    bilinear `upsampling_weight`.  Cached: callers do not modify it."""
    rng = np.random.default_rng(seed)
    h6, w6 = conv6_hw(*hw)
    p = {}

    def put(name, shape, fan_in, out):
        p[f"{name}_weight"] = rng.standard_normal(shape, np.float32) / np.float32(np.sqrt(fan_in))
        p[f"{name}_bias"] = rng.standard_normal(out, np.float32) * np.float32(0.01)

    for name, (cout, cin, k) in _CONVS.items():
        if heads or name != "mask_conv3":
            put(name, (cout, cin or in_ch, k, k), (cin or in_ch) * k * k, cout)
    for name, (cin, cout) in _DECONVS.items():
        put(name, (cin, cout, 4, 4), cin * 4, cout)
    if heads:
        for name, shape in {"fc6": (256, 1024 * h6 * w6), "fc7": (256, 256), "rot": (4, 256),
                            "trans": (3, 256)}.items():
            put(name, shape, shape[1], shape[0])
    else:
        p["upsampling_weight"] = bilinear_kernel(2)
    return p


@functools.lru_cache(maxsize=None)
def _template(hw):
    shapes = jax.eval_shape(JFlowNet(pred_flow=True, pred_mask=True).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 8)))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, np.float32) * np.float32(0.02), shapes)
    return tree, state_dict_from_flax(tree)


@functools.lru_cache(maxsize=None)
def _fresh(hw) -> dict:
    """build_model's seeded 8-channel network (the recipe's INPUT_MASK,
    flow and mask heads) at `hw`, as a state_dict."""
    return t_train_net.build_model(_cfg("", hw=hw), torch.float32, device="cpu").state_dict()


def _model(hw, state: dict) -> FlowNetDeepIM:
    """An 8-channel port network at `hw` holding copies of `state` (built on
    the meta device, so no weights are drawn)."""
    model = FlowNetDeepIM(in_channels=8, input_hw=hw, device="meta")
    model.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    return model


def jax_template(hw):
    """The JAX model's parameter tree at `hw` (shapes from eval_shape, no
    compile) filled with seeded values, and a port model holding the same
    values."""
    tree, state = _template(hw)
    return tree, _model(hw, state)


def _equal_dicts(a: dict, b: dict):
    assert list(a) == list(b) or set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# -- the .params format --------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["arg", "aux", ""])
@pytest.mark.parametrize("legacy", [False, True], ids=["int64_dims", "uint32_dims"])
def test_params_files_cross_both_ways(tmp_path, legacy, prefix):
    """The port reads what JAX writes and JAX reads what the port writes,
    bit for bit, with int64 (mxnet >= 1.5) and uint32 (<= 1.3) dims and
    each name prefix; both write the same bytes.  Integer and float16
    arrays round-trip too."""
    rng = np.random.RandomState(0)
    p = {"flow_conv1_weight": rng.randn(64, 6, 7, 7).astype(np.float32), "flow_conv1_bias": np.ones(64, np.float32),
         "deconv5_weight": rng.randn(64, 32, 4, 4).astype(np.float32), "fc7_weight": rng.randn(256, 256),
         "upsampling_weight": bilinear_kernel(2)}
    p["extra_i32"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    p["extra_f16"] = np.linspace(-1, 1, 5).astype(np.float16)
    p["extra_u8"] = np.arange(4, dtype=np.uint8)
    t_path, j_path = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    t_io.save_mxnet_params(t_path, p, prefix=prefix, legacy_uint32_dims=legacy)
    j_io.save_mxnet_params(j_path, p, prefix=prefix, legacy_uint32_dims=legacy)
    assert Path(t_path).read_bytes() == Path(j_path).read_bytes()
    for got in (t_io.load_mxnet_params(j_path), j_io.load_mxnet_params(t_path)):
        _equal_dicts(got, p)
        assert list(got) == list(p)
    raw = t_io.load_mxnet_params(t_path, strip_prefix=False)
    assert list(raw) == [f"{prefix}:{k}" if prefix else k for k in p]
    with pytest.raises(ValueError, match="not an MXNet"):
        t_io.load_mxnet_params(str(Path(__file__)))


# -- import and export against the JAX package ---------------------------------------

@pytest.mark.parametrize("hw", SIZES, ids=["64x64", "128x192"])
def test_import_equals_jax(hw):
    """state_dict_from_mxnet equals state_dict_from_flax(flax_from_mxnet(...))
    on every key, bit for bit: a full DeepIM checkpoint (8 channels) and a
    vanilla 6-channel FlowNetS (widened, heads kept from the template).  At
    128x192 fc6's column permutation is not the identity."""
    tree, model = jax_template(hw)
    for p, strict in ((mx_params(hw), True), (mx_params(hw, in_ch=6, heads=False), False)):
        got = state_dict_from_mxnet(p, model, input_hw=hw, strict=strict)
        ref = state_dict_from_flax(flax_from_mxnet(p, tree, input_hw=hw, strict=strict))
        assert set(got) == set(ref) == set(model.state_dict())
        _equal_dicts(got, {k: ref[k].numpy() for k in got})
    h6, w6 = conv6_hw(*hw)
    full = mx_params(hw)
    fc6 = state_dict_from_mxnet(full, model, input_hw=hw)["fc6.weight"].numpy()
    assert np.array_equal(fc6, full["fc6_weight"]) == (h6 * w6 == 1)


@pytest.mark.parametrize("hw", SIZES, ids=["64x64", "128x192"])
def test_export_equals_jax(tmp_path, hw):
    """mxnet_from_state_dict equals mxnet_from_flax array for array and in
    order, the synthesised upsamplers included, and the .params files the
    two write are the same bytes; export then import is the identity."""
    tree, model = jax_template(hw)
    sd = state_dict_from_mxnet(mx_params(hw), model, input_hw=hw)
    got = mxnet_from_state_dict(sd, input_hw=hw)
    ref = mxnet_from_flax(flax_from_mxnet(mx_params(hw), tree, input_hw=hw), input_hw=hw)
    assert list(got) == list(ref) and {"upsampling_weight", "mask_upsampling_weight"} <= set(got)
    _equal_dicts(got, ref)
    t_io.save_mxnet_params(str(tmp_path / "t.params"), got)
    j_io.save_mxnet_params(str(tmp_path / "j.params"), ref)
    assert (tmp_path / "t.params").read_bytes() == (tmp_path / "j.params").read_bytes()
    _equal_dicts(state_dict_from_mxnet(got, model, input_hw=hw), sd)
    _equal_dicts({k: v for k, v in got.items() if not k.endswith("upsampling_weight")}, mx_params(hw))


def _mx_forward(p, x_bgr, hw):
    """The reference symbol's forward (deepIM_flownet.py:63-230, :315-341)
    from MXNet's operator semantics, on the raw arrays: Convolution is
    conv2d (OIHW), Deconvolution is conv_transpose2d (IOHW), FC flattens
    NCHW (c, h, w)."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    acts, x = {}, x_bgr
    for name, s, pad in (("flow_conv1", 2, 3), ("conv2", 2, 2), ("conv3", 2, 2), ("conv3_1", 1, 1),
                         ("conv4", 2, 1), ("conv4_1", 1, 1), ("conv5", 2, 1), ("conv5_1", 1, 1), ("conv6", 2, 1),
                         ("conv6_1", 1, 1)):
        x = F.leaky_relu(F.conv2d(x, t[f"{name}_weight"], t[f"{name}_bias"], s, pad), 0.1)
        acts[name] = x
    c6, c5, c4 = acts["conv6_1"], acts["conv5_1"], acts["conv4_1"]
    fc = F.leaky_relu(F.linear(c6.reshape(c6.shape[0], -1), t["fc6_weight"], t["fc6_bias"]), 0.1)
    fc = F.leaky_relu(F.linear(fc, t["fc7_weight"], t["fc7_bias"]), 0.1)
    rot = F.linear(fc, t["rot_weight"], t["rot_bias"])
    out = {"rot": rot / rot.norm(dim=-1, keepdim=True), "trans": F.linear(fc, t["trans_weight"], t["trans_bias"])}

    def deconv(y, name, ref):
        y = F.conv_transpose2d(y, t[f"{name}_weight"], t[f"{name}_bias"], 2)
        return y[:, :, 1:1 + ref.shape[2], 1:1 + ref.shape[3]]

    def conv(y, name):
        return F.conv2d(y, t[f"{name}_weight"], t[f"{name}_bias"], 1, 1)

    cat2 = torch.cat([c5, F.leaky_relu(deconv(c6, "deconv5", c5), 0.1),
                      deconv(conv(c6, "Convolution1"), "upsample_flow6to5", c5)], 1)
    cat3 = torch.cat([c4, F.leaky_relu(deconv(cat2, "deconv4", c4), 0.1),
                      deconv(conv(cat2, "Convolution2"), "upsample_flow5to4", c4)], 1)
    for key, name, ch in (("flow", "Convolution3", 2), ("mask_logit", "mask_conv3", 1)):
        up = F.conv_transpose2d(conv(cat3, name), torch.from_numpy(bilinear_kernel(ch)), stride=16)
        out[key] = up[:, :, 8:8 + hw[0], 8:8 + hw[1]]
    return out


def test_forward_matches_jax_and_mxnet():
    """At 128x192 a vanilla 6-channel checkpoint widened into the recipe's
    8-channel network with heads from a full checkpoint: the port's fp32
    forward on RGB input equals JAX's forward of its own import, and the
    MXNet-semantics forward of the raw arrays on BGR input with the two
    extra channels at zero."""
    hw = (128, 192)
    full, vanilla = mx_params(hw, in_ch=6), mx_params(hw, in_ch=6, heads=False, seed=3)
    p = {**full, **vanilla}
    tree, model = jax_template(hw)
    model.load_state_dict(state_dict_from_mxnet(p, model, input_hw=hw))
    x = np.random.RandomState(5).rand(2, 8, *hw).astype(np.float32)
    x[:, 6:] = 0
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    j_out = JFlowNet(pred_flow=True, pred_mask=True).apply(flax_from_mxnet(p, tree, input_hw=hw),
                                                           jnp.asarray(x.transpose(0, 2, 3, 1)))
    bgr = torch.from_numpy(x[:, [2, 1, 0, 5, 4, 3]].copy())
    with torch.no_grad():
        mx = _mx_forward(p, bgr, hw)
    assert np.abs(got["trans"].numpy()).max() > 1e-2
    for key, tol in (("rot", 1e-5), ("trans", 1e-5), ("flow", 1e-4), ("mask_logit", 1e-4)):
        j = np.asarray(j_out[key])
        j = j.transpose(0, 3, 1, 2) if j.ndim == 4 else j
        np.testing.assert_allclose(got[key].numpy(), j, atol=tol, rtol=0, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), mx[key].numpy(), atol=tol, rtol=0, err_msg=key)


def test_channels_bgr_and_strictness():
    """flow_conv1 of a 6-channel checkpoint in an 8-channel model: its image
    blocks reversed (BGR -> RGB), the two extra channels zero; with
    bgr_to_rgb=False kept as stored.  A vanilla FlowNet raises in strict
    mode and, lenient (init_from_flownet), keeps every head of the model
    and imports the rest; more checkpoint channels than the model's and a
    wrong shape raise."""
    hw = (64, 64)
    _, model = jax_template(hw)
    vanilla = mx_params(hw, in_ch=6, heads=False)
    w = vanilla["flow_conv1_weight"]
    got = state_dict_from_mxnet(vanilla, model, input_hw=hw, strict=False)["convs.flow_conv1.weight"].numpy()
    np.testing.assert_array_equal(got[:, :6], w[:, [2, 1, 0, 5, 4, 3]])
    assert not got[:, 6:].any()
    kept = state_dict_from_mxnet(vanilla, model, input_hw=hw, bgr_to_rgb=False, strict=False)
    np.testing.assert_array_equal(kept["convs.flow_conv1.weight"].numpy()[:, :6], w)
    with pytest.raises(KeyError, match="mask_conv3_weight"):
        state_dict_from_mxnet(vanilla, model, input_hw=hw, strict=True)
    own = model.state_dict()
    lenient = state_dict_from_mxnet(vanilla, model, input_hw=hw, strict=False)
    for key in own:
        layer = key.rsplit(".", 1)[0]
        if layer in HEADS:
            assert torch.equal(lenient[key], own[key]), key
        else:
            assert not torch.equal(lenient[key], own[key]), key
    with pytest.raises(ValueError, match="input channels"):
        state_dict_from_mxnet(mx_params(hw, in_ch=10), model, input_hw=hw)
    with pytest.raises(ValueError, match="fc6"):
        state_dict_from_mxnet(mx_params((128, 192)), model, input_hw=hw)


# -- init_pretrained and the converter CLI ---------------------------------------------

def _cfg(pretrained: str, epoch: int = 0, init_from_flownet: bool = False, hw=(128, 192)):
    return update_config_dict(Config(), {"SCALES": list(hw), "network": {
        "pretrained": pretrained, "pretrained_epoch": epoch, "init_from_flownet": init_from_flownet,
        "INPUT_MASK": True, "PRED_FLOW": True, "PRED_MASK": True}})


@pytest.mark.parametrize("route", ["params_prefix", "params_epoch0", "jax_npz", "port_cli_npz"])
def test_init_pretrained_routes(tmp_path, route):
    """init_pretrained loads network.pretrained by each route: the
    reference's <prefix>-%04d.params (pretrained_epoch 5, and epoch 0
    where the bare prefix is no file) of a vanilla FlowNet with
    init_from_flownet (the heads keep build_model's seeded draw), the flax
    .npz the JAX converter's save_npz_params writes, and this port's
    converter output; each equal to the direct import."""
    hw = (128, 192)
    tree, _ = _template(hw)
    fresh = _fresh(hw)
    vanilla, full = mx_params(hw, in_ch=6, heads=False), mx_params(hw)
    if route.startswith("params"):
        epoch = 5 if route == "params_prefix" else 0
        t_io.save_mxnet_params(str(tmp_path / f"flownet-{epoch:04d}.params"), vanilla)
        cfg = _cfg(str(tmp_path / "flownet"), epoch, init_from_flownet=True)
        want = state_dict_from_mxnet(vanilla, fresh, input_hw=hw, strict=False)
    elif route == "jax_npz":
        save_npz_params(str(tmp_path / "init.npz"), flax_from_mxnet(full, tree, input_hw=hw))
        cfg = _cfg(str(tmp_path / "init.npz"))
        want = state_dict_from_flax(flax_from_mxnet(full, tree, input_hw=hw))
    else:
        t_io.save_mxnet_params(str(tmp_path / "full-0000.params"), full)
        t_convert.main(["import", "--params", str(tmp_path / "full-0000.params"), "--out", str(tmp_path / "cli.npz"),
                        "--height", "128", "--width", "192", "--input-mask"])
        cfg = _cfg(str(tmp_path / "cli.npz"))
        want = state_dict_from_mxnet(full, fresh, input_hw=hw)
    model = _model(hw, fresh)
    t_train_net.init_pretrained(cfg, model)
    got = model.state_dict()
    assert set(got) == set(want)
    _equal_dicts({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()})
    if route.startswith("params"):
        assert all(torch.equal(got[k], fresh[k]) for k in got if k.rsplit(".", 1)[0] in HEADS)
        with pytest.raises(KeyError, match="checkpoint is missing"):
            t_train_net.init_pretrained(_cfg(cfg.network.pretrained, cfg.network.pretrained_epoch), model)


def test_converter_cli_roundtrip(tmp_path):
    """The port's CLI: import a DeepIM checkpoint into a .npz, export that
    .npz and a train_net checkpoint holding the same weights back to
    .params: every source array returned bit for bit, the upsamplers
    added."""
    from deepim_tpu_torch.engine.checkpoint import save_checkpoint
    from deepim_tpu_torch.engine.train import TrainState

    hw = (128, 192)
    src = str(tmp_path / "deepim-0008.params")
    t_io.save_mxnet_params(src, mx_params(hw, in_ch=6))
    args = ["--height", "128", "--width", "192"]
    t_convert.main(["import", "--params", src, "--out", str(tmp_path / "imported.npz"), *args])
    t_convert.main(["export", "--npz", str(tmp_path / "imported.npz"), "--out", str(tmp_path / "a.params"), *args])
    sd = t_convert.load_npz_state_dict(str(tmp_path / "imported.npz"))
    model = FlowNetDeepIM(in_channels=6, input_hw=hw, device="meta")
    model.load_state_dict(sd, assign=True)
    save_checkpoint(str(tmp_path / "run"), 8, TrainState(model, None))
    t_convert.main(["export", "--ckpt", str(tmp_path / "run_ckpt" / "8"), "--out", str(tmp_path / "b.params"), *args])
    source = t_io.load_mxnet_params(src)
    for out in ("a.params", "b.params"):
        back = t_io.load_mxnet_params(str(tmp_path / out))
        assert set(back) == set(source) | {"upsampling_weight", "mask_upsampling_weight"}
        _equal_dicts({k: back[k] for k in source}, source)


def test_train_net_starts_from_pretrained(tmp_path, monkeypatch):
    """train_net loads network.pretrained into the model before the train
    step (and DDP) wraps it: the model handed to train_step_dp holds the
    import of the file over build_model's draw (heads kept)."""
    hw = (64, 64)
    devkit = _tiny_devkit(tmp_path)
    params = str(tmp_path / "flownet-0000.params")
    t_io.save_mxnet_params(params, mx_params(hw, in_ch=6, heads=False))
    cfg = update_config_dict(Config(), {
        "SCALES": [64, 64], "output_path": str(tmp_path / "out"),
        "dataset": {"dataset": "LM6D_REFINE", "dataset_path": devkit, "root_path": devkit, "image_set": "train_",
                    "model_dir": os.path.join(devkit, "models"), "class_name": ["cube"],
                    "INTRINSIC_MATRIX": [80.0, 0, 32.0, 0, 80.0, 32.0, 0, 0, 1], "ZNEAR": 0.05, "ZFAR": 10.0},
        "network": {"pretrained": params, "init_from_flownet": True, "INPUT_MASK": True, "PRED_FLOW": True,
                    "PRED_MASK": True},
        "TRAIN": {"BATCH_PAIRS": 2}})
    seen, built = {}, {}

    class Stop(Exception):
        pass

    def spy(step, mesh, state, unused):
        seen.update({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        raise Stop

    def build(*args, **kwargs):
        model = build_model(*args, **kwargs)
        built.update({k: v.detach().clone() for k, v in model.state_dict().items()})
        return model

    build_model = t_train_net.build_model
    monkeypatch.setattr(t_train_net, "build_model", build)
    monkeypatch.setattr(t_train_net, "train_step_dp", spy)
    with pytest.raises(Stop):
        t_train_net.train_net(cfg, output_dir=str(tmp_path / "run"), device="cpu")
    want = state_dict_from_mxnet(t_io.load_mxnet_params(params), built, input_hw=hw, strict=False)
    assert set(want) == set(built) and any(not torch.equal(want[k], built[k]) for k in want)
    _equal_dicts({k: v.numpy() for k, v in seen.items()}, {k: v.numpy() for k, v in want.items()})


def _tiny_devkit(tmp_path) -> str:
    from deepim_tpu_torch.render.mesh import make_test_cube
    from deepim_tpu_torch.render.rasterizer import RasterConfig
    from deepim_tpu_torch.tools.synth_data import generate_dataset

    path = str(tmp_path / "devkit")
    k = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
    generate_dataset(path, {"cube": make_test_cube(0.08)}, k, n_train=2, n_val=0, height=64, width=64,
                     z_range=(0.45, 0.6), raster_cfg=RasterConfig(height=64, width=64, tile_h=16, tile_w=16,
                                                                   max_faces_per_tile=128, znear=0.05, zfar=10.0),
                     device="cpu")
    return path
