"""Convert reference MXNet checkpoints to and from the port (counterpart of
deepim_tpu/tools/convert_mxnet_checkpoint.py, with its subcommands and
flags).

Import (deepim/train.py:165-195 load_param and init path):

    python -m deepim_tpu_torch.tools.convert_mxnet_checkpoint import \
        --params /path/to/flownet-0000.params --out /ckpts/flownet_init.npz \
        [--height 480 --width 640] [--input-depth] [--input-mask] \
        [--no-flow] [--no-mask-head] [--keep-bgr] [--lenient]

writes a .npz of the port's state_dict (keys such as
"convs.flow_conv1.weight"), which network.pretrained accepts, as it
accepts the flax-tree .npz the JAX converter writes.

Export:

    python -m deepim_tpu_torch.tools.convert_mxnet_checkpoint export \
        --npz /ckpts/trained.npz --out /path/deepim-0008.params
    python -m deepim_tpu_torch.tools.convert_mxnet_checkpoint export \
        --ckpt <output>/<prefix>_ckpt/8 --out /path/deepim-0008.params

writes a reference-format .params file (mx.nd.save layout) from either
kind of .npz or from a checkpoint of engine/checkpoint.py, so models
trained here load in the reference stack (lib/utils/load_model.py:10-37).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from deepim_tpu_torch.models.convert import state_dict_from_flax


def load_npz_params(path: str) -> dict:
    """A flat .npz of "a/b/c" keys (the JAX converter's save_npz_params) as
    the nested tree it was flattened from."""
    tree: dict = {}
    for key, arr in dict(np.load(path)).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_npz_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The port's state_dict from a .npz: the flax tree the JAX converter
    writes (keys ending in /kernel or /bias, through state_dict_from_flax)
    or this converter's own state_dict keys."""
    with np.load(path) as z:
        keys = list(z.keys())
        if keys and all(k.endswith(("/kernel", "/bias")) for k in keys):
            return state_dict_from_flax(load_npz_params(path))
        return {k: torch.from_numpy(np.array(z[k], np.float32)) for k in keys}


def save_npz_state_dict(path: str, state_dict) -> None:
    np.savez(path, **{k: v.detach().to("cpu", torch.float32).numpy() for k, v in state_dict.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import")
    imp.add_argument("--params", required=True, help="MXNet .params path")
    imp.add_argument("--out", required=True, help="output .npz path")
    imp.add_argument("--height", type=int, default=480)
    imp.add_argument("--width", type=int, default=640)
    imp.add_argument("--input-depth", action="store_true")
    imp.add_argument("--input-mask", action="store_true")
    imp.add_argument("--no-flow", action="store_true")
    imp.add_argument("--no-mask-head", action="store_true")
    imp.add_argument("--keep-bgr", action="store_true")
    imp.add_argument("--lenient", action="store_true", help="leave layers missing from the checkpoint at init")
    exp = sub.add_parser("export")
    src = exp.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", help="a .npz of this converter or of the JAX package's")
    src.add_argument("--ckpt", help="a checkpoint file of engine/checkpoint.py (<prefix>_ckpt/<epoch>)")
    exp.add_argument("--out", required=True)
    exp.add_argument("--height", type=int, default=480)
    exp.add_argument("--width", type=int, default=640)
    exp.add_argument("--keep-rgb", action="store_true")
    args = ap.parse_args(argv)

    from deepim_tpu_torch.models.import_mxnet import mxnet_from_state_dict, state_dict_from_mxnet
    from deepim_tpu_torch.utils.mxnet_io import load_mxnet_params, save_mxnet_params

    if args.cmd == "import":
        from deepim_tpu_torch.models.flownet import FlowNetDeepIM

        # Layers absent from the checkpoint (the heads of a vanilla FlowNet)
        # keep the seeded initialisation of a fresh model, as init_weights
        # does (deepIM_flownet.py:782-821).
        model = FlowNetDeepIM(in_channels=6 + 2 * args.input_depth + 2 * args.input_mask,
                              input_hw=(args.height, args.width), pred_flow=not args.no_flow,
                              pred_mask=not args.no_mask_head, generator=torch.Generator().manual_seed(0),
                              device="cpu")
        mx_params = load_mxnet_params(args.params)
        sd = state_dict_from_mxnet(mx_params, model, input_hw=(args.height, args.width),
                                   bgr_to_rgb=not args.keep_bgr, strict=not args.lenient)
        save_npz_state_dict(args.out, sd)
        print(f"wrote {args.out} ({len(mx_params)} source arrays)")
    else:
        if args.npz:
            sd = load_npz_state_dict(args.npz)
        else:
            sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)["model"]
        mx_params = mxnet_from_state_dict(sd, input_hw=(args.height, args.width), rgb_to_bgr=not args.keep_rgb)
        save_mxnet_params(args.out, mx_params)
        print(f"wrote {args.out} ({len(mx_params)} arrays)")


if __name__ == "__main__":
    main()
