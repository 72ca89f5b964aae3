#!/usr/bin/env python3
"""Convert a JAX-package checkpoint (orbax, a directory <prefix>_ckpt/<epoch>)
into the PyTorch port's checkpoint file (deepim_tpu_torch/engine/checkpoint.py):

    python experiments/convert_orbax_checkpoint.py --cfg <yaml> --prefix <jax prefix> \
        --epoch N --out-prefix <port prefix>

It needs a host with JAX and orbax: it reads the checkpoint through the JAX
package's own engine/checkpoint.py:load_checkpoint (with no template, so it
takes the checkpoint's structure).  The port reads the file it writes on
any host.  The two checkpoints share the path <prefix>_ckpt/<epoch> (a
directory for JAX, a file for the port), so --out-prefix must differ from
--prefix.  A test_deepim or a resumed train_net of the port then points its
output directory (or TRAIN.model_prefix) at the new prefix.

cfg builds the port's network and optimizer, as train_net builds them, and
the checkpoint goes into them:
  * the parameters through models/convert.py:state_dict_from_flax; every
    parameter of the network must be there;
  * the optimizer state of deepim_tpu/engine/train.py:make_optimizer:
    optax.sgd's trace -> SGD momentum_buffer; optax.adamw's mu / nu /
    count -> AdamW exp_avg / exp_avg_sq / step; the learning-rate
    schedule's count -> Optimizer.count; apply_if_finite's
    notfinite_count -> Optimizer.notfinite_count.  clip_by_global_norm and
    add_decayed_weights hold no state.  A part the cfg's optimizer needs
    that the checkpoint lacks, or one it cannot place, raises and names it;
  * the step.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from deepim_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from deepim_tpu.engine.train import TrainState as JaxTrainState  # noqa: E402
from deepim_tpu_torch.config import Config, load_config  # noqa: E402
from deepim_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from deepim_tpu_torch.engine.train import Optimizer, TrainState, make_optimizer  # noqa: E402
from deepim_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from deepim_tpu_torch.tools.train_net import build_model  # noqa: E402


def optimizer_parts(opt_state) -> dict:
    """The stateful parts of a restored optax state (orbax gives named
    tuples as dicts, tuples as lists, empty states as None): lists under
    'trace', 'adam', 'schedule_count' and 'notfinite_count'."""
    parts = {"trace": [], "adam": [], "schedule_count": [], "notfinite_count": []}

    def walk(node, where):
        if node is None:
            return
        if isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{where}[{i}]")
        elif isinstance(node, dict) and "notfinite_count" in node and "inner_state" in node:
            parts["notfinite_count"].append(int(np.asarray(node["notfinite_count"])))
            walk(node["inner_state"], f"{where}.inner_state")
        elif isinstance(node, dict) and set(node) == {"trace"}:
            parts["trace"].append(node["trace"])
        elif isinstance(node, dict) and set(node) == {"count", "mu", "nu"}:
            parts["adam"].append(node)
        elif isinstance(node, dict) and set(node) == {"count"}:
            parts["schedule_count"].append(int(np.asarray(node["count"])))
        else:
            keys = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"optimizer state part {where} ({keys}) is none the port's optimizer holds")

    walk(opt_state, "opt_state")
    return parts


def _one(parts: dict, name: str, what: str):
    if len(parts[name]) != 1:
        raise ValueError(f"the checkpoint's optimizer state holds {len(parts[name])} {what}; want one")
    return parts[name][0]


def _per_parameter(model: torch.nn.Module, tree, what: str) -> dict:
    """A params-shaped moment tree -> {parameter: tensor} in the port's
    layout (the same transposes as the weights: the updates are
    elementwise)."""
    moments = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    out = {}
    for name, p in model.named_parameters():
        if name not in moments:
            raise ValueError(f"the checkpoint's {what} has no entry for parameter {name}")
        if tuple(moments[name].shape) != tuple(p.shape):
            raise ValueError(f"the checkpoint's {what} of {name} has shape {tuple(moments[name].shape)}, "
                             f"the parameter {tuple(p.shape)}")
        out[p] = moments[name]
    return out


def load_optimizer_state(opt: Optimizer, model: torch.nn.Module, opt_state, cfg: Config) -> None:
    """Fill the port's optimizer (made from cfg.TRAIN) from a restored
    optax state of make_optimizer's chain for the same TRAIN settings."""
    parts = optimizer_parts(opt_state)
    name = cfg.TRAIN.optimizer.lower()
    if name == "sgd":
        if not parts["trace"]:
            raise ValueError("TRAIN.optimizer is sgd, but the checkpoint's optimizer state has no optax trace "
                             "(the SGD momentum)")
        for p, buf in _per_parameter(model, _one(parts, "trace", "optax traces"), "SGD trace").items():
            opt.inner.state[p] = {"momentum_buffer": buf}
    else:
        if not parts["adam"]:
            raise ValueError("TRAIN.optimizer is adam, but the checkpoint's optimizer state has no optax "
                             "scale_by_adam state (mu, nu, count)")
        adam = _one(parts, "adam", "scale_by_adam states")
        mu = _per_parameter(model, adam["mu"], "adam mu")
        nu = _per_parameter(model, adam["nu"], "adam nu")
        step = float(np.asarray(adam["count"]))
        for p in mu:
            opt.inner.state[p] = {"step": torch.tensor(step), "exp_avg": mu[p], "exp_avg_sq": nu[p]}
    if not parts["schedule_count"]:
        raise ValueError("the checkpoint's optimizer state has no learning-rate schedule count")
    opt.count = _one(parts, "schedule_count", "schedule counts")
    if cfg.TRAIN.skip_nonfinite != bool(parts["notfinite_count"]):
        raise ValueError(f"TRAIN.skip_nonfinite is {cfg.TRAIN.skip_nonfinite}, but the checkpoint's optimizer "
                         f"state {'has' if parts['notfinite_count'] else 'has no'} apply_if_finite's "
                         "notfinite_count")
    if parts["notfinite_count"]:
        opt.notfinite_count = _one(parts, "notfinite_count", "apply_if_finite states")


def convert(cfg: Config, prefix: str, epoch: int, out_prefix: str) -> str:
    """Read the JAX checkpoint <prefix>_ckpt/<epoch>, write the port's
    <out_prefix>_ckpt/<epoch>; returns its path."""
    if os.path.abspath(prefix) == os.path.abspath(out_prefix):
        raise ValueError("--out-prefix must differ from --prefix: both checkpoints live at <prefix>_ckpt/<epoch>")
    restored = jax_load_checkpoint(prefix, epoch, JaxTrainState(None, None, 0))
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    state_dict = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, restored.params))
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if missing or unexpected:
        raise ValueError(f"the checkpoint's parameters do not fit cfg's network: missing {sorted(missing)}, "
                         f"unexpected {sorted(unexpected)}")
    opt = None
    if jax.tree_util.tree_leaves(restored.opt_state):
        opt = make_optimizer(model.parameters(), cfg.TRAIN, lambda count: cfg.TRAIN.lr)
        load_optimizer_state(opt, model, restored.opt_state, cfg)
    return save_checkpoint(out_prefix, epoch, TrainState(model, opt, int(np.asarray(restored.step))))


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, help="the run's YAML config (network and TRAIN optimizer)")
    ap.add_argument("--prefix", required=True, help="the JAX checkpoint's prefix (<prefix>_ckpt/<epoch>)")
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--out-prefix", required=True, help="the port's checkpoint prefix; must differ from --prefix")
    args = ap.parse_args(argv)
    path = convert(load_config(args.cfg), args.prefix, args.epoch, args.out_prefix)
    print(path)
    return path


if __name__ == "__main__":
    main()
