"""Checkpoints: one file per epoch, <prefix>_ckpt/<epoch>, holding the
model's state_dict, the optimizer's state and the step (the naming of
deepim_tpu/engine/checkpoint.py, written with torch.save instead of
orbax).  Files are read with torch.load(weights_only=True).  A JAX
package's orbax checkpoint (a directory per epoch) is converted into one
on a host with JAX:

    python experiments/convert_orbax_checkpoint.py --cfg <yaml> --prefix <jax prefix> \
        --epoch N --out-prefix <port prefix>
"""
from __future__ import annotations

import os

import torch

from deepim_tpu_torch.engine.train import TrainState


def checkpoint_dir(prefix: str) -> str:
    return os.path.abspath(prefix + "_ckpt")


def checkpoint_path(prefix: str, epoch: int) -> str:
    return os.path.join(checkpoint_dir(prefix), str(epoch))


def save_checkpoint(prefix: str, epoch: int, state: TrainState) -> str:
    """Write the checkpoint for `epoch`, replacing one saved before for the
    same epoch.  Returns its path."""
    path = checkpoint_path(prefix, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opt = state.optimizer
    payload = {
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": None if opt is None else {
            "inner": opt.inner.state_dict(), "count": opt.count,
            "notfinite_count": opt.notfinite_count,
        },
        "step": int(state.step),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def read_checkpoint(prefix: str, epoch: int) -> dict:
    """The saved payload for `epoch` ({'model', 'optimizer', 'step'}), on
    the CPU."""
    path = checkpoint_path(prefix, epoch)
    if os.path.isdir(path):
        raise RuntimeError(f"{path} is a directory (an orbax checkpoint of the JAX package); convert it on a "
                           "host with JAX: python experiments/convert_orbax_checkpoint.py --cfg <yaml> --prefix "
                           f"<its prefix> --epoch {epoch} --out-prefix <another prefix>")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(prefix: str, epoch: int, state: TrainState,
                    allow_unexpected: frozenset[str] | set[str] = frozenset()) -> TrainState:
    """Load the checkpoint for `epoch` into `state` (its model, and its
    optimizer unless that is None) and return the state with the saved step.

    Every parameter the model has must be in the checkpoint; a saved
    parameter the model lacks raises unless its name is in
    `allow_unexpected` (the heads an eval model leaves out).  A model built
    on the meta device takes the saved tensors themselves, on the CPU."""
    payload = read_checkpoint(prefix, epoch)
    meta = any(p.is_meta for p in state.model.parameters())
    missing, unexpected = state.model.load_state_dict(payload["model"], strict=False, assign=meta)
    bad = sorted(set(unexpected) - set(allow_unexpected))
    if missing or bad:
        raise RuntimeError(f"checkpoint {checkpoint_path(prefix, epoch)} does not fit the model: "
                           f"missing {sorted(missing)}, unexpected {bad}")
    if state.optimizer is not None:
        saved = payload["optimizer"]
        if saved is None:
            raise RuntimeError(f"checkpoint {checkpoint_path(prefix, epoch)} holds no optimizer state")
        state.optimizer.inner.load_state_dict(saved["inner"])
        state.optimizer.count = saved["count"]
        state.optimizer.notfinite_count = saved["notfinite_count"]
    return TrainState(state.model, state.optimizer, payload["step"])


def merge_matching_params(fresh: dict, loaded: dict) -> tuple[dict, list[str]]:
    """Copy every entry of `loaded` whose name and shape match into a copy
    of `fresh` (both state_dicts); the others keep the fresh values.  A
    checkpoint trained at another resolution seeds every layer but fc6,
    whose input size scales with the frame.  Returns (merged, names kept
    fresh)."""
    merged, skipped = {}, []
    for k, v in fresh.items():
        src = loaded.get(k)
        if src is not None and tuple(src.shape) == tuple(v.shape):
            merged[k] = src.to(v.dtype)
        else:
            merged[k] = v
            skipped.append(k)
    return merged, skipped


def latest_epoch(prefix: str) -> int | None:
    d = checkpoint_dir(prefix)
    if not os.path.isdir(d):
        return None
    epochs = [int(x) for x in os.listdir(d) if x.isdigit()]
    return max(epochs) if epochs else None
