"""Training-driver helpers shared with the test driver: the class-indexed
mesh bank and the network built from a Config (counterparts of
build_mesh_bank and build_model in deepim_tpu/tools/train_net.py; the
training loop itself, train_net, comes with the training driver).
"""
from __future__ import annotations

import os

import torch

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.device import resolve_device
from deepim_tpu_torch.models.flownet import FlowNetDeepIM
from deepim_tpu_torch.render.mesh import MeshBank, load_textured_mesh


def build_mesh_bank(cfg: Config):
    """Load every class's model from dataset.model_dir into one bank.
    Returns (vertices, colors, faces, face_valid) numpy arrays, the tuple
    MeshBuffers.gather takes."""
    if cfg.dataset.TEXTURE_SAMPLING:
        raise NotImplementedError("dataset.TEXTURE_SAMPLING is not ported yet (ROADMAP A8)")
    meshes = [load_textured_mesh(os.path.join(cfg.dataset.model_dir, cls))
              for cls in cfg.dataset.class_name]
    bank = MeshBank.from_meshes(meshes)
    return bank.vertices, bank.colors, bank.faces, bank.face_valid


def build_model(cfg: Config, dtype=torch.float32, device="cuda") -> FlowNetDeepIM:
    """The matching network for cfg at cfg's resolution with its heads, in
    eval mode, its weights drawn from a fixed seed (0, as the JAX package
    initialises from PRNGKey(0)).  float32 only until ROADMAP A5 (the JAX
    package builds its networks in bf16)."""
    if dtype != torch.float32:
        raise NotImplementedError("only float32 networks are ported (bf16 is ROADMAP A5)")
    if cfg.network.REGRESSOR_NUM > 1 or cfg.network.ROT_TYPE != "QUAT":
        raise NotImplementedError("REGRESSOR_NUM > 1 and ROT_TYPE EULER are not ported yet "
                                  "(ROADMAP A2)")
    return FlowNetDeepIM(
        in_channels=input_channels(cfg), input_hw=(cfg.height, cfg.width),
        pred_flow=cfg.network.PRED_FLOW, pred_mask=cfg.network.PRED_MASK,
        generator=torch.Generator().manual_seed(0), device=resolve_device(device),
    ).eval()


def input_channels(cfg: Config) -> int:
    return 6 + (2 if cfg.network.INPUT_DEPTH else 0) + (2 if cfg.network.INPUT_MASK else 0)

