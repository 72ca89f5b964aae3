"""Training configuration sections (field-for-field copies of
deepim_tpu/config.py's TrainConfig and TrainIterConfig, so values copy
across; see the JAX file for each field's origin in the reference)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"
    warmup: bool = False
    warmup_lr: float = 0.0
    warmup_step: int = 0
    begin_epoch: int = 0
    end_epoch: int = 0
    lr: float = 1e-4
    lr_step: str = "4, 6"
    momentum: float = 0.975
    wd: float = 0.0005
    # Global-norm gradient clipping; 0 disables.
    grad_clip: float = 0.0
    # Skip updates whose gradients are not finite (optax.apply_if_finite,
    # 100 consecutive errors at most).
    skip_nonfinite: bool = True
    model_prefix: str = "deepim"
    CHECKPOINT_INTERVAL: int = 1
    RESUME: bool = False
    SHUFFLE: bool = True
    BATCH_PAIRS: int = 1
    # 'all' | 'viz' | 'valid' | 'viz_visible'
    FLOW_WEIGHT_TYPE: str = "all"
    TENSORBOARD_LOG: bool = False
    INIT_MASK: str = "box_gt"
    UPDATE_MASK: str = "box_gt"
    MASK_DILATE: bool = False
    REPLACE_OBSERVED_BG_RATIO: float = 0.0
    VISUALIZE: bool = False


@dataclass(frozen=True)
class TrainIterConfig:
    SE3_DIST_LOSS: bool = False
    LW_ROT: float = 0.0
    LW_TRANS: float = 0.0
    TRANS_LOSS_TYPE: str = "L2"
    TRANS_SMOOTH_L1_SCALAR: float = 3.0
    SE3_PM_LOSS: bool = False
    LW_PM: float = 0.0
    SE3_PM_LOSS_TYPE: str = "L1"
    SE3_PM_SL1_SCALAR: float = 1.0
    NUM_3D_SAMPLE: int = -1
    LW_FLOW: float = 0.0
    LW_MASK: float = 0.0
