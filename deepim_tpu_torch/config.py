"""Layered configuration: typed dataclass defaults with strict YAML
overrides (field-for-field copy of deepim_tpu/config.py, so values copy
across; see the JAX file for each field's origin in the reference).

Experiment files are read with utils/yaml_subset.py; unknown keys raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

from deepim_tpu_torch.utils.yaml_subset import load_file

DEFAULT_K = (
    (572.4114, 0.0, 325.2611),
    (0.0, 573.57043, 242.04899),
    (0.0, 0.0, 1.0),
)


@dataclass(frozen=True)
class NetworkConfig:
    PIXEL_MEANS: tuple[float, float, float] = (0.0, 0.0, 0.0)  # RGB order
    pretrained: str = ""
    pretrained_epoch: int = 0
    init_from_flownet: bool = False
    skip_initialize: bool = False
    INPUT_DEPTH: bool = False
    INPUT_MASK: bool = False
    PRED_MASK: bool = False
    PRED_FLOW: bool = False
    STANDARD_FLOW_REP: bool = False
    TRAIN_ITER: bool = False
    TRAIN_ITER_SIZE: int = 1
    REGRESSOR_NUM: int = 1
    ROT_TYPE: str = "QUAT"  # 'QUAT' | 'EULER'
    ROT_COORD: str = "CAMERA"
    TRANS_LOSS_TYPE: str = "L2"
    FIXED_PARAMS: tuple[str, ...] = ()


@dataclass(frozen=True)
class DatasetConfig:
    dataset: str = "LM6D_REFINE"
    dataset_path: str = "./data/LINEMOD_6D/LM6d_converted/LM6d_refine"
    image_set: str = "train_ape"
    root_path: str = "./data"
    test_image_set: str = "val_ape"
    model_dir: str = ""
    model_file: str = ""
    pose_file: str = ""
    DEPTH_FACTOR: float = 1000.0
    NORMALIZE_FLOW: float = 1.0
    NORMALIZE_3D_POINT: float = 0.1
    INTRINSIC_MATRIX: tuple = DEFAULT_K
    ZNEAR: float = 0.25
    ZFAR: float = 6.0
    NUM_CLASSES: int = 1
    # Per-fragment texture sampling in the render (render/rasterizer.py:texture_gather).
    TEXTURE_SAMPLING: bool = False
    class_name_file: str = ""
    class_name: tuple[str, ...] = ()
    trans_means: tuple[float, float, float] = (0.0, 0.0, 0.0)
    trans_stds: tuple[float, float, float] = (1.0, 1.0, 1.0)

    def intrinsic_matrix(self) -> np.ndarray:
        return np.asarray(self.INTRINSIC_MATRIX, np.float32).reshape(3, 3)


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


@dataclass(frozen=True)
class TestConfig:
    __test__ = False  # not a pytest class

    BATCH_PAIRS: int = 1
    test_epoch: int = 0
    VISUALIZE: bool = False
    test_iter: int = 1
    INIT_MASK: str = "box_rendered"
    UPDATE_MASK: str = "box_rendered"
    FAST_TEST: bool = False
    PRECOMPUTED_ICP: bool = False
    BEFORE_ICP: bool = False
    FLIP_PAIR: bool = False
    VIS_VIDEO: bool = False
    MASK_DILATE: bool = False


@dataclass(frozen=True)
class Config:
    output_path: str = "./output"
    symbol: str = "deepim_flownet"
    SCALES: tuple[tuple[int, int], ...] = ((480, 640),)
    MXNET_VERSION: str = ""  # accepted for reference-yaml compatibility
    default: tuple = ()      # reference 'default' section (frequent/kvstore)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    train_iter: TrainIterConfig = field(default_factory=TrainIterConfig)

    @property
    def height(self) -> int:
        return self.SCALES[0][0]

    @property
    def width(self) -> int:
        return self.SCALES[0][1]


def _coerce(value: Any, target: Any) -> Any:
    """YAML value -> the field's shape (lists become tuples; null becomes
    an empty tuple or string where the field is one)."""
    if isinstance(value, list):
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    if value is None and isinstance(target, (tuple, str)):
        return () if isinstance(target, tuple) else ""
    return value


def _update_section(section: Any, overrides: dict) -> Any:
    valid = {f.name for f in dataclasses.fields(section)}
    updates = {}
    for k, v in overrides.items():
        if k == "NORMALIZE_ROT":  # present in reference yamls, unused there too
            continue
        if k not in valid:
            raise ValueError(f"key: {k} does not exist in config section {type(section).__name__}")
        cur = getattr(section, k)
        v = _coerce(v, cur)
        if k == "INTRINSIC_MATRIX" and v is not None:
            v = tuple(map(tuple, np.asarray(v, np.float32).reshape(3, 3).tolist()))
        if k in ("trans_means", "trans_stds", "PIXEL_MEANS") and v is not None:
            v = tuple(np.asarray(v, np.float32).flatten().tolist())
        updates[k] = v
    return replace(section, **updates)


def update_config(cfg: Config, config_file: str) -> Config:
    """Apply a YAML experiment file over `cfg`; unknown keys raise."""
    return update_config_dict(cfg, load_file(config_file))


def update_config_dict(cfg: Config, exp: dict) -> Config:
    updates: dict[str, Any] = {}
    for k, v in exp.items():
        if not hasattr(cfg, k):
            raise ValueError(f"key: {k} does not exist in config")
        if isinstance(v, dict):
            if k == "default":
                updates[k] = tuple(sorted(v.items()))
                continue
            section = getattr(cfg, k)
            sec = _update_section(section, v)
            if k == "dataset" and v.get("class_name_file"):
                with open(v["class_name_file"]) as f:
                    sec = replace(sec, class_name=tuple(line.strip() for line in f))
            updates[k] = sec
        elif k == "SCALES":
            updates[k] = (tuple(v),)
        else:
            updates[k] = _coerce(v, getattr(cfg, k))
    return replace(cfg, **updates)


def validate_config(cfg: Config) -> Config:
    """Cross-field checks, so no accepted value is silently ignored."""
    if cfg.network.ROT_TYPE not in ("QUAT", "EULER"):
        raise ValueError(f"network.ROT_TYPE must be QUAT or EULER, got {cfg.network.ROT_TYPE!r}")
    if cfg.network.ROT_COORD.lower() not in ("model", "camera", "camera_new", "naive"):
        raise ValueError(f"Unknown network.ROT_COORD {cfg.network.ROT_COORD!r}")
    if cfg.network.TRAIN_ITER_SIZE > 1 and not cfg.network.TRAIN_ITER:
        raise ValueError("network.TRAIN_ITER_SIZE > 1 requires network.TRAIN_ITER: true")
    if cfg.train_iter.SE3_DIST_LOSS and cfg.network.ROT_TYPE != "QUAT":
        raise ValueError("train_iter.SE3_DIST_LOSS requires network.ROT_TYPE='QUAT'")
    if cfg.TRAIN.optimizer.lower() not in ("sgd", "adam"):
        raise ValueError(f"Unknown TRAIN.optimizer {cfg.TRAIN.optimizer!r}")
    if cfg.TRAIN.FLOW_WEIGHT_TYPE not in ("all", "viz", "valid", "viz_visible"):
        raise ValueError(f"Unknown TRAIN.FLOW_WEIGHT_TYPE {cfg.TRAIN.FLOW_WEIGHT_TYPE!r}")
    if cfg.train_iter.SE3_PM_LOSS and cfg.train_iter.NUM_3D_SAMPLE <= 0:
        raise ValueError("SE3_PM_LOSS requires train_iter.NUM_3D_SAMPLE > 0")
    return cfg


def load_config(config_file: str | None = None) -> Config:
    cfg = Config()
    if config_file:
        cfg = update_config(cfg, config_file)
    return validate_config(cfg)
