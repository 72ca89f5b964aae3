from deepim_tpu_torch.engine.losses import (
    flow_loss,
    mask_loss,
    point_matching_loss,
    se3_dist_loss,
    smooth_l1,
)
from deepim_tpu_torch.engine.lr_schedule import lr_steps_from_config, warmup_multifactor_schedule
from deepim_tpu_torch.engine.refine import (
    EngineConfig,
    LightParams,
    MeshBuffers,
    Observation,
    refine,
    refine_step,
    render_at_pose,
    tune_raster_for_bank,
)
from deepim_tpu_torch.engine.tracker import make_tracker, track_video_sharded
from deepim_tpu_torch.engine.train import (
    Optimizer,
    TrainBatch,
    TrainState,
    compute_losses,
    flow_weights_from_valid,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "flow_loss", "mask_loss", "point_matching_loss", "se3_dist_loss", "smooth_l1",
    "lr_steps_from_config", "warmup_multifactor_schedule",
    "EngineConfig", "LightParams", "MeshBuffers", "Observation", "refine", "refine_step",
    "render_at_pose", "tune_raster_for_bank",
    "make_tracker", "track_video_sharded",
    "Optimizer", "TrainBatch", "TrainState", "compute_losses", "flow_weights_from_valid",
    "make_optimizer", "make_train_step",
]
