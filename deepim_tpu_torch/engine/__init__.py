from deepim_tpu_torch.engine.refine import (
    EngineConfig,
    MeshBuffers,
    Observation,
    refine,
    refine_step,
    render_at_pose,
    tune_raster_for_bank,
)

__all__ = [
    "EngineConfig", "MeshBuffers", "Observation", "refine", "refine_step",
    "render_at_pose", "tune_raster_for_bank",
]
