from deepim_tpu_torch.data.loader import TestLoader, TrainLoader
from deepim_tpu_torch.data.pairdb import (
    LM_CLASSES,
    LM_IDX2CLASS,
    SYMMETRIC_CLASSES,
    PairDB,
    load_gt_pairdb,
    merge_pairdb,
)

__all__ = ["TestLoader", "TrainLoader", "LM_CLASSES", "LM_IDX2CLASS", "SYMMETRIC_CLASSES", "PairDB",
           "load_gt_pairdb", "merge_pairdb"]
