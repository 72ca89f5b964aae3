"""Ordered test batches decoded on a thread pool (the TestLoader of
deepim_tpu/data/loader.py; its TrainLoader comes with the training
driver).

Batches are numpy dicts, decoded by two threads; the driver moves them to
the device.  Each record's random draws (TEST.MASK_DILATE) come from a
generator keyed by the record's position in the pair list,
SeedSequence([17, index]), so batching and thread scheduling cannot change
a sample.
"""
from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.data.preprocess import make_test_sample


def _stack(samples: list[dict[str, np.ndarray]], key: str) -> np.ndarray:
    return np.stack([s[key] for s in samples])


class TestLoader:
    """Ordered test batches; the last batch is padded to full size with
    repeats of the last record, and each batch comes with its number of
    valid samples."""

    __test__ = False  # not a pytest class

    def __init__(self, pairdb: list[dict], cfg: Config, batch_size: int):
        self.pairdb = pairdb
        self.cfg = cfg
        self.batch_size = batch_size
        self.class_name = list(cfg.dataset.class_name)
        self.k = cfg.dataset.intrinsic_matrix()

    def __len__(self) -> int:
        return -(-len(self.pairdb) // self.batch_size)

    def _make_sample(self, rec: dict, index: int) -> dict[str, np.ndarray]:
        rng = random.Random(
            int.from_bytes(np.random.SeedSequence([17, index]).generate_state(2).tobytes(), "little")
        )
        s = make_test_sample(rec, self.cfg, rng)
        s["class_index"] = np.int32(self.class_name.index(rec["gt_class"]))
        return s

    def batches(self) -> Iterator[tuple[dict[str, Any], int]]:
        n = len(self.pairdb)
        with ThreadPoolExecutor(max_workers=2) as pool:
            for start in range(0, n, self.batch_size):
                idxs = [min(start + j, n - 1) for j in range(self.batch_size)]
                recs = [self.pairdb[i] for i in idxs]
                valid = min(self.batch_size, n - start)
                samples = list(pool.map(self._make_sample, recs, idxs))
                batch = {
                    "image_observed": _stack(samples, "image_observed"),
                    "mask_observed": _stack(samples, "mask_observed"),
                    "pose_rendered": _stack(samples, "pose_rendered"),
                    "pose_observed": _stack(samples, "pose_observed"),
                    "class_index": _stack(samples, "class_index"),
                    "k": self.k,
                }
                if "depth_observed" in samples[0]:
                    batch["depth_observed"] = _stack(samples, "depth_observed")
                yield batch, valid
