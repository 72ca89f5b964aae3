"""Host data loaders decoded on thread pools (counterpart of
deepim_tpu/data/loader.py).

TrainLoader yields shuffled epochs of TrainBatch (CPU tensors; the
training step moves them to the device) through a bounded prefetch queue
filled by a producer thread; TestLoader yields ordered numpy batches.

Determinism: every random draw of a training sample is keyed by
(SEED, epoch, global_slot), the sample's position in the global shuffled
stream, and the shuffle by (SEED, epoch).  Thread scheduling and process
sharding therefore cannot change a sample, and every process of a
multi-process run sees the same global batch order.  The test loader keys
each record's draws (TEST.MASK_DILATE) by its position in the pair list,
SeedSequence([17, index]).
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np
import torch

from deepim_tpu_torch.config import Config
from deepim_tpu_torch.data.preprocess import DecodeCache, VOCBackgrounds, make_test_sample, make_train_sample
from deepim_tpu_torch.engine.train import TrainBatch
from deepim_tpu_torch.utils import tracing


def _stack(samples: list[dict[str, np.ndarray]], key: str) -> np.ndarray:
    return np.stack([s[key] for s in samples])


def _default_processes() -> tuple[int, int]:
    """(rank, world size) of torch.distributed when it is initialised,
    else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


_END = object()

SEED = 0  # keys every draw, as the JAX TrainLoader's default seed
NUM_WORKERS = 2  # decode threads a batch is assembled on
PREFETCH = 2  # batches the producer thread assembles ahead
DECODE_CACHE_MB = 8192  # the DecodeCache's budget across epochs (0 disables it)


class TrainLoader:
    """Shuffled, epoch-based training batches.  `batch_size` is the global
    batch; process `process_index` of `process_count` assembles its
    contiguous slice of each one.  Give both or neither: without them they
    come from torch.distributed."""

    def __init__(
        self,
        pairdb: list[dict],
        cfg: Config,
        points_by_class: dict[str, np.ndarray],
        batch_size: int,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.pairdb = pairdb
        self.cfg = cfg
        self.points_by_class = points_by_class
        self.batch_size = batch_size
        if process_index is None and process_count is None:
            process_index, process_count = _default_processes()
        elif process_index is None or process_count is None:
            raise ValueError("give process_index and process_count together, or neither")
        self.process_index = process_index
        self.process_count = process_count
        if batch_size % self.process_count:
            raise ValueError(f"global batch {batch_size} not divisible by {self.process_count} processes")
        self.local_batch_size = batch_size // self.process_count
        self.class_name = list(cfg.dataset.class_name)
        self.k = torch.from_numpy(cfg.dataset.intrinsic_matrix())
        self._epoch_counter = 0
        self.voc = VOCBackgrounds(cfg.dataset.root_path)
        self.cache = DecodeCache(DECODE_CACHE_MB) if DECODE_CACHE_MB else None

    @property
    def epoch_size(self) -> int:
        return len(self.pairdb) // self.batch_size

    def _make_sample(self, rec: dict, epoch: int, global_slot: int) -> dict[str, np.ndarray]:
        words = np.random.SeedSequence([SEED, epoch, global_slot]).generate_state(8)
        rng = random.Random(int.from_bytes(words[:2].tobytes(), "little"))
        nprng = np.random.RandomState(words[2:])
        s = make_train_sample(rec, self.cfg, self.points_by_class[rec["gt_class"]], rng, nprng, self.voc,
                              cache=self.cache)
        s["class_index"] = np.int32(self.class_name.index(rec["gt_class"]))
        return s

    def _assemble(self, pool: ThreadPoolExecutor, recs: list[dict], epoch: int, slots: list[int]) -> TrainBatch:
        samples = list(pool.map(self._make_sample, recs, [epoch] * len(recs), slots))
        n = len(samples)

        def stacked(key: str, empty_shape: tuple[int, ...] | None = None):
            if key in samples[0]:
                return torch.from_numpy(_stack(samples, key))
            return None if empty_shape is None else torch.zeros((n, *empty_shape), dtype=torch.float32)

        return TrainBatch(
            image_observed=stacked("image_observed"),
            mask_observed=stacked("mask_observed"),
            mask_gt_observed=stacked("mask_gt_observed"),
            depth_gt_observed=stacked("depth_gt_observed"),
            pose_rendered=stacked("pose_rendered"),
            pose_observed=stacked("pose_observed"),
            class_index=stacked("class_index"),
            points_model=stacked("points_model", (1, 3)),
            points_weights=stacked("points_weights", (1,)),
            k=self.k,
            depth_observed=stacked("depth_observed"),
        )

    def epoch(self, epoch: int | None = None) -> Iterator[TrainBatch]:
        """One shuffled epoch, assembled ahead by a producer thread into a
        queue of PREFETCH batches.  `epoch` keys the shuffle and every
        sample's draws; when omitted an internal counter gives 0, 1, ... in
        call order.  An exception in the producer is raised here."""
        if epoch is None:
            epoch = self._epoch_counter
            self._epoch_counter += 1
        if self.cfg.TRAIN.SHUFFLE:
            shuffle_rng = np.random.RandomState(np.random.SeedSequence([SEED, epoch]).generate_state(8))
            order = shuffle_rng.permutation(len(self.pairdb)).tolist()
        else:
            order = list(range(len(self.pairdb)))
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                lo = self.process_index * self.local_batch_size
                with ThreadPoolExecutor(max_workers=NUM_WORKERS) as pool:
                    for bi in range(self.epoch_size):
                        slots = [bi * self.batch_size + lo + j for j in range(self.local_batch_size)]
                        recs = [self.pairdb[order[s]] for s in slots]
                        with tracing.span("loader.batch"):
                            tracing.count("loader.batches")
                            batch = self._assemble(pool, recs, epoch, slots)
                        if not put(batch):
                            return
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)
                return
            put(_END)

        thread = threading.Thread(target=producer, name="TrainLoader", daemon=True)
        thread.start()
        try:
            while True:
                with tracing.span("loader.wait"):
                    item = q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            closed.set()
            thread.join()


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
                with tracing.span("loader.batch"):
                    tracing.count("loader.batches")
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
