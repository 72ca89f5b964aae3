"""Pair database for the LM6d_refine dataset layout (copy of
deepim_tpu/data/pairdb.py, which names the reference file each part
re-implements).  The on-disk layout is

    <devkit>/data/observed/<scene>/<idx>-color.png / -depth.png / -label.png
    <devkit>/data/gt_observed/<class>/<idx>-color.png / -depth.png / -pose.txt
    <devkit>/data/rendered[/_val_PoseCNN]/<class>/<idx>_<k>-color.png /
        -depth.png / -pose.txt
    <devkit>/image_set/<set>.txt      (lines: "<observed_idx> <rendered_idx>")
    <devkit>/models/<class>/points.xyz, textured.obj, texture_map.png
    <devkit>/models/models_info.txt   (id ... diameter_mm ...)

A pair record holds file paths and poses; pixel data is loaded lazily by the
preprocessing stage.  The pairdb is cached to a pickle next to the data
(gt_pairdb).  Records hold only strings, numpy arrays and Python scalars,
so the two packages read each other's caches.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from deepim_tpu_torch.utils.native import load_points_xyz

# LINEMOD class table (LM6D_REFINE.py:70-86; bowl/cup excluded as in the
# reference).
LM_IDX2CLASS = {
    1: "ape", 2: "benchvise", 4: "camera", 5: "can", 6: "cat",
    8: "driller", 9: "duck", 10: "eggbox", 11: "glue",
    12: "holepuncher", 13: "iron", 14: "lamp", 15: "phone",
}
LM_CLASSES = tuple(sorted(LM_IDX2CLASS.values()))
# Objects evaluated with the symmetric ADI metric (LM6D_REFINE.py:420).
SYMMETRIC_CLASSES = ("eggbox", "glue", "bowl", "cup")


def load_pose_file(path: str) -> np.ndarray:
    """-pose.txt: one header line then a 3x4 [R|t] (LM6D_REFINE.py:196)."""
    return np.loadtxt(path, skiprows=1).astype(np.float32).reshape(3, 4)


def save_pose_file(path: str, pose: np.ndarray, header: str = "pose") -> None:
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in np.asarray(pose).reshape(3, 4):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")


@dataclass
class PairDB:
    """One (image_set x class) pair database."""

    name: str
    devkit_path: str
    image_set: str
    cur_class: str
    idx2class: dict[int, str] | None = None
    syn: bool = False  # LM6D_REFINE_SYN: synthetic observed data
    cache_dir: str | None = None

    def __post_init__(self):
        if self.idx2class is None:
            self.idx2class = self._discover_classes()
        self.classes = tuple(sorted(self.idx2class.values()))
        self.num_classes = len(self.classes)
        self.observed_data_path = os.path.join(self.devkit_path, "data", "observed")
        self.gt_observed_data_path = os.path.join(self.devkit_path, "data", "gt_observed")
        if self.image_set.startswith("PoseCNN_val"):
            self.rendered_data_path = os.path.join(self.devkit_path, "data", "rendered_val_PoseCNN")
        elif self.image_set.startswith(("train", "my_val", "my_minival", "val")):
            self.rendered_data_path = os.path.join(self.devkit_path, "data", "rendered")
        else:
            raise ValueError(f"unknown prefix of {self.image_set}")
        self.phase = "train" if self.image_set.startswith("train") else "val"
        self._points: dict[str, np.ndarray] = {}
        self._diameters: dict[str, float] = {}

    def _discover_classes(self) -> dict[int, str]:
        """Class table: the LINEMOD id map when the model dirs are LINEMOD
        classes (LM6D_REFINE.py:70-86); otherwise ids 1..N over the sorted
        models/ subdirectories (custom/synthetic datasets)."""
        models_dir = os.path.join(self.devkit_path, "models")
        if os.path.isdir(models_dir):
            dirs = sorted(
                d for d in os.listdir(models_dir)
                if os.path.isdir(os.path.join(models_dir, d))
            )
            if dirs and not set(dirs) <= set(LM_IDX2CLASS.values()):
                return {i + 1: name for i, name in enumerate(dirs)}
        return dict(LM_IDX2CLASS)

    # -- model data ---------------------------------------------------------
    def class2idx(self, class_name: str) -> int:
        for k, v in self.idx2class.items():
            if v == class_name:
                return k
        raise KeyError(class_name)

    def points(self, cls_name: str) -> np.ndarray:
        """models/<class>/points.xyz as (N, 3) float32 (LM6D_REFINE.py:101-110);
        the native parser when native/libdeepim_meshio.so loads, numpy
        otherwise."""
        if cls_name not in self._points:
            path = os.path.join(self.devkit_path, "models", cls_name, "points.xyz")
            self._points[cls_name] = load_points_xyz(path)
        return self._points[cls_name]

    def diameter(self, cls_name: str) -> float:
        """models/models_info.txt: 'id x diameter_mm ...' (LM6D_REFINE.py:112-126)."""
        if not self._diameters:
            path = os.path.join(self.devkit_path, "models", "models_info.txt")
            with open(path) as f:
                for line in f:
                    parts = line.strip().split()
                    if not parts:
                        continue
                    idx = int(parts[0])
                    if idx in self.idx2class:
                        self._diameters[self.idx2class[idx]] = float(parts[2]) / 1000.0
        return self._diameters[cls_name]

    # -- index / records ----------------------------------------------------
    def load_image_set_index(self) -> list[list[str]]:
        path = os.path.join(self.devkit_path, "image_set", self.image_set + ".txt")
        with open(path) as f:
            return [x.strip().split(" ") for x in f if x.strip()]

    def _obs_path(self, index: str, kind: str) -> str:
        return os.path.join(self.observed_data_path, f"{index}-{kind}.png")

    def _rend_path(self, index: str, kind: str) -> str:
        return os.path.join(self.rendered_data_path, f"{index}-{kind}.png")

    def load_pair_record(self, pair_index: list[str]) -> dict[str, Any]:
        """One pair record (LM6D_REFINE.py:225-261)."""
        obs_idx, rend_idx = pair_index[0], pair_index[1]
        cls = self.cur_class
        local = obs_idx.split("/")[-1]
        rec = {
            "gt_class": cls,
            "image_observed": self._obs_path(obs_idx, "color"),
            "image_rendered": self._rend_path(rend_idx, "color"),
            "depth_observed": self._obs_path(obs_idx, "depth"),
            "depth_gt_observed": os.path.join(self.gt_observed_data_path, cls, f"{local}-depth.png"),
            "depth_rendered": self._rend_path(rend_idx, "depth"),
            "mask_gt_observed": self._obs_path(obs_idx, "label"),
            "mask_idx": self.class2idx(cls),
            "pose_observed": load_pose_file(
                os.path.join(self.gt_observed_data_path, cls, f"{local}-pose.txt")
            ),
            "pose_rendered": load_pose_file(
                os.path.join(self.rendered_data_path, f"{rend_idx}-pose.txt")
            ),
            "pair_flipped": False,
            "img_flipped": False,
            "data_syn": self.syn,
        }
        return rec

    def gt_pairdb(self) -> list[dict[str, Any]]:
        """All pair records, with a pickle cache (LM6D_REFINE.py:198-218)."""
        cache_dir = self.cache_dir or os.path.join(self.devkit_path, "cache")
        os.makedirs(cache_dir, exist_ok=True)
        cache_file = os.path.join(
            cache_dir, f"{self.name}_{self.image_set}_{self.cur_class}_gt_pairdb.pkl"
        )
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        pairdb = [self.load_pair_record(p) for p in self.load_image_set_index()]
        with open(cache_file, "wb") as f:
            pickle.dump(pairdb, f, protocol=4)
        return pairdb


def get_flipped_pair_record(rec: dict[str, Any]) -> dict[str, Any]:
    """Exchange the observed and rendered roles of one pair
    (lib/dataset/imdb.py:202-217 get_flipped_pairs_entry, modernized to the
    live record schema: the reference's version still uses the retired
    *_real key names and cannot run).  The flipped observed side has no
    label image; its gt mask derives from the stored rendered depth
    (mask_gt_observed=None + depth_gt_observed > 0.2 in preprocessing)."""
    out = dict(rec)
    out.update(
        image_observed=rec["image_rendered"],
        image_rendered=rec["image_observed"],
        depth_observed=rec["depth_rendered"],
        depth_gt_observed=rec["depth_rendered"],
        depth_rendered=rec["depth_observed"],
        mask_gt_observed=None,
        pose_observed=rec["pose_rendered"],
        pose_rendered=rec["pose_observed"],
        pair_flipped=True,
    )
    return out


def append_flipped_pairs(pairdb: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Double the pairdb with observed<->rendered exchanged pairs
    (imdb.py:219-235 append_flipped_pairs; enabled via pair_flip in
    load_gt_pairdb, load_data.py:107)."""
    return pairdb + [get_flipped_pair_record(r) for r in pairdb]


def load_gt_pairdb(
    cfg,
    dataset_name: str,
    image_set: str,
    class_name: str,
    root_path: str,
    devkit_path: str,
    pair_flip: bool = False,
):
    """Factory mirroring lib/utils/load_data.py:92-111: LM6D_REFINE and
    LM6D_REFINE_SYN variants by name; pair_flip appends observed<->rendered
    exchanged pairs (TEST.FLIP_PAIR)."""
    syn = "SYN" in dataset_name.upper()
    db = PairDB(
        name=dataset_name,
        devkit_path=devkit_path,
        image_set=image_set,
        cur_class=class_name,
        syn=syn,
    )
    pairdb = db.gt_pairdb()
    if pair_flip:
        pairdb = append_flipped_pairs(pairdb)
    return db, pairdb


def merge_pairdb(pairdbs: list[list[dict]]) -> list[dict]:
    """Concatenate pair records from several sets (load_data.py:114-119)."""
    out: list[dict] = []
    for db in pairdbs:
        out.extend(db)
    return out
