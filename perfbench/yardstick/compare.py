"""The numbers that decide `correct`, each the program's output against
the plain reference's on the same inputs.

Refinement: pose_gap, the root mean square over compared calls,
iterations and samples of each sample's relative gap: the mean distance
between the model points under the program's and the reference's pose,
over the median (over the batch) distance the reference moved them from
the initial pose by that iteration.  A mean of squares, not the widest
gap: where a rounding moves a mask's edge by a pixel, the crop and so one
sample's next input change, and the widest gap swings from seed to seed by
4x (PERF.md); a wrong answer of the size of the refinement's own step
still weighs in.

Training: loss_gap, the widest relative gap of each loss (pm, flow, mask,
total) of the first compared step's inner iterations, and of the step's
loss (the total the optimizer takes) of every inner iteration of the
compared steps.  Not every loss of every step: a later step's flow loss
swings with a pixel of its flow labels (one seed in fifteen read 10x the
rest there, PERF.md), where the first step's parts and every step's total
stay steady; grad_gap, by the
worst leaf, the gap between the norms of the program's and the reference's
gradient as the optimizer got it over the first step (its momentum buffer
less the weight decay of the unchanged initial parameters), over the
larger of the reference leaf's norm and the median leaf's; change_gap,
the same for each leaf's change over the compared steps.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (nought to rounding: they move by round-off alone).
"""
from __future__ import annotations

import torch

NEGLIGIBLE = 1e-3


def model_points(poses: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """poses (..., B, 3, 4), points (B, N, 3) -> (..., B, N, 3)."""
    return points @ poses[..., :3].transpose(-1, -2) + poses[..., None, :, 3]


def pose_gaps(prog: torch.Tensor, ref: torch.Tensor, pose0: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Each sample's relative gap after each iteration, (T, B); prog, ref:
    (T, B, 3, 4) poses after each iteration, pose0 (B, 3, 4); inf where
    the program's pose is not finite."""
    gap = (model_points(prog, points) - model_points(ref, points)).norm(dim=-1).mean(-1)
    moved = (model_points(ref, points) - model_points(pose0, points)[None]).norm(dim=-1).mean(-1)
    scale = torch.clamp(moved.median(dim=1).values, min=1e-9)
    rel = gap / scale[:, None]
    return torch.where(torch.isfinite(prog).all(-1).all(-1), rel, float("inf"))


def pose_gap(gaps: list[torch.Tensor]) -> tuple[float, float]:
    """(root mean square, widest) of the relative gaps of all compared calls."""
    g = torch.cat([x.reshape(-1) for x in gaps]).double()
    return float(torch.sqrt(torch.mean(g * g))), float(g.max())


def loss_gap(prog: list[dict], ref: list[dict]) -> float:
    worst = 0.0
    for step, (p, r) in enumerate(zip(prog, ref)):
        for name in ("pm_loss", "flow_loss", "mask_loss", "total") if step == 0 else ("total",):
            a, b = p[name].double().cpu(), r[name].double().cpu()
            if not torch.isfinite(a).all():
                return float("inf")
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    return worst


def leaf_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    """Worst leaf's |norm(prog) - norm(ref)| / max(norm(ref), median norm)."""
    norms_r = {n: float(ref[n].double().norm()) for n in keep}
    med = float(torch.tensor(sorted(norms_r.values())).median())
    worst = 0.0
    for n in keep:
        a = float(prog[n].double().norm())
        if a != a or a == float("inf"):
            return float("inf")
        worst = max(worst, abs(a - norms_r[n]) / max(norms_r[n], med, 1e-30))
    return worst


def kept_leaves(grad_ref: dict) -> list[str]:
    norms = {n: float(g.double().norm()) for n, g in grad_ref.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return [n for n, v in norms.items() if v >= NEGLIGIBLE * med]
