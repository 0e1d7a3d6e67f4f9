"""The numbers that decide `correct`, and their limits.

Training: each of the first three steps' losses, the norm of the first
step's gradient (as Adam holds it after one step: exp_avg / (1 - b1)) and
the norm of the parameters' change over the three steps, each against the
plain reference, by the worst leaf: the gap between the two norms over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone and are left out of the change.
Rendering: the per-pixel error (largest over the channels) of each
sampled view against the reference's image, by its mean and its median,
worst view. Every cell: the launches that left the kernel route the
configuration and the mix name (core/cell.py: off_route), limit 0.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)}."""
    names = [k for k in ref if keep is None or k in keep]
    r = {k: _norm(ref[k]) for k in names}
    med = statistics.median(r.values())
    return {k: abs(_norm(prog[k]) - r[k]) / max(r[k], med, 1e-30) for k in names}


def split_scenes(leaves: dict, n_scenes: int) -> dict:
    """{name: (K, ...)} -> {(name, k): (...)} for stacked scenes."""
    if n_scenes == 1:
        return leaves
    return {(n, k): t[k] for n, t in leaves.items() for k in range(n_scenes)}


def train_readings(prog: dict, ref: dict, n_scenes: int) -> tuple:
    """prog and ref: {"losses": [[...] per step], "grad1": {leaf}, "change":
    {leaf}} with the same leaf names and loss order -> (readings, the worst
    leaf of each gap)."""
    gaps = [abs(p - r) / abs(r) for ps, rs in zip(prog["losses"], ref["losses"])
            for p, r in zip(ps, rs)]
    g_ref = split_scenes(ref["grad1"], n_scenes)
    med = statistics.median(_norm(t) for t in g_ref.values())
    moving = {k for k, t in g_ref.items() if _norm(t) >= 1e-3 * med}
    grad = leaf_gaps(split_scenes(prog["grad1"], n_scenes), g_ref)
    change = leaf_gaps(split_scenes(prog["change"], n_scenes),
                       split_scenes(ref["change"], n_scenes), moving)
    readings = {"loss_rel": max(gaps), "loss1_rel": max(gaps[: len(prog["losses"][0])]),
                "grad_norm_gap": max(grad.values()),
                "grad_norm_gap_median": statistics.median(grad.values()),
                "change_norm_gap": max(change.values()),
                "change_norm_gap_median": statistics.median(change.values())}
    worst = {"grad": str(max(grad, key=grad.get)), "change": str(max(change, key=change.get)),
             "still": len(g_ref) - len(moving)}
    return readings, worst


def image_readings(pairs) -> dict:
    """pairs: [(program image, reference image)] (H, W, 3) on one device."""
    mean, median = 0.0, 0.0
    for a, b in pairs:
        e = (a.float() - b.float()).abs().amax(dim=-1).flatten()
        mean = max(mean, float(e.mean()))
        median = max(median, float(e.median()))
    return {"image_err_mean": mean, "image_err_median": median}


def verdict(readings: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number with
    a limit is at or under it (a reading that is not a number fails). A
    number whose limit file entry is null is reported and not compared:
    PERF.md says why (no control or fault separates it from sound runs)."""
    checks = {k: {"value": v, "limit": lim[k]} for k, v in readings.items()}
    ok = all(c["limit"] is None or (c["value"] == c["value"] and c["value"] <= c["limit"])
             for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
