"""KD-tree median-split partitioning of Gaussian sets (copied from
threedgrut_tpu/export/partition.py, numpy only).

Reference: threedgrut/export/partition.py (632 LoC) - splits a model into
<= N-particle partitions by recursive median splits along the widest
axis, for engines with per-asset particle limits (4-GiB USDZ guard).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Partition:
    indices: np.ndarray          # particle indices of this partition
    aabb_min: np.ndarray
    aabb_max: np.ndarray

    @property
    def num_gaussians(self) -> int:
        return len(self.indices)


def kd_partition(positions: np.ndarray, max_particles: int,
                 min_particles: int = 1) -> List[Partition]:
    """Recursive median split along the widest axis until every leaf has
    <= max_particles points. Deterministic and balanced (median split)."""
    n = positions.shape[0]
    out: List[Partition] = []

    def recurse(idx: np.ndarray):
        pts = positions[idx]
        if len(idx) <= max_particles:
            out.append(Partition(indices=idx,
                                 aabb_min=pts.min(0) if len(idx) else
                                 np.zeros(3),
                                 aabb_max=pts.max(0) if len(idx) else
                                 np.zeros(3)))
            return
        widths = pts.max(0) - pts.min(0)
        axis = int(np.argmax(widths))
        order = np.argsort(pts[:, axis], kind="stable")
        half = len(idx) // 2
        recurse(idx[order[:half]])
        recurse(idx[order[half:]])

    recurse(np.arange(n))
    return out


def partition_attributes(attrs: Dict[str, np.ndarray],
                         partitions: List[Partition]
                         ) -> List[Dict[str, np.ndarray]]:
    """Slice an attribute dict (positions/rotation/...) per partition."""
    return [{k: v[p.indices] for k, v in attrs.items()} for p in partitions]


def partitions_manifest(partitions: List[Partition],
                        file_names: Optional[List[str]] = None) -> dict:
    """JSON-able manifest mirroring the reference's *_partitions.json."""
    return {
        "num_partitions": len(partitions),
        "partitions": [
            {
                "id": i,
                "num_gaussians": int(p.num_gaussians),
                "file": file_names[i] if file_names else None,
                "aabb_min": [float(v) for v in p.aabb_min],
                "aabb_max": [float(v) for v in p.aabb_max],
            }
            for i, p in enumerate(partitions)
        ],
    }
