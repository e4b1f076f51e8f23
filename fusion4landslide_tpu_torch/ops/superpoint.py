"""Native superpoint partition: geometric features and nested regions.

Port of ``fusion4landslide_tpu.ops.superpoint`` (the role of the
reference's SuperPoint-Transformer bridge, src/superpoint_partition.py:
37-162): the 15-column partition table of ``partition_type: superpoint``
generated from the tile cloud itself.

- ``geometric_features``: linearity, planarity and scattering from the
  eigenvalues of each point's kNN covariance (exact k-NN, ``ops.knn``);
- level 1: VCCS supervoxels (``ops.supervoxel``; above 8192 points its
  graph comes from kernel 1, as on the accelerator);
- levels 2..L: greedy region merging on the host (``_region_merge``, the
  JAX package's numpy code unchanged, including its unstable
  ``np.argsort`` over edge costs), so every level nests in the one below.
"""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.ops.eig3 import eigvals_sym3x3
from fusion4landslide_tpu_torch.ops.knn import knn, median_nn_distance
from fusion4landslide_tpu_torch.ops.normals import neighborhood_covariance
from fusion4landslide_tpu_torch.ops.supervoxel import supervoxel_segmentation
from fusion4landslide_tpu_torch.utils.timing import StageTimer

__all__ = [
    "geometric_features",
    "superpoint_hierarchy",
    "generate_superpoint_partition",
]


def geometric_features(points, k: int = 30, mask=None, *, neighbours=None) -> torch.Tensor:
    """(n, 3) [linearity, planarity, scattering] = (l1 - l2) / l1,
    (l2 - l3) / l1, l3 / l1 of the kNN covariance eigenvalues
    l1 >= l2 >= l3. ``neighbours`` passes a precomputed ``knn(points,
    points, k, mask)`` result."""
    sqd, idx = knn(points, points, k, mask) if neighbours is None else neighbours
    evals = eigvals_sym3x3(neighborhood_covariance(points, idx, torch.isfinite(sqd)))
    l3, l2, l1 = evals[..., 0], evals[..., 1], evals[..., 2]
    l1 = torch.clamp(l1, min=1e-12)
    feats = torch.stack([(l1 - l2) / l1, (l2 - l3) / l1, l3 / l1], dim=-1)
    if mask is not None:
        feats = torch.where(mask.to(torch.bool)[:, None], feats, 0.0)
    return feats


def _region_merge(labels: np.ndarray, neigh: np.ndarray, feats: np.ndarray,
                  points: np.ndarray, target: int, spatial_weight: float) -> np.ndarray:
    """Greedy edge contraction to ``target`` regions; returns the map old
    region id -> new region id (compact). The JAX package's host code."""
    K = int(labels.max()) + 1
    if K <= target:
        return np.arange(K)

    sums_f = np.zeros((K, feats.shape[1]))
    sums_p = np.zeros((K, 3))
    counts = np.zeros(K)
    np.add.at(sums_f, labels, feats)
    np.add.at(sums_p, labels, points)
    np.add.at(counts, labels, 1)
    mean_f = sums_f / counts[:, None]
    mean_p = sums_p / counts[:, None]

    # Region adjacency from cross-label kNN edges.
    a = np.repeat(labels, neigh.shape[1])
    b = labels[neigh.reshape(-1)]
    sel = a != b
    pairs = np.stack([np.minimum(a[sel], b[sel]), np.maximum(a[sel], b[sel])], 1)
    pairs = np.unique(pairs, axis=0)

    df = np.linalg.norm(mean_f[pairs[:, 0]] - mean_f[pairs[:, 1]], axis=1)
    dp = np.linalg.norm(mean_p[pairs[:, 0]] - mean_p[pairs[:, 1]], axis=1)
    order = np.argsort(df + spatial_weight * dp)
    parent = np.arange(K)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    remaining = K
    for e in order:
        if remaining <= target:
            break
        ra, rb = find(pairs[e, 0]), find(pairs[e, 1])
        if ra == rb:
            continue
        # Merge the smaller into the larger; later decisions see the
        # merged region's running means.
        if counts[ra] < counts[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        tot = counts[ra] + counts[rb]
        mean_f[ra] = (mean_f[ra] * counts[ra] + mean_f[rb] * counts[rb]) / tot
        mean_p[ra] = (mean_p[ra] * counts[ra] + mean_p[rb] * counts[rb]) / tot
        counts[ra] = tot
        remaining -= 1

    roots = np.array([find(i) for i in range(K)])
    _, remap = np.unique(roots, return_inverse=True)
    return remap


def superpoint_hierarchy(points, *, levels: int = 3, base_resolution: float | None = None,
                         k_neighbors: int = 30, coarsening: float = 4.0,
                         spatial_weight: float = 0.02, intensity=None, device=None,
                         timings: dict | None = None) -> list[np.ndarray]:
    """Nested per-point labels (numpy int64) for levels 1..``levels`` of
    an (n, 3) cloud. ``base_resolution`` defaults to sqrt(3) 10 times the
    median point spacing; ``intensity`` (n,) joins the features. Runs on
    ``device`` (default ``cuda``); ``timings`` collects the seconds of
    ``superpoint_knn``, ``superpoint_features``, ``superpoint_vccs`` and
    ``superpoint_merge``."""
    dev = resolve_device(device)
    timer = StageTimer({} if timings is None else timings, dev)
    pts = np.asarray(points, np.float32)
    p = pts - pts.mean(axis=0)
    p_d = torch.as_tensor(p, device=dev)
    if base_resolution is None:
        base_resolution = float(np.sqrt(3) * 10.0 * float(median_nn_distance(p_d)))
    k_graph = min(k_neighbors, 15)
    # One search serves both: the first k_graph columns of the exact,
    # (distance, index)-ordered k_neighbors-NN are the k_graph-NN.
    nn_feat = knn(p_d, p_d, k_neighbors)
    timer.mark("superpoint_knn")
    feats = geometric_features(p_d, k_neighbors, neighbours=nn_feat).cpu().numpy()
    neigh = nn_feat[1][:, :k_graph].cpu().numpy()
    timer.mark("superpoint_features")
    seg = supervoxel_segmentation(p_d, float(base_resolution), k_neighbors=k_graph)
    _, lab = np.unique(seg.labels.cpu().numpy(), return_inverse=True)
    timer.mark("superpoint_vccs")
    if intensity is not None:
        inten = np.asarray(intensity, np.float32).reshape(-1, 1)
        inten = inten / max(float(np.abs(inten).max()), 1e-9)
        feats = np.concatenate([feats, inten], axis=1)

    out = [lab]
    cur = lab
    # A spatial term scaled to the data extent: features dominate, ties
    # break spatially.
    extent = float((p.max(0) - p.min(0)).max())
    sw = spatial_weight / max(extent, 1e-9)
    for _ in range(1, levels):
        target = max(int(np.ceil((int(cur.max()) + 1) / coarsening)), 1)
        cur = _region_merge(cur, neigh, feats, p, target, sw)[cur]
        out.append(cur.copy())
    timer.mark("superpoint_merge")
    return out


def generate_superpoint_partition(points, path: str | None = None, *, levels: int = 3,
                                  base_resolution: float | None = None,
                                  k_neighbors: int = 30, coarsening: float = 4.0,
                                  intensity=None, device=None,
                                  timings: dict | None = None) -> list[np.ndarray]:
    """``superpoint_hierarchy``'s labels, written as the reference's
    15-column table (``partition_of_input_{src,tgt}_tile_N.txt``) when
    ``path`` is given."""
    level_labels = superpoint_hierarchy(
        points, levels=levels, base_resolution=base_resolution, k_neighbors=k_neighbors,
        coarsening=coarsening, intensity=intensity, device=device, timings=timings,
    )
    if path is not None:
        from fusion4landslide_tpu_torch.ops.partition_io import write_superpoint_partition

        write_superpoint_partition(path, np.asarray(points), level_labels)
    return level_labels
