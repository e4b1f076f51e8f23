"""Density clustering backends on the host (the port's own copy of
``fusion4landslide_tpu.ops.clustering``): scikit-learn's HDBSCAN and
DBSCAN, imported when called. ``clustering_type: hdbscan`` of the
rgb_guided method runs here; without scikit-learn the import raises."""

from __future__ import annotations

import numpy as np

__all__ = ["dbscan_labels", "hdbscan_labels"]


def hdbscan_labels(points: np.ndarray, *, min_cluster_size: int = 10,
                   min_samples: int = 1000) -> np.ndarray:
    """(n,) cluster labels of standardised points, -1 = noise (reference
    rgb_guided.py:889-895)."""
    from sklearn.cluster import HDBSCAN
    from sklearn.preprocessing import StandardScaler

    pts = StandardScaler().fit_transform(np.asarray(points))
    min_samples = min(int(min_samples), len(pts) - 1) if len(pts) > 1 else 1
    clus = HDBSCAN(min_cluster_size=int(min_cluster_size), min_samples=max(min_samples, 1))
    return clus.fit(pts).labels_.astype(np.int64)


def dbscan_labels(points: np.ndarray, *, eps: float = 0.5, min_samples: int = 10) -> np.ndarray:
    """(n,) DBSCAN cluster labels, -1 = noise (reference f2s3.py:194-211)."""
    from sklearn.cluster import DBSCAN

    clus = DBSCAN(eps=float(eps), min_samples=int(min_samples))
    return clus.fit(np.asarray(points)).labels_.astype(np.int64)
