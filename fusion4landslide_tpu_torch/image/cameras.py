"""Camera metadata I/O and per-tile camera selection (port of
``fusion4landslide_tpu.image.cameras``; reference
src/coarse_to_fine_matching_base.py:730-998), numpy on the host except the
in-frame counts, which project through ``image.geometry.project_points``.

- ``camera_intrinsic.txt``: 3x3 K, space-delimited (base:920);
- ``rockfall_simulator``: per-epoch ``camera_extrinsic_epoch_{1,2}.txt``,
  quaternion + translation; world->camera is the inverse pose
  (base:949-955);
- ``brienz``: SOP/COP/mounting transform chains in PRCS or SOCS
  (base:957-982);
- ``brienz_tls``: one 4x4 camera pose per epoch, world->camera =
  inverse(pose) (base:984-993).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.image.geometry import project_points

__all__ = [
    "count_in_frame",
    "load_extrinsics",
    "load_images_used",
    "load_intrinsic",
    "load_intrinsic_pair",
    "quaternion_to_rotation_matrix",
    "select_best_images",
]


def quaternion_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation (base:217-235 convention)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_intrinsic(input_root: str) -> np.ndarray:
    """The shared 3x3 K of ``image/camera_intrinsic.txt``."""
    return np.loadtxt(osp.join(input_root, "image", "camera_intrinsic.txt"), delimiter=" ")


def load_intrinsic_pair(input_root: str) -> tuple[np.ndarray, np.ndarray]:
    """(K_src, K_tgt): the single ``camera_intrinsic.txt`` for both epochs,
    else ``camera_intrinsic_{src,tgt}.txt`` (src/rgb_guided.py:1928-1935)."""
    single = osp.join(input_root, "image", "camera_intrinsic.txt")
    if osp.exists(single):
        K = np.loadtxt(single, delimiter=" ")
        return K, K
    return tuple(
        np.loadtxt(osp.join(input_root, "image", f"camera_intrinsic_{side}.txt"), delimiter=" ")
        for side in ("src", "tgt")
    )


def load_extrinsics(input_root: str, dataset: str, *, coord_type: str = "PRCS",
                    src_pose: str | None = None,
                    tgt_pose: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(src_extrinsic, tgt_extrinsic) 4x4 world->camera transforms."""
    tdir = osp.join(input_root, "image", "transformations")
    dataset = (dataset or "").lower()
    if dataset == "rockfall_simulator":
        out = []
        for epoch in (1, 2):
            q = np.loadtxt(osp.join(tdir, f"camera_extrinsic_epoch_{epoch}.txt"))
            pose = np.eye(4)
            pose[:3, :3] = quaternion_to_rotation_matrix(q[:4])
            pose[:3, 3] = q[4:7]
            out.append(np.linalg.inv(pose))
        return out[0], out[1]
    if dataset == "brienz":
        def load(name, delimiter=" "):
            return np.loadtxt(osp.join(tdir, name), delimiter=delimiter)

        sop_s, cop_s = load("sop_transformation_200221.txt"), load("cop_transformation_10_1_200221.txt")
        sop_t, cop_t = load("sop_transformation_201130.txt"), load("cop_transformation_9_1_201130.txt")
        mount = load("mounting_transformation.txt", ",")
        inv = np.linalg.inv
        if coord_type == "PRCS":
            return mount @ inv(cop_s) @ inv(sop_s), mount @ inv(cop_t) @ inv(sop_t)
        if coord_type == "SOCS":
            return cop_s @ inv(mount), cop_t @ inv(mount)
        raise NotImplementedError(f"coord_type {coord_type}")
    if dataset == "brienz_tls":
        pose_s = np.loadtxt(osp.join(tdir, src_pose), delimiter=" ")
        pose_t = np.loadtxt(osp.join(tdir, tgt_pose), delimiter=" ")
        return np.linalg.inv(pose_s), np.linalg.inv(pose_t)
    raise NotImplementedError(f"dataset '{dataset}' camera extrinsics")


def load_images_used(input_root: str) -> list[tuple[str, np.ndarray]]:
    """Parse ``image/transformations/Images_used.txt`` (base:774-811): per
    camera a name line, a translation line and three rotation rows (the
    camera pose). Returns [(image name, 4x4 world->camera extrinsic)]."""
    path = osp.join(input_root, "image", "transformations", "Images_used.txt")
    entries = []
    with open(path) as fh:
        while True:
            name = fh.readline().strip()
            if not name:
                break
            translation = np.array(fh.readline().split(), dtype=np.float64)
            rotation = np.array([fh.readline().split() for _ in range(3)], dtype=np.float64)
            pose = np.eye(4)
            pose[:3, :3] = rotation
            pose[:3, 3] = translation
            entries.append((name, np.linalg.inv(pose)))
    return entries


def count_in_frame(points: np.ndarray, extrinsics: np.ndarray, intrinsic: np.ndarray,
                   image_size: tuple[int, int], *, v_flip: bool = True,
                   device=None) -> np.ndarray:
    """(C,) count of points projecting inside the image, per candidate
    (C, 4, 4) camera (``_get_the_most_matched_idx``, base:730-758), on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(intrinsic, np.float32), device=dev)
    exts = torch.as_tensor(np.asarray(extrinsics, np.float32), device=dev)
    return np.array([
        int(project_points(pts, ext, K, image_size, v_flip=v_flip)[2].sum()) for ext in exts
    ])


def select_best_images(points: np.ndarray, entries: list[tuple[str, np.ndarray]],
                       intrinsic: np.ndarray, image_size: tuple[int, int], *, num: int = 1,
                       v_flip: bool = True, device=None) -> list[tuple[str, np.ndarray]]:
    """Top-``num`` candidate cameras by in-frame point count, best first
    (``_find_the_most_matched_image``, base:760-858)."""
    if not entries:
        return []
    counts = count_in_frame(points, np.stack([e for _, e in entries]), intrinsic, image_size,
                            v_flip=v_flip, device=device)
    return [entries[i] for i in np.argsort(counts)[::-1][:num]]
