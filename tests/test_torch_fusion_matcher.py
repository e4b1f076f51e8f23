"""The RGB+3D fusion method with the image matcher in the loop (no
precomputed pixel matches): the host tile over two source images x one
target image, merged by fill-in, against the JAX package's (TPU branch
emulated, as ``tests/test_torch_fusion_host.py`` holds the host tile),
and ``main_fusion`` with per-tile camera selection over ``Images_used.txt``
and ``img_matching_type: zncc`` (the host tiles, and what the runner is
handed).

The port's ZNCC matcher is held to the JAX one in
``tests/test_torch_matching.py``; here both sides match with the JAX
matcher, so the comparison sees the tile's own stages (flows ~1e-5 px
apart would flip near-tie pixel chains, see
``tests/test_torch_driver_methods.py``)."""

import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)
import sys
from pathlib import Path

import jax
import numpy as np

from fusion4landslide_tpu_torch.synth import (
    SMALL_IMG_SIZE,
    synth_epoch_pair,
    synth_textured_images,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_driver import SMALL, seeded_weights, write_run  # noqa: E402,F401
from test_torch_driver_methods import jax_matcher  # noqa: E402
from test_torch_fusion_host import (  # noqa: E402,F401
    CFG,
    RGB_CFG,
    fine_calls,
    flax_and_torch_models,
    score_host_parity,
    tpu_branch,
)


def shifted(E: np.ndarray, dx: float) -> np.ndarray:
    """The world->camera ``E`` of a camera moved ``dx`` m along x."""
    E2 = E.copy()
    E2[0, 3] -= dx
    return E2


def test_run_fusion_tile_with_the_matcher_matches_emulated_jax(tpu_branch, fine_calls,
                                                                tmp_path, monkeypatch):
    from fusion4landslide_tpu.pipelines.fusion import run_fusion_tile as j_run
    from fusion4landslide_tpu_torch.pipelines.fusion import run_fusion_tile

    dips, agg, td, ta = flax_and_torch_models()
    src, tgt, _ = synth_epoch_pair(5.0, 4.0, density=80.0, seed=5)
    s0, t0, K, E, _ = synth_textured_images(src, tgt, SMALL_IMG_SIZE)
    E2 = shifted(E, 0.02)
    s1, _, *_ = synth_textured_images(src, tgt, SMALL_IMG_SIZE, camera=(K, E2))
    cfg = {**CFG, **RGB_CFG, "img_matching_type": "zncc"}
    kw = dict(src_images=[s0, s1], tgt_images=[t0], src_extrinsics=[E, E2],
              tgt_extrinsics=[E], tile_id=0)
    jo = j_run({**cfg, "output_dir": str(tmp_path / "jax")}, dips, agg, src, tgt, s0, t0,
               K, E, E, **kw)
    jax.clear_caches()
    jax_matcher(monkeypatch)
    to = run_fusion_tile({**cfg, "output_dir": str(tmp_path / "port")}, td, ta, src, tgt, s0,
                         t0, K, E, E, device="cpu", **kw)
    assert to["n_2d_matches"] == jo["n_2d_matches"] > 0
    score_host_parity(jo, to, src, fine_calls, min_assigned=0.5)


def camera_selection_epoch(tmp_path):
    """A 10 m x 6 m epoch at zero offset with two source and one target
    candidate camera in ``Images_used.txt`` and their rendered images."""
    from PIL import Image

    from fusion4landslide_tpu_torch.io.ply import write_ply

    data = tmp_path / "data"
    (data / "raw_pcd").mkdir(parents=True)
    src, tgt, _ = synth_epoch_pair(10.0, 6.0, seed=3)
    write_ply(str(data / "raw_pcd" / "epoch1.ply"), src)
    write_ply(str(data / "raw_pcd" / "epoch2.ply"), tgt)
    img_s, img_t, K, E, _ = synth_textured_images(src, tgt, (240, 320))
    img_s2, _, *_ = synth_textured_images(src, tgt, (240, 320), camera=(K, shifted(E, 0.5)))
    image = data / "image"
    (image / "transformations").mkdir(parents=True)
    np.savetxt(image / "camera_intrinsic.txt", K, delimiter=" ")
    with open(image / "transformations" / "Images_used.txt", "w") as f:
        for name, e in (("epoch1.ply_a.png", E), ("epoch1.ply_b.png", shifted(E, 0.5)),
                        ("epoch2.ply_a.png", E)):
            pose = np.linalg.inv(e.astype(np.float64))
            f.write(f"{name}\n" + " ".join(map(str, pose[:3, 3])) + "\n")
            for row in pose[:3, :3]:
                f.write(" ".join(map(str, row)) + "\n")
    for side, name, img in (("src", "epoch1.ply_a.png", img_s), ("src", "epoch1.ply_b.png", img_s2),
                            ("tgt", "epoch2.ply_a.png", img_t)):
        (image / "raw_images" / f"{side}_images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(image / "raw_images" / f"{side}_images" / name)
    return data


def test_main_fusion_camera_selection_with_zncc(tmp_path, seeded_weights, monkeypatch):
    """Per-tile camera selection with ``img_matching_type: zncc``: the
    host tiles match their tiles' best cameras and write every tile's
    tables; the runner path matches each selected pair once and hands each
    tile its pairs (the runner itself replaced, as in
    ``tests/test_torch_driver.py``)."""
    from fusion4landslide_tpu_torch import main_fusion
    from fusion4landslide_tpu_torch.parallel import pipeline

    camera_selection_epoch(tmp_path)
    opts = dict(img_matching_type="zncc", image_size=[240, 320], crop_size=None,
                overlap_size=None, num_sub_img=2)
    cfg = write_run(tmp_path, "fusion_brienz.yaml", "host", seeded_weights, **SMALL,
                    use_mesh=False, **opts)
    summary = main_fusion.main(["--config", cfg, "--device", "cpu"])
    results = tmp_path / "host" / "demo_run" / "results"
    assert sorted(summary["tile_s"]) == ["0", "1"]
    for tid in ("0", "1"):
        table = np.loadtxt(results / f"c2f_dvfs_src2tgt_tile_{tid}.txt", ndmin=2)
        assert len(table) > 100 and np.isfinite(table).all()
        assert (results / f"c2f_dvfms_from_global_2d_src2tgt_wo_pruning_visualize_tile_{tid}.txt"
                ).exists()

    calls = []

    def fake_runner(cfg, dips, agg, tiles, **kw):
        calls.append(([t[0] for t in tiles], kw))
        return {}

    monkeypatch.setattr(pipeline, "run_fusion3d_tiles", fake_runner)
    cfg = write_run(tmp_path, "fusion_brienz.yaml", "runner", seeded_weights, **SMALL,
                    use_mesh=True, **opts)
    main_fusion.main(["--config", cfg, "--device", "cpu"])
    (tiles, kw), = calls
    assert tiles == ["0", "1"] and kw["n_image_pairs"] == 4
    for tid in tiles:
        kit = kw["image_kit_fn"](tid, None, None)
        assert len(kit["pix"]) == len(kit["src_extrinsics"]) == len(kit["tgt_extrinsics"]) >= 1
        assert all(len(p) > 100 for p in kit["pix"]) and kw["pix_cap"] >= len(kit["pix"][0])
