"""Recovery of the planted shift with seeded random weights: the port's CPU
step against the JAX step (TPU branch emulated on the CPU) on a symmetric
split tile at the production density (100 pts/m^2) and the production
statics of ``configs/landslide/fusion_3d_brienz.yaml``.

``chip_smoke.py`` runs the production tile with ``seeded_models(0)`` and
holds its recovery to floors; this witness measures, on a reduced tile of
the same geometry and with the same weights (bridged to Flax), what the
reference reaches and what broken runs of the port reach. Run it as a
script from the repository root (one JSON line per run):

    PYTHONPATH=. python tests/test_torch_recovery.py --n-core 10000 --margin 5

(minutes on the CPU). The port's runs also go on a card, at the
production tile's full size (JAX is not needed for them):

    PYTHONPATH=. python tests/test_torch_recovery.py --device cuda \
        --n-core 250000 --margin 10 --halo 20 --chunk 2048 \
        --runs port port:no_icp port:tgt_seed

Runs: ``jax`` (the reference, emulated TPU branch), ``port`` (the port's
CPU path), ``port:no_icp`` (fine stage without ICP refinement),
``port:tgt_seed`` (the target cloud's patch sampler draws with another
seed, so the two epochs' descriptors stop corresponding) and ``stages``
(each stage of the port's step replayed through its JAX twin on the
same inputs, see ``stages``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import numpy as np
import pytest
import torch

from fusion4landslide_tpu_torch.models.convert import params_from_flax, seeded_models
from fusion4landslide_tpu_torch.ops.segments import bucket_size
from fusion4landslide_tpu_torch.parallel.pipeline import fusion3d_statics
from fusion4landslide_tpu_torch.synth import PLANTED_SHIFT, synth_split_tile

#: ``chip_smoke.py``'s production config (fusion_3d_brienz.yaml statics).
CFG = {
    "level_of_superpoint": [1, 2, 3], "feat_patch_points": 256, "feat_chunk": 2048,
    "member_cap": 512, "agg_max_points": 512, "num_min_matches_for_small_patch": 10,
    "fine_max_matches": 256, "global_matching_gated": True, "output_tgt2src": False,
}
SCALARS = (5.0, 0.1, 0.1, 10, 10, 0.5, 0.15)


def flax_from_state_dict(sd: dict) -> dict:
    """Flax parameter tree (numpy leaves) of a port state dict: the
    inverse of ``state_dict_from_flax``."""
    tree: dict = {}
    for key, val in sd.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.T.copy()
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {"params": tree}


def recovery(valid, moved, src, core, moving) -> dict:
    """chip_smoke.py's recovery readings from a step's (n,) ``valid`` and
    (n, 3) ``moved`` (centred frame) for the (n, 3) centred ``src``."""
    disp = np.where(valid[:, None], moved - src, 0.0)
    static = core & ~moving
    err_mov = np.linalg.norm(disp[core & moving & valid] - PLANTED_SHIFT, axis=1)
    err_sta = np.linalg.norm(disp[static & valid], axis=1)
    return {
        "static_assigned": float(valid[static].mean()),
        "core_assigned": float(valid[core].mean()),
        "static_err_m": float(np.median(err_sta)) if err_sta.size else None,
        "moving_err_m": float(np.median(err_mov)) if err_mov.size else None,
    }


def split_tile(n_core: int, margin: float, halo: float | None = None):
    """The symmetric split tile of ``chip_smoke.py`` at density 100
    (``halo`` defaults to ``margin``: the cropped ring is the same)."""
    halo = margin if halo is None else halo
    src, tgt, core, moving = synth_split_tile(n_core, margin, margin, halo=halo)
    n, m = len(src), len(tgt)
    N, M = bucket_size(n), bucket_size(m)
    c = src.mean(0)
    sb = np.zeros((N, 3), np.float32)
    sb[:n] = src - c
    tb = np.zeros((M, 3), np.float32)
    tb[:m] = tgt - c
    return dict(n=n, m=m, sb=sb, tb=tb, sm=np.arange(N) < n, tm=np.arange(M) < m,
                core=core, moving=moving)


@contextlib.contextmanager
def tpu_branch_emulated():
    """The JAX package's TPU branch on the CPU (Pallas in interpret mode)."""
    import jax

    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_pallas, "pallas_available", lambda: True)
        for mod, name in (
            (hashgrid_pallas, "radius_sample_window"),
            (hashgrid_pallas, "hash_grid_knn_window"),
            (knn_pallas, "knn_pallas"),
        ):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        yield
    jax.clear_caches()


@contextlib.contextmanager
def _fault(name: str | None):
    """Broken variants of the port's step, for the witness's broken runs."""
    with pytest.MonkeyPatch.context() as mp:
        if name == "tgt_seed":
            from fusion4landslide_tpu_torch.pipelines import f2s3

            calls = {"clouds": 0}
            sample = f2s3.radius_sample_blocks
            dips = f2s3.compute_dips_features

            def counted(*a, **kw):
                calls["clouds"] += 1
                return dips(*a, **kw)

            def reseeded(win, cen, r2, P, seed, *a, **kw):
                return sample(win, cen, r2, P, seed + calls["clouds"] - 1, *a, **kw)

            mp.setattr(f2s3, "radius_sample_blocks", reseeded)
            from fusion4landslide_tpu_torch.pipelines import f2s3_device

            mp.setattr(f2s3_device, "compute_dips_features", counted)
        elif name not in (None, "no_icp"):
            raise ValueError(f"unknown fault {name!r}")
        yield


def run(kind: str, tile: dict, device: str = "cpu", chunk: int = 512) -> dict:
    """One run (``jax``, ``port`` or ``port:<fault>``) on ``tile`` with
    ``seeded_models(0)``; returns its recovery readings. The port's
    runs go on ``device``; the JAX run is always the emulated CPU one.
    ``chunk`` (DIPs network rows per call) bounds memory; chip_smoke.py
    uses 2048."""
    N, M, n = tile["sb"].shape[0], tile["tb"].shape[0], tile["n"]
    statics = fusion3d_statics({**CFG, "feat_chunk": chunk}, N, M)
    td, ta = seeded_models(0, "cpu")
    fault = kind.split(":", 1)[1] if ":" in kind else None
    if fault == "no_icp":
        statics["icp_max_iter"] = 0
    t0 = time.perf_counter()
    if kind == "jax":
        import jax

        from fusion4landslide_tpu.pipelines.fusion_device import fusion3d_tile_step

        with tpu_branch_emulated():
            out = fusion3d_tile_step(
                flax_from_state_dict(td.state_dict()), flax_from_state_dict(ta.state_dict()),
                tile["sb"], tile["sm"], tile["tb"], tile["tm"], jax.random.PRNGKey(0),
                *SCALARS, **statics,
            )
            valid, moved = np.asarray(out.valid[:n]), np.asarray(out.moved[:n])
            extra = dict(n_vox=[int(out.n_vox_src), int(out.n_vox_tgt)],
                         median_res=float(out.median_res))
    else:
        from fusion4landslide_tpu_torch.pipelines.fusion_device import fusion3d_tile_step

        with _fault(fault):
            out = fusion3d_tile_step(
                td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
                torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
                device=device, **statics,
            )
        valid, moved = out.valid[:n].cpu().numpy(), out.moved[:n].cpu().numpy()
        extra = dict(n_vox=[int(out.n_vox_src), int(out.n_vox_tgt)],
                     median_res=float(out.median_res), overflow=out.overflow)
    rec = recovery(valid, moved, tile["sb"][:n], tile["core"], tile["moving"])
    return {"run": kind, **rec, **extra, "valid": valid, "moved": moved,
            "seconds": time.perf_counter() - t0}


#: Stages of the port's step held against their JAX twins by ``stages``:
#: name in the port's ``fusion_device`` -> JAX module of the same name.
_STAGES = {
    "gated_feature_nn1": "ops.gated_match",
    "supervoxel_graph": "ops.supervoxel",
    "supervoxel_segmentation": "ops.supervoxel",
    "_segment_centroids": "pipelines.fusion_device",
    "drop_small_and_compact": "pipelines.f2s3_device",
    "label_members": "ops.segments",
    "_aggregate_chunked": "pipelines.fusion_device",
    "coarse_match_superpoints_chunked": "pipelines.fusion_device",
    "fine_match_pairs": "pipelines.fusion",
}


def _outputs(name: str, out, port: bool) -> list:
    """A stage's compared outputs; the port's window overflow count,
    which the JAX functions do not return, is left out."""
    if name == "supervoxel_segmentation":
        return [out.labels]
    if name == "fine_match_pairs":
        return [out.valid]  # R, t: compared on the pairs valid on both sides
    if port and name in ("supervoxel_graph", "_segment_centroids"):
        out = out[:-1]
    return list(out) if isinstance(out, tuple) else [out]


def _seed_refit_singular_values(args, kw, pair: int) -> list:
    """Singular values of the first ICP refit's cross-covariance for one
    fine pair (float64): its matched voxels, the Kabsch seed, the 1-NN
    inliers within ``icp_threshold`` under the seed."""
    mem, mm, tl, gi, gv, lt, sv, tv = (np.asarray(a, np.float64) if a.dtype.kind == "f"
                                       else np.asarray(a) for a in
                                       (x.numpy() for x in args[:8]))
    w = gi[mem[pair]]
    mv = mm[pair] & gv[mem[pair]] & (lt[w] == tl[pair])
    a, b = sv[mem[pair][mv]][: kw["fine_max_matches"]], tv[w[mv]][: kw["fine_max_matches"]]

    def fit(x, y):
        cx, cy = x.mean(0), y.mean(0)
        u, _, vt = np.linalg.svd((x - cx).T @ (y - cy))
        d = np.sign(np.linalg.det(vt.T @ u.T))
        rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        return rot, cy - rot @ cx

    rot, tr = fit(a, b)
    d2 = (((a @ rot.T + tr)[:, None] - b[None]) ** 2).sum(-1)
    inl = d2.min(1) <= kw["icp_threshold"] ** 2
    x, y = a[inl], b[d2.argmin(1)[inl]]
    cov = (x - x.mean(0)).T @ (y - y.mean(0))
    return np.linalg.svd(cov, compute_uv=False).tolist()


def stages(tile: dict, chunk: int = 512) -> dict:
    """The port's CPU step once, every call of ``_STAGES`` recorded; each
    is then replayed through the JAX function of the same name (TPU branch
    emulated) on the SAME inputs, so a disagreement is that stage's own.
    Returns per stage and call: mismatching entries of discrete outputs,
    max |diff| of float outputs; for the fine pairs, mismatches of
    ``valid``, max |dR| and |dt| over the pairs valid on both sides, and
    for each pair whose translations differ by > 1 mm the singular values
    of its first ICP refit."""
    import importlib

    import jax.numpy as jnp

    from fusion4landslide_tpu_torch.pipelines import fusion_device as tfd

    N, M = tile["sb"].shape[0], tile["tb"].shape[0]
    statics = fusion3d_statics({**CFG, "feat_chunk": chunk}, N, M)
    td, ta = seeded_models(0, "cpu")
    fa = flax_from_state_dict(ta.state_dict())
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in _STAGES:
            def rec(*a, _f=getattr(tfd, name), _n=name, **kw):
                out = _f(*a, **kw)
                calls.append((_n, a, kw, out))
                return out
            mp.setattr(tfd, name, rec)
        tfd.fusion3d_tile_step(
            td, ta, torch.from_numpy(tile["sb"]), torch.from_numpy(tile["sm"]),
            torch.from_numpy(tile["tb"]), torch.from_numpy(tile["tm"]), *SCALARS,
            device="cpu", **statics,
        )

    def to_jax(v):
        if isinstance(v, torch.nn.Module):
            return fa
        if isinstance(v, torch.Tensor):
            arr = v.numpy()
            return jnp.asarray(arr.astype(np.int32) if arr.dtype == np.int64 else arr)
        return v

    report: dict = {}
    with tpu_branch_emulated():
        for name, a, kw, out in calls:
            jfn = getattr(importlib.import_module("fusion4landslide_tpu." + _STAGES[name]), name)
            jout = jfn(*map(to_jax, a), **{k: to_jax(v) for k, v in kw.items()})
            row = []
            for t_v, j_v in zip(_outputs(name, out, True), _outputs(name, jout, False)):
                t_v, j_v = np.asarray(t_v), np.asarray(j_v)
                if t_v.dtype.kind == "f":
                    both = np.isfinite(t_v) & np.isfinite(j_v)
                    row.append(float(np.abs(t_v[both] - j_v[both]).max()) if both.any() else 0.0)
                else:
                    row.append(int((t_v.astype(np.int64) != j_v.astype(np.int64)).sum()))
            if name == "fine_match_pairs":
                ok = out.valid.numpy() & np.asarray(jout.valid)
                dR = np.abs(out.R.numpy() - np.asarray(jout.R)).max((1, 2))[ok]
                dt = np.abs(out.t.numpy() - np.asarray(jout.t)).max(1)
                row += [float(dR.max()) if ok.any() else 0.0,
                        float(dt[ok].max()) if ok.any() else 0.0,
                        {int(p): _seed_refit_singular_values(a, kw, int(p))
                         for p in np.nonzero(ok & (dt > 1e-3))[0]}]
            report.setdefault(name, []).append(row)
    return report


def test_flax_bridge_round_trips_the_seeded_weights():
    """The witness hands ``seeded_models`` weights to the JAX step: the
    inverse bridge gives the Flax modules' own tree and round-trips."""
    import jax

    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet
    from fusion4landslide_tpu.models.dips import PointNetFeature

    td, ta = seeded_models(0, "cpu")
    fd, fa = flax_from_state_dict(td.state_dict()), flax_from_state_dict(ta.state_dict())
    ref_d = PointNetFeature().init(jax.random.PRNGKey(0), np.zeros((1, 128, 3), np.float32))
    ref_a = ClusterFeatureNet().init(
        jax.random.PRNGKey(1), np.zeros((1, 8, 64), np.float32), np.ones((1, 8), bool)
    )
    for got, ref in ((fd, ref_d), (fa, ref_a)):
        shapes = jax.tree.map(np.shape, got)
        assert shapes == jax.tree.map(np.shape, jax.tree.map(np.asarray, ref))
    sd_d, sd_a = params_from_flax(fd, fa)
    for sd, mod in ((sd_d, td), (sd_a, ta)):
        for key, val in mod.state_dict().items():
            assert torch.equal(sd[key], val), key


def test_recovery_readings_of_a_known_field():
    """Exact shift on the moving half, zero on the static half, one point
    in four unassigned."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(400, 3)).astype(np.float32)
    core = np.arange(400) < 300
    moving = np.arange(400) % 2 == 0
    valid = np.arange(400) % 4 != 3
    moved = src + np.where(moving[:, None], PLANTED_SHIFT + [0.002, 0, 0], 0.0)
    rec = recovery(valid, moved, src, core, moving)
    assert rec["static_assigned"] == pytest.approx(0.5)
    assert rec["core_assigned"] == pytest.approx(0.75)
    assert rec["static_err_m"] == 0.0
    assert rec["moving_err_m"] == pytest.approx(0.002, abs=1e-7)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-core", type=int, default=10000)
    ap.add_argument("--margin", type=float, default=5.0)
    ap.add_argument("--halo", type=float, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--runs", nargs="+", default=["jax", "port"])
    args = ap.parse_args()
    torch.set_grad_enabled(False)
    tile = split_tile(args.n_core, args.margin, args.halo)
    print(json.dumps({"tile": {"n_core": args.n_core, "margin_m": args.margin,
                               "halo_m": args.halo, "device": args.device,
                               "chunk": args.chunk,
                               "src": tile["n"], "tgt": tile["m"],
                               "bucket": tile["sb"].shape[0]}}), flush=True)
    done = []
    for kind in args.runs:
        if kind == "stages":
            print(json.dumps({"stages": stages(tile, args.chunk)}), flush=True)
            continue
        res = run(kind, tile, args.device, args.chunk)
        done.append(res)
        print(json.dumps({k: v for k, v in res.items() if k not in ("valid", "moved")}),
              flush=True)
    by = {r["run"]: r for r in done}
    if "jax" in by and "port" in by:
        vj, vt = by["jax"]["valid"], by["port"]["valid"]
        common = vj & vt
        gap = np.linalg.norm(by["jax"]["moved"][common] - by["port"]["moved"][common], axis=1)
        print(json.dumps({"jax_vs_port": {
            "overlap_frac": float(common.sum()) / max(int(vj.sum()), int(vt.sum()), 1),
            "median_gap_m": float(np.median(gap)) if gap.size else None,
            "frac_gap_gt_10mm": float((gap > 0.01).mean()) if gap.size else None,
        }}), flush=True)


if __name__ == "__main__":
    main()
