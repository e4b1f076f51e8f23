"""The RGB+3D fusion host tile: ``run_fusion_tile`` with the tile's
pixel matches injected as precomputed matches (the configuration's
``img_matching_result_dir`` path), as ``main_fusion`` runs a tile on one
GPU.

Judged per window tile, on rows, pairs and points drawn from the seed:
the median resolution (kernel 2) against the exact median; the voxel
centroids against the voxelisation of the raw cloud at the program's
resolution; the DIPs descriptors (kernel 1, LRF, PointNet) against the
float64 reference at the program's voxels; the gated global match
against the exact gated 1-NN over the program's descriptors; the pixel
chaining of the 2D matches against the exact two-hop chain over the
projected voxels; the aggregation network against its float64 copy on
the program's descriptors; the coarse superpoint match against the exact
gated mutual 1-NN over the program's superpoint features; each fine
pair's ICP fit against float64 ICP from the same start; and the dense
DVF against each point's fit re-derived by the plain assignment rule
from the fine pairs' fits."""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.models.aggregation import ClusterFeatureNet
from fusion4landslide_tpu_torch.models.dips import PointNetFeature
from fusion4landslide_tpu_torch.pipelines import fusion as prog

import flops
from probes import to_host
from reference import aggregation as ragg
from reference import assign as rassign
from reference import chain as rchain
from reference import dips as rdips
from reference import icp as ricp
from reference import knn as rknn
from reference import median as rmed
from reference import voxel as rvox
from reference.precision import round_tf32, tf32
from weights import load_into, make_weights

#: Fine pairs drawn per ICP call for the judge.
JUDGE_PAIRS = 32
#: Superpoints drawn per aggregation call for the judge.
JUDGE_SUPERPOINTS = 32

#: Layer spans: (module attribute, span name).
SPANS = [
    ("median_nn_distance_counted", "grid_search.median"),
    ("voxel_downsample", "grid_search.voxels"),
    ("compute_dips_features", "dips"),
    ("gated_feature_nn1", "matching.gated"),
    ("project_points", "rgb.project"),
    ("chain_2d_matches_to_3d", "rgb.chain"),
    ("supervoxel_graph", "partition.graph"),
    ("pca_normals", "partition.normals"),
    ("supervoxel_segmentation", "partition.vccs"),
    ("aggregate_superpoints", "aggregation"),
    ("coarse_match_superpoints", "matching.coarse"),
    ("fine_match_pairs", "fine.svd_icp"),
    ("sparse_assign_core", "grid_search.sparse_assign"),
    ("save_txt", "tables.write"),
]


class Pipeline:
    module = prog

    def __init__(self, cfg: dict, seed: int, device, judge_rows: int):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.judge_rows = judge_rows
        self.raw = {"dips": make_weights("dips", 4 * seed, device),
                    "agg": make_weights("agg", 4 * seed + 1, device)}
        self.dips = load_into(PointNetFeature(), self.raw["dips"]).to(device)
        self.agg = load_into(ClusterFeatureNet(), self.raw["agg"]).to(device)
        self.rec = None

    # -- probes -------------------------------------------------------
    def captures(self):
        """(module attribute, hook) pairs that record what the judge reads."""
        def median(args, kwargs, out):
            self.rec["median"].append(to_host(torch.as_tensor(out[0]).reshape(())))

        def voxels(args, kwargs, out):
            if self.rec["p2v"] is None:  # the source cloud's, the first call
                self.rec["p2v"] = to_host(out[1])

        def dips(args, kwargs, out):
            core, radius = args[1], args[3]
            which = len(self.rec["dips"])
            rows = self._rows(core.shape[0], which)
            self.rec["dips"].append({
                "radius": float(radius), "rows": rows,
                "q": to_host(core[rows]), "f": to_host(out[0][rows]),
                "all_q": to_host(core), "all_f": to_host(out[0])})

        def gated(args, kwargs, out):
            rows = self.rec["dips"][0]["rows"]
            self.rec["gated"] = {"idx": to_host(out[1][rows]), "valid": to_host(out[2][rows]),
                                 "max_mag": float(args[4])}

        def chain(args, kwargs, out):
            self.rec["chain"] = {"idx": to_host(out[0]), "valid": to_host(out[1]),
                                 "thr": float(args[3]), "mode": kwargs.get("mode")}

        def labels(args, kwargs, out):
            self.rec["labels"].append(np.array(out[0], copy=True))

        def aggregate(args, kwargs, out):
            member_idx, member_mask = args[3], args[4]
            which = len(self.rec["agg"])
            self.rec["agg_members"].append(to_host(member_mask.sum(dim=1)))
            live = torch.nonzero(member_mask.any(dim=1)).squeeze(1)
            rng = np.random.default_rng([self.seed & (2**63 - 1), self.rec["index"], 40, which])
            pick = rng.choice(live.shape[0], size=min(JUDGE_SUPERPOINTS, live.shape[0]),
                              replace=False)
            sel = live[torch.from_numpy(pick).to(live.device)]
            self.rec["agg"].append({
                "cloud": which % 2, "idx": to_host(member_idx[sel]),
                "mask": to_host(member_mask[sel]), "f": to_host(out[0][sel]),
                "max_points": int(kwargs["agg_max_points"])})

        def coarse(args, kwargs, out):
            self.rec["coarse"].append({
                "args": [to_host(a) for a in args[:6]], "mm": float(args[6]),
                "mutual": bool(kwargs.get("mutual", True)),
                "idx": to_host(out[0]), "valid": to_host(out[1])})

        def fine(args, kwargs, out):
            members, mask, tgt_label = args[0], args[1], args[2]
            self.rec["fine"].append({
                "level": len(self.rec["labels"]) // 2 - 1, "m0": to_host(members[:, 0]),
                "live": to_host(mask.any(dim=1)), "tgt": to_host(tgt_label),
                "R": to_host(out.R), "t": to_host(out.t), "valid": to_host(out.valid)})

        def icp(args, kwargs, out):
            src_m, tgt_m = args[1], args[2]
            rng = np.random.default_rng([self.seed & (2**63 - 1), self.rec["index"], 30,
                                         len(self.rec["icp"])])
            B = src_m.shape[0]
            sel = torch.from_numpy(rng.choice(B, size=min(B, JUDGE_PAIRS), replace=False))
            sel = sel.to(src_m.device)
            self.rec["icp"].append({
                "src": to_host(src_m[sel]), "tgt": to_host(tgt_m[sel]),
                "mask": to_host(kwargs["src_mask"][sel]), "R0": to_host(kwargs["R_init"][sel]),
                "t0": to_host(kwargs["t_init"][sel]), "R": to_host(out.R[sel]),
                "t": to_host(out.t[sel]), "max_dist": float(args[3]),
                "max_iter": int(kwargs["max_iter"])})

        return [("median_nn_distance_counted", median), ("voxel_downsample", voxels),
                ("compute_dips_features", dips), ("gated_feature_nn1", gated),
                ("chain_2d_matches_to_3d", chain), ("_compact_labels", labels),
                ("aggregate_superpoints", aggregate), ("coarse_match_superpoints", coarse),
                ("fine_match_pairs", fine), ("icp_by_type", icp)]

    def _rows(self, n: int, which: int) -> torch.Tensor:
        rng = np.random.default_rng([self.seed & (2**63 - 1), self.rec["index"], which])
        k = min(n, self.judge_rows)
        return torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False))).to(self.device)

    # -- the timed call -------------------------------------------------
    def run_tile(self, tile: dict, index: int, timings: dict | None) -> dict:
        self.rec = {"index": index, "median": [], "p2v": None, "dips": [], "gated": None,
                    "chain": None, "labels": [], "agg": [], "agg_members": [], "coarse": [],
                    "fine": [], "icp": []}
        out = prog.run_fusion_tile(
            self.cfg, self.dips, self.agg, tile["src"], tile["tgt"], None, None,
            tile["K"], tile["E"], tile["E"], corres_2d=tile["corres_2d"], tile_id=index,
            device=self.device, timings=timings)
        rec, self.rec = self.rec, None
        rec["result"] = {k: out[k] for k in ("dvfs", "valid", "n_vox", "median_res")}
        return rec

    def counters(self, tile: dict, rec: dict) -> dict:
        """Work of one tile, from the program's counts."""
        n_s, n_t = rec["result"]["n_vox"]
        members = [m.numpy() for m in rec["agg_members"]]
        return {"n_core": tile["n_core"], "patches": n_s + n_t,
                "flops": flops.dips_flops(n_s + n_t) + flops.aggregation_flops(
                    members, int(self.cfg.get("agg_max_points", 512)))}

    # -- the judge ------------------------------------------------------
    def judge(self, tile: dict, rec: dict, control: bool = False) -> dict:
        """The compared numbers of one tile (names as in the limits file).
        ``control``: every judged answer comes from the reference in TF32
        instead of from the program (the control of the limits)."""
        dev = self.device
        src, tgt = tile["src"], tile["tgt"]
        center = src.mean(axis=0)
        s = (src - center).astype(np.float32)
        t = (tgt - center).astype(np.float32)
        s_d, t_d = torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)
        res = rec["result"]
        out = {}

        # Kernel 2: the median resolution that sizes the voxels and patches.
        gaps = []
        for cloud, med in zip((s_d, t_d), rec["median"]):
            ref = rmed.median_nn(cloud)
            got = rmed.median_nn(cloud, tf32=True) if control else float(med)
            gaps.append(abs(got - ref) / ref)
        out["median_gap"] = max(gaps)

        origin = np.minimum(s.min(axis=0), t.min(axis=0))
        out["voxel_gap_m"] = max(
            rvox.centroid_gap(cloud, origin, res["median_res"], d["q"].numpy(), n_prog,
                              rvox.tf32_means(dev) if control else None)
            for d, cloud, n_prog in zip(rec["dips"], (s, t), res["n_vox"]))

        dg = []
        for d, cloud in zip(rec["dips"], (s_d, t_d)):
            q = d["q"].to(dev)
            ref = rdips.descriptors(self.raw["dips"], q, cloud, d["radius"])
            if control:
                with tf32():
                    f = rdips.descriptors(self.raw["dips"], q, cloud, d["radius"], tf32=True)
            else:
                f = d["f"].to(dev).double()
            dg.append((f - ref).norm(dim=1))
        dg = torch.cat(dg)
        out["dips_gap_max"] = float(dg.max())
        out["dips_gap_p99"] = float(torch.quantile(dg, 0.99))

        g, d0, d1 = rec["gated"], rec["dips"][0], rec["dips"][1]
        qf, rf = d0["f"].to(dev), d1["all_f"].to(dev)
        gate = (d0["q"].to(dev), d1["all_q"].to(dev), g["max_mag"])
        idx, ok = ((rknn.nearest(qf, rf, tf32=True, gate=gate)) if control
                   else (g["idx"].to(dev), g["valid"].to(dev)))
        out["match_gap"] = float(rknn.choice_gap(qf, rf, idx, ok, gate=gate).max())

        out["chain_gap_px2"] = self._chain_gap(tile, rec, center, control)
        out["agg_gap"] = self._agg_gap(rec, control)
        out["coarse_gap"] = self._coarse_gap(rec, control)

        # Each sampled fine pair's ICP fit against float64 ICP from the same
        # start (the Kabsch seed on the pair's matches).
        gaps = []
        for c in rec["icp"]:
            for b in range(c["mask"].shape[0]):
                m = c["mask"][b].to(dev)
                if int(m.sum()) < ricp.MIN_INLIERS:
                    continue
                args = (c["src"][b].to(dev), c["tgt"][b].to(dev), m, c["R0"][b].to(dev),
                        c["t0"][b].to(dev), c["max_dist"], c["max_iter"])
                R_ref, t_ref, n_in = ricp.icp(*args)
                if n_in < ricp.MIN_INLIERS:
                    continue
                if control:
                    R, tr, _ = ricp.icp(*args, tf32=True)
                else:
                    R, tr = c["R"][b].to(dev).double(), c["t"][b].to(dev).double()
                p = args[0][m].double()
                gaps.append(float((p @ R.T + tr - (p @ R_ref.T + t_ref)).norm(dim=1).max()))
        gaps = np.asarray(gaps or [0.0])
        out["icp_gap_p90_m"] = float(np.quantile(gaps, 0.9))
        out["icp_gap_max_m"] = float(gaps.max())

        out["dvf_gap_m"] = self._dvf_gap(tile, rec, s, center, control)
        return out

    def _chain_gap(self, tile, rec, center, control) -> float:
        """The pixel chaining of sampled source voxels (squared pixels)."""
        dev = self.device
        ch = rec["chain"]
        if ch is None:
            return float("inf")
        if ch["mode"] not in (None, "nn_src_only"):
            raise ValueError(f"the judge knows the chain mode nn_src_only, not {ch['mode']!r}")
        size = tuple(int(x) for x in self.cfg["image_size"])
        K = torch.from_numpy(tile["K"]).to(dev)
        E = torch.from_numpy(tile["E"]).to(dev)
        c64 = torch.from_numpy(center.astype(np.float64)).to(dev)
        vox = [d["all_q"].to(dev).double() + c64 for d in rec["dips"]]
        (uv_s, e_s), (uv_t, e_t) = (rchain.project(v, K, E, size) for v in vox)
        ends = torch.from_numpy(tile["corres_2d"]).to(dev).double()
        rows = torch.from_numpy(self._sample(vox[0].shape[0], rec["index"], 50)).to(dev)
        if control:
            (cs, _), (ct, ce) = (rchain.project(v, K, E, size, tf32=True) for v in vox)
            idx, ok = rchain.chain(cs, ct, ce, ends, ch["thr"], rows, tf32=True)
        else:
            idx, ok = ch["idx"].to(dev)[rows], ch["valid"].to(dev)[rows]
        gap = rchain.chain_gap(uv_s, e_s, uv_t, e_t, ends, ch["thr"], rows, idx, ok)
        return float(gap.max()) if gap.numel() else 0.0

    def _agg_gap(self, rec, control) -> float:
        """Sampled superpoint features against the float64 network on the
        program's descriptors: the widest gap over the median norm."""
        dev = self.device
        gaps, norms = [], []
        for a in rec["agg"]:
            feats = rec["dips"][a["cloud"]]["all_f"].to(dev)
            idx, mask = ragg.thin(a["idx"].to(dev).long(), a["mask"].to(dev), a["max_points"])
            x = feats[idx]
            ref = ragg.features(self.raw["agg"], x, mask)
            f = (ragg.features(self.raw["agg"], x, mask, tf32=True) if control
                 else a["f"].to(dev).double())
            gaps.append((f - ref).norm(dim=1))
            norms.append(ref.norm(dim=1))
        if not gaps:
            return float("inf")
        return float(torch.cat(gaps).max() / torch.cat(norms).median().clamp(min=1e-12))

    def _coarse_gap(self, rec, control) -> float:
        """Each level's superpoint matches against the exact gated mutual
        1-NN over the program's superpoint features (squared distance)."""
        dev = self.device
        out = 0.0
        for c in rec["coarse"]:
            if not c["mutual"]:
                raise ValueError("the judge knows the mutual coarse match only")
            args = [a.to(dev) for a in c["args"]]
            fs, cs, vs, ft, ct, vt = args
            fs, cs, ft, ct = fs.double(), cs.double(), ft.double(), ct.double()
            if control:
                idx, ok = rknn.mutual_nearest(fs, cs, vs, ft, ct, vt, c["mm"], tf32=True)
            else:
                idx, ok = c["idx"].to(dev), c["valid"].to(dev)
            gap = rknn.mutual_gap(fs, cs, vs, ft, ct, vt, c["mm"], idx, ok)
            out = max(out, float(gap.max()) if gap.numel() else 0.0)
        return out

    def _dvf_gap(self, tile, rec, s, center, control) -> float:
        """Sampled source points' DVF rows against R p + t of the fit the
        plain assignment rule gives them (metres); inf where a point has a
        row and the rule gives it none, or the other way round."""
        res = rec["result"]
        n = s.shape[0]
        n_vox = res["n_vox"][0]
        p2v = rec["p2v"].numpy().astype(np.int64)
        levels = []
        for f in rec["fine"]:
            lab = rec["labels"][2 * f["level"]]
            live = f["live"].numpy()
            levels.append({"level": f["level"], "lab": lab,
                           "src": lab[f["m0"].numpy().astype(np.int64)][live],
                           "tgt": f["tgt"].numpy()[live], "R": f["R"].numpy()[live],
                           "t": f["t"].numpy()[live], "valid": f["valid"].numpy()[live]})
        levels.sort(key=lambda lv: lv["level"])
        rows = self._sample(n, rec["index"], 21)
        vox = np.where(p2v[rows] < n_vox, p2v[rows], -1)
        R, tr, assigned = rassign.fits(vox, levels)
        valid = np.asarray(res["valid"], bool)
        dvfs = res["dvfs"]
        if dvfs.shape[0] != int(valid.sum()) or not np.array_equal(valid[rows], assigned):
            return float("inf")
        keep = rows[assigned]
        at = (np.cumsum(valid) - 1)[keep]
        p = s[keep].astype(np.float64)
        moved_ref = np.einsum("nij,nj->ni", R[assigned], p) + tr[assigned] + center
        if control:
            Rt = round_tf32(torch.from_numpy(R[assigned].astype(np.float32)))
            pt = round_tf32(torch.from_numpy(s[keep]))
            moved = ((Rt * pt[:, None, :]).sum(-1)
                     + torch.from_numpy(tr[assigned].astype(np.float32))).numpy() + center
            src_col = tile["src"][keep]
        else:
            moved, src_col = dvfs[at, 3:6], dvfs[at, :3]
        if not keep.size:
            return 0.0
        return float(max(np.abs(moved - moved_ref).max(),
                         np.abs(src_col.astype(np.float64) - tile["src"][keep]).max()))

    def _sample(self, n: int, index: int, which: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed & (2**63 - 1), index, which])
        return np.sort(rng.choice(n, size=min(n, self.judge_rows), replace=False))
