"""The F2S3 host tile: ``run_f2s3_tile``, as ``main_f2s3`` runs a tile on
one GPU.

Judged per window tile, on rows drawn from the seed: the median
resolution (kernel 2) against the exact median; the DIPs descriptors
(kernel 1, LRF, PointNet) against the float64 reference; the feature
1-NN (kernel 3) against the exact 1-NN over the program's descriptors;
and the filter's scores against the float64 filter on the program's
correspondences, on supervoxels drawn half from those where the program
scores some correspondence above 0 and half from all. With seeded
weights no supervoxel's fit passes the filter's robustness test, so the
rigid re-fit (``refine_results``) is not reached."""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.models.dips import PointNetFeature
from fusion4landslide_tpu_torch.models.filtering import FilteringNetwork
from fusion4landslide_tpu_torch.pipelines import f2s3 as prog

import flops
from probes import to_host
from reference import dips as rdips
from reference import filtering as rfilt
from reference import knn as rknn
from reference import median as rmed
from reference.precision import tf32
from weights import load_into, make_weights

SPANS = [
    ("median_nn_distance_counted", "grid_search.median"),
    ("compute_dips_features", "dips"),
    ("supervoxel_segmentation", "partition.vccs"),
    ("drop_small_and_compact", "partition.compact"),
    ("nn1", "matching.feature_nn1"),
    ("save_txt", "tables.write"),
    ("filter_supervoxel_buckets", "filter"),
    ("write_f2s3_outputs", "tables"),
]

#: Supervoxels drawn per tile for the filter's judge: this many with a
#: score above 0, and as many from all.
JUDGE_SUPERVOXELS = 32


class Pipeline:
    module = prog

    def __init__(self, cfg: dict, seed: int, device, judge_rows: int):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.judge_rows = judge_rows
        self.raw = {"dips": make_weights("dips", 4 * seed, device),
                    "filter": make_weights("filter", 4 * seed + 2, device)}
        self.dips = load_into(PointNetFeature(), self.raw["dips"]).to(device)
        self.filt = load_into(FilteringNetwork(), self.raw["filter"]).to(device)
        self.rec = None

    def captures(self):
        def median(args, kwargs, out):
            self.rec["median"].append(to_host(torch.as_tensor(out[0]).reshape(())))

        def dips(args, kwargs, out):
            core, radius = args[1], args[3]
            rows = self._rows(core.shape[0], len(self.rec["dips"]))
            self.rec["dips"].append({"radius": float(radius), "q": to_host(core[rows]),
                                     "f": to_host(out[0][rows])})

        def nn1(args, kwargs, out):
            rows = self._rows(args[0].shape[0], 7)
            self.rec["nn"] = {"q": to_host(args[0][rows]), "r": to_host(args[1]),
                              "idx": to_host(out[1][rows])}

        def filt(args, kwargs, out):
            self.rec["filter"].append({"corr": to_host(args[1]), "idx": to_host(args[2]),
                                       "mask": to_host(args[3]), "scores": to_host(out[2])})

        return [("median_nn_distance_counted", median), ("compute_dips_features", dips),
                ("nn1", nn1), ("filter_supervoxel_buckets", filt)]

    def _rows(self, n: int, which: int) -> torch.Tensor:
        rng = np.random.default_rng([self.seed & (2**63 - 1), self.rec["index"], which])
        k = min(n, self.judge_rows)
        return torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False))).to(self.device)

    def run_tile(self, tile: dict, index: int, timings: dict | None) -> dict:
        self.rec = {"index": index, "median": [], "dips": [], "nn": None, "filter": []}
        out = prog.run_f2s3_tile(self.cfg, self.dips, self.filt, tile["src"], tile["tgt"],
                                 tile_id=index, device=self.device, timings=timings)
        rec, self.rec = self.rec, None
        rec["labels"] = out["labels"]
        return rec

    def counters(self, tile: dict, rec: dict) -> dict:
        patches = len(tile["src"]) + len(tile["tgt"]) if rec["dips"] else 0
        return {"n_core": tile["n_core"], "patches": patches,
                "flops": flops.dips_flops(patches) + flops.filter_flops(
                    int((rec["labels"] >= 0).sum())),
                "knn_nm": (len(tile["src"]), len(tile["tgt"]))}

    def judge(self, tile: dict, rec: dict, control: bool = False) -> dict:
        """The compared numbers of one tile; ``control``: the judged
        answers come from the reference in TF32 instead of the program."""
        dev = self.device
        center = tile["src"].mean(axis=0)
        clouds = [torch.from_numpy((c - center).astype(np.float32)).to(dev)
                  for c in (tile["src"], tile["tgt"])]
        out = {}

        gaps = []
        for cloud, med in zip(clouds, rec["median"]):
            ref = rmed.median_nn(cloud)
            got = rmed.median_nn(cloud, tf32=True) if control else float(med)
            gaps.append(abs(got - ref) / ref)
        out["median_gap"] = max(gaps) if len(gaps) == 2 else float("inf")

        if rec["dips"]:
            dg = []
            for d, cloud in zip(rec["dips"], clouds):
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

        nn = rec["nn"]
        q, r = nn["q"].to(dev), nn["r"].to(dev)
        idx, ok = (rknn.nearest(q, r, tf32=True) if control
                   else (nn["idx"].to(dev), torch.ones(q.shape[0], dtype=torch.bool, device=dev)))
        out["nn_gap"] = float(rknn.choice_gap(q, r, idx, ok).max())

        gap = 0.0 if rec["filter"] else float("inf")
        for i, fl in enumerate(rec["filter"]):
            mask = fl["mask"].bool()
            live = np.nonzero(mask.any(dim=1).numpy())[0]
            scored = np.nonzero(((fl["scores"] > 0) & mask).any(dim=1).numpy())[0]
            rng = np.random.default_rng([self.seed & (2**63 - 1), rec["index"], 11, i])
            pick = set(rng.choice(scored, size=min(JUDGE_SUPERVOXELS, scored.size),
                                  replace=False).tolist())
            rest = np.setdiff1d(live, np.fromiter(pick, np.int64, len(pick)))
            pick |= set(rng.choice(rest, size=min(JUDGE_SUPERVOXELS, rest.size),
                                   replace=False).tolist())
            for sv in sorted(pick):
                m = mask[sv]
                corr = fl["corr"][fl["idx"][sv][m].long()].to(dev)
                ref = rfilt.scores(self.raw["filter"], corr)
                sc = (rfilt.scores(self.raw["filter"], corr, tf32=True) if control
                      else fl["scores"][sv][m].to(dev).double())
                gap = max(gap, float((sc - ref).abs().max()))
        out["filter_score_gap"] = gap
        return out
