"""Faults that a broken program could have, planted beneath the probes
(``run.build(faults=...)``): each is the module attribute it breaks and
a function of the call's result, or, marked ``replaces``, of the
original function and the call's arguments. The tests
(``tests/test_bench_faults.py``) and ``calibrate.py --faults`` read
them: the judge has to call every one of them not correct."""

from __future__ import annotations

import numpy as np
import torch


def replaces(fn):
    fn.replaces = True
    return fn


def _half_zero(out):
    f = out[0].clone()
    f[f.shape[0] // 2:] = 0.0
    return (f,) + tuple(out[1:])


def _gated_altered(out):
    sqd, idx, valid = out
    return sqd, torch.roll(idx, 1), valid


def _icp_unchanged(out):
    eye = torch.eye(3, dtype=out.R.dtype, device=out.R.device).expand_as(out.R).clone()
    return out._replace(R=eye, t=torch.zeros_like(out.t))


def _dvf_altered(out):
    out = dict(out)
    out["dvfs"] = out["dvfs"].copy()
    out["dvfs"][:, 3:6] += np.float32(0.01)
    return out


def _nn_altered(out):
    return out[0], torch.roll(out[1], 1)


def _scores_altered(out):
    new_tgt, keep, scores, robust = out
    return new_tgt, keep, scores * 0.5, robust


@replaces
def _median_of_half(orig, args, kwargs):
    return orig(args[0][::2], *args[1:], **kwargs)


def _chain_altered(out):
    idx, valid = out
    return torch.roll(idx, idx.shape[0] // 2), valid


def _aggregation_altered(out):
    feat, coord = out
    return torch.roll(feat, 1, dims=0), coord


def _coarse_altered(out):
    idx, valid = out
    return torch.roll(idx, 1), valid


FAULTS = {
    "fusion_rgb.interior": {
        "median_over_half_the_cloud": ("median_nn_distance_counted", _median_of_half),
        "half_the_descriptors_left_out": ("compute_dips_features", _half_zero),
        "gated_match_altered": ("gated_feature_nn1", _gated_altered),
        "pixel_chain_altered": ("chain_2d_matches_to_3d", _chain_altered),
        "aggregation_altered": ("aggregate_superpoints", _aggregation_altered),
        "coarse_match_altered": ("coarse_match_superpoints", _coarse_altered),
        "icp_returns_its_state_unchanged": ("icp_by_type", _icp_unchanged),
        "dense_dvf_altered": ("run_fusion_tile", _dvf_altered),
    },
    "f2s3.interior": {
        "median_over_half_the_cloud": ("median_nn_distance_counted", _median_of_half),
        "half_the_descriptors_left_out": ("compute_dips_features", _half_zero),
        "feature_nn_altered": ("nn1", _nn_altered),
        "filter_scores_altered": ("filter_supervoxel_buckets", _scores_altered),
    },
}
