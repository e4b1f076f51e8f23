"""Kernel 3 (feature-space brute-force kNN) of the PyTorch port vs the JAX
package's ``knn_pallas`` in interpret mode (the TPU branch, emulated on
the CPU), and the host-path neighbour helpers built around it.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card
(``test_knn_kernel_matches_plain_on_card`` here, and ``chip_smoke.py``).
Distances are compared within 1e-5 (times the squared feature scale for
unnormalised inputs); indices must be equal except at near-ties, judged
with the port's (k+1)-th distance.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion4landslide_tpu.ops.knn_pallas import knn_pallas
from fusion4landslide_tpu_torch.checks import knn_agreement
from fusion4landslide_tpu_torch.ops import knn as tknn
from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES
from fusion4landslide_tpu_torch.ops.knn_cuda import knn_feature, knn_plain, sq_norms

# The JAX ``ops`` package re-exports the function ``knn`` under the
# module's name.
jknn = importlib.import_module("fusion4landslide_tpu.ops.knn")


def _feats(rng, n, d, unit=True):
    x = rng.normal(size=(n, d)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _port_with_next(q, r, k, mask, exclude_self):
    """The port's (k+1)-NN from the plain version (no k limit), for the
    near-tie rule."""
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    r2 = sq_norms(rt)
    if mask is not None:
        r2 = torch.where(torch.from_numpy(mask), r2, torch.inf)
    return knn_plain(qt, rt, k + 1, sq_norms(qt), r2, exclude_self=exclude_self)


# (D, k, n, m, mask kind, exclude_self, unit-norm features)
CASES = [
    (16, 1, 700, 1500, "none", False, True),
    (64, 1, 513, 2049, "random", True, True),
    (64, 4, 1000, 2500, "random", True, True),
    (16, 4, 300, 600, "tail", False, False),
    (64, 4, 200, 700, "all", False, True),
    (16, 4, 300, 500, "two", True, True),
]


@pytest.mark.parametrize("d,k,n,m,mask_kind,exclude_self,unit", CASES)
def test_knn_plain_matches_pallas_interpret(d, k, n, m, mask_kind, exclude_self, unit):
    rng = np.random.default_rng(d * 1000 + k * 10 + n)
    q = _feats(rng, n, d, unit)
    r = _feats(rng, m, d, unit)
    mask = {
        "none": None,
        "random": rng.uniform(size=m) > 0.2,
        "tail": np.arange(m) < m - 77,
        "all": np.zeros(m, bool),
        "two": np.isin(np.arange(m), [5, 400]),  # k larger than the valid refs
    }[mask_kind]
    jd, ji = knn_pallas(
        jnp.asarray(q), jnp.asarray(r), k, None if mask is None else jnp.asarray(mask),
        exclude_self=exclude_self, interpret=True,
    )
    jd, ji = torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji))
    td, ti = knn_feature(
        torch.from_numpy(q), torch.from_numpy(r), k,
        None if mask is None else torch.from_numpy(mask), exclude_self=exclude_self,
    )
    pd_, pi = _port_with_next(q, r, k, mask, exclude_self)
    assert torch.equal(td, pd_[:, :k]) and torch.equal(ti, pi[:, :k])
    scale = 1.0 if unit else float(np.mean(np.sum(r * r, axis=1)))
    agr = knn_agreement(td, ti, jd, ji, atol=1e-5 * scale, d_next=pd_[:, k])
    assert agr["finite_equal"] and agr["dist_ok"], agr
    assert agr["index_mismatch"] == 0, agr
    assert torch.equal(ti[~torch.isfinite(td)], torch.zeros_like(ti[~torch.isfinite(td)]))
    if mask_kind == "all":
        assert not torch.isfinite(td).any()
    if mask_kind == "two":
        assert torch.isfinite(td).sum(1).max() == 2


def test_k128_matches_xla_search():
    """k = 128 (the kernel's limit). The Pallas kernel's interpret-mode
    trace at k = 128 takes minutes on the CPU, so this case is held against
    the JAX package's exact XLA search, which differs from the kernel only
    at rounding near-ties (it selects on the clamped full distance)."""
    rng = np.random.default_rng(128)
    q, r = _feats(rng, 300, 16), _feats(rng, 600, 16)
    mask = rng.uniform(size=600) > 0.1
    jd, ji = jknn._knn_xla(jnp.asarray(q), jnp.asarray(r), 128, jnp.asarray(mask))
    td, ti = knn_feature(torch.from_numpy(q), torch.from_numpy(r), 128, torch.from_numpy(mask))
    pd_, _ = _port_with_next(q, r, 128, mask, False)
    agr = knn_agreement(
        td, ti, torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji)), d_next=pd_[:, 128]
    )
    assert agr["finite_equal"] and agr["dist_ok"] and agr["index_mismatch"] == 0, agr
    with pytest.raises(ValueError):
        knn_feature(torch.from_numpy(q), torch.from_numpy(r), 129)


def test_selection_follows_the_kernel_not_the_xla_search():
    """Near-duplicate refs, far from a query of large norm: their raw scores
    |r|^2 - 2 q.r differ, but adding |q|^2 = 2^24 before selecting (as the
    XLA search does) rounds their distances to one value, and the tie goes
    to the lower index. The Pallas kernel, and the port, select on the raw
    score and pick the truly nearest ref. Every value is a power of two,
    so all sums are exact in any order."""
    d = 16
    q = np.zeros((4, d), np.float32)
    q[:, 0] = 4096.0  # |q|^2 = 2^24
    q[1:, 3] = [0.5, 0.25, 0.125]  # q.r stays 0 for the refs below
    r = np.zeros((6, d), np.float32)
    r[0, 1] = 2.0**-4  # raw score 2^-8
    r[1, 1] = 2.0**-5  # raw score 2^-10: the nearest
    r[2, 2] = 2.0**-3  # raw score 2^-6
    r[3:, 0] = -4096.0  # far away
    jx_d, jx_i = jknn._knn_xla(jnp.asarray(q), jnp.asarray(r), 1)
    jp_d, jp_i = knn_pallas(jnp.asarray(q), jnp.asarray(r), 1, interpret=True)
    td, ti = tknn.knn(torch.from_numpy(q), torch.from_numpy(r), 1)
    assert (np.asarray(jx_i)[:, 0] == 0).all()  # the XLA search: the tie to index 0
    assert (np.asarray(jp_i)[:, 0] == 1).all()  # the kernel: the nearest, index 1
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jp_i))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jp_d))


def test_knn_dispatch():
    """``ops.knn.knn`` sends D > 8, k <= 128 to kernel 3 and keeps the
    exact XLA port for 3-d inputs; on the CPU no kernel is launched."""
    rng = np.random.default_rng(3)
    before = dict(LAUNCHES)
    q, r = torch.from_numpy(_feats(rng, 100, 64)), torch.from_numpy(_feats(rng, 300, 64))
    mask = torch.arange(300) < 250
    d1, i1 = tknn.knn(q, r, 3, mask, exclude_self=True)
    d2, i2 = knn_feature(q, r, 3, mask, exclude_self=True)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    nd, ni = tknn.nn1(q, r, mask)
    assert torch.equal(nd, d2[:, 0]) and torch.equal(ni, i2[:, 0])
    p = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    d3, i3 = tknn.knn(p, p, 2, exclude_self=True)
    want = torch.cdist(p.double(), p.double()) ** 2
    want.fill_diagonal_(torch.inf)
    assert torch.equal(i3[:, 0].long(), want.argmin(1))
    assert dict(LAUNCHES) == before


@pytest.fixture
def tpu_branch(monkeypatch):
    from fusion4landslide_tpu.ops import hashgrid_pallas, knn_pallas as jkp

    jax.clear_caches()
    monkeypatch.setattr(jkp, "pallas_available", lambda: True)
    monkeypatch.setattr(
        hashgrid_pallas, "hash_grid_knn_window",
        functools.partial(hashgrid_pallas.hash_grid_knn_window, interpret=True),
    )
    yield
    jax.clear_caches()


def _terrain(n, seed, extent=8.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = np.sin(xy[:, 0] * 0.9) * 0.5 + rng.normal(scale=0.02, size=n)
    return (np.column_stack([xy, z]) - [extent / 2, extent / 2, 0]).astype(np.float32)


def test_median_nn_distance_and_nn1_spatial_match_jax(tpu_branch):
    """The host tile's resolution (grid loop above 4096 points, brute force
    below) and its C2C 1-NN, through the emulated TPU branch."""
    from fusion4landslide_tpu.ops.hashgrid import nn1_spatial as j_nn1_spatial
    from fusion4landslide_tpu_torch.ops.hashgrid import nn1_spatial

    big, small = _terrain(5000, 0), _terrain(3000, 1)
    for pts in (big, small):
        jm = float(jknn.median_nn_distance(jnp.asarray(pts)))
        tm = float(tknn.median_nn_distance(torch.from_numpy(pts)))
        assert abs(jm - tm) <= 1e-5 * jm, (len(pts), jm, tm)
    mask = np.arange(3000) < 2900
    jm = float(jknn.median_nn_distance(jnp.asarray(small), jnp.asarray(mask)))
    tm = float(tknn.median_nn_distance(torch.from_numpy(small), torch.from_numpy(mask)))
    assert abs(jm - tm) <= 1e-5 * jm
    q = big[:1500] + np.float32(0.3)
    jd, ji = j_nn1_spatial(jnp.asarray(q), jnp.asarray(small))
    td, ti = nn1_spatial(torch.from_numpy(q), torch.from_numpy(small))
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)
    assert (np.asarray(ji) == ti.numpy()).mean() >= 0.999


@pytest.mark.cuda
def test_knn_kernel_matches_plain_on_card():
    """Kernel 3 against its plain version on the card (bit-equal scores,
    so no index may differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    for d, k, excl in ((64, 1, False), (64, 8, True), (20, 3, False), (16, 128, False)):
        q = torch.from_numpy(_feats(rng, 3000, d)).to(dev)
        r = torch.from_numpy(_feats(rng, 5000, d)).to(dev)
        mask = torch.arange(5000, device=dev) < 4900
        kd, ki = knn_feature(q, r, k, mask, exclude_self=excl)
        r2 = torch.where(mask, sq_norms(r), torch.inf)
        pd_, pi = knn_plain(q, r, k, sq_norms(q), r2, exclude_self=excl)
        assert torch.equal(kd, pd_) and torch.equal(ki, pi), (d, k)
