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
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.ops.knn_pallas import knn_pallas
from fusion4landslide_tpu_torch.checks import knn_agreement
from fusion4landslide_tpu_torch.ops import knn as tknn
from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES
from fusion4landslide_tpu_torch.ops.knn_cuda import (
    filter_terms,
    knn_feature,
    knn_plain,
    sq_norms,
    tf32_pack,
    tf32_split,
)
from hypothesis import given, settings, strategies as st

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


# --------------------------------------------------------------------------
# Kernel 3's TF32 filter, emulated: the split, the certified margin, and
# filter-then-rescore selection. The CUDA kernel itself runs on the card
# only; these hold its arithmetic argument on the CPU.
# --------------------------------------------------------------------------

_F32_BITS = st.integers(min_value=0, max_value=2**32 - 1).map(
    lambda b: np.array([b], np.uint32).view(np.float32)[0]
).filter(math.isfinite)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(_F32_BITS, min_size=1, max_size=64))
def test_tf32_split_is_exact(values):
    """hi keeps no low 13 mantissa bits, hi + lo == x bit for bit, and lo
    is below 2^-10 |hi| for normal x."""
    x = torch.tensor(np.array(values, np.float32))
    hi, lo = tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.equal((hi + lo).view(torch.int32), x.view(torch.int32))
    normal = x.abs() >= 2.0**-126
    assert (lo.abs() <= hi.abs() * 2.0**-10)[normal].all()


def test_tf32_pack_pads_narrow_rows_with_zeros():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(37, 20)).astype(np.float32))
    packed = tf32_pack(x, 128)
    hi, lo = tf32_split(x)
    assert packed.shape == (128, 128)
    assert torch.equal(packed[:37, :20], hi) and torch.equal(packed[:37, 64:84], lo)
    assert not packed[:37, 20:64].any() and not packed[:37, 84:].any()
    assert not packed[37:].any()
    assert torch.equal(packed[:37, :64] + packed[:37, 64:], torch.nn.functional.pad(x, (0, 44)))


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of a float32 operand: the low 13 mantissa
    bits dropped."""
    return (x.astype(np.float32).view(np.int32) & np.int32(-(1 << 13))).view(np.float32)


def _f32_toward_zero(x: np.ndarray) -> np.ndarray:
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def _emulated_3xtf32_dot(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(n, m) c^ = sum_d lo_q hi_r + hi_q lo_r + hi_q hi_r with both parts
    TF32-truncated, the products exact, summed in float32 in groups of 8
    (reversed order inside a group), group sums added in turn, every sum
    rounded toward zero (a tensor core may truncate)."""
    q_hi, r_hi = _tf32_trunc(q), _tf32_trunc(r)
    q_lo, r_lo = _tf32_trunc(q - q_hi), _tf32_trunc(r - r_hi)

    def add(a, b):
        return _f32_toward_zero(a.astype(np.float64) + b)

    acc = np.zeros((q.shape[0], r.shape[0]), np.float32)
    for d0 in range(0, q.shape[1], 8):
        terms = []
        for d in range(d0, min(d0 + 8, q.shape[1])):
            for a, b in ((q_lo, r_hi), (q_hi, r_lo), (q_hi, r_hi)):
                terms.append(np.multiply.outer(a[:, d], b[:, d]).astype(np.float32))
        group = np.zeros_like(acc)
        for t in reversed(terms):
            group = add(group, t)
        acc = add(acc, group)
    return acc


def _exact_scores(q, r, r2) -> np.ndarray:
    """(n, m) |r|^2 - 2 q.r with the kernel's unfused float32 chain."""
    acc = np.zeros((q.shape[0], r.shape[0]), np.float32)
    for d in range(q.shape[1]):
        acc = acc + np.multiply.outer(q[:, d], r[:, d]).astype(np.float32)
    return (r2[None, :] - np.float32(2.0) * acc).astype(np.float32)


def _kernel_lower_bounds(q, r, r2):
    """((n, m) lower_ij, (n,) B_i) as the kernel forms them from
    ``filter_terms``: an emulated 3xTF32 centred dot product (truncating
    sums), then lower = fma(-W_j, P_i, fma(-2, c', A_j)) in float32."""
    ft = filter_terms(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(r2))
    n, m, d = q.shape[0], r.shape[0], q.shape[1]
    a = (ft.qpack[:n, :d] + ft.qpack[:n, 64:64 + d]).numpy()
    b = (ft.rpack[:m, :d] + ft.rpack[:m, 64:64 + d]).numpy()
    c = _emulated_3xtf32_dot(a, b).astype(np.float64)
    inner = (ft.ref_a[:m].double().numpy()[None, :] - 2.0 * c).astype(np.float32)
    lower = (inner - np.multiply.outer(ft.row_p[:n].double().numpy(), ft.ref_w[:m].double().numpy())).astype(np.float32)
    return lower, ft.row_b[:n].numpy()


@pytest.mark.parametrize("kind", ["unit", "spread", "clustered"])
@pytest.mark.parametrize("d", [16, 33, 64])
def test_margin_bounds_emulated_3xtf32_score(kind, d):
    """The kernel's certified lower bound never exceeds the exact chain:
    lower_ij + B_i <= s_ij for an emulated tensor-core score (TF32
    truncation of both parts, truncating float32 sums in k8 groups,
    reversed within a group), on unit-norm features, on unnormalised ones
    with row norms over 1e-3..1e3, and on clustered unit features (the
    random-init DIPs descriptors sit within ~0.04 of their mean)."""
    rng = np.random.default_rng(100 + d)
    q, r = _feats(rng, 120, d), _feats(rng, 150, d)
    if kind == "spread":
        q = (q * 10.0 ** rng.uniform(-3, 3, size=(120, 1))).astype(np.float32)
        r = (r * 10.0 ** rng.uniform(-3, 3, size=(150, 1))).astype(np.float32)
    elif kind == "clustered":
        centre = _feats(rng, 1, d)
        q = centre + 0.04 * q
        r = centre + 0.04 * r
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
    r2 = sq_norms(torch.from_numpy(r)).numpy()
    exact = _exact_scores(q, r, r2).astype(np.float64)
    lower, b = _kernel_lower_bounds(q, r, r2)
    bound = lower.astype(np.float64) + b.astype(np.float64)[:, None]
    assert (bound <= exact).all(), (bound - exact).max()
    # The margin stays a small multiple of the chain's own rounding.
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    rn = np.linalg.norm(r.astype(np.float64), axis=1)
    scale = np.multiply.outer(qn, rn) + (rn * rn)[None, :]
    assert ((exact - bound) / scale).max() < 2.0 ** -11


def _near_tie_feats(rng, rows: int) -> np.ndarray:
    """Rows built to flip a TF32 selection (as ``chip_smoke.py``'s stress
    shape): norms over 1e-3..1e3, exact duplicates, rows one ulp apart."""
    x = _feats(rng, rows, 64) * 10.0 ** rng.uniform(-3, 3, size=(rows, 1))
    x = x.astype(np.float32)
    dup = np.arange(8, rows, 8)
    x[dup] = x[dup - 5]
    ulp = np.arange(3, rows, 8)
    x[ulp] = np.nextafter(x[ulp - 1], np.float32(np.inf))
    return x


def _primed(bd, b):
    """The kernel's threshold: an upper bound of bd - B (+inf if bd is)."""
    t = (np.float32(bd) - np.float32(b)).astype(np.float32)
    t = np.float32(t + np.float32(2.0**-22) * (abs(np.float32(bd)) + abs(np.float32(b))))
    return np.float32(np.inf) if not np.isfinite(bd) else t


def _filter_then_rescore(q, r, k, exclude_self):
    """The kernel's selection, emulated: per row, four lists (the columns
    8 jc + 2 tq + e of each 128-ref tile belong to thread tq); per tile a
    thread's threshold is primed(its k-th best) (for k = 1 the best of the
    four); a ref is rescored with the exact chain only when its certified
    lower bound is at most the threshold, then inserted with strict <; the
    four lists merge by (score, index). Returns the output and the count of
    rescored candidates."""
    n, m = q.shape[0], r.shape[0]
    r2 = sq_norms(torch.from_numpy(r)).numpy()
    q2 = sq_norms(torch.from_numpy(q)).numpy()
    exact = _exact_scores(q, r, r2)
    lower, bb = _kernel_lower_bounds(q, r, r2)
    best = np.full((n, 4, k), np.inf, np.float32)
    idx = np.zeros((n, 4, k), np.int64)
    rescored = 0
    for j0 in range(0, m, 128):
        quad = best[:, :, k - 1].min(axis=1)
        for tq in range(4):
            cols = [j for j in range(j0, min(j0 + 128, m)) if (j % 8) // 2 == tq]
            for i in range(n):
                thr = _primed(quad[i] if k == 1 else best[i, tq, k - 1], bb[i])
                for j in cols:
                    if not lower[i, j] <= thr:
                        continue
                    rescored += 1
                    s = np.float32(np.inf) if exclude_self and i == j else exact[i, j]
                    if s < best[i, tq, k - 1]:
                        pos = int((best[i, tq] <= s).sum())
                        best[i, tq, pos + 1:] = best[i, tq, pos:-1].copy()
                        idx[i, tq, pos + 1:] = idx[i, tq, pos:-1].copy()
                        best[i, tq, pos], idx[i, tq, pos] = s, j
                        thr = min(thr, _primed(best[i, tq, k - 1], bb[i]))
    flat_d, flat_i = best.reshape(n, 4 * k), idx.reshape(n, 4 * k)
    out_d = np.empty((n, k), np.float32)
    out_i = np.empty((n, k), np.int32)
    for i in range(n):
        order = np.lexsort((flat_i[i], flat_d[i]))[:k]
        dd = np.maximum(flat_d[i, order] + q2[i], np.float32(0.0)).astype(np.float32)
        out_d[i] = dd
        out_i[i] = np.where(np.isfinite(dd), flat_i[i, order], 0)
    return out_d, out_i, rescored


@pytest.mark.parametrize("k", [1, 8, 128])
def test_filter_then_rescore_equals_plain_on_near_ties(k):
    """Filter-then-rescore selects exactly what the plain version selects,
    bit for bit, on duplicates, one-ulp neighbours and a wide norm spread
    (self-kNN with exclude_self)."""
    rng = np.random.default_rng(40 + k)
    x = _near_tie_feats(rng, 200)
    d, i, rescored = _filter_then_rescore(x, x, k, exclude_self=True)
    xt = torch.from_numpy(x)
    pd_, pi = knn_plain(xt, xt, k, sq_norms(xt), sq_norms(xt), exclude_self=True)
    np.testing.assert_array_equal(d, pd_.numpy())
    np.testing.assert_array_equal(i, pi.numpy())
    if k == 1:
        assert rescored < 0.25 * x.shape[0] ** 2, rescored


@pytest.mark.parametrize("m,k,exclude_self", [(50, 1, False), (50, 3, True), (5, 8, True), (0, 2, False)])
def test_zero_query_rows_are_answered_from_the_norms(m, k, exclude_self):
    """The wrapper's closed form for all-zero query rows (which the kernel
    skips) equals the plain version: refs of least |r|^2 in index order,
    with duplicated norms, masked refs and too few refs."""
    from fusion4landslide_tpu_torch.ops.knn_cuda import _zero_rows

    rng = np.random.default_rng(m + k)
    r = torch.from_numpy(_feats(rng, m, 16, unit=False))
    r2 = sq_norms(r)
    if m > 6:
        r2[4] = torch.inf
        r2[6] = r2[2]
    q = torch.zeros((12, 16))
    q[5, 3] = -0.0
    zd, zi = _zero_rows(12, k, r2, exclude_self=exclude_self)
    pd_, pi = knn_plain(q, r, k, sq_norms(q), r2, exclude_self=exclude_self)
    assert torch.equal(zd, pd_) and torch.equal(zi, pi)


@pytest.mark.cuda
def test_knn_kernel_matches_plain_on_card():
    """Kernel 3 against its plain version on the card (bit-equal scores,
    so no index may differ), on random features and on near ties."""
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
    # Duplicates, one-ulp neighbours and a wide norm spread (self-kNN):
    # equal scores must come out in index order.
    x = torch.from_numpy(_near_tie_feats(rng, 4096)).to(dev)
    for k in (1, 2, 8, 16):
        kd, ki = knn_feature(x, x, k, exclude_self=True)
        pd_, pi = knn_plain(x, x, k, sq_norms(x), sq_norms(x), exclude_self=True)
        assert torch.equal(kd, pd_) and torch.equal(ki, pi), ("near-tie", k)



@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_block_local_1nn_equals_the_slabs(monkeypatch, d, masked, exclude_self):
    """Above 2^28 pairs a 1-NN (the host RGB tiles' pixel chaining) takes
    the block-local search; forced here with 512-row blocks, it returns
    the brute-force slabs' distances and indices bit for bit, exact
    duplicates (ties to the lower index) and masked references included."""
    import fusion4landslide_tpu_torch.ops.knn as tk

    rng = np.random.default_rng(d)
    n = 3000
    ref = rng.uniform(0, 60, size=(n, d)).astype(np.float32)
    ref[1500:1700] = ref[:200]
    query = ref.copy() if exclude_self else rng.uniform(0, 60, size=(2000, d)).astype(np.float32)
    mask = torch.from_numpy(np.arange(n) % 7 != 0) if masked else None
    q, r = torch.from_numpy(query), torch.from_numpy(ref)
    slab_d, slab_i = tk.knn(q, r, 1, mask, exclude_self=exclude_self)
    monkeypatch.setattr(tk, "_LOCAL_PAIRS", 0)
    monkeypatch.setattr(tk, "_LOCAL_BLOCK", 512)
    local_d, local_i = tk.knn(q, r, 1, mask, exclude_self=exclude_self)
    assert torch.equal(local_i, slab_i) and torch.equal(local_d, slab_d)
    assert torch.isfinite(local_d).all()
