"""Grid-window kernels of the PyTorch port vs the JAX package's Pallas
kernels in interpret mode (the TPU branch, emulated on the CPU).

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the CUDA kernels themselves are held against those plain versions on the
card (``test_kernel_matches_plain_on_card`` here, and ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu.ops import hashgrid as jhg
from fusion4landslide_tpu.ops import hashgrid_pallas as jhp
from fusion4landslide_tpu_torch.checks import (
    knn_agreement,
    sample_agreement,
    sampler_borderline_rows,
)
from fusion4landslide_tpu_torch.ops import hashgrid as thg
from fusion4landslide_tpu_torch.ops import hashgrid_cuda as thc

WINDOW, CHUNK = 4096, 512  # shrunk for interpret-mode speed; overflow asserted 0


def _terrain(n, seed, extent=6.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, size=(n, 2))
    z = np.sin(xy[:, 0] * 0.9) * 0.5 + rng.normal(scale=0.02, size=n)
    return (np.column_stack([xy, z]) - [extent / 2, extent / 2, 0]).astype(np.float32)


def _grids(ref, cell, mask):
    jg = jhg.build_hash_grid(jnp.asarray(ref), cell, jnp.asarray(mask))
    tg = thg.build_hash_grid(torch.from_numpy(ref), cell, torch.from_numpy(mask))
    return jg, tg


def test_build_hash_grid_matches_jax():
    ref = _terrain(3000, 0)
    mask = np.ones(3000, bool)
    mask[::7] = False
    for cell, max_cells in ((0.3, 1 << 21), (0.05, 4096)):
        jg = jhg.build_hash_grid(jnp.asarray(ref), cell, jnp.asarray(mask), max_cells=max_cells)
        tg = thg.build_hash_grid(
            torch.from_numpy(ref), cell, torch.from_numpy(mask), max_cells=max_cells
        )
        used = int(np.asarray(jg.starts)[-1])
        np.testing.assert_array_equal(np.asarray(jg.index), tg.index.numpy())
        np.testing.assert_array_equal(np.asarray(jg.starts), tg.starts.numpy())
        np.testing.assert_array_equal(np.asarray(jg.starts)[:used], tg.starts.numpy()[:used])
        np.testing.assert_array_equal(np.asarray(jg.dims), tg.dims.numpy())
        assert float(jg.cell) == float(tg.cell)
        assert int(jg.m_valid) == int(tg.m_valid)


def _pixels(n, seed, extent=240.0):
    """2D points in pixel units with a zero z column (the RGB channel's
    pixel-space searches)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(0, extent, size=(n, 2))
    return np.column_stack([uv, np.zeros(n)]).astype(np.float32)


def _grid_knn_case(shape):
    """(ref, mask, query, radius): a terrain patch in metres, or pixel
    matches in 5-pixel cells."""
    if shape == "pixel":
        ref = _pixels(3000, 8)
        query = np.concatenate([ref[:1000], _pixels(1200, 9)])
        radius = 5.0
    else:
        ref = _terrain(3000, 1)
        query = np.concatenate([ref[:1500], _terrain(700, 2)])
        radius = 0.25
    mask = np.ones(3000, bool)
    mask[-40:] = False
    return ref, mask, query, radius


@pytest.mark.parametrize("shape,k,exclude_self", [
    pytest.param("terrain", 1, False, id="1-False"),
    pytest.param("terrain", 1, True, id="1-True"),
    pytest.param("terrain", 3, False, id="3-False"),
    pytest.param("terrain", 3, True, id="3-True"),
    pytest.param("terrain", 32, True, id="32-True"),
    pytest.param("pixel", 1, False, id="pixel-1-False"),
    pytest.param("pixel", 1, True, id="pixel-1-True"),
    pytest.param("pixel", 32, False, id="pixel-32-False"),
])
def test_grid_knn_plain_matches_pallas_interpret(shape, k, exclude_self):
    ref, mask, query, radius = _grid_knn_case(shape)
    jg, tg = _grids(ref, radius, mask)
    kw = dict(window=WINDOW, chunk=CHUNK, exclude_self=exclude_self)
    jd, ji, jov = jhp.hash_grid_knn_window(
        jnp.asarray(query), jg, radius, k, interpret=True, **kw
    )
    td, ti, tov = thc.hash_grid_knn_window(torch.from_numpy(query), tg, radius, k + 1, **kw)
    assert int(jov) == 0 and int(tov) == 0
    # The uncentred score rounds at ~|r|^2 * 2^-23 on either side (each
    # side's summation order differs): 1e-5 m^2 on the terrain, two ulps
    # of the largest |r|^2 in pixel units.
    atol = 1e-5 if shape == "terrain" else 2 * 2.0**-23 * float((ref**2).sum(1).max())
    agr = knn_agreement(
        td[:, :k], ti[:, :k], torch.from_numpy(np.array(jd)),
        torch.from_numpy(np.array(ji)), d_next=td[:, k], atol=atol,
    )
    assert agr["finite_equal"] and agr["dist_ok"], agr
    assert agr["index_mismatch"] == 0, agr
    # At k = 32 most rows hold fewer refs than k within the radius.
    assert np.isfinite(np.asarray(jd)[:, :min(k, 3)]).mean() > 0.5


@pytest.mark.parametrize("num_points,priority", [(256, "random"), (128, "distance")])
def test_radius_sampler_plain_matches_pallas_interpret(num_points, priority):
    ref = _terrain(4000, 3)
    mask = np.ones(4000, bool)
    mask[::11] = False
    query = np.concatenate([ref[:1200], _terrain(500, 4)])
    radius = 0.6
    jg, tg = _grids(ref, radius, mask)
    kw = dict(window=WINDOW, chunk=CHUNK, priority=priority)
    ji, jv, jx, jov = jhp.radius_sample_window(
        jnp.asarray(query), jg, radius, num_points, 0, interpret=True, **kw
    )
    ti, tv, tx, tov = thc.radius_sample_window(
        torch.from_numpy(query), tg, radius, num_points, 0, **kw
    )
    assert int(jov) == 0 and int(tov) == 0
    # Borderline queries, in the original query order.
    win = thc.window_prologue(torch.from_numpy(query), tg, 512, WINDOW)
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    border_sorted = sampler_borderline_rows(
        win, thc.block_centres(win), r2, num_points, priority, chunk=CHUNK
    )
    border = torch.zeros(query.shape[0], dtype=torch.bool)
    border[win.qorder] = border_sorted[: query.shape[0]]
    ji_t = torch.from_numpy(np.array(ji))
    jv_t = torch.from_numpy(np.array(jv))
    agr = sample_agreement(ji_t, jv_t, ti, tv, border)
    assert agr["exact_frac"] >= 0.999, agr
    assert agr["unexplained_rows"] == 0, agr
    same = jv_t & tv & (ji_t == ti)
    np.testing.assert_array_equal(np.asarray(jx)[same.numpy()], tx.numpy()[same.numpy()])
    assert tv.sum(1).float().mean() > 50


def test_radius_sampler_range_matches_whole_cloud():
    """Sampling consecutive block ranges of one prologue (the DIPs path)
    gives the rows of the whole-cloud sample."""
    ref = _terrain(3000, 5)
    tg = thg.build_hash_grid(torch.from_numpy(ref), 0.6)
    win = thc.window_prologue(torch.from_numpy(ref), tg, 512, WINDOW)
    cen = thc.block_centres(win)
    r2 = torch.tensor(0.36)
    whole = thc.radius_sample_blocks(win, cen, r2, 128, 0, chunk=CHUNK)
    parts = [
        thc.radius_sample_blocks(win, cen, r2, 128, 0, chunk=CHUNK, b0=b, b1=min(b + 2, win.nb))
        for b in range(0, win.nb, 2)
    ]
    for j in range(3):
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))


def test_grid_traced_loops_match_jax(monkeypatch):
    """median_nn_distance_traced / knn_grid_traced through the emulated
    TPU branch (Pallas window kernel in interpret mode)."""
    from fusion4landslide_tpu.ops import knn_pallas

    jax.clear_caches()
    monkeypatch.setattr(knn_pallas, "pallas_available", lambda: True)
    monkeypatch.setattr(
        jhp, "hash_grid_knn_window",
        functools.partial(jhp.hash_grid_knn_window, interpret=True),
    )
    pts = _terrain(2000, 6)
    mask = np.ones(2048, bool)
    mask[2000:] = False
    pts = np.concatenate([pts, np.zeros((48, 3), np.float32)])
    jm = float(jhg.median_nn_distance_traced(jnp.asarray(pts), jnp.asarray(mask)))
    tm, t_ov = thg.median_nn_distance_traced(torch.from_numpy(pts), torch.from_numpy(mask))
    tm = float(tm)
    assert int(t_ov) == 0
    # Kernel-2 distances are uncentred (|r|^2 - 2 q.r + |q|^2): each side's
    # summation order rounds them differently by ~|r|^2 * 2^-23.
    assert abs(jm - tm) <= 1e-5 * jm
    q = pts[:1000] + np.float32(0.01)
    jd, ji = jhg.knn_grid_traced(
        jnp.asarray(q), jnp.asarray(pts), 1, r0=0.05, ref_mask=jnp.asarray(mask),
        r_max=0.5,
    )
    td, ti, t_ov = thg.knn_grid_traced(
        torch.from_numpy(q), torch.from_numpy(pts), 1, r0=0.05,
        ref_mask=torch.from_numpy(mask), r_max=0.5,
    )
    assert int(t_ov) == 0
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    jax.clear_caches()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Both grid-window CUDA kernels against their plain versions on the
    card; kernel 2 bit for bit at k = 1, 3 and 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    ref = torch.from_numpy(_terrain(20000, 7, extent=14.0)).to(dev)
    grid = thg.build_hash_grid(ref, 0.6)
    win = thc.window_prologue(ref, grid, 512, 32768)
    # Kernel 2 bit for bit: the 3D terrain, pixel matches (z = 0, 5-pixel
    # cells) and near ties (duplicated refs and one-ulp neighbours).
    pix = torch.from_numpy(_pixels(20000, 10, extent=1200.0)).to(dev)
    base = _terrain(6000, 11, extent=8.0)
    dup = np.concatenate([base, base[::3], np.nextafter(base[::5], np.float32(np.inf))])
    dup = torch.from_numpy(dup.astype(np.float32)).to(dev)
    wins = {
        "terrain": win,
        "pixel": thc.window_prologue(pix, thg.build_hash_grid(pix, 5.0), 512, 32768),
        "near_tie": thc.window_prologue(dup, thg.build_hash_grid(dup, 0.3), 512, 32768),
    }
    for shape, w in wins.items():
        assert int(w.overflow) == 0, shape
        for k in (1, 3, 32):
            for excl in (False, True):
                d_k, i_k = thc.grid_knn_blocks(w, k, exclude_self=excl)
                d_p, i_p = thc.grid_knn_plain(w, k, exclude_self=excl)
                assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), (shape, k, excl)
    cen = thc.block_centres(win)
    r2 = torch.tensor(0.36, device=dev)
    for P, prio in ((256, "random"), (128, "distance")):
        out_k = thc.radius_sample_blocks(win, cen, r2, P, 0, prio)
        out_p = thc.radius_sample_plain(win, cen, r2, P, 0, prio)
        border = sampler_borderline_rows(win, cen, r2, P, prio)
        agr = sample_agreement(out_p[0], out_p[1], out_k[0], out_k[1], border)
        assert agr["exact_frac"] >= 0.999 and agr["unexplained_rows"] == 0, agr


@pytest.mark.cuda
def test_dips_epilogue_matches_plain_on_card():
    """The DIPs epilogue kernel's two entry points against the plain chain
    on the card: the trunk shapes (2048 x 256 x {256, 512}, 2048 x 256 x
    1024 for the max-pool), a ragged batch and point count (37 x 100),
    C = 4, and inputs with NaN and +-0 (``chip_smoke.epilogue_entry_check``,
    which ``chip_smoke.py`` runs on the card as well)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    chip_smoke.epilogue_entry_check(torch.device("cuda"))


@pytest.mark.cuda
def test_pointnet_epilogue_path_matches_plain_on_card():
    """``PointNetFeature`` on the card with non-trivial BatchNorm
    statistics: the epilogue kernel's path equal to the plain chain's in
    float32 and bf16, ten epilogues and ten launches a call
    (``chip_smoke.pointnet_epilogue_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke

    chip_smoke.pointnet_epilogue_check(torch.device("cuda"))
