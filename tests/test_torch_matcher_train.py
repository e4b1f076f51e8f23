"""Matcher training (``image/eloftr_train.py``, ``image/roma_train.py``) vs
the JAX package's: the synthetic pairs, each loss and its parts and every
gradient leaf on the same pair and the same Flax initialisation, two Adam
steps under the cosine schedule against optax's, and checkpoints read
both ways. Tolerances are stated per test."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.image import eloftr as teloftr
from fusion4landslide_tpu_torch.image import roma as troma
from fusion4landslide_tpu_torch.image import eloftr_train as tet
from fusion4landslide_tpu_torch.image import roma_train as trt
from fusion4landslide_tpu_torch.image.flax_bridge import flat_from_tree, flat_grads_from_module

#: ``tests/test_eloftr_train.py``'s TINY and its training settings.
ELOFTR_TINY = dict(stage_num_blocks=(1, 1, 1, 1), out_features=(8, 8, 16, 32), hidden_size=32,
                   num_attention_layers=1, fine_matching_slice_dim=4)
ELOFTR_SETTINGS = dict(size=64, steps=60, lr=3e-3, batch=2, max_rot=0.05, max_shift=0.15)
#: ``tests/test_roma.py``'s TINY and ``test_training_reduces_epe``'s
#: settings. RoMa's GP Gram matrix is (6 x 6)^2 at 48 px: well conditioned.
ROMA_TINY = dict(enc_channels=(8, 16, 24), gp_dim=32, coord_freqs=4, anchors=8,
                 decoder_channels=32, decoder_blocks=2, refine_channels=(16, 12))
ROMA_SETTINGS = dict(size=48, steps=120, lr=3e-3, max_rot=0.05)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _tensors(pair):
    return tuple(torch.from_numpy(np.asarray(x)) for x in pair)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_pair_matches_jax(seed):
    """Same seed, same pair: images and warp within 1e-5, valid equal."""
    from fusion4landslide_tpu.image import roma_train as jrt

    for kw in (ELOFTR_SETTINGS, ROMA_SETTINGS):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):
            jp = jrt.make_pair(rj, jrt.TrainSettings(**kw))
            tp = trt.make_pair(rt, trt.TrainSettings(**kw))
            for a, b in zip(tp[:3], jp[:3]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=1e-5)
            np.testing.assert_array_equal(tp[3], jp[3])
            assert 0.3 < tp[3].mean() <= 1.0


class Side:
    """One matcher on both sides: the Flax init on the first pair of seed
    0, JAX's jitted loss-and-gradient, and the port's module and loss."""

    def __init__(self, name: str):
        from fusion4landslide_tpu.image import eloftr as jeloftr
        from fusion4landslide_tpu.image import eloftr_train as jet
        from fusion4landslide_tpu.image import roma as jroma
        from fusion4landslide_tpu.image import roma_train as jrt

        self.name = name
        if name == "eloftr":
            self.cfg, self.settings = jeloftr.ELoFTRConfig(**ELOFTR_TINY), ELOFTR_SETTINGS
            jmodel = jeloftr.EfficientLoFTRFlax(self.cfg)
            self.port_loss, self.is_norm = tet.eloftr_loss, teloftr._is_norm
        else:
            self.cfg, self.settings = jroma.RoMaConfig(**ROMA_TINY), ROMA_SETTINGS
            jmodel = jroma.RoMaMatcher(self.cfg)
            inlier = 3.0 * 2.0 / ROMA_SETTINGS["size"]
            self.port_loss = functools.partial(trt.roma_loss, inlier_norm=inlier)
            self.is_norm = troma._is_norm
        pair = jrt.make_pair(np.random.default_rng(0), jrt.TrainSettings(**self.settings))
        self.pair = pair
        self.params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), *pair[:2]))
        if name == "eloftr":
            def jloss(p, *x):
                return jet._loss_fn(p, jmodel, *x)
        else:
            def jloss(p, *x):
                return jrt._loss_fn(p, jmodel, *x, inlier)
        jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        jpair = tuple(jnp.asarray(x) for x in pair)
        self.jgrad = lambda p: jgrad(p, *jpair)

    def port_model(self, params=None):
        params = self.params if params is None else params
        if self.name == "eloftr":
            return teloftr.eloftr_from_flax(params, teloftr.ELoFTRConfig(**ELOFTR_TINY), "cpu")
        return troma.roma_from_flax(params, troma.RoMaConfig(**ROMA_TINY), "cpu")

    def to_flax(self, model):
        return (teloftr.eloftr_to_flax if self.name == "eloftr" else troma.roma_to_flax)(model)


@pytest.fixture(scope="module", params=["eloftr", "roma"])
def side(request):
    return Side(request.param)


def _hold_grads(jgrads, model, is_norm):
    """Every gradient leaf within 1e-3 of its norm, or of 1e-5 x the
    largest leaf's norm where the leaf vanishes (a conv bias in front of a
    GroupNorm reads ~1e-6 against 5 on RoMa). Measured: <= 2.2e-5 of the
    leaf's norm on the others."""
    got = flat_grads_from_module(model, is_norm)
    want = flat_from_tree(jgrads)
    assert set(got) == set(want)
    big = max(np.linalg.norm(v) for v in want.values())
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-3 * np.linalg.norm(want[k]) + 1e-5 * big, (k, err)


def test_loss_and_grads_match_jax(side):
    """Loss and its parts within 1e-4 (relative) of JAX's ``_loss_fn`` on
    the same pair and Flax init; gradients as ``_hold_grads``."""
    (jl, jaux), jg = side.jgrad(side.params)
    model = side.port_model()
    loss, aux = side.port_loss(model, *_tensors(side.pair))
    loss.backward()
    for got, want in zip((loss, *aux), (jl, *jaux)):
        got = float(got.detach())
        assert abs(got - float(want)) <= 1e-4 * abs(float(want)) + 1e-6, (got, want)
    _hold_grads(jg, model, side.is_norm)


def test_two_adam_steps_match_optax(side):
    """Two Adam steps under the cosine schedule (the trainers'
    ``adam_cosine``, lr 3e-3 over 60 steps) on the same pair against
    optax's ``adam(cosine_decay_schedule(...))``: each leaf's update within
    1% (L2, relative; measured <= 5e-4). Adam turns a vanishing gradient
    (RoMa's two conv biases in front of a GroupNorm, ~1e-6 against 5)
    into full steps of its rounding noise's sign: those leaves are left
    out, and there are at most two."""
    import optax

    steps, lr = 60, 3e-3
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))
    params = jax.tree.map(jnp.asarray, side.params)
    state = tx.init(params)
    for _ in range(2):
        _, g = side.jgrad(params)
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
    model = side.port_model()
    opt, sched = trt.adam_cosine(model, lr, steps)
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        side.port_loss(model, *_tensors(side.pair))[0].backward()
        opt.step()
        sched.step()
    got, want = side.to_flax(model), flat_from_tree(jax.tree.map(np.asarray, params))
    start = flat_from_tree(side.params)
    g0 = flat_from_tree(jax.tree.map(np.asarray, side.jgrad(side.params)[1]))
    big = max(np.linalg.norm(v) for v in g0.values())
    vanishing = {k for k, v in g0.items() if np.linalg.norm(v) <= 1e-5 * big}
    assert len(vanishing) <= 2, vanishing
    errs = {k: _rel_err(got[k] - start[k], want[k] - start[k]) for k in want if k not in vanishing}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-2, (worst, errs[worst])


def test_checkpoints_read_both_ways(side, tmp_path):
    """A checkpoint the port writes loads in the JAX loader with equal
    leaves and config, and the JAX one in the port's."""
    from fusion4landslide_tpu.image import eloftr as jeloftr
    from fusion4landslide_tpu.image import roma as jroma

    jmod = jeloftr if side.name == "eloftr" else jroma
    tmod = teloftr if side.name == "eloftr" else troma
    model = side.port_model()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    getattr(tmod, f"save_{side.name}_weights")(port_path, model)
    getattr(jmod, f"save_{side.name}_weights")(jax_path, side.params, side.cfg)
    back, bcfg = getattr(jmod, f"load_{side.name}_weights")(port_path)
    mine = getattr(tmod, f"load_{side.name}_weights")(jax_path, device="cpu")
    assert bcfg == side.cfg
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(side.cfg)
    back, flat = flat_from_tree(jax.tree.map(np.asarray, back)), side.to_flax(model)
    assert set(back) == set(flat) == set(side.to_flax(mine))
    want = flat_from_tree(side.params)
    for key, val in side.to_flax(mine).items():
        np.testing.assert_array_equal(back[key], flat[key])
        np.testing.assert_array_equal(val, want[key])


def test_trainers_run_and_checkpoint(side, tmp_path):
    """Three steps of the port's trainer from the Flax init on the CPU:
    one logged loss per step, finite; the checkpoint lands where it was
    asked to and reloads."""
    settings = trt.TrainSettings(**{**side.settings, "steps": 3, "batch": 2})
    path = str(tmp_path / f"{side.name}.npz")
    train = tet.train_eloftr if side.name == "eloftr" else trt.train_roma
    model, _, hist = train(settings, seed=0, log_every=1, checkpoint_to=path,
                           checkpoint_every=1, model=side.port_model(), device="cpu")
    assert len(hist) == 3 and np.isfinite(np.asarray(hist)).all()
    tmod = teloftr if side.name == "eloftr" else troma
    again = getattr(tmod, f"load_{side.name}_weights")(path, device="cpu")
    for key, val in side.to_flax(again).items():
        np.testing.assert_array_equal(val, side.to_flax(model)[key])
