"""Asc-bias and prop-invar on the scoring fast paths.

The score (make_score), the chunked pattern-tip scorer
(make_score_unbounded) and the sharded scorer must match make_forward — the
level-sweep path whose asc/+I semantics are oracle-verified — for all
three asc flavors and for +I, so tree search never has to leave the fast
path (reference `src/likelihood.c:321-414`, `src/core_likelihood.c:960-978`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libpll_tpu.engine import evaluate as ev
from libpll_tpu.ops import tipcodes as tc
from libpll_tpu.ops.likelihood import (ASC_FELSENSTEIN, ASC_LEWIS,
                                       ASC_STAMATAKIS)
from libpll_tpu.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE

from libpll_tpu.utils.simulate import caterpillar_newick as _caterpillar_newick
from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick

from score_cases import PATHS, _build, _use

SITES = 128
CATS, STATES = 4, 4


def _asc_model(model, states, asc_weights):
    """Forward-path model with the S pseudo-columns appended to the site
    axis (weights = asc state weights); score-path model with asc_weights
    carried separately."""
    fwd = dict(model)
    pw = np.zeros(SITES + states, np.float32)
    pw[:SITES] = np.asarray(model["pattern_weights"])
    pw[SITES:] = asc_weights
    fwd["pattern_weights"] = jnp.asarray(pw)
    fwd["invariant"] = jnp.full((SITES + states,), -1, jnp.int32)

    sc = dict(model)
    sc["asc_weights"] = jnp.asarray(asc_weights, jnp.float32)
    return fwd, sc


def _asc_clv(clv, states):
    """Append the S all-one-state pseudo-columns to every tip CLV."""
    nodes, C, S, L = clv.shape
    eye = np.eye(states, dtype=np.float32)
    ext = np.zeros((nodes, C, S, L + states), np.float32)
    ext[..., :L] = np.asarray(clv)
    tips_mask = np.asarray(clv).sum(axis=(1, 2, 3)) > 0  # tips are set
    ext[tips_mask, :, :, L:] = eye[None, None]
    return jnp.asarray(ext)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("asc_mode", [ASC_LEWIS, ASC_FELSENSTEIN,
                                      ASC_STAMATAKIS])
@pytest.mark.parametrize("newick_fn,tips", [
    (_random_tree_newick, 12),
    (_caterpillar_newick, 24),   # deep chain: nonzero scalers in the tail
])
def test_score_asc_matches_forward(asc_mode, newick_fn, tips, path,
                                   monkeypatch):
    built = _use(path, monkeypatch)
    rng = np.random.default_rng(tips + asc_mode)
    newick = (newick_fn(tips, rng) if newick_fn is _random_tree_newick
              else newick_fn(tips))
    topo, model, pmatrix, clv, scalers = _build(newick, sites=SITES)
    topo_asc = topo._replace(asc_mode=asc_mode)
    asc_w = rng.integers(1, 4, STATES).astype(np.float64)
    fwd_model, sc_model = _asc_model(model, STATES, asc_w)

    # forward reference: asc columns ride the site axis
    topo_fwd = topo_asc._replace(sites=SITES)
    fwd = ev.make_forward(topo_fwd)
    clv_fwd = _asc_clv(clv, STATES)
    scal_fwd = jnp.zeros((topo.schedule.n_inner + 1, SITES + STATES),
                         jnp.int32)
    want, _ = fwd(fwd_model, clv_fwd, scal_fwd)

    # score + asc tail
    score = ev.make_score(topo_asc, CATS, STATES)
    got = score(sc_model, clv[:topo.schedule.tips])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)

    # chunked pattern-tip scorer + asc tail
    masks = tc.tip_masks_from_clv(clv[:topo.schedule.tips])
    score_u = ev.make_score_unbounded(topo_asc, CATS, STATES, masks)
    got_u = score_u(sc_model)
    np.testing.assert_allclose(float(got_u), float(want), rtol=2e-6)
    assert len(built) == 2 * (path == "kernel")


@pytest.mark.parametrize("path,scale_mode", [
    ("xla", SCALE_PER_SITE), ("xla", SCALE_PER_RATE),
    ("kernel", SCALE_PER_SITE)])
def test_score_pinv_matches_forward(path, scale_mode, monkeypatch):
    """+I on the fast paths: the score and the chunked pattern-tip
    scorer vs the forward's invariant-site mix."""
    _use(path, monkeypatch)
    rng = np.random.default_rng(7)
    newick = _random_tree_newick(12, rng)
    topo, model, pmatrix, clv, scalers = _build(newick, sites=SITES,
                                                scale_mode=scale_mode)
    tips = topo.schedule.tips

    # plant invariant columns: make the first 16 sites constant state 0
    clv_np = np.array(clv)
    const = np.zeros((STATES, 16), np.float32)
    const[0] = 1.0
    clv_np[:tips, :, :, :16] = const[None, None]
    clv = jnp.asarray(clv_np)

    pinv = 0.25
    invariant = np.full(SITES, -1, np.int32)
    invariant[:16] = 0
    model = dict(model)
    model["prop_invar"] = jnp.asarray([pinv], jnp.float32)
    model["prop_invar_pc"] = jnp.full((CATS,), pinv, jnp.float32)
    model["invariant"] = jnp.asarray(invariant)

    fwd = ev.make_forward(topo)
    want, _ = fwd(model, clv, scalers)

    score = ev.make_score(topo, CATS, STATES, use_pinv=True)
    got = score(model, clv[:tips])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)

    masks = tc.tip_masks_from_clv(clv[:tips])
    score_u = ev.make_score_unbounded(topo, CATS, STATES, masks,
                                      use_pinv=True)
    got_u = score_u(model)
    np.testing.assert_allclose(float(got_u), float(want), rtol=2e-6)


@pytest.mark.parametrize("path", PATHS)
def test_score_sharded_asc_pinv(path, monkeypatch):
    """Sharded scorer with +I on the virtual CPU mesh."""
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:4])
    if devs.size < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = Mesh(devs, ("sites",))
    built = _use(path, monkeypatch)

    rng = np.random.default_rng(3)
    newick = _random_tree_newick(10, rng)
    topo, model, pmatrix, clv, scalers = _build(newick, sites=4 * SITES)
    tips = topo.schedule.tips

    # +I config
    clv_np = np.array(clv)
    const = np.zeros((STATES, 32), np.float32)
    const[1] = 1.0
    clv_np[:tips, :, :, :32] = const[None, None]
    clv = jnp.asarray(clv_np)
    invariant = np.full(4 * SITES, -1, np.int32)
    invariant[:32] = 1
    model = dict(model)
    model["prop_invar"] = jnp.asarray([0.3], jnp.float32)
    model["prop_invar_pc"] = jnp.full((CATS,), 0.3, jnp.float32)
    model["invariant"] = jnp.asarray(invariant)

    fwd = ev.make_forward(topo)
    want, _ = fwd(model, clv, scalers)

    score = ev.make_score_sharded(topo, CATS, STATES, mesh, use_pinv=True)
    got = score(model, clv[:tips])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    assert len(built) == (path == "kernel")
