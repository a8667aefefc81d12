"""Multi-device scoring: the score under shard_map over a virtual 8-device
sites mesh — the cross-device traffic of one full-tree evaluation is
exactly one psum (SURVEY §2.4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libpll_tpu.engine.evaluate import make_forward, make_score_sharded
from libpll_tpu.ops import tipcodes as tc
from libpll_tpu.parallel.mesh import (make_sites_mesh, replicated,
                                      sharding_for_rank)
from libpll_tpu.utils.constants import SCALE_NONE, SCALE_PER_SITE
from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick

from score_cases import PATHS, _build, _use


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("scale_mode", [SCALE_PER_SITE, SCALE_NONE])
def test_sharded_score_matches_forward(scale_mode, path, monkeypatch):
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    built = _use(path, monkeypatch)
    rng = np.random.default_rng(2)
    topo, model, pmatrix, clv, scalers = _build(
        _random_tree_newick(12, rng), sites=1024, scale_mode=scale_mode)
    t = topo.schedule.tips
    logl_ref, _ = make_forward(topo)(model, clv, scalers)

    mesh = make_sites_mesh()
    tp = jax.device_put(clv[:t], sharding_for_rank(mesh, 4))
    model = {k: jax.device_put(
        v, sharding_for_rank(mesh, 1)
        if k in ("pattern_weights", "invariant") else replicated(mesh))
        for k, v in model.items()}
    score = make_score_sharded(topo, 4, 4, mesh)
    logl = jax.jit(score)(model, tp)
    np.testing.assert_allclose(float(logl), float(logl_ref), rtol=2e-6)
    assert len(built) == (path == "kernel")


@pytest.mark.parametrize("path", PATHS)
def test_sharded_dyn_score_matches_forward(path, monkeypatch):
    """The pattern-tip scorer under shard_map: nibble slabs sharded on
    sites, each device summing its local chunks (or one kernel launch),
    one psum."""
    from libpll_tpu.engine.evaluate import make_score_unbounded_sharded

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    built = _use(path, monkeypatch)
    rng = np.random.default_rng(4)
    topo, model, pmatrix, clv, scalers = _build(
        _random_tree_newick(14, rng), sites=1024)
    t = topo.schedule.tips
    logl_ref, _ = make_forward(topo)(model, clv, scalers)

    masks = tc.tip_masks_from_clv(clv[:t])

    mesh = make_sites_mesh()
    score = make_score_unbounded_sharded(topo, 4, 4, masks, mesh)
    logl = score(model)
    np.testing.assert_allclose(float(logl), float(logl_ref), rtol=2e-6)
    assert len(built) == (path == "kernel")
