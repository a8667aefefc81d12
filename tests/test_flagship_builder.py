"""The __graft_entry__ flagship builder's tip_masks mode (the memory-light
path used by the giant-config benchmarks: ambiguity bitmasks instead of a
materialized [nodes, rates, states, sites] CLV tensor) must be semantically
identical to the CLV mode: decoding its masks to one-hot tip CLVs and
running the level-sweep forward must reproduce the pattern-tip scorer's
logL on the same topology/model.
"""

import numpy as np

import jax.numpy as jnp

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _build_flagship
from libpll_tpu.engine.evaluate import make_forward, make_score_unbounded


def test_tip_masks_builder_matches_clv_semantics():
    tips, sites, rate_cats, states = 12, 256, 4, 4
    topo, model, masks, none = _build_flagship(tips, sites,
                                               tip_masks=True, seed=3)
    assert none is None
    assert masks.shape == (tips, sites) and masks.dtype == np.uint32
    assert masks.min() >= 1 and masks.max() <= 0x8  # single-state draws

    # decode masks -> one-hot tip CLVs, run the level-sweep forward
    nodes = 2 * tips - 2
    clv = np.zeros((nodes, rate_cats, states, sites), np.float32)
    for s in range(states):
        clv[:tips, :, s, :] = ((masks >> s) & 1)[:, None, :]
    scalers = jnp.zeros((topo.schedule.n_inner + 1, sites), jnp.int32)
    logl_fwd, _ = make_forward(topo)(model, jnp.asarray(clv), scalers)

    # the pattern-tip scorer on the masks themselves
    score = make_score_unbounded(topo, rate_cats, states, masks)
    logl_dyn = float(score(model))

    assert abs(float(logl_fwd) - logl_dyn) <= 1e-6 * abs(logl_dyn) + 1e-3


def test_tip_masks_builder_is_deterministic():
    # same seed + args -> same masks
    _, _, m1, _ = _build_flagship(8, 64, tip_masks=True, seed=11)
    _, _, m2, _ = _build_flagship(8, 64, tip_masks=True, seed=11)
    np.testing.assert_array_equal(m1, m2)


def test_tip_masks_chunk_layout_invariance():
    # chunked row draws must equal one unchunked draw from the same rng
    # state — pins the chunk-boundary behavior of _draw_tip_masks (the
    # giant-config builder stages ~256 MB chunks at the 1M-site target).
    from __graft_entry__ import _draw_tip_masks

    for step in (1, 3, 7, 16):
        ref = _draw_tip_masks(np.random.default_rng(5), 16, 33, step=16)
        got = _draw_tip_masks(np.random.default_rng(5), 16, 33, step=step)
        np.testing.assert_array_equal(ref, got)
