"""f32 fast-path accuracy budget.

The scoring fast paths run float32 with 2**32-unit scaling counters
while the parity contract is float64; these tests pin the relationship:
|logL_f32 − logL_f64| must stay within the stated budget

    |Δ| ≤ ACC_REL · |logL_f64| + ACC_ABS

on representative configurations including a deep (caterpillar) tree with
active scaling.  The budget holds because (a) per-site f32 rounding is a
random walk over sites, (b) the float64 fold of the per-site (or
per-block) terms removes the accumulator ulp loss that dominates at large
|logL| (ops/tipcodes.accurate_sum)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as ev
from libpll_tpu.ops import tipcodes as tc
from libpll_tpu.utils.simulate import caterpillar_newick as _caterpillar_newick
from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick

from score_cases import ACC_ABS, ACC_REL, PATHS, _build, _use


def _f64_model(model):
    out = {}
    for k, v in model.items():
        if v.dtype == jnp.float32:
            out[k] = v.astype(jnp.float64)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("newick_fn,tips,sites", [
    (_random_tree_newick, 24, 2048),
    (_caterpillar_newick, 48, 512),   # deep chain: scaling events in f32
])
def test_f32_score_accuracy_budget(newick_fn, tips, sites, path,
                                   monkeypatch):
    built = _use(path, monkeypatch)
    rng = np.random.default_rng(tips)
    newick = (newick_fn(tips, rng) if newick_fn is _random_tree_newick
              else newick_fn(tips))
    topo, model, pmatrix, clv, scalers = _build(newick, sites=sites)
    t = topo.schedule.tips

    # float64 truth on the XLA path (oracle-parity-verified semantics)
    fwd = ev.make_forward(topo)
    want, _ = fwd(_f64_model(model), clv.astype(jnp.float64), scalers)
    want = float(want)

    # float32 score
    score = ev.make_score(topo, 4, 4)
    got = float(score(model, clv[:t]))

    budget = ACC_REL * abs(want) + ACC_ABS
    assert abs(got - want) <= budget, (got, want, budget)

    # float32 pattern-tip scorer
    masks = tc.tip_masks_from_clv(clv[:t])
    score_u = ev.make_score_unbounded(topo, 4, 4, masks)
    got_u = float(score_u(model))
    assert abs(got_u - want) <= budget, (got_u, want, budget)
    # the kernel takes the unbounded scorer's slab in one launch
    assert len(built) == 2 * (path == "kernel")


def test_f32_score_accuracy_budget_per_rate():
    """Budget row for SCALE_PER_RATE (the reference's ≥10k-taxa mode,
    core_likelihood.c:916-941): deep caterpillar so the per-rate counters
    actually diverge across categories.  The GPU score kernel is
    per-site-only by deliberate scope (ops/score_kernel.py), so the f32
    vehicle here is the XLA forward path — the path per-rate
    configurations actually run."""
    from libpll_tpu.utils.constants import SCALE_PER_RATE

    tips, sites = 48, 512
    topo, model, pmatrix, clv, scalers = _build(
        _caterpillar_newick(tips), sites=sites, scale_mode=SCALE_PER_RATE)

    fwd = ev.make_forward(topo)
    want = float(fwd(_f64_model(model), clv.astype(jnp.float64), scalers)[0])
    got = float(fwd(model, clv, scalers)[0])

    budget = ACC_REL * abs(want) + ACC_ABS
    assert abs(got - want) <= budget, (got, want, budget)


@pytest.mark.parametrize("path", PATHS)
def test_f32_score_accuracy_budget_protein(path, monkeypatch):
    """Budget row for the 20-state score (the protein half of the model
    zoo; reference counterpart core_partials_avx2.c 20x20)."""
    _use(path, monkeypatch)
    tips, sites, states = 16, 256, 20
    rng = np.random.default_rng(20)
    topo, model, pmatrix, clv, scalers = _build(
        _random_tree_newick(tips, rng), sites=sites, states=states, seed=20)
    t = topo.schedule.tips

    fwd = ev.make_forward(topo)
    want = float(fwd(_f64_model(model), clv.astype(jnp.float64), scalers)[0])

    score = ev.make_score(topo, 4, states)
    got = float(score(model, clv[:t]))

    budget = ACC_REL * abs(want) + ACC_ABS
    assert abs(got - want) <= budget, (got, want, budget)


def test_block_partial_fold_is_f64_under_x64():
    """The global site fold must run in f64 when x64 is enabled — the
    f32-accumulator ulp loss would otherwise dominate at |logL| ~ 1e7."""
    parts = jnp.full((4096,), np.float32(-2441.406))  # |sum| ~ 1e7
    total = tc.accurate_sum(parts)
    assert total.dtype == jnp.float64
    np.testing.assert_allclose(float(total), 4096 * float(parts[0]),
                               rtol=1e-12)


def test_f32_accuracy_budget_deep_partition():
    """Deep-tree budget row through the Partition API (the giant-tree
    path): 1024-taxon caterpillar, f32 vs f64, both scaling modes."""
    import jax
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("needs x64 for the f64 truth")
    import libpll_tpu as pll
    from libpll_tpu.io import maps as m

    def caterpillar(tips):
        s = "(t0:0.1,t1:0.1)"
        for i in range(2, tips - 2):
            s = f"({s}:0.1,t{i}:0.1)"
        return f"({s}:0.1,t{tips - 2}:0.1,t{tips - 1}:0.1);"

    from libpll_tpu.tree import utree as ut
    import sys
    sys.setrecursionlimit(200000)

    tips, sites = 1024, 128
    rng = np.random.default_rng(7)
    tree = ut.parse_newick_string(caterpillar(tips))
    root = tree.nodes[-1]
    ops, blens, midx = ut.create_operations(ut.traverse(root))
    seqs = rng.integers(0, 4, (tips, sites))
    alpha = np.array(list("ACGT"))

    for scaling in ("site", "rate"):
        logls = {}
        for dtype in (jnp.float64, jnp.float32):
            part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3,
                                 4, tips - 2, scaling=scaling, dtype=dtype)
            for i in range(tips):
                part.set_tip_states(i, m.pll_map_nt, "".join(alpha[seqs[i]]))
            part.set_frequencies(0, np.array([0.3, 0.25, 0.2, 0.25]))
            part.set_subst_params(0, np.array([1.2, 2.1, 0.7, 1.4, 3.3, 1.0]))
            part.set_category_rates(np.asarray(pll.compute_gamma_cats(0.8, 4)))
            part.update_prob_matrices([0] * 4, midx, blens)
            part.update_partials(ops)
            logls[dtype] = float(part.compute_edge_loglikelihood(
                root.clv_index, root.scaler_index, root.back.clv_index,
                root.back.scaler_index, root.pmatrix_index, [0] * 4))
        want, got = logls[jnp.float64], logls[jnp.float32]
        budget = ACC_REL * abs(want) + ACC_ABS
        assert abs(got - want) <= budget, (scaling, got, want, budget)

