"""Protein empirical models, LG4 mixtures, and heterotachy parity."""

import numpy as np
import pytest

import oracle

if not oracle.available():
    pytest.skip("reference oracle unavailable", allow_module_level=True)

import libpll_tpu as pll
from libpll_tpu.io import maps
from libpll_tpu.models.aa_tables import AA_MIXTURE_MODELS, AA_MODELS
from libpll_tpu.models.gamma import compute_gamma_cats

RNG = np.random.default_rng(23)

OPS = [
    (5, 0, 0, 0, -1, 1, 1, -1),
    (6, 1, 2, 2, -1, 3, 3, -1),
    (7, 2, 5, 4, 0, 6, 5, 1),
    (8, 3, 7, 6, 2, 4, 7, -1),
]


def test_aa_tables_identical_to_reference():
    for name in AA_MODELS:
        rates, freqs = AA_MODELS[name]
        np.testing.assert_array_equal(rates,
                                      oracle.aa_table(f"pll_aa_rates_{name}",
                                                      190), err_msg=name)
        np.testing.assert_array_equal(freqs,
                                      oracle.aa_table(f"pll_aa_freqs_{name}",
                                                      20), err_msg=name)
    for name in AA_MIXTURE_MODELS:
        rates, freqs = AA_MIXTURE_MODELS[name]
        np.testing.assert_array_equal(
            rates.ravel(), oracle.aa_table(f"pll_aa_rates_{name}", 760))
        np.testing.assert_array_equal(
            freqs.ravel(), oracle.aa_table(f"pll_aa_freqs_{name}", 80))


def _protein_seqs(n, sites):
    return ["".join(RNG.choice(list("ARNDCQEGHILKMFPSTWYV"), sites))
            for _ in range(n)]


@pytest.mark.parametrize("model", ["lg", "wag", "dayhoff", "blosum62",
                                   "hivb", "stmtrev"])
def test_empirical_protein_model_loglikelihood(model):
    """All-models coverage mirrors test/src/protein-models.c."""
    sites = 20
    rates_tbl, freqs_tbl = AA_MODELS[model]
    blens = RNG.uniform(0.05, 1.0, 8)
    seqs = _protein_seqs(5, sites)

    ref = oracle.RefPartition(5, 4, 20, sites, 1, 8, 4, 4)
    mine = pll.Partition(5, 4, 20, sites, 1, 8, 4, 4)
    gam = compute_gamma_cats(1.0, 4)
    for part in (ref, mine):
        part.set_frequencies(0, freqs_tbl)
        part.set_subst_params(0, rates_tbl)
        part.set_category_rates(gam)
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, maps.pll_map_aa, s)
        mine.set_tip_states(i, maps.pll_map_aa, s)
    pidx = np.zeros(4, int)
    ref.update_prob_matrices(pidx, np.arange(8), blens)
    mine.update_prob_matrices(pidx, np.arange(8), blens)
    ref.update_partials(OPS)
    mine.update_partials([pll.Operation(*o) for o in OPS])
    r = ref.edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    m = mine.compute_edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    np.testing.assert_allclose(m, r, rtol=1e-10)


def test_lg4x_mixture():
    """LG4X: each Gamma category uses its own rate matrix + frequencies
    (reference examples/lg4/lg4.c:295-370)."""
    sites = 20
    rates4, freqs4 = AA_MIXTURE_MODELS["lg4x"]
    blens = RNG.uniform(0.05, 1.0, 8)
    seqs = _protein_seqs(5, sites)

    # 4 rate matrices, one per category
    ref = oracle.RefPartition(5, 4, 20, sites, 4, 8, 4, 4)
    mine = pll.Partition(5, 4, 20, sites, 4, 8, 4, 4)
    gam = compute_gamma_cats(0.9, 4)
    for part in (ref, mine):
        for k in range(4):
            part.set_frequencies(k, freqs4[k])
            part.set_subst_params(k, rates4[k])
        part.set_category_rates(gam)
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, maps.pll_map_aa, s)
        mine.set_tip_states(i, maps.pll_map_aa, s)
    pidx = np.arange(4)  # category k -> matrix k
    ref.update_prob_matrices(pidx, np.arange(8), blens)
    mine.update_prob_matrices(pidx, np.arange(8), blens)
    ref.update_partials(OPS)
    mine.update_partials([pll.Operation(*o) for o in OPS])

    r = ref.edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    m = mine.compute_edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    np.testing.assert_allclose(m, r, rtol=1e-10)

    # derivatives under the mixture
    ref_sum = ref.sumtable(7, 8, 2, 3, pidx)
    my_sum = mine.update_sumtable(7, 8, 2, 3, pidx)
    for t in [0.1, 1.0, 10.0]:
        rd = ref.likelihood_derivatives(2, 3, t, pidx, ref_sum)
        md = mine.compute_likelihood_derivatives(2, 3, t, pidx, my_sum)
        np.testing.assert_allclose(md, rd, rtol=1e-8, atol=1e-10)


def test_heterotachy_per_branch_matrices():
    """Different rate matrices on different branches
    (reference examples/heterotachy/heterotachy.c:41-48)."""
    sites = 30
    params_a = RNG.uniform(0.2, 3.0, 6)
    params_b = RNG.uniform(0.2, 3.0, 6)
    freqs_a = RNG.uniform(0.1, 1.0, 4)
    freqs_a /= freqs_a.sum()
    freqs_b = RNG.uniform(0.1, 1.0, 4)
    freqs_b /= freqs_b.sum()
    blens = RNG.uniform(0.05, 1.0, 8)
    seqs = ["".join(RNG.choice(list("ACGT"), sites)) for _ in range(5)]

    ref = oracle.RefPartition(5, 4, 4, sites, 2, 8, 1, 4)
    mine = pll.Partition(5, 4, 4, sites, 2, 8, 1, 4)
    for part in (ref, mine):
        part.set_frequencies(0, freqs_a)
        part.set_subst_params(0, params_a)
        part.set_frequencies(1, freqs_b)
        part.set_subst_params(1, params_b)
        part.set_category_rates(np.ones(1))
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, maps.pll_map_nt, s)
        mine.set_tip_states(i, maps.pll_map_nt, s)
    # model A on branches 0..3, model B on 4..7
    for part in (ref, mine):
        part.update_prob_matrices([0], np.arange(4), blens[:4])
        part.update_prob_matrices([1], np.arange(4, 8), blens[4:])
    ref.update_partials(OPS)
    mine.update_partials([pll.Operation(*o) for o in OPS])
    # evaluate with model A at the root edge
    r = ref.edge_loglikelihood(8, 3, 7, 2, 6, [0])
    m = mine.compute_edge_loglikelihood(8, 3, 7, 2, 6, [0])
    np.testing.assert_allclose(m, r, rtol=1e-10)


def test_lg4m_mixture_fast_score():
    """LG4M on the scoring fast path: per-category rate matrices ride the
    pmatrix C-axis, so the pattern-tip score supports mixtures by
    construction — verified against the level-sweep forward."""
    import jax.numpy as jnp

    from libpll_tpu.engine.evaluate import (make_forward, make_score,
                                            topology_from_tree)
    from libpll_tpu.io.maps import encode_sequence, tipmask_to_clv
    from libpll_tpu.models.gtr import eigen_decompose
    from libpll_tpu.tree import utree as ut
    from libpll_tpu.utils.constants import SCALE_PER_SITE

    sites, C, S = 128, 4, 20
    rates4, freqs4 = AA_MIXTURE_MODELS["lg4m"]
    rng = np.random.default_rng(4)
    items = [f"t{i}:{rng.uniform(0.05, 0.4):.3f}" for i in range(8)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.4):.3f}")
    tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")
    topo, branches = topology_from_tree(tree, sites,
                                        scale_mode=SCALE_PER_SITE)

    evs, lefts, rights = [], [], []
    for k in range(4):
        w, l, r = eigen_decompose(np.asarray(rates4[k]),
                                  np.asarray(freqs4[k]))
        evs.append(w)
        lefts.append(l)
        rights.append(r)
    gam = compute_gamma_cats(0.9, C)
    f32 = jnp.float32
    model = {
        "branch_lengths": jnp.asarray(branches, f32),
        "rates": jnp.asarray(gam, f32),
        "prop_invar": jnp.zeros((4,), f32),
        "params_indices": jnp.arange(4, dtype=jnp.int32),
        "eigenvals": jnp.asarray(np.stack(evs), f32),
        "left": jnp.asarray(np.stack(lefts), f32),
        "right": jnp.asarray(np.stack(rights), f32),
        "freqs_pc": jnp.asarray(np.stack(freqs4), f32),
        "prop_invar_pc": jnp.zeros((C,), f32),
        "rate_weights": jnp.full((C,), 0.25, f32),
        "pattern_weights": jnp.ones((sites,), f32),
        "invariant": jnp.full((sites,), -1, jnp.int32),
    }

    seqs = _protein_seqs(8, sites)
    masks = np.stack([encode_sequence(s, maps.pll_map_aa) for s in seqs])
    nodes = 2 * 8 - 2
    clv = np.zeros((nodes, C, S, sites), np.float32)
    for i in range(8):
        clv[i] = np.broadcast_to(tipmask_to_clv(masks[i], S).T[None],
                                 (C, S, sites))
    clv = jnp.asarray(clv)
    scalers = jnp.zeros((topo.schedule.n_inner + 1, sites), jnp.int32)

    want, _ = make_forward(topo)(model, clv, scalers)
    score = make_score(topo, C, S, tip_encoding="masks")
    got = float(score(model, jnp.asarray(masks.astype(np.int32))))
    np.testing.assert_allclose(got, float(want), rtol=2e-5)
