"""Core numerical parity vs the compiled reference oracle.

Randomized-input equivalence testing of maps, RNG, gamma discretization,
eigendecomposition → P-matrices, CLV sweeps with scaling, and root/edge
log-likelihoods, following the reference's own cross-kernel consistency
strategy (test/runtest.py runs every test under all SIMD arches against one
golden file; here the 'arches' are {oracle C, XLA}).
"""

import numpy as np
import pytest

import oracle

if not oracle.available():
    pytest.skip("reference oracle unavailable", allow_module_level=True)

import libpll_tpu as pll
from libpll_tpu.io import maps
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.utils.rng import GlibcRandom, shuffled_order

RNG = np.random.default_rng(42)


# ---------------------------------------------------------------- maps ----
@pytest.mark.parametrize("name", ["pll_map_nt", "pll_map_aa", "pll_map_bin"])
def test_char_maps_identical(name):
    ours = getattr(maps, name)
    ref = oracle.map_table(name)
    assert np.array_equal(ours, ref), np.nonzero(ours != ref)


# ----------------------------------------------------------------- rng ----
@pytest.mark.parametrize("seed", [1, 42, 12345, 2**31 - 1, 2**32 - 5])
def test_rng_stream_parity(seed):
    import ctypes as ct
    lib = oracle.get_lib()
    buf = oracle.RandomData()
    state = ct.create_string_buffer(128)
    assert lib.pll_initstate_r(ct.c_uint(seed), state, 128, ct.byref(buf)) == 0
    assert lib.pll_srandom_r(ct.c_uint(seed), ct.byref(buf)) == 0
    mine = GlibcRandom(seed)
    out = ct.c_int32()
    for _ in range(1000):
        lib.pll_random_r(ct.byref(buf), ct.byref(out))
        assert mine.next() == out.value


def test_shuffled_order_seed_zero_is_identity():
    assert shuffled_order(10, 0) == list(range(10))


# --------------------------------------------------------------- gamma ----
@pytest.mark.parametrize("alpha", [0.02, 0.1, 0.5, 1.0, 2.37, 10.0, 100.0])
@pytest.mark.parametrize("cats", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("mode", [0, 1])
def test_gamma_cats_parity(alpha, cats, mode):
    lib = oracle.get_lib()
    ref = np.zeros(cats)
    rc = lib.pll_compute_gamma_cats(alpha, cats, oracle.as_double_p(ref), mode)
    assert rc == 1
    ours = compute_gamma_cats(alpha, cats, mode)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-15)


# ----------------------------------------------------- eigen + pmatrix ----
def _random_model(states):
    n = states * (states - 1) // 2
    params = RNG.uniform(0.2, 3.0, n)
    freqs = RNG.uniform(0.1, 1.0, states)
    freqs /= freqs.sum()
    return params, freqs


@pytest.mark.parametrize("states", [4, 5, 20])
@pytest.mark.parametrize("rate_cats", [1, 4])
def test_pmatrix_parity(states, rate_cats):
    params, freqs = _random_model(states)
    blens = np.array([0.0, 1e-9, 0.01, 0.1, 1.0, 10.0, 90.0])
    n_mat = len(blens)

    ref = oracle.RefPartition(3, 1, states, 10, 1, n_mat, rate_cats, 1)
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, params)
    if rate_cats > 1:
        rates = np.zeros(rate_cats)
        oracle.get_lib().pll_compute_gamma_cats(
            1.0, rate_cats, oracle.as_double_p(rates), 0)
    else:
        rates = np.ones(1)
    ref.set_category_rates(rates)
    ref.update_prob_matrices(np.zeros(rate_cats), np.arange(n_mat), blens)

    p = pll.Partition(3, 1, states, 10, 1, n_mat, rate_cats, 1)
    p.set_frequencies(0, freqs)
    p.set_subst_params(0, params)
    p.set_category_rates(rates)
    p.update_prob_matrices(np.zeros(rate_cats, int), np.arange(n_mat), blens)

    ours = np.asarray(p.pmatrix)  # [B, C, S, S]
    for b in range(n_mat):
        refmat = ref.get_pmatrix(b)[:, :, :states]  # [C, S, Spad]->[C,S,S]
        np.testing.assert_allclose(ours[b], refmat, rtol=1e-10, atol=1e-12,
                                   err_msg=f"branch {b} t={blens[b]}")


# ------------------------------------------------ full 5-taxon parity -----
def _random_sequences(n_taxa, sites, alphabet="ACGT-RYKMN"):
    return ["".join(RNG.choice(list(alphabet), sites)) for _ in range(n_taxa)]


def _five_taxon_setup(states, sites, rate_cats, scaling, pinv=0.0,
                      seqs=None, blens=None, asc=None):
    """Build identical reference and rebuild partitions for the classic 5-taxon
    unrooted topology used throughout the reference tests
    (test/src/00010_NMDU_lkcalc.c:41-204)."""
    params, freqs = _random_model(states)
    if blens is None:
        blens = RNG.uniform(0.05, 1.5, 8)
    if seqs is None:
        assert states == 4
        seqs = _random_sequences(5, sites)
    charmap = maps.pll_map_nt if states == 4 else maps.pll_map_aa
    if rate_cats > 1:
        rates = compute_gamma_cats(0.75, rate_cats)
    else:
        rates = np.ones(1)

    attribs = 0
    if scaling == "rate":
        attribs |= 1 << 9  # PLL_ATTRIB_RATE_SCALERS
    if asc is not None:
        attribs |= asc_attrib(asc)

    ref = oracle.RefPartition(5, 4, states, sites, 1, 8, rate_cats, 4,
                              attributes=attribs)
    mine = pll.Partition(5, 4, states, sites, 1, 8, rate_cats, 4,
                         scaling=scaling, asc_bias_alloc=asc is not None)
    for part in (ref, mine):
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, params)
        part.set_category_rates(rates)
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, charmap, s)
        mine.set_tip_states(i, charmap, s)
    if pinv:
        ref.set_invariant_proportion(0, pinv)
        mine.update_invariant_sites_proportion(0, pinv)

    pidx = np.zeros(rate_cats, int)
    ref.update_prob_matrices(pidx, np.arange(8), blens)
    mine.update_prob_matrices(pidx, np.arange(8), blens)

    # post-order schedule for ((0,1),(2,3),4); CLVs 5..8, scalers 0..3
    ops = [
        (5, 0, 0, 0, -1, 1, 1, -1),
        (6, 1, 2, 2, -1, 3, 3, -1),
        (7, 2, 5, 4, 0, 6, 5, 1),
        (8, 3, 7, 6, 2, 4, 7, -1),
    ]
    ref.update_partials(ops)
    mine.update_partials([pll.Operation(*o) for o in ops])
    return ref, mine, pidx


def asc_attrib(name):
    # PLL_ATTRIB_AB_* (pll.h:116-120); AB_FLAG = 1<<8 activates the type
    return {"lewis": 1 << 5, "felsenstein": 2 << 5,
            "stamatakis": 3 << 5}[name] | (1 << 8)


@pytest.mark.parametrize("rate_cats", [1, 4])
@pytest.mark.parametrize("scaling", ["site", "rate"])
@pytest.mark.parametrize("pinv", [0.0, 0.3])
def test_five_taxon_loglikelihood_parity(rate_cats, scaling, pinv):
    ref, mine, pidx = _five_taxon_setup(4, 60, rate_cats, scaling, pinv=pinv)

    # edge logl at the root edge (clv 8 vs tip 4 is internal edge 7<->8)
    ref_logl = ref.edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    my_logl = mine.compute_edge_loglikelihood(8, 3, 7, 2, 6, pidx)
    np.testing.assert_allclose(my_logl, ref_logl, rtol=1e-10)

    if scaling == "site":
        # root logl at clv 8 (per-rate root is unsupported in the reference)
        ref_logl, ref_ps = ref.root_loglikelihood(8, 3, pidx, persite=True)
        my_logl, my_ps = mine.compute_root_loglikelihood(8, 3, pidx,
                                                         persite=True)
        np.testing.assert_allclose(my_logl, ref_logl, rtol=1e-10)
        np.testing.assert_allclose(my_ps, ref_ps, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("scaling", ["site", "rate"])
def test_five_taxon_clv_and_scaler_parity(scaling):
    ref, mine, _ = _five_taxon_setup(4, 40, 4, scaling)
    states = 4
    for node in range(5, 9):
        refclv = ref.get_clv(node)  # [L, C, Spad]
        myclv = np.asarray(mine.clv[node])  # [C, S, L]
        np.testing.assert_allclose(
            myclv, refclv[:, :, :states].transpose(1, 2, 0),
            rtol=1e-10, atol=1e-300, err_msg=f"clv {node}")
    for sb in range(4):
        refsc = ref.get_scaler(sb)
        mysc = np.asarray(mine.scalers[sb])
        if scaling == "rate":
            refsc = refsc.reshape(-1, mine.rate_cats).T  # [C, L]
        np.testing.assert_array_equal(mysc, refsc, err_msg=f"scaler {sb}")


def test_deep_tree_triggers_scaling():
    """Chain enough nodes that CLVs underflow 2**-256 and scalers engage."""
    sites, states, rate_cats = 30, 4, 2
    n_inner = 300
    params, freqs = _random_model(states)
    seqs = _random_sequences(3, sites, alphabet="ACGT")

    ref = oracle.RefPartition(3, n_inner, states, sites, 1, 2, rate_cats,
                              n_inner)
    mine = pll.Partition(3, n_inner, states, sites, 1, 2, rate_cats, n_inner,
                         scaling="site")
    for part in (ref, mine):
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, params)
        part.set_category_rates(np.array([0.5, 1.5]))
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, maps.pll_map_nt, s)
        mine.set_tip_states(i, maps.pll_map_nt, s)
    pidx = np.zeros(rate_cats, int)
    # long branches make each pruning step attenuate the CLV by ~4x per
    # site, so 300 chained nodes push well past the 2**-256 threshold
    blens = np.array([0.9, 1.3])
    ref.update_prob_matrices(pidx, np.arange(2), blens)
    mine.update_prob_matrices(pidx, np.arange(2), blens)

    # caterpillar: node k combines previous inner (or tips) repeatedly
    ops = [(3, 0, 0, 0, -1, 1, 1, -1)]
    for k in range(1, n_inner):
        ops.append((3 + k, k, 2 + k, k % 2, k - 1, 2, 1, -1))
    ref.update_partials(ops)
    mine.update_partials([pll.Operation(*o) for o in ops])

    top_scaler = np.asarray(mine.scalers[n_inner - 1])
    assert top_scaler.max() > 0, "test should exercise scaling"
    ref_logl = ref.root_loglikelihood(2 + n_inner, n_inner - 1, pidx)
    my_logl = mine.compute_root_loglikelihood(2 + n_inner, n_inner - 1, pidx)
    np.testing.assert_allclose(my_logl, ref_logl, rtol=1e-10)
