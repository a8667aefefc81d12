"""Level-parallel sweep equivalence and multi-device site sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import libpll_tpu as pll
from libpll_tpu.io import maps
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.ops import clv as clv_ops
from libpll_tpu.parallel import mesh as pmesh
from libpll_tpu.tree import schedule as sched
from libpll_tpu.tree import utree as ut

RNG = np.random.default_rng(3)


def _random_tree_newick(n_tips):
    """Random binary topology over taxa t0..t{n-1} with random lengths."""
    items = [f"t{i}:{RNG.uniform(0.05, 0.5):.4f}" for i in range(n_tips)]
    while len(items) > 3:
        i, j = sorted(RNG.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{RNG.uniform(0.05, 0.5):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def _build_partition(n_tips, sites, rate_cats=4, dtype=jnp.float64,
                     scaling="site"):
    tree = ut.parse_newick_string(_random_tree_newick(n_tips))
    trav = ut.traverse(tree.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    part = pll.Partition(n_tips, n_tips - 2, 4, sites, 1,
                         len(branches), rate_cats, n_tips - 2,
                         scaling=scaling, dtype=dtype)
    params = RNG.uniform(0.5, 2.0, 6)
    freqs = RNG.uniform(0.1, 1.0, 4)
    freqs /= freqs.sum()
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, params)
    part.set_category_rates(compute_gamma_cats(1.0, rate_cats))
    for node in tree.nodes[:n_tips]:
        part.set_tip_states(node.clv_index, maps.pll_map_nt,
                            "".join(RNG.choice(list("ACGT"), sites)))
    pidx = np.zeros(rate_cats, int)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    return tree, part, ops, pidx


def test_leveled_sweep_matches_sequential():
    tree, part, ops, pidx = _build_partition(16, 37)
    # sequential (kernels donate their buffers, so pass copies)
    clv_seq, scal_seq = clv_ops.update_partials(
        jnp.array(part.clv), jnp.array(part.scalers), jnp.asarray(
            pll.engine.partition.operations_to_array(ops,
                                                     part.scale_buffers)),
        part.pmatrix, scale_mode=part.scale_mode)
    # leveled
    level_ops, level_valid = sched.build_levels(ops, part.scale_buffers)
    clv_lev, scal_lev = clv_ops.update_partials_leveled(
        jnp.array(part.clv), jnp.array(part.scalers), jnp.asarray(level_ops),
        jnp.asarray(level_valid), part.pmatrix, scale_mode=part.scale_mode)
    np.testing.assert_allclose(np.asarray(clv_lev), np.asarray(clv_seq),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(scal_lev), np.asarray(scal_seq))


def test_levels_respect_dependencies():
    tree = ut.parse_newick_string(_random_tree_newick(24))
    ops, _, _ = ut.create_operations(ut.traverse(tree.root))
    level_ops, valid = sched.build_levels(ops, 22)
    available = set(range(24))
    for lvl in range(level_ops.shape[0]):
        produced = set()
        for row in level_ops[lvl]:
            assert int(row[2]) in available
            assert int(row[5]) in available
            produced.add(int(row[0]))
        available |= produced


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_site_sharded_loglikelihood_matches_single_device():
    n_dev = len(jax.devices())
    sites = pmesh.pad_sites(100, pmesh.make_sites_mesh())
    tree, part, ops, pidx = _build_partition(12, sites)
    root = tree.root
    part.update_partials(ops)
    want = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, pidx)

    # fresh partition, sharded across the mesh before any compute
    tree2, part2, ops2, _ = _build_partition(12, sites)
    # rebuild identically (same RNG would diverge) -> instead shard the same
    # partition's buffers and recompute
    mesh = pmesh.make_sites_mesh()
    pmesh.shard_partition(part, mesh)
    part.update_partials(ops)
    got = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, pidx)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the CLV really is distributed
    assert len(part.clv.sharding.device_set) == n_dev


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_shard_partition_allocates_clv_sharded():
    """On a fresh partition shard_partition allocates no CLV: the tensor
    is created at its first read already split over the mesh, and the
    staged tips reach each device as its own shard, so it is never whole
    on one device.  The values equal a single-device partition's."""
    mesh = pmesh.make_sites_mesh()
    sites = pmesh.pad_sites(100, mesh)
    seqs = ["".join(RNG.choice(list("ACGT-"), sites)) for _ in range(6)]

    def fresh():
        part = pll.Partition(6, 4, 4, sites, 1, 9, 4, 4)
        for i, s in enumerate(seqs):
            part.set_tip_states(i, maps.pll_map_nt, s)
        return part

    part = fresh()
    pmesh.shard_partition(part, mesh)
    assert part._clv is None
    clv = part.clv
    assert clv.sharding == pmesh.sharding_for_rank(mesh, 4)
    assert len(clv.sharding.device_set) == len(jax.devices())
    np.testing.assert_array_equal(np.asarray(clv), np.asarray(fresh().clv))


def test_site_sharded_spr_round_matches_single_device():
    """Tree search on a site-sharded partition: spr_round must run
    unmodified on the mesh (GSPMD partitions the schedule-as-data
    candidate scorer; the logL fold crosses the mesh as one psum) and
    reproduce the single-device round exactly, leaving the CLV tensor
    sharded."""
    from jax.sharding import Mesh

    from libpll_tpu.search import spr as spr_mod

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (virtual) mesh")

    def build(tips, sites, seed=0):
        rng = np.random.default_rng(seed)
        items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
        while len(items) > 3:
            i, j = sorted(rng.choice(len(items), 2, replace=False))
            b = items.pop(j)
            a = items.pop(i)
            items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
        tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")
        part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3,
                             4, tips - 2)
        alpha = np.array(list("ACGT"))
        seqs = rng.integers(0, 4, (tips, sites))
        for n in ut.query_tipnodes(tree):
            part.set_tip_states(n.clv_index, maps.pll_map_nt,
                                "".join(alpha[seqs[n.clv_index]]))
        part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        part.set_subst_params(0, [1.2, 2.1, 0.7, 1.4, 3.3, 1.0])
        part.set_category_rates(compute_gamma_cats(1.0, 4))
        return tree, part

    tips, sites = 16, 256
    tree1, part1 = build(tips, sites)
    res1 = spr_mod.spr_round(tree1, part1, [0] * 4, radius=3, batch=16)

    tree2, part2 = build(tips, sites)
    mesh = Mesh(np.asarray(jax.devices()), ("sites",))
    pmesh.shard_partition(part2, mesh)
    res2 = spr_mod.spr_round(tree2, part2, [0] * 4, radius=3, batch=16)

    assert res1.n_candidates == res2.n_candidates
    np.testing.assert_allclose(res2.logl0, res1.logl0, rtol=1e-12)
    np.testing.assert_allclose(res2.best_logl, res1.best_logl, rtol=1e-12)
    assert res1.best == res2.best
    assert "sites" in str(part2.clv.sharding.spec)


def test_site_sharded_blopt_matches_single_device():
    """The device-resident Newton branch-length sweep likewise runs
    unmodified on a site-sharded partition (GSPMD inserts the psum for
    the derivative folds) and matches the single-device result."""
    from jax.sharding import Mesh

    from libpll_tpu.engine import blopt

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (virtual) mesh")

    def build(tips, sites, seed=0):
        rng = np.random.default_rng(seed)
        items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
        while len(items) > 3:
            i, j = sorted(rng.choice(len(items), 2, replace=False))
            b = items.pop(j)
            a = items.pop(i)
            items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
        tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")
        part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3,
                             4, tips - 2)
        alpha = np.array(list("ACGT"))
        seqs = rng.integers(0, 4, (tips, sites))
        for n in ut.query_tipnodes(tree):
            part.set_tip_states(n.clv_index, maps.pll_map_nt,
                                "".join(alpha[seqs[n.clv_index]]))
        part.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        part.set_subst_params(0, [1.2, 2.1, 0.7, 1.4, 3.3, 1.0])
        part.set_category_rates(compute_gamma_cats(1.0, 4))
        return tree, part

    tips, sites = 16, 256
    tree1, part1 = build(tips, sites)
    l1, s1 = blopt.optimize_branch_lengths_scan(tree1, part1, [0] * 4,
                                                max_sweeps=2)
    tree2, part2 = build(tips, sites)
    mesh = Mesh(np.asarray(jax.devices()), ("sites",))
    pmesh.shard_partition(part2, mesh)
    l2, s2 = blopt.optimize_branch_lengths_scan(tree2, part2, [0] * 4,
                                                max_sweeps=2)
    assert s1 == s2
    np.testing.assert_allclose(l2, l1, rtol=1e-9)


def test_modelopt_runs_sharded():
    """optimize_model runs unmodified on a site-sharded partition (the
    gradient/L-BFGS program partitions under GSPMD) and reproduces the
    single-device fit."""
    from jax.sharding import Mesh

    from libpll_tpu.engine import modelopt

    tree, part, ops, pidx = _build_partition(10, 64)
    start_params = part.subst_params[0].copy()
    start_freqs = part.frequencies[0].copy()

    def rebuild():
        t = ut.parse_newick_string(ut.export_newick(tree.root))
        p2 = pll.Partition(10, 8, 4, 64, 1, part.prob_matrices, 4, 8)
        p2.set_frequencies(0, start_freqs)
        p2.set_subst_params(0, start_params)
        p2.set_category_rates(compute_gamma_cats(1.0, 4))
        p2.clv = p2.clv.at[:10].set(part.clv[:10])
        p2._tip_masks = part._tip_masks.copy()
        return t, p2

    t1, p1 = rebuild()
    res_single = modelopt.optimize_model(p1, t1, rounds=1, lbfgs_steps=20)

    t2, p2 = rebuild()
    mesh = Mesh(np.asarray(jax.devices()), ("sites",))
    pmesh.shard_partition(p2, mesh)
    res_sharded = modelopt.optimize_model(p2, t2, rounds=1, lbfgs_steps=20)

    np.testing.assert_allclose(res_sharded.logl, res_single.logl,
                               rtol=1e-9)
    np.testing.assert_allclose(res_sharded.frequencies,
                               res_single.frequencies, rtol=1e-6)
