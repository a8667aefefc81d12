"""Incremental re-evaluation after topology moves (SURVEY §3.5; reference
examples/partial-traversal/partial.c + utree_moves.c): after an SPR/NNI,
refresh only the changed P-matrices and the invalidated CLVs — the partial
traversal must yield a *strict subset* of the full schedule — and the edge
log-likelihood must equal a from-scratch evaluation of the new topology.
Rollback must restore the original logL exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

import libpll_tpu as pll
from libpll_tpu.tree import incremental as inc
from libpll_tpu.tree import moves, utree as ut

NEWICK = ("((A:0.10,B:0.20):0.30,((C:0.15,D:0.25):0.12,"
          "(E:0.08,F:0.30):0.22):0.05,G:0.40);")
SEQS = {
    "A": "ACGTACGTACGTACGTACGT", "B": "ACGTACGTTCGTACGAACGT",
    "C": "ACGAACGTACGAACGTACGT", "D": "CCGTACGTACGTACTTACGT",
    "E": "ACGTACGGACGTACGTACGG", "F": "ACTTACGTACGTACGTACGT",
    "G": "ACGTACGTACGCACGTAAGT",
}
TIPS, SITES, CATS = 7, 20, 4


def _fresh():
    tree = ut.parse_newick_string(NEWICK)
    part = pll.Partition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3, CATS,
                         TIPS - 2)
    trav = ut.traverse(tree.root)
    order = {n.label: n.clv_index for n in trav if n.label}
    for lab in SEQS:
        part.set_tip_states(order[lab], pll.maps.pll_map_nt, SEQS[lab])
    part.set_frequencies(0, [0.3, 0.25, 0.25, 0.2])
    part.set_subst_params(0, [1.2, 2.4, 0.9, 1.1, 3.0, 1.0])
    part.set_category_rates(pll.compute_gamma_cats(0.7, CATS))
    return tree, part


def _full_eval(tree, part):
    """Full traversal + schedule; marks per-direction validity flags."""
    trav = ut.traverse(tree.root)
    ops, blens, midx = ut.create_operations(trav)
    part.update_prob_matrices([0] * CATS, midx, blens)
    part.update_partials(ops)
    inc.mark_valid(trav)
    r = tree.root
    return part.compute_edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, [0] * CATS)


def _eval_edge(tree, part):
    r = tree.root
    return part.compute_edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, [0] * CATS)


def _scratch_logl(tree):
    """From-scratch evaluation of the same topology on a fresh partition."""
    tree_check = ut.parse_newick_string(ut.export_newick(tree.root))
    part2 = _fresh()[1]
    trav = ut.traverse(tree_check.root)
    order = {n.label: n.clv_index for n in trav if n.label}
    for lab in SEQS:
        part2.set_tip_states(order[lab], pll.maps.pll_map_nt, SEQS[lab])
    return _full_eval(tree_check, part2)


def _incremental_eval(tree, part, changed):
    """Refresh changed P-matrices + the minimal invalidated op subset;
    returns (logl, n_partial_ops)."""
    if changed:
        bl = [b for b, _ in changed]
        mi = [m for _, m in changed]
        part.update_prob_matrices([0] * CATS, mi, bl)
    dirty = inc.partial_traverse(tree.root)
    ops = inc.create_partial_operations(dirty)
    if ops:
        part.update_partials(ops)
    return _eval_edge(tree, part), len(ops)


def test_spr_incremental_is_partial():
    tree, part = _fresh()
    logl0 = _full_eval(tree, part)
    n_full = TIPS - 2  # inner nodes in the full schedule

    # repeated evaluation with no changes: empty op subset, identical logL
    logl_again, n_ops = _incremental_eval(tree, part, [])
    assert n_ops == 0
    assert logl_again == logl0

    # SPR: pick the first legal (prune node, regraft edge) pair
    from libpll_tpu.errors import SprError
    trav = ut.traverse(tree.root)
    inner = [n for n in trav if not n.is_tip and n is not tree.root]
    rb = moves.Rollback(moves.MOVE_SPR)
    changed = None
    for p in inner:
        for r in trav:
            try:
                changed = moves.spr_safe(p, r, rollback=rb)
                break
            except SprError:
                continue
        if changed:
            break
    assert changed, "no legal SPR found"

    logl_inc, n_ops = _incremental_eval(tree, part, changed)
    # the partial schedule must be a STRICT subset of the full schedule —
    # this fails if invalidation degenerates to a full recompute
    assert 0 < n_ops < n_full, (n_ops, n_full)

    assert abs(logl_inc - _scratch_logl(tree)) < 1e-9
    assert abs(logl_inc - logl0) > 1e-6  # the move actually changed the tree

    # rollback restores the original logL bit-for-bit, again incrementally
    restored = moves.rollback_move(rb)
    logl_back, n_ops_back = _incremental_eval(tree, part, restored)
    assert 0 < n_ops_back < n_full
    assert logl_back == logl0


def test_nni_incremental_is_partial():
    tree, part = _fresh()
    logl0 = _full_eval(tree, part)
    n_full = TIPS - 2

    trav = ut.traverse(tree.root)
    # an inner edge: both endpoints inner
    edge = next(n for n in trav
                if not n.is_tip and not n.back.is_tip and n is not tree.root)
    rb = moves.Rollback(moves.MOVE_NNI)
    moves.nni(edge, moves.NNI_LEFT, rollback=rb)

    # NNI keeps branch/pmatrix pairings: no P-matrix refresh needed
    logl_nni, n_ops = _incremental_eval(tree, part, [])
    assert 0 < n_ops < n_full, (n_ops, n_full)
    assert abs(logl_nni - _scratch_logl(tree)) < 1e-9

    moves.rollback_move(rb)
    logl_back, n_ops_back = _incremental_eval(tree, part, [])
    assert 0 < n_ops_back < n_full
    assert logl_back == logl0


def test_branch_length_change_invalidates_edge():
    """Changing one branch length invalidates only the directions looking
    through that edge (reference newton-loop usage pattern)."""
    tree, part = _fresh()
    logl0 = _full_eval(tree, part)

    # pick an inner edge away from the root and stretch it
    trav = ut.traverse(tree.root)
    edge = next(n for n in trav
                if not n.is_tip and not n.back.is_tip and n is not tree.root
                and n.back is not tree.root)
    edge.length = edge.back.length = edge.length + 0.17
    inc.invalidate_edge(edge)

    logl_new, n_ops = _incremental_eval(
        tree, part, [(edge.length, edge.pmatrix_index)])
    assert 0 < n_ops < TIPS - 2
    assert abs(logl_new - _scratch_logl(tree)) < 1e-9
    assert abs(logl_new - logl0) > 1e-8


def test_hky_via_gtr_parameterization():
    """HKY (reference test/src/hky.c): ti/tv ratio k as GTR params
    [1,k,1,1,k,1]; logL must match the oracle."""
    import sys
    sys.path.insert(0, "tests")
    import oracle
    if not oracle.available():
        pytest.skip("no oracle")

    k = 2.5
    params = [1.0, k, 1.0, 1.0, k, 1.0]
    freqs = [0.3, 0.25, 0.25, 0.2]

    tree, part = _fresh()
    part.set_subst_params(0, params)
    part.set_frequencies(0, freqs)
    logl = _full_eval(tree, part)

    ref = oracle.RefPartition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3,
                              CATS, TIPS - 2)
    trav = ut.traverse(tree.root)
    order = {n.label: n.clv_index for n in trav if n.label}
    for lab in SEQS:
        ref.set_tip_states(order[lab], oracle.map_table("pll_map_nt"),
                           SEQS[lab])
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, params)
    from libpll_tpu.models.gamma import compute_gamma_cats
    ref.set_category_rates(compute_gamma_cats(0.7, CATS))
    ops, blens, midx = ut.create_operations(trav)
    ref.update_prob_matrices([0] * CATS, midx, blens)
    ref.update_partials([o.as_tuple() for o in ops])
    r = tree.root
    ref_logl = ref.edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, [0] * CATS)
    np.testing.assert_allclose(logl, ref_logl, rtol=1e-10)


def test_peek_index_matches_peek_partial_exactly():
    """PeekIndex (the per-round Euler-interval oracle) must reproduce
    peek_partial's output exactly — same nodes, same post-order — across
    random SPR and NNI candidates, including prune subtrees that contain
    the evaluation root (the orientation-flip case, where the oracle may
    only err toward descending)."""
    from libpll_tpu.tree import moves
    from libpll_tpu.tree import incremental as inc_mod

    rng = np.random.default_rng(123)
    for trial in range(6):
        tips = int(rng.integers(8, 40))
        from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick
        tree = ut.parse_newick_string(_random_tree_newick(tips, rng))
        root = tree.root
        trav = ut.traverse(root)
        inc_mod.mark_valid(trav)
        idx = inc_mod.PeekIndex(root)

        inners = [n for n in ut.query_innernodes(tree)]
        all_dirs = []
        for n in inners:
            all_dirs.extend(n.ring())
        checked = 0
        for _ in range(60):
            p = all_dirs[rng.integers(len(all_dirs))]
            r = all_dirs[rng.integers(len(all_dirs))]
            snap = inc_mod.snapshot_flags(
                [p, p.next.back, p.next.next.back, r, r.back])
            rb = moves.Rollback(moves.MOVE_SPR)
            with moves.record_flips() as flips:
                try:
                    # plain spr (not spr_safe): containment of the eval
                    # root inside the pruned subtree is exactly the edge
                    # case we want covered; r inside the pruned subtree
                    # corrupts the tree, so keep the containment check
                    if moves._subtree_contains(p.back, r):
                        raise moves.SprError("contained")
                    moves.spr(p, r, rollback=rb)
                except moves.SprError:
                    inc_mod.restore_flags(snap)
                    continue
            want = inc_mod.peek_partial(root)
            got = idx.peek(flips)
            moves.rollback_move(rb)
            inc_mod.restore_flags(snap)
            assert [id(n) for n in got] == [id(n) for n in want], (
                trial, tips, checked)
            checked += 1
        assert checked > 10

        # NNI sweep over every inner edge, both types
        for n in inners:
            for m in n.ring():
                if m.back.next is None:
                    continue
                for t in (moves.NNI_LEFT, moves.NNI_RIGHT):
                    snap = inc_mod.snapshot_flags(
                        [m, m.back, m.next.back, m.back.next.back,
                         m.back.next.next.back])
                    rb = moves.Rollback(moves.MOVE_NNI)
                    with moves.record_flips() as flips:
                        moves.nni(m, t, rollback=rb)
                    want = inc_mod.peek_partial(root)
                    got = idx.peek(flips)
                    moves.rollback_move(rb)
                    inc_mod.restore_flags(snap)
                    assert [id(x) for x in got] == [id(x) for x in want]


def test_peek_index_contains_matches_subtree_contains():
    """PeekIndex.contains must equal moves._subtree_contains for every
    (directed start, target) pair on the base topology."""
    from libpll_tpu.tree import moves
    from libpll_tpu.tree import incremental as inc_mod
    from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick

    rng = np.random.default_rng(77)
    for tips in (8, 13, 27):
        tree = ut.parse_newick_string(_random_tree_newick(tips, rng))
        root = tree.root
        inc_mod.mark_valid(ut.traverse(root))
        idx = inc_mod.PeekIndex(root)

        dirs = []
        for n in tree.nodes:
            dirs.extend([n] if n.is_tip else list(n.ring()))
        for start in dirs:
            if start.is_tip:
                continue
            for target in dirs:
                want = moves._subtree_contains(start, target)
                got = idx.contains(start, target)
                assert got == want, (tips, start.node_index,
                                     target.node_index)
