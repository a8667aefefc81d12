"""Simulated DNA alignments with real phylogenetic signal.

Sequences evolve down a random binary tree under GTR+Γ4, so a tree search
has work to do (uniform-random data leaves every topology near-equally
bad) and the generating topology is known for RF comparisons.
"""

from __future__ import annotations

import numpy as np

from ..models.gamma import compute_gamma_cats
from ..models.gtr import eigen_decompose

FREQS = np.array([0.3, 0.25, 0.2, 0.25])
SUBST_PARAMS = np.array([1.2, 2.7, 0.8, 1.1, 3.2, 1.0])
ALPHA = 0.8


def random_tree_newick(tips: int, rng) -> str:
    """Random unrooted binary topology by random pairwise joins, branch
    lengths uniform in [0.05, 0.5)."""
    items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def caterpillar_newick(tips: int, length: float = 0.1) -> str:
    """The maximally unbalanced (deepest) topology on ``tips`` taxa."""
    b = f"{length}"
    s = f"(t0:{b},t1:{b})"
    for i in range(2, tips - 2):
        s = f"({s}:{b},t{i}:{b})"
    return f"({s}:{b},t{tips - 2}:{b},t{tips - 1}:{b});"


def _pmatrix(w, left, right, t):
    """P(t) = left @ diag(expm1(w t)) @ right + I (ops/pmatrix.py), rows
    renormalized."""
    p = (left * np.expm1(w * t)[None, :]) @ right + np.eye(len(w))
    p = np.clip(p, 0.0, None)
    return p / p.sum(1, keepdims=True)


def evolve_down_tree(tree, sites, w, left, right, freqs, rng, rates=(1.0,)):
    """Evolve ``sites`` columns down an unrooted UTree under the GTR
    process given by its eigendecomposition (``w``, ``left``, ``right``).

    The root sequence is drawn from ``freqs`` at ``tree.root``; each site
    draws one rate category of ``rates`` (uniform weights).  Returns
    [tips, sites] uint8 states indexed by the tips' ``clv_index``.
    """
    states = len(freqs)
    rates = np.asarray(rates, np.float64)
    cat = rng.integers(0, len(rates), sites)

    def evolve(seq, t):
        p = np.stack([_pmatrix(w, left, right, r * t) for r in rates])
        cdf = np.cumsum(p[cat, seq], axis=1)  # [sites, states]
        u = rng.random(sites)
        return np.minimum((u[:, None] > cdf).sum(1), states - 1).astype(
            np.uint8)

    out = np.empty((tree.tip_count, sites), np.uint8)
    root = tree.root
    root_seq = rng.choice(states, size=sites, p=freqs).astype(np.uint8)
    # stack of (node entered via its .back edge, sequence at that vertex)
    stack = [(m.back, evolve(root_seq, m.length))
             for m in (root, root.next, root.next.next)]
    while stack:
        node, seq = stack.pop()
        if node.is_tip:
            out[node.clv_index] = seq
            continue
        for m in (node.next, node.next.next):
            stack.append((m.back, evolve(seq, m.length)))
    return out


def simulate_dna(tips: int, sites: int, seed: int = 11):
    """Evolve ``sites`` DNA columns under GTR+Γ4 down a random ``tips``-taxon
    tree (:func:`evolve_down_tree`).

    Returns ``(sequences, truth_newick)``: label -> ACGT string, and the
    generating topology as unrooted Newick.  Deterministic in ``seed``.
    """
    from ..tree import utree as ut

    rng = np.random.default_rng(seed)
    w, left, right = eigen_decompose(SUBST_PARAMS, FREQS)
    rates = np.asarray(compute_gamma_cats(ALPHA, 4))

    # random binary tree by leaf splitting
    parent, blen = {0: -1}, {0: 0.0}
    leaves, next_id = [0], 1
    while len(leaves) < tips:
        node = leaves.pop(rng.integers(len(leaves)))
        for _ in range(2):
            parent[next_id] = node
            blen[next_id] = rng.uniform(0.02, 0.4)
            leaves.append(next_id)
            next_id += 1

    children = {}
    for node, par in parent.items():
        if node:
            children.setdefault(par, []).append(node)
    leaf_label = {n: f"t{i}" for i, n in enumerate(leaves)}

    def newick(node):
        # iterative post-order: deep trees exceed the recursion limit
        out = {}
        stack = [(node, False)]
        while stack:
            n, ready = stack.pop()
            if n in leaf_label:
                out[n] = f"{leaf_label[n]}:{blen[n]:.5f}"
            elif ready:
                a, b = children[n]
                out[n] = f"({out[a]},{out[b]}):{blen[n]:.5f}"
            else:
                stack.append((n, True))
                stack.extend((c, False) for c in children[n])
        return out[node]

    left_root, right_root = children[0]
    if right_root not in children:  # a leaf: expand the left side instead
        left_root, right_root = right_root, left_root
    rl, rr = children[right_root]
    truth = f"({newick(left_root)},{newick(rl)},{newick(rr)});"

    tree = ut.parse_newick_string(truth)
    seqs = evolve_down_tree(tree, sites, w, left, right, FREQS, rng, rates)
    alphabet = np.array(list("ACGT"))
    return ({node.label: "".join(alphabet[seqs[node.clv_index]])
             for node in ut.query_tipnodes(tree)}, truth)
