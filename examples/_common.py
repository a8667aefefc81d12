"""Shared setup for the example scripts: a small DNA alignment + tree.

Examples default to the CPU backend so they run anywhere; set
LIBPLL_EXAMPLES_DEVICE=1 to use JAX's default backend (the GPU).
"""

import os
import sys

# run from anywhere without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if not os.environ.get("LIBPLL_EXAMPLES_DEVICE"):
    import jax
    jax.config.update("jax_platforms", "cpu")

NEWICK = ("((A:0.10,B:0.20):0.30,((C:0.15,D:0.25):0.12,"
          "(E:0.08,F:0.30):0.22):0.05,G:0.40);")

SEQS = {
    "A": "ACGTACGTACGTACGTACGT",
    "B": "ACGTACGTTCGTACGAACGT",
    "C": "ACGAACGTACGAACGTACGT",
    "D": "CCGTACGTACGTACTTACGT",
    "E": "ACGTACGGACGTACGTACGG",
    "F": "ACTTACGTACGTACGTACGT",
    "G": "ACGTACGTACGCACGTAAGT",
}


def dna_partition(rate_cats=4, alpha=0.8):
    """(tree, partition, traversal): the standard example setup."""
    import libpll_tpu as pll
    from libpll_tpu.tree import utree as ut

    tree = ut.parse_newick_string(NEWICK)
    tips = tree.tip_count
    part = pll.Partition(tips, tips - 2, 4, len(SEQS["A"]), 1,
                         2 * tips - 3, rate_cats, tips - 2)
    trav = ut.traverse(tree.root)
    order = {n.label: n.clv_index for n in trav if n.label}
    for lab, seq in SEQS.items():
        part.set_tip_states(order[lab], pll.maps.pll_map_nt, seq)
    part.set_frequencies(0, [0.3, 0.25, 0.25, 0.2])
    part.set_subst_params(0, [1.2, 2.4, 0.9, 1.1, 3.0, 1.0])
    part.set_category_rates(pll.compute_gamma_cats(alpha, rate_cats))
    return tree, part, trav
