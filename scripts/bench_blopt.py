#!/usr/bin/env python3
"""Device-resident branch-length optimization at scale.

Optimizes all 2n-3 branch lengths of a random `tips`-taxon tree over
`sites` random DNA sites with the whole-sweep compiled program
(engine/blopt.optimize_branch_lengths_scan) and reports per-sweep
wall-clock.  The per-edge host loop would pay ~4 dispatches x (2n-3)
edges per sweep; the scan program pays ONE.

Usage: python scripts/bench_blopt.py [tips] [sites] [cpu]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax

tips = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
sites = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
if len(sys.argv) > 3 and sys.argv[3] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import libpll_tpu as pll
from libpll_tpu.engine import blopt
from libpll_tpu.tree import utree as ut

print("platform:", jax.devices()[0].platform, flush=True)
rng = np.random.default_rng(11)
items = [f"t{i}:{rng.uniform(0.05, 0.4):.4f}" for i in range(tips)]
while len(items) > 3:
    i, j = sorted(rng.choice(len(items), 2, replace=False))
    b = items.pop(j)
    a = items.pop(i)
    items.append(f"({a},{b}):{rng.uniform(0.05, 0.4):.4f}")
tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")

part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4,
                     tips - 2, dtype=jnp.float32)
order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
alpha = "ACGT"
for i in range(tips):
    part.set_tip_states(order[f"t{i}"], pll.maps.pll_map_nt,
                        "".join(alpha[s] for s in rng.integers(0, 4, sites)))
part.set_frequencies(0, [0.3, 0.25, 0.25, 0.2])
part.set_subst_params(0, [1.2, 2.4, 0.9, 1.1, 3.0, 1.0])
part.set_category_rates(pll.compute_gamma_cats(1.0, 4))

t0 = time.perf_counter()
logl, sweeps = blopt.optimize_branch_lengths_scan(tree, part, [0] * 4,
                                                  max_sweeps=3, tol=1e-4)
dt = time.perf_counter() - t0
n_edges = 2 * tips - 3
print(f"{tips} taxa x {sites} sites: {sweeps} sweeps over {n_edges} edges "
      f"in {dt:.1f}s total (incl. one-time compile), final logL {logl:.2f}")
