#!/usr/bin/env python3
"""SPR search round at scale on the live backend.

Builds a random `tips`-taxon tree over `sites` random DNA sites, runs
likelihood SPR rounds with the schedule-as-data incremental scorer
(search/spr.py) and reports per-round and per-candidate wall-clock plus the
zero-recompile check — the verdict's "SPR round on a >=1024-taxon tree with
0 recompiles after warmup" criterion.

Usage: python scripts/bench_spr.py [tips] [sites] [rounds] [radius] [cpu]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax

tips = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
sites = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 3
radius = int(sys.argv[4]) if len(sys.argv) > 4 else 3
if len(sys.argv) > 5 and sys.argv[5] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import libpll_tpu as pll
from libpll_tpu.search import spr as spr_search
from libpll_tpu.tree import utree as ut

print("platform:", jax.devices()[0].platform, flush=True)

rng = np.random.default_rng(3)
items = [f"t{i}:{rng.uniform(0.05, 0.4):.4f}" for i in range(tips)]
while len(items) > 3:
    i, j = sorted(rng.choice(len(items), 2, replace=False))
    b = items.pop(j)
    a = items.pop(i)
    items.append(f"({a},{b}):{rng.uniform(0.05, 0.4):.4f}")
newick = f"({items[0]},{items[1]},{items[2]});"

tree = ut.parse_newick_string(newick)
part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4,
                     tips - 2, dtype=jnp.float32)
order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
alpha = "ACGT"
for i in range(tips):
    seq = "".join(alpha[s] for s in rng.integers(0, 4, sites))
    part.set_tip_states(order[f"t{i}"], pll.maps.pll_map_nt, seq)
part.set_frequencies(0, [0.3, 0.25, 0.25, 0.2])
part.set_subst_params(0, [1.2, 2.4, 0.9, 1.1, 3.0, 1.0])
part.set_category_rates(pll.compute_gamma_cats(1.0, 4))

cap = 128
scorer = spr_search.make_round_scorer(part, cap)
# restrict prune set so a round is a measurable, bounded batch
prune = [n for n in ut.query_innernodes(tree)][: 64]

for r in range(rounds):
    cands = spr_search.spr_neighborhood(tree, radius, prune_nodes=prune)
    t0 = time.perf_counter()
    res = spr_search.spr_round(tree, part, [0] * 4, capacity=cap,
                               batch=32, candidates=cands, scorer=scorer)
    dt = time.perf_counter() - t0
    per = dt / max(res.n_candidates, 1) * 1e3
    print(f"round {r}: {res.n_candidates} candidates in {dt:.2f}s "
          f"({per:.1f} ms/candidate incl. host encode), "
          f"max dirty ops {res.n_ops_max}, logL {res.logl0:.2f} -> "
          f"{res.best_logl:.2f} improved={res.improved}", flush=True)

print("scorer compilations:", scorer._cache_size(),
      "(1 == zero recompiles across rounds)")
assert scorer._cache_size() == 1
