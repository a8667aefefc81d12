#!/usr/bin/env python3
"""End-to-end ML tree inference benchmark (time-to-tree).

Runs the composed driver `search.infer.infer_tree` — the workflow libpll
users assemble by hand from the library's pieces (reference:
`src/stepwise.c` starting trees + `src/utree_moves.c` SPR loops + the
newton example's branch-length optimization; the reference ships no
composed search driver itself) — on simulated data with real
phylogenetic signal (libpll_tpu/utils/simulate.py), on JAX's default
backend, and reports per-phase wall-clock plus the final log-likelihood.

Validation: the final tree + branch lengths are re-scored by the plain
float64 reference on the CPU (libpll_tpu/engine/reference.py); |Δ logL|
must sit inside the float32 accuracy budget (2e-6·|logL| + 5e-3), or
1e-6·|logL| for a float64 run.

Usage: python scripts/bench_infer.py [tips] [sites] [float32|float64]
"""

import sys
import time

tips = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
sites = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
dtype_name = sys.argv[3] if len(sys.argv) > 3 else "float32"

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

import libpll_tpu  # noqa: F401  (x64)

print("platform:", jax.devices()[0].platform, jax.devices()[0].device_kind,
      flush=True)
DTYPE = jnp.dtype(dtype_name)


def main():
    from libpll_tpu.search.infer import infer_tree
    from libpll_tpu.utils.simulate import ALPHA, simulate_dna

    print(f"simulating {tips} x {sites} DNA...", flush=True)
    t0 = time.perf_counter()
    data, truth_newick = simulate_dna(tips, sites)
    assert len(data) == tips, len(data)
    print(f"  simulated in {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    # min_delta 1e-2: at bench scale (|logL| ~ 1e6-1e7) smaller deltas are
    # Newton-sweep noise and only add no-progress rounds
    res = infer_tree(data, alpha=ALPHA, seed=42, dtype=DTYPE, min_delta=1e-2,
                     spr_batch=128)
    total = time.perf_counter() - t0
    print(f"ours: time-to-tree {total:.1f}s  logL={res.logl:.3f}  "
          f"rounds={res.rounds}  parsimony_start={res.start_parsimony_score}")
    print("  phases:", {k: round(v, 2) for k, v in res.timings.items()})
    print("  trajectory:", [round(x, 1) for x in res.trajectory])

    # topology quality vs the generating tree (0 = exact recovery; the
    # normalized form divides by the 2(n-3) maximum)
    from libpll_tpu.tree import utree as ut
    from libpll_tpu.tree.compare import rf_distance
    truth = ut.parse_newick_string(truth_newick)
    rf = rf_distance(res.tree, truth)
    rf_max = 2 * (tips - 3)
    print(f"RF distance to generating topology: {rf}/{rf_max} "
          f"(normalized {rf/rf_max:.4f})", flush=True)

    # float64 reference re-score of the final tree
    from libpll_tpu.engine.reference import rescore_alignment

    t0 = time.perf_counter()
    want = rescore_alignment(res.tree, data, alpha=ALPHA)
    t_eval = time.perf_counter() - t0
    budget = (1e-6 * abs(want) if DTYPE == jnp.float64
              else 2e-6 * abs(want) + 5e-3)
    print(f"f64 reference re-score of our final tree: {want:.3f}  "
          f"|Δ|={abs(res.logl - want):.4f}  budget={budget:.3f}  "
          f"(one f64 CPU eval: {t_eval:.1f}s)")
    assert abs(res.logl - want) <= budget, (res.logl, want)


if __name__ == "__main__":
    main()
