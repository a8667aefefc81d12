#!/usr/bin/env python3
"""f32 fast-path accuracy at flagship scale, measured on the live backend.

Compares the f32 pattern-tip score (make_score_unbounded) on JAX's default
backend against the float64 level-sweep forward on the CPU, on the same
data, and prints one line per configuration:

    config | logL_f64 | logL_f32 | |delta| | budget(2e-6*|L|+5e-3) | ok

Run:  python scripts/bench_accuracy.py          (default backend)
      python scripts/bench_accuracy.py cpu      (CPU, small configurations)
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import jax

CPU = len(sys.argv) > 1 and sys.argv[1] == "cpu"
if CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as ev
from libpll_tpu.ops import tipcodes as tc
from libpll_tpu.utils.simulate import caterpillar_newick as _caterpillar_newick
from libpll_tpu.utils.simulate import random_tree_newick as _random_tree_newick

from score_cases import ACC_ABS, ACC_REL, _build

CONFIGS = [
    ("flagship 64x262144", _random_tree_newick, 64, 262144),
    ("deep 512-caterpillar x 8192", _caterpillar_newick, 512, 8192),
    ("large 1024 x 32768", _random_tree_newick, 1024, 32768),
    ("deep 4096-caterpillar x 2048", _caterpillar_newick, 4096, 2048),
]
if CPU:  # the CPU is slow: shrink
    CONFIGS = [
        ("flagship 32x8192", _random_tree_newick, 32, 8192),
        ("deep 64-caterpillar x 1024", _caterpillar_newick, 64, 1024),
    ]


def run(name, newick_fn, tips, sites):
    rng = np.random.default_rng(tips)
    newick = (newick_fn(tips, rng) if newick_fn is _random_tree_newick
              else newick_fn(tips))
    # float64 truth on the host CPU backend (f64 CLVs at these scales
    # are large; the level sweep is identical either way)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        topo, model, pmatrix, clv, scalers = _build(newick, sites=sites)
        t = topo.schedule.tips
        model64 = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32
                       else v) for k, v in model.items()}
        fwd = jax.jit(ev.make_forward(topo))
        want = float(fwd(model64, clv.astype(jnp.float64), scalers)[0])

    masks = tc.tip_masks_from_clv(clv[:t])
    if not CPU:
        dev = jax.devices()[0]
        model = {k: jax.device_put(np.asarray(v), dev)
                 for k, v in model.items()}
    score = ev.make_score_unbounded(topo, 4, 4, masks)
    got = float(score(model))

    delta = abs(got - want)
    budget = ACC_REL * abs(want) + ACC_ABS
    print(f"{name:32s} f64={want:16.4f} f32={got:16.4f} "
          f"|d|={delta:10.4g} budget={budget:8.4g} "
          f"{'OK' if delta <= budget else 'FAIL'}")
    return delta <= budget


def main():
    ok = True
    for cfg in CONFIGS:
        ok &= run(*cfg)
    print("accuracy budget:", "HELD" if ok else "VIOLATED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
