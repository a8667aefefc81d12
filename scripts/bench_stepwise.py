#!/usr/bin/env python3
"""Stepwise-addition benchmark: ours vs the compiled reference.

Builds a randomized stepwise-addition parsimony tree on `tips` x `sites`
random DNA and reports wall-clock + score for (a) the rebuild
(search/stepwise.py, persistent directional vectors + batched candidate
scoring) and (b) the reference's pll_fastparsimony_stepwise via the oracle
.so (plain-C kernels, single core; the reference's SIMD tiers accelerate
the Fitch words but not the O(n) candidate loop structure).

Usage: python scripts/bench_stepwise.py [tips] [sites] [platform] [engine]
engine: "device" (whole build as ONE compiled program, default), "host"
(per-insertion batched device calls), or "sharded" (device build with the
Fitch word axis sharded over all available devices — one integer psum per
insertion; bit-identical results).
"""
import os
import sys
import time

tips = int(sys.argv[1]) if len(sys.argv) > 1 else 500
sites = int(sys.argv[2]) if len(sys.argv) > 2 else 10000
if len(sys.argv) > 3:
    os.environ["JAX_PLATFORMS"] = sys.argv[3]
    if sys.argv[3] == "cpu" and len(sys.argv) > 4 and sys.argv[4] == "sharded":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
engine = sys.argv[4] if len(sys.argv) > 4 else "device"

import numpy as np
sys.path.insert(0, "tests")
sys.path.insert(0, ".")

import jax
if len(sys.argv) > 3:
    jax.config.update("jax_platforms", sys.argv[3])
print("platform:", jax.devices()[0].platform)

rng = np.random.default_rng(7)
seqs = ["".join(rng.choice(list("ACGT"), sites)) for _ in range(tips)]
labels = [f"t{i}" for i in range(tips)]

from libpll_tpu.search.parsimony import FastParsimony
from libpll_tpu.search.stepwise import fastparsimony_stepwise

mesh = None
if engine == "sharded":
    import numpy as _np
    from jax.sharding import Mesh
    mesh = Mesh(_np.asarray(jax.devices()), ("words",))
    print(f"mesh: {mesh.devices.size} devices on the word axis")

t0 = time.perf_counter()
from libpll_tpu.io import maps
part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, states=4)
t1 = time.perf_counter()
tree, score = fastparsimony_stepwise([part], labels, seed=42,
                                     engine=engine, mesh=mesh)
t2 = time.perf_counter()
print(f"ours ({engine}): init {t1-t0:.2f}s build {t2-t1:.2f}s score={score}")

# second build: compiled caches warm
t3 = time.perf_counter()
tree, score2 = fastparsimony_stepwise([part], labels, seed=43,
                                      engine=engine, mesh=mesh)
t4 = time.perf_counter()
print(f"ours ({engine}, warm): build {t4-t3:.2f}s score={score2}")

import oracle
if oracle.available():
    from test_stepwise import _oracle_stepwise
    t5 = time.perf_counter()
    ref_score = _oracle_stepwise(seqs, labels, 42)
    t6 = time.perf_counter()
    print(f"reference: build {t6-t5:.2f}s score={ref_score}")
    assert ref_score == score, (ref_score, score)
    print(f"speedup (warm): {(t6-t5)/(t4-t3):.2f}x; seed-exact score parity OK")
