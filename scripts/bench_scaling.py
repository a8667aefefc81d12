#!/usr/bin/env python3
"""Scaling over a sites-sharded mesh.

Times the sharded full-tree forward (make_forward under a 1-D ``sites``
mesh, the partial log-likelihoods meeting in one psum) on 1, 2, 4, ...
devices of JAX's default backend, checks that every mesh size gives the
same logL, and prints ms per evaluation, speedup and efficiency.  With
``cpu`` it runs on eight virtual CPU devices instead, which checks the
mechanism only: CPU "devices" share the host's cores.

``giant`` scores the 10 240-taxon configuration of BASELINE.json on one
device with the chunked pattern-tip scorer (make_score_unbounded) and
prints the peak device memory.

Usage: python scripts/bench_scaling.py [cpu] [giant [sites ...]]
"""

import os
import sys
import time

if "cpu" in sys.argv[1:]:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import numpy as np

sys.path.insert(0, ".")

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from __graft_entry__ import _build_flagship
from libpll_tpu.engine.evaluate import make_forward, make_score_unbounded
from libpll_tpu.utils.profiling import time_jitted

TIPS, SITES = 64, 65536


def time_mesh(n_dev):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("sites",))
    topo, model, clv, scalers = _build_flagship(TIPS, SITES)
    vec = NamedSharding(mesh, P("sites"))
    repl = NamedSharding(mesh, P())
    clv = jax.device_put(clv, NamedSharding(mesh, P(None, None, None,
                                                    "sites")))
    scalers = jax.device_put(scalers, NamedSharding(mesh, P(None, "sites")))
    model = {k: jax.device_put(
        v, vec if k in ("pattern_weights", "invariant") else repl)
        for k, v in model.items()}
    fwd = jax.jit(make_forward(topo))
    logl = float(fwd(model, clv, scalers)[0])
    return logl, time_jitted(fwd, model, clv, scalers) * 1e3


def giant():
    tips = 10240
    sizes = [int(a) for a in sys.argv[1:] if a.isdigit()] or [131072]
    dev = jax.devices()[0]
    for sites in sizes:
        t0 = time.perf_counter()
        topo, model, masks, _ = _build_flagship(tips, sites, tip_masks=True)
        t_build = time.perf_counter() - t0
        score = jax.jit(make_score_unbounded(topo, 4, 4, masks))
        t0 = time.perf_counter()
        s = float(score(model))
        t_first = time.perf_counter() - t0
        ms = time_jitted(score, model, reps=3) * 1e3
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        print(f"giant {tips} x {sites} on {dev.device_kind}: logL={s:.3f} "
              f"(host build {t_build:.0f} s, first call {t_first:.1f} s "
              f"incl. compile, {ms:.1f} ms/eval, peak device memory "
              f"{peak / 2**30:.2f} GiB)", flush=True)


def main():
    dev = jax.devices()[0]
    print(f"config: {TIPS} taxa x {SITES} sites x 4 rate cats, "
          f"{dev.platform} {dev.device_kind}")
    ref_logl = base = None
    n = 1
    while n <= len(jax.devices()):
        logl, ms = time_mesh(n)
        if ref_logl is None:
            ref_logl, base = logl, ms
        assert abs(logl - ref_logl) < 1e-6 * abs(ref_logl), (logl, ref_logl)
        print(f"devices={n}  {ms:8.3f} ms/eval  speedup {base / ms:5.2f}x  "
              f"efficiency {base / ms / n * 100:5.1f}%")
        n *= 2


if __name__ == "__main__":
    if "giant" in sys.argv[1:]:
        giant()
    else:
        main()
