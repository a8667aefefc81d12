#!/usr/bin/env python3
"""Full-tree evaluation throughput of the flagship configuration.

64 taxa x 262 144 sites x 4 Γ categories, DNA, GTR, per-site scaling,
float32, nibble-packed pattern tips: ``make_score(tip_encoding="chars")``,
the tree-search scoring entry point, on JAX's default backend.

Exits non-zero without a GPU.  Prints the device, the milliseconds per
evaluation (median over timed calls that each end in
``block_until_ready``, after warm-up) and, as the last line, one JSON
object with the rate in site-rate-node CLV updates per second.  No
baseline ratio: the rate is this program's own, measured here.
"""

import json
import sys

TIPS = 64
SITES = 262144
RATE_CATS = 4
STATES = 4
REPS = 20


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default backend is "
                 f"{jax.default_backend()!r}")
    import libpll_tpu  # noqa: F401  (x64, matmul precision)
    from __graft_entry__ import _build_flagship
    from libpll_tpu.engine import evaluate as ev
    from libpll_tpu.ops.tipcodes import pack_tipchars
    from libpll_tpu.utils.profiling import time_jitted

    topo, model, masks, _ = _build_flagship(TIPS, SITES, rate_cats=RATE_CATS,
                                            tip_masks=True)
    score = jax.jit(ev.make_score(topo, RATE_CATS, STATES,
                                  tip_encoding="chars"))
    tp = pack_tipchars(masks)
    logl = float(score(model, tp))
    dt = time_jitted(score, model, tp, reps=REPS)

    dev = jax.devices()[0]
    updates = (TIPS - 2) * SITES * RATE_CATS
    print(f"# {dev.platform} {dev.device_kind}: {dt * 1e3:.3f} ms per "
          f"full-tree evaluation, logL {logl:.3f}", file=sys.stderr)
    print(json.dumps({
        "metric": "CLV updates/sec",
        "value": updates / dt,
        "unit": "site-rate-node updates/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
