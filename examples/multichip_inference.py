"""Sites-sharded ML inference over a device mesh.

The same `infer_tree` call as examples/infer_ml_tree.py, with a
`jax.sharding.Mesh`: the stepwise build shards its Fitch word axis (one
integer psum per insertion), the partition shards its site axis, and the
SPR scorer / Newton sweep programs partition automatically under GSPMD —
one psum per logL fold crosses the devices.  Results are identical to the
single-device run (tests/test_infer.py asserts exact agreement).

Run on CPU with a virtual mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/multichip_inference.py
On a host with several GPUs the same code shards across them
(chip_smoke.py --four runs it on four).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
from jax.sharding import Mesh

from libpll_tpu.search.infer import infer_tree
from libpll_tpu.tree import utree as ut


def main():
    rng = np.random.default_rng(1)
    labels = [f"t{i}" for i in range(10)]
    seqs = {lab: "".join(rng.choice(list("ACGT"), 60)) for lab in labels}

    mesh = Mesh(np.asarray(jax.devices()), ("sites",))
    print(f"mesh: {mesh.devices.size} x {jax.devices()[0].platform}")

    res = infer_tree(seqs, alpha=0.9, seed=42, radius=6, max_rounds=6,
                     mesh=mesh)
    print(f"parsimony start score: {res.start_parsimony_score}")
    print(f"final logL {res.logl:.4f} after {res.rounds} rounds")
    print("clv sharding:", res.partition.clv.sharding.spec)
    print("tree:", ut.export_newick(res.tree.root)[:70], "...")


if __name__ == "__main__":
    main()
