"""The fast paths: forward from tip CLVs, tree-search scoring (also from
nibble-packed tips) and the device-resident Newton step, each one
compiled program (no reference equivalent).

Runs on JAX's default backend: the GPU where there is one (the float32
score then runs in the GPU score kernel), the CPU otherwise."""

from _common import dna_partition

import numpy as np
import jax
import jax.numpy as jnp

from libpll_tpu.engine.evaluate import (make_forward_fused, make_score,
                                        make_train_step_fused,
                                        topology_from_tree)
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.models.gtr import eigen_decompose
from libpll_tpu.ops.tipcodes import pack_tipchars


def main():
    tree, part, trav = dna_partition()
    sites, rate_cats = part.sites, part.rate_cats
    topo, branches = topology_from_tree(tree, sites)

    params = [1.2, 2.4, 0.9, 1.1, 3.0, 1.0]
    freqs = np.asarray([0.3, 0.25, 0.25, 0.2])
    w, left, right = eigen_decompose(np.asarray(params), freqs)
    dtype = jnp.float32
    model = {
        "branch_lengths": jnp.asarray(branches, dtype),
        "rates": jnp.asarray(compute_gamma_cats(0.8, rate_cats), dtype),
        "prop_invar": jnp.zeros((1,), dtype),
        "params_indices": jnp.zeros(rate_cats, np.int32),
        "eigenvals": jnp.asarray(w[None], dtype),
        "left": jnp.asarray(left[None], dtype),
        "right": jnp.asarray(right[None], dtype),
        "freqs_pc": jnp.asarray(np.broadcast_to(freqs, (rate_cats, 4)),
                                dtype),
        "prop_invar_pc": jnp.zeros((rate_cats,), dtype),
        "rate_weights": jnp.full((rate_cats,), 1.0 / rate_cats, dtype),
        "pattern_weights": jnp.ones((sites,), dtype),
        "invariant": jnp.full((sites,), -1, jnp.int32),
    }
    tip_clv = jnp.asarray(part.clv[:part.tips], dtype)

    fwd = jax.jit(make_forward_fused(topo, rate_cats, 4))
    logl, _, _, _ = fwd(model, tip_clv)
    print(f"forward logL: {float(logl):.4f}")

    score = jax.jit(make_score(topo, rate_cats, 4))
    print(f"score logL: {float(score(model, tip_clv)):.4f}")

    chars = pack_tipchars(part._tip_masks)
    score_chars = jax.jit(make_score(topo, rate_cats, 4,
                                     tip_encoding="chars"))
    print(f"score logL from nibble tips: "
          f"{float(score_chars(model, chars)):.4f}")

    step = jax.jit(make_train_step_fused(topo, rate_cats, 4))
    logl, t_star = step(model, tip_clv)
    print(f"Newton step: logL={float(logl):.4f}  t*={float(t_star):.6f}")


if __name__ == "__main__":
    main()
