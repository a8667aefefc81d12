"""Shared builders for the scoring tests: a tree, a random GTR(+Γ) model
and random single-state tip CLVs, the plain float64 reference, and the
switch that makes the scoring wrappers run the GPU score kernel in Pallas
interpret mode on the CPU."""

import numpy as np

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as ev
from libpll_tpu.engine.evaluate import _pmatrices, topology_from_tree
from libpll_tpu.engine.reference import reference_loglikelihood
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.models.gtr import eigen_decompose
from libpll_tpu.ops import score_kernel as sk
from libpll_tpu.tree import utree as ut
from libpll_tpu.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE
from libpll_tpu.utils.simulate import caterpillar_newick, random_tree_newick

# the repo's stated float32 budget against the float64 path
ACC_REL, ACC_ABS = 2e-6, 5e-3

TREES = {
    "caterpillar": lambda: caterpillar_newick(40),
    "random": lambda: random_tree_newick(24, np.random.default_rng(3)),
    "random160": lambda: random_tree_newick(160, np.random.default_rng(5)),
}


def _gtr(rng, states):
    params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.uniform(0.1, 1.0, states)
    return params, freqs / freqs.sum()


def _build(newick, sites=256, rate_cats=4, states=4, seed=0,
           scale_mode=SCALE_PER_SITE, dtype=jnp.float32):
    """(topo, model, pmatrix, clv, scalers) with a GTR(+Γ) model drawn
    from ``seed`` and tip CLVs of random single states."""
    rng = np.random.default_rng(seed)
    tree = ut.parse_newick_string(newick)
    tips = tree.tip_count
    topo, branches = topology_from_tree(tree, sites, scale_mode=scale_mode)
    params, freqs = _gtr(rng, states)
    w, left, right = eigen_decompose(params, freqs)
    model = {
        "branch_lengths": jnp.asarray(branches, dtype),
        "rates": jnp.asarray(compute_gamma_cats(1.0, rate_cats), dtype),
        "prop_invar": jnp.zeros((1,), dtype),
        "params_indices": jnp.zeros(rate_cats, np.int32),
        "eigenvals": jnp.asarray(w[None], dtype),
        "left": jnp.asarray(left[None], dtype),
        "right": jnp.asarray(right[None], dtype),
        "freqs_pc": jnp.asarray(np.broadcast_to(freqs, (rate_cats, states)),
                                dtype),
        "prop_invar_pc": jnp.zeros((rate_cats,), dtype),
        "rate_weights": jnp.full((rate_cats,), 1.0 / rate_cats, dtype),
        "pattern_weights": jnp.ones((sites,), dtype),
        "invariant": jnp.full((sites,), -1, jnp.int32),
    }
    nodes = 2 * tips - 2
    clv = np.zeros((nodes, rate_cats, states, sites), np.float32)
    st = rng.integers(0, states, (tips, sites))
    clv[:tips] = np.eye(states, dtype=np.float32)[st].transpose(
        0, 2, 1)[:, None]
    clv = jnp.asarray(clv, dtype)
    sshape = ((topo.schedule.n_inner + 1, rate_cats, sites)
              if scale_mode == SCALE_PER_RATE
              else (topo.schedule.n_inner + 1, sites))
    scalers = jnp.zeros(sshape, jnp.int32)
    pmatrix = _pmatrices(model, topo, dtype)
    return topo, model, pmatrix, clv, scalers


def reference(newick, model, clv, seed=0, scale_mode=SCALE_PER_SITE,
              pinv=0.0, invariant=None):
    """float64 reference logL (ops/clv + ops/likelihood on the CPU) of the
    case :func:`_build` made from ``newick`` and ``seed``."""
    tree = ut.parse_newick_string(newick)
    tips = tree.tip_count
    params, freqs = _gtr(np.random.default_rng(seed), clv.shape[2])
    return reference_loglikelihood(
        tree, np.asarray(clv[:tips], np.float64), frequencies=freqs,
        subst_params=params, rates=np.asarray(model["rates"], np.float64),
        pattern_weights=np.asarray(model["pattern_weights"], np.float64),
        rate_weights=np.asarray(model["rate_weights"], np.float64),
        prop_invar=pinv, invariant=invariant, scale_mode=scale_mode)


def budget(want):
    return ACC_REL * abs(want) + ACC_ABS


PATHS = ("xla", "kernel")


def _use(path, monkeypatch):
    """Make the scoring wrappers take ``path``: ``"kernel"`` runs the
    kernel of ops/score_kernel.py in interpret mode wherever its scope
    allows (any alphabet: it computes every width, the wrappers keep it
    to DNA for speed alone), ``"xla"`` leaves them as they are off a GPU.
    Returns a list that records each kernel call."""
    built = []
    if path == "kernel":
        def choose(self, xla, *args):
            built.append(self)
            return self(*args, interpret=True)

        monkeypatch.setattr(ev._KernelScore, "supported",
                            lambda self, dtype: sk.kernel_supported(
                                self.topo.scale_mode, dtype, 4, 4))
        monkeypatch.setattr(ev._KernelScore, "choose", choose)
    return built
