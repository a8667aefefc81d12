"""Plain float64 re-score of a tree: the engine's reference path.

The operation table of the tree's post-order traversal runs through
:func:`libpll_tpu.ops.clv.update_partials` (a ``lax.scan`` over operations
in the reference's index convention) and the edge log-likelihood through
:func:`libpll_tpu.ops.likelihood.edge_loglikelihood`, in float64 on the
CPU device — independent of the level sweep, the score kernel and the
search code whose results it checks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gtr import eigen_decompose
from ..ops import clv as clv_ops
from ..ops import likelihood as lk_ops
from ..ops.pmatrix import compute_pmatrices
from ..tree import utree as ut
from ..utils.constants import SCALE_PER_RATE, SCALE_PER_SITE
from .partition import operations_to_array


def edge_node(tree):
    """An inner node of ``tree`` whose edge the re-score evaluates."""
    return tree.root if not tree.root.is_tip else tree.root.back


def reference_loglikelihood(tree, tip_clv, *, frequencies, subst_params,
                            rates, pattern_weights, rate_weights=None,
                            prop_invar: float = 0.0, invariant=None,
                            scale_mode: int = SCALE_PER_SITE,
                            device=None) -> float:
    """float64 log-likelihood of ``tree`` with its own branch lengths.

    ``tip_clv``: [tips, C, S, L] tip CLVs indexed by the tips'
    ``clv_index``; one GTR matrix shared by all C rate categories with
    ``rates``, equal category weights unless ``rate_weights`` is given.
    Runs on ``device`` (default: the first CPU device).
    """
    device = device or jax.devices("cpu")[0]
    f64 = jnp.float64
    root = edge_node(tree)
    ops, branches, pidx = ut.create_operations(ut.traverse(root))
    tips, C, S, L = np.shape(tip_clv)
    n_scalers = tips - 2
    with jax.default_device(device):
        w, left, right = eigen_decompose(np.asarray(subst_params),
                                         np.asarray(frequencies))
        pm = compute_pmatrices(
            jnp.asarray(branches, f64), jnp.asarray(rates, f64),
            jnp.full((1,), prop_invar, f64), jnp.zeros(C, jnp.int32),
            jnp.asarray(w[None], f64), jnp.asarray(left[None], f64),
            jnp.asarray(right[None], f64), dtype=f64)
        pmatrix = jnp.zeros((2 * tips - 3,) + pm.shape[1:], f64)
        pmatrix = pmatrix.at[jnp.asarray(pidx)].set(pm)

        clv = jnp.concatenate(
            [jnp.asarray(tip_clv, f64),
             jnp.zeros((tips - 2, C, S, L), f64)], axis=0)
        sshape = ((n_scalers + 1, C, L) if scale_mode == SCALE_PER_RATE
                  else (n_scalers + 1, L))
        scalers = jnp.zeros(sshape, jnp.int32)
        table = jnp.asarray(operations_to_array(ops, n_scalers))
        clv, scalers = clv_ops.update_partials(clv, scalers, table, pmatrix,
                                               scale_mode=scale_mode)

        def srow(node):
            return node.scaler_index if node.scaler_index >= 0 else n_scalers

        freqs = jnp.broadcast_to(jnp.asarray(frequencies, f64), (C, S))
        rw = (jnp.full((C,), 1.0 / C, f64) if rate_weights is None
              else jnp.asarray(rate_weights, f64))
        inv = (jnp.full((L,), -1, jnp.int32) if invariant is None
               else jnp.asarray(invariant, jnp.int32))
        logl, _ = lk_ops.edge_loglikelihood(
            clv[root.clv_index], clv[root.back.clv_index],
            scalers[srow(root)], scalers[srow(root.back)],
            pmatrix[root.pmatrix_index], freqs, rw,
            jnp.asarray(pattern_weights, f64),
            jnp.full((C,), prop_invar, f64), inv, sites=L,
            per_rate=scale_mode == SCALE_PER_RATE)
        return float(logl)


def tip_clv_from_masks(masks, rate_cats: int, states: int) -> np.ndarray:
    """[tips, L] ambiguity bitmasks -> [tips, C, S, L] float64 0/1 CLVs
    (a broadcast view; categories share the tip data)."""
    masks = np.asarray(masks, np.uint32)
    bits = (masks[:, None, :] >> np.arange(states, dtype=np.uint32)[
        None, :, None]) & 1
    return np.broadcast_to(bits[:, None].astype(np.float64),
                           (masks.shape[0], rate_cats, states,
                            masks.shape[1]))


def rescore_alignment(tree, sequences, *, alpha: float, rate_cats: int = 4,
                      states: int = 4, charmap=None, frequencies=None,
                      subst_params=None) -> float:
    """float64 logL of a tree over an alignment (label -> sequence) under
    :func:`~libpll_tpu.search.infer.infer_tree`'s model: GTR with
    ``frequencies``/``subst_params`` (default uniform) and Γ(``alpha``),
    on the compressed site patterns."""
    from ..io import maps
    from ..io.compress import compress_site_patterns
    from ..models.gamma import compute_gamma_cats

    cmap = charmap if charmap is not None else (
        maps.pll_map_nt if states == 4 else maps.pll_map_aa)
    labels = list(sequences)
    seqs, weights = compress_site_patterns([sequences[k] for k in labels],
                                           cmap)
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    masks = np.zeros((len(labels), len(seqs[0])), np.uint32)
    for lab, seq in zip(labels, seqs):
        masks[order[lab]] = maps.encode_sequence(seq, cmap)
    return reference_loglikelihood(
        tree, tip_clv_from_masks(masks, rate_cats, states),
        frequencies=(frequencies if frequencies is not None
                     else [1.0 / states] * states),
        subst_params=(subst_params if subst_params is not None
                      else [1.0] * (states * (states - 1) // 2)),
        rates=compute_gamma_cats(alpha, rate_cats),
        pattern_weights=np.asarray(weights, np.float64))
