"""Schedule-as-data incremental evaluation — the device half of dirty-subtree
CLV reuse (SURVEY §3.5) and the engine of likelihood SPR/NNI search.

After a topology move only O(depth) CLVs change (tree/incremental.py
computes the minimal post-order subset).  This module evaluates such an op
subset **without recompiling and without touching the base buffers**: the
op table is a traced int32 array padded to a fixed capacity ``K``, candidate
CLVs land in ``K`` scratch rows, and children are fetched from base-or-
scratch by row id (rows ≥ N alias scratch).  A whole set of SPR candidates
is scored in ONE compiled call (`lax.map` over stacked tables), each
candidate costing a handful of row-streams instead of a full-tree sweep —
the likelihood analog of the reference's `clv_valid` partial traversal
(`examples/partial-traversal/partial.c:61-104`, `src/stepwise.c:241-323`),
with the candidate loop device-resident instead of host-driven.

Committing an accepted move is just :func:`libpll_tpu.ops.clv.update_partials`
with the same (padded) table — that scan is already schedule-as-data.

Row encoding (per candidate):
  * CLV row r:    r < N -> base ``clv[r]``; r >= N -> scratch row r - N.
  * scaler row s: s <= NS -> base ``scalers[s]`` (NS is the always-zero
    dummy); s > NS -> scratch row s - NS - 1.
Pad rows repeat the last real op (idempotent recompute), so ``n_ops`` is
only needed by the caller, not the kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import CapacityError
from ..utils.constants import SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE
from . import likelihood as lk_ops
from .clv import _one_partial, _scale_consts


def pad_op_table(ops_arr: np.ndarray, capacity: int) -> np.ndarray:
    """Pad an [n, 8] op table to [capacity, 8] by repeating the final op
    (recomputing an op is idempotent: parent CLV and scaler are pure
    functions of the children).  Raises if n > capacity."""
    n = ops_arr.shape[0]
    if n > capacity:
        raise CapacityError(
            f"op subset ({n}) exceeds capacity ({capacity})")
    if n == 0:
        raise ValueError("empty op table")
    pad = np.repeat(ops_arr[-1:], capacity - n, axis=0)
    return np.concatenate([ops_arr, pad], axis=0).astype(np.int32)


def encode_candidate_ops(operations, n_nodes: int, n_scale_buffers: int,
                         capacity: int):
    """Translate a partial-traversal op list into the scratch-row encoding.

    The k-th op's parent lands in scratch rows (CLV row ``N + k``, scaler
    row ``NS + 1 + k``); child/scaler references to a parent recomputed
    earlier in the same subset are redirected to its scratch row, and
    "no scaler" (-1) maps to the base dummy row ``NS``.

    Returns (table [capacity, 8] int32, row_of, scal_of) where the dicts
    map original clv/scaler indices to encoded rows — used to locate the
    evaluation edge (fall back to the base row for untouched nodes).
    """
    from ..engine.partition import Operation

    N, NS = n_nodes, n_scale_buffers
    row_of = {}
    scal_of = {}
    rows = []
    for k, op in enumerate(operations):
        t = op.as_tuple() if isinstance(op, Operation) else tuple(op)
        (p, ps, c1, m1, s1, c2, m2, s2) = t

        def crow(c):
            return row_of.get(c, c)

        def srow(s):
            if s < 0:
                return NS  # dummy (always-zero)
            return scal_of.get(s, s)

        enc_ps = NS if ps < 0 else NS + 1 + k
        rows.append((N + k, enc_ps, crow(c1), m1, srow(s1),
                     crow(c2), m2, srow(s2)))
        row_of[p] = N + k
        if ps >= 0:
            scal_of[ps] = NS + 1 + k
    table = pad_op_table(np.asarray(rows, np.int32), capacity)
    return table, row_of, scal_of


def make_candidate_scorer(n_nodes: int, n_scale_buffers: int, capacity: int,
                          *, sites: int, scale_mode: int = SCALE_PER_SITE,
                          asc_mode: int = 0):
    """Build the batched candidate scorer.

    Returns ``score(clv, scalers, pmatrix, model, tables, upd_midx,
    upd_blens, eval_rows) -> logl [B]`` where

      * ``clv`` [N, C, S, L], ``scalers`` [NS+1, (C,) L] — base state,
        read-only (reference index convention);
      * ``tables`` int32 [B, capacity, 8] — per-candidate op subsets in the
        scratch-row encoding (see module doc; columns as update_partials);
      * ``upd_midx``/``upd_blens`` [B, U] — the candidate's changed
        P-matrix slots and branch lengths (an SPR changes 3;
        `src/utree_moves.c:204-251`), applied to a per-candidate copy;
      * ``eval_rows`` int32 [B, 5]: (parent_row, parent_scaler_row,
        child_row, child_scaler_row, edge_matrix) in the same encoding.

    Everything is data — one compilation serves every topology of the same
    (N, NS, capacity, sites) envelope; that is the no-recompile property
    tree search needs.
    """
    from .pmatrix import compute_pmatrices

    N, NS = n_nodes, n_scale_buffers
    per_rate = scale_mode == SCALE_PER_RATE
    K = capacity

    def fetch(clv, scratch, row):
        base = clv[jnp.clip(row, 0, N - 1)]
        scr = scratch[jnp.clip(row - N, 0, K - 1)]
        return jnp.where(row < N, base, scr)

    def fetch_scal(scalers, scal_scratch, row):
        base = scalers[jnp.clip(row, 0, NS)]
        scr = scal_scratch[jnp.clip(row - NS - 1, 0, K - 1)]
        return jnp.where(row < NS + 1, base, scr)

    @partial(jax.jit, static_argnames=())
    def score(clv, scalers, pmatrix, model, tables, upd_midx, upd_blens,
              eval_rows):
        dtype = clv.dtype
        thresh, factor = _scale_consts(dtype)
        C, S, L = clv.shape[1:]

        def one(args):
            table, midx, blens, erows = args
            # per-candidate P-matrix refresh (3 changed slots for an SPR)
            new = compute_pmatrices(
                blens.astype(dtype), model["rates"].astype(dtype),
                model["prop_invar"].astype(dtype), model["params_indices"],
                model["eigenvals"].astype(dtype),
                model["left"].astype(dtype), model["right"].astype(dtype),
                dtype=dtype)
            pm = pmatrix.at[midx].set(new)

            sshape = ((K, C, L) if per_rate else (K, L))
            init = (jnp.zeros((K, C, S, L), dtype),
                    jnp.zeros(sshape, jnp.int32))

            def body(carry, arg):
                scratch, scal_scratch = carry
                k, op = arg
                _, ps, c1, m1, s1, c2, m2, s2 = (op[i] for i in range(8))
                x = _one_partial(pm[m1], fetch(clv, scratch, c1),
                                 pm[m2], fetch(clv, scratch, c2), dtype)
                if scale_mode != SCALE_NONE:
                    has = ps != NS
                    if scale_mode == SCALE_PER_SITE:
                        mask = jnp.all(x < thresh, axis=(0, 1)) & has
                        x = jnp.where(mask[None, None, :], x * factor, x)
                    else:
                        mask = jnp.all(x < thresh, axis=1) & has
                        x = jnp.where(mask[:, None, :], x * factor, x)
                    cnt = (fetch_scal(scalers, scal_scratch, s1)
                           + fetch_scal(scalers, scal_scratch, s2)
                           + mask.astype(jnp.int32))
                    scal_scratch = scal_scratch.at[k].set(cnt)
                scratch = scratch.at[k].set(x)
                return (scratch, scal_scratch), None

            (scratch, scal_scratch), _ = jax.lax.scan(
                body, init, (jnp.arange(K), table))

            pr, psr, cr, csr, em = (erows[i] for i in range(5))
            logl, _ = lk_ops.edge_loglikelihood(
                fetch(clv, scratch, pr), fetch(clv, scratch, cr),
                fetch_scal(scalers, scal_scratch, psr),
                fetch_scal(scalers, scal_scratch, csr),
                pm[em], model["freqs_pc"].astype(dtype),
                model["rate_weights"].astype(dtype),
                model["pattern_weights"].astype(dtype),
                model["prop_invar_pc"].astype(dtype),
                model["invariant"], sites=sites, per_rate=per_rate,
                asc_mode=asc_mode)
            return logl

        # lax.map, not vmap: batching candidates turns every
        # base-or-scratch fetch into a B-row gather and every scratch
        # update into a dynamic-update-slice on a [B,K,C,S,L] buffer,
        # where the sequential map keeps per-candidate slices as cheap
        # row streams.  Which wins on a GPU is not measured yet.
        return jax.lax.map(one, (tables, upd_midx, upd_blens, eval_rows))

    return score
