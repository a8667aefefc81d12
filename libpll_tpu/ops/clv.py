"""Conditional-likelihood-vector (CLV) update — the Felsenstein pruning step.

Capability parity with `pll_update_partials` / `pll_core_update_partial_*`
(libpll `src/partials.c:177-212`, `src/core_partials.c:560-663`), redesigned
for XLA: the per-site/rate/state triple loop becomes, per operation,

    ``new[c] = (P_left[c] @ clv_left[c]) * (P_right[c] @ clv_right[c])``

a pair of batched ``[S,S] @ [S, sites]`` matmuls — sites on the minor
axis — and the whole post-order schedule is executed on-device as a
``lax.scan`` over an int32 operation table. Tips are bit-encoded 0/1 CLVs
(the reference's default, `src/pll.c:905-964`), so tip-tip / tip-inner cases
need no special kernels.

Numerical scaling matches the reference exactly (`core_partials.c:607-663`):
whenever every entry of a site's span (all rates × states for per-site mode;
one rate's states for per-rate mode) falls below 2**-256, the span is
multiplied by 2**256 and the per-site (per site×rate) exponent counter is
incremented; a parent's counter starts as the sum of its children's
(`fill_parent_scaler`, `core_partials.c:24-46`).

Scaler bookkeeping: scaler row ``K`` (the last one) is a dummy that always
stays zero; operations whose reference scaler index is -1 ("no scaler") are
remapped to it, which makes "absent" scalers read as zero and turns their
writes into no-ops (the dummy row is re-zeroed after the sweep).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.constants import (SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE,
                               scale_shift_bits)


def _scale_consts(dtype):
    """(threshold, factor) = (2**-shift, 2**shift) in the working dtype."""
    import numpy as np

    shift = scale_shift_bits(dtype)
    return (np.ldexp(np.ones((), dtype), -shift),
            np.ldexp(np.ones((), dtype), shift))


def _one_partial(pmat_l, clv_l, pmat_r, clv_r, dtype):
    """[C,S,S] @ [C,S,L] twice, multiplied elementwise -> [C,S,L]."""
    left = jnp.einsum("cij,cjn->cin", pmat_l, clv_l,
                      preferred_element_type=dtype, precision="highest")
    right = jnp.einsum("cij,cjn->cin", pmat_r, clv_r,
                       preferred_element_type=dtype, precision="highest")
    return left * right


@partial(jax.jit, static_argnames=("scale_mode",), donate_argnums=(0, 1))
def update_partials(clv, scalers, ops, pmatrix, scale_mode=SCALE_PER_SITE):
    """Execute a post-order operation schedule on-device.

    Args:
      clv: [N, C, S, L] all CLV buffers (tips first, inner nodes after,
        matching the reference index convention).
      scalers: [K+1, L] (per-site) or [K+1, C, L] (per-rate) int32 exponent
        counters; row K is the always-zero dummy.
      ops: int32 [n_ops, 8] rows of (parent_clv, parent_scaler, child1_clv,
        child1_matrix, child1_scaler, child2_clv, child2_matrix,
        child2_scaler); scaler indices already remapped -1 -> K.
      pmatrix: [M, C, S, S].
      scale_mode: SCALE_NONE / SCALE_PER_SITE / SCALE_PER_RATE.

    Returns:
      (clv, scalers) updated.
    """
    dtype = clv.dtype
    thresh, factor = _scale_consts(dtype)
    dummy = scalers.shape[0] - 1 if scale_mode != SCALE_NONE else 0

    def body(carry, op):
        clv, scalers = carry
        p, ps, c1, m1, s1, c2, m2, s2 = (op[k] for k in range(8))
        x = _one_partial(pmatrix[m1], clv[c1], pmatrix[m2], clv[c2], dtype)

        if scale_mode == SCALE_NONE:
            clv = clv.at[p].set(x)
            return (clv, scalers), None

        has_scaler = ps != dummy
        if scale_mode == SCALE_PER_SITE:
            mask = jnp.all(x < thresh, axis=(0, 1)) & has_scaler  # [L]
            x = jnp.where(mask[None, None, :], x * factor, x)
        else:  # SCALE_PER_RATE
            mask = jnp.all(x < thresh, axis=1) & has_scaler  # [C, L]
            x = jnp.where(mask[:, None, :], x * factor, x)

        new_scaler = scalers[s1] + scalers[s2] + mask.astype(scalers.dtype)
        clv = clv.at[p].set(x)
        scalers = scalers.at[ps].set(new_scaler)
        # writes aimed at "no scaler" land in the dummy row; keep it zero
        scalers = scalers.at[dummy].set(0)
        return (clv, scalers), None

    (clv, scalers), _ = jax.lax.scan(body, (clv, scalers), ops)
    return clv, scalers


@partial(jax.jit, static_argnames=("scale_mode",), donate_argnums=(0, 1))
def update_partials_leveled(clv, scalers, level_ops, level_valid, pmatrix,
                            scale_mode=SCALE_PER_SITE):
    """Level-parallel variant: ops grouped by tree depth, one batched kernel
    per level (all ops in a level are independent).

    Args:
      level_ops: int32 [n_levels, width, 8], padded by repeating ops from the
        same level (see schedule.py) — duplicate lanes recompute identical
        values, so concurrent writes agree.
      level_valid: bool [n_levels, width] (True everywhere with duplicate
        padding; kept for masking alternative padding schemes).

    This is the throughput path: the batched matmul per level has
    ``width × C × S × L`` output elements, which keeps the device busy for
    small trees where the sequential scan would be launch-bound.
    """
    dtype = clv.dtype
    thresh, factor = _scale_consts(dtype)
    dummy = scalers.shape[0] - 1 if scale_mode != SCALE_NONE else 0

    def one_op(clv, scalers, op, valid):
        p, ps, c1, m1, s1, c2, m2, s2 = (op[k] for k in range(8))
        x = _one_partial(pmatrix[m1], clv[c1], pmatrix[m2], clv[c2], dtype)
        if scale_mode == SCALE_NONE:
            return p, x, ps, None
        has_scaler = (ps != dummy) & valid
        if scale_mode == SCALE_PER_SITE:
            mask = jnp.all(x < thresh, axis=(0, 1)) & has_scaler
            x = jnp.where(mask[None, None, :], x * factor, x)
        else:
            mask = jnp.all(x < thresh, axis=1) & has_scaler
            x = jnp.where(mask[:, None, :], x * factor, x)
        new_scaler = scalers[s1] + scalers[s2] + mask.astype(scalers.dtype)
        return p, x, ps, new_scaler

    def level(carry, lev):
        clv, scalers = carry
        ops, valid = lev
        p, x, ps, new_scaler = jax.vmap(
            one_op, in_axes=(None, None, 0, 0))(clv, scalers, ops, valid)
        # padded lanes all write to the scratch slot; with multiple writers
        # to the same index, .at[].set keeps one of them - harmless there.
        clv = clv.at[p].set(x)
        if scale_mode != SCALE_NONE:
            scalers = scalers.at[ps].set(new_scaler)
            scalers = scalers.at[dummy].set(0)
        return (clv, scalers), None

    (clv, scalers), _ = jax.lax.scan(level, (clv, scalers),
                                     (level_ops, level_valid))
    return clv, scalers
