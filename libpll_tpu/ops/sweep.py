"""Throughput-optimized pruning sweep (the performance path).

Same math as :mod:`libpll_tpu.ops.clv` (which remains the reference
implementation, mirroring libpll's generic-vs-SIMD duality), restructured for
throughput:

  * inner CLVs are renumbered *level-major* so each dependency level's
    parents occupy one contiguous row range — the level's result lands with
    a single ``dynamic_update_slice`` (static offset) instead of a scatter;
  * the per-level Python loop is unrolled at trace time with each level's
    exact width (no padding lanes, no scan carry);
  * children are fetched with one batched gather per side and contracted by
    a single batched ``[S,S] @ [S, L]`` einsum per side;
  * the caller donates the CLV/scaler buffers, so XLA updates them in place.

Scaler rows are also level-major: inner node at CLV row ``tips + k`` owns
scaler row ``k``; row ``n_inner`` is the always-zero dummy used for tips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE
from .clv import _scale_consts


@dataclass(frozen=True)
class Level:
    """One dependency level, child indices in renumbered (level-major) space."""

    child1: np.ndarray  # [w] int32 CLV rows
    matrix1: np.ndarray  # [w] int32
    child2: np.ndarray  # [w] int32
    matrix2: np.ndarray  # [w] int32
    scaler1: np.ndarray  # [w] int32 scaler rows (dummy for tips/no-scaler)
    scaler2: np.ndarray  # [w] int32
    offset: int  # first parent CLV row (parents are offset..offset+w-1)
    has_scaler: np.ndarray  # [w] bool (parent writes a scaler row)


@dataclass(frozen=True)
class LevelSchedule:
    levels: Tuple[Level, ...]
    tips: int
    n_inner: int
    clv_map: dict  # original clv index -> level-major row
    scaler_map: dict  # original scaler index -> level-major scaler row


def build_level_schedule(operations: Sequence, tips: int) -> LevelSchedule:
    """Group ops into dependency levels and renumber CLVs level-major.

    Tips keep rows 0..tips-1; the k-th inner node *in level order* gets CLV
    row tips+k and scaler row k. Returns the schedule plus index maps for
    translating evaluation-edge indices.
    """
    from ..engine.partition import Operation

    rows = []
    for op in operations:
        t = op.as_tuple() if isinstance(op, Operation) else tuple(op)
        rows.append(t)

    level_of = {}
    levels_raw: List[List[tuple]] = []
    for t in rows:
        c1, c2 = t[2], t[5]
        lvl = max(level_of.get(c1, -1), level_of.get(c2, -1)) + 1
        while len(levels_raw) <= lvl:
            levels_raw.append([])
        levels_raw[lvl].append(t)
        level_of[t[0]] = lvl

    clv_map = {i: i for i in range(tips)}
    scaler_map = {}
    n_inner = 0
    dummy_scaler = sum(len(lv) for lv in levels_raw)  # row n_inner at the end

    levels: List[Level] = []
    for lv in levels_raw:
        w = len(lv)
        offset = tips + n_inner

        def srow(orig_scaler, child_row):
            # child scaler row in level-major space: derived from the child's
            # clv row (inner nodes own their row), dummy for tips / -1
            if orig_scaler < 0 or child_row < tips:
                return dummy_scaler
            return child_row - tips

        c1 = np.empty(w, np.int32)
        m1 = np.empty(w, np.int32)
        c2 = np.empty(w, np.int32)
        m2 = np.empty(w, np.int32)
        s1 = np.empty(w, np.int32)
        s2 = np.empty(w, np.int32)
        has = np.empty(w, bool)
        for k, t in enumerate(lv):
            (p, ps, tc1, tm1, ts1, tc2, tm2, ts2) = t
            c1[k] = clv_map[tc1]
            c2[k] = clv_map[tc2]
            m1[k], m2[k] = tm1, tm2
            s1[k] = srow(ts1, c1[k])
            s2[k] = srow(ts2, c2[k])
            has[k] = ps >= 0
            clv_map[p] = offset + k
            if ps >= 0:
                scaler_map[ps] = offset + k - tips
        levels.append(Level(c1, m1, c2, m2, s1, s2, offset, has))
        n_inner += w

    return LevelSchedule(tuple(levels), tips, n_inner, clv_map, scaler_map)


def make_level_sweep(schedule: LevelSchedule, scale_mode: int = SCALE_PER_SITE):
    """Build ``sweep(clv, scalers, pmatrix) -> (clv, scalers)``.

    clv: [tips + n_inner, C, S, L] (level-major rows).
    scalers: [n_inner + 1, L] / [n_inner + 1, C, L] int32; last row dummy.
    Donate both for in-place updates.
    """
    dummy = schedule.n_inner

    def sweep(clv, scalers, pmatrix):
        dtype = clv.dtype
        thresh, factor = _scale_consts(dtype)
        for lev in schedule.levels:
            a = jnp.take(clv, jnp.asarray(lev.child1), axis=0)
            b = jnp.take(clv, jnp.asarray(lev.child2), axis=0)
            x = (jnp.einsum("wcij,wcjn->wcin", pmatrix[jnp.asarray(lev.matrix1)],
                            a, preferred_element_type=dtype)
                 * jnp.einsum("wcij,wcjn->wcin", pmatrix[jnp.asarray(lev.matrix2)],
                              b, preferred_element_type=dtype))

            if scale_mode != SCALE_NONE:
                has = jnp.asarray(lev.has_scaler)
                if scale_mode == SCALE_PER_SITE:
                    mask = jnp.all(x < thresh, axis=(1, 2)) & has[:, None]
                    x = jnp.where(mask[:, None, None, :], x * factor, x)
                else:  # SCALE_PER_RATE
                    mask = jnp.all(x < thresh, axis=2) & has[:, None, None]
                    x = jnp.where(mask[:, :, None, :], x * factor, x)
                new_scaler = (jnp.take(scalers, jnp.asarray(lev.scaler1), axis=0)
                              + jnp.take(scalers, jnp.asarray(lev.scaler2), axis=0)
                              + mask.astype(scalers.dtype))
                scalers = jax.lax.dynamic_update_slice_in_dim(
                    scalers, new_scaler, lev.offset - schedule.tips, axis=0)

            clv = jax.lax.dynamic_update_slice_in_dim(clv, x, lev.offset,
                                                      axis=0)
        if scale_mode != SCALE_NONE:
            # the dummy row is never written (scaler writes are contiguous
            # level rows), so it stays zero by construction
            pass
        return clv, scalers

    return sweep
