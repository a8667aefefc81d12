"""Schedule-as-data edge-score kernel for NVIDIA GPUs (Pallas, Triton route).

One program per block of sites runs the whole post-order pruning sweep and
the edge log-likelihood for its sites, and writes one partial logL:

* the operation table is data (an int32 array the program reads), so one
  compiled kernel serves every topology with the same table capacity;
* tips are read as ambiguity codes (nibble words or bitmasks) and decoded
  to 0/1 rows in registers, or as full tip CLVs;
* inner CLVs live in a few *slots* of a per-block scratch that stays in
  L2.  The host orders the post-order by Sethi–Ullman labels and assigns
  slots from a free list, so a random 64-taxon tree needs 3–4 slots, a
  random 1024-taxon tree 6–7 and a caterpillar 2, independent of the site
  count;
* the per-rate ``[S,S]`` contractions of one child are a single
  ``[R,R] @ [R,BL]`` product against a block-diagonal P-matrix, with
  ``R = C·S`` padded to a power of two, at IEEE float32 precision;
* each block writes one partial sum; the caller sums the partials in a
  second XLA pass (float64 when x64 is on).

Scope: float32, per-site or no scaling (2**-32 threshold, exact counters),
+I through the linear fold of :func:`libpll_tpu.engine.evaluate`, and
C·S <= :data:`MAX_ROWS`.  Wider alphabets, per-rate scaling and float64
use the XLA path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import SCALE_NONE, SCALE_PER_SITE, scale_shift_bits
from .clv import _scale_consts
from .sweep import LevelSchedule

# op-table columns
_C1, _M1, _C2, _M2, _DST, _FLAGS = range(6)
_HAS, _USE1, _USE2 = 1, 2, 4
_COLS = 8


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class SlotPlan:
    """Host-side schedule for the kernel.

    ``table`` is [capacity, 8] int32: row 0 is the header (n_ops, eval
    parent ref, eval child ref, edge matrix), rows 1..n_ops the operations
    (child1 ref, matrix1, child2 ref, matrix2, destination slot, flags).
    A *ref* is a tip index (< tips) or ``tips + slot``.
    """

    table: np.ndarray
    n_ops: int
    n_slots: int


def plan_slots(schedule: LevelSchedule, parent_clv: int, child_clv: int,
               edge_matrix: int) -> SlotPlan:
    """Order the sweep for minimal live inner CLVs and assign slots."""
    tips, dummy = schedule.tips, schedule.n_inner
    if parent_clv < tips:
        raise ValueError("evaluation-edge parent must be an inner node")
    node = {}
    for lev in schedule.levels:
        for k in range(len(lev.child1)):
            node[lev.offset + k] = (
                int(lev.child1[k]), int(lev.matrix1[k]),
                int(lev.child2[k]), int(lev.matrix2[k]),
                int(lev.has_scaler[k]) * _HAS
                | (int(lev.scaler1[k]) != dummy) * _USE1
                | (int(lev.scaler2[k]) != dummy) * _USE2)

    # Sethi–Ullman labels (level order visits children first); a tip
    # needs no slot, a parent may reuse a child's slot
    label = {}
    for row in sorted(node):
        c1, _, c2, _, _ = node[row]
        a, b = label.get(c1, 0), label.get(c2, 0)
        label[row] = max(a, b) if a != b else a + 1

    free, slot_of, ops = [], {}, []
    n_slots = 0

    def emit(root):
        nonlocal n_slots
        stack = [(root, False)]
        while stack:
            row, ready = stack.pop()
            if row < tips:
                continue
            c1, m1, c2, m2, flags = node[row]
            if not ready:
                stack.append((row, True))
                # the heavier child runs first (pushed last)
                for c in sorted((c1, c2), key=lambda c: label.get(c, 0)):
                    stack.append((c, False))
                continue
            refs = []
            for c in (c1, c2):
                if c < tips:
                    refs.append(c)
                else:
                    refs.append(tips + slot_of[c])
                    free.append(slot_of.pop(c))
            if free:
                dst = free.pop()
            else:
                dst, n_slots = n_slots, n_slots + 1
            slot_of[row] = dst
            ops.append((refs[0], m1, refs[1], m2, dst, flags))

    roots = sorted({parent_clv, child_clv}, key=lambda r: -label.get(r, 0))
    for r in roots:
        emit(r)

    def ref(r):
        return r if r < tips else tips + slot_of[r]

    table = np.zeros((_pow2(len(ops) + 1), _COLS), np.int32)
    table[0, :4] = (len(ops), ref(parent_clv), ref(child_clv), edge_matrix)
    if ops:
        table[1:len(ops) + 1, :6] = np.asarray(ops, np.int32)
    return SlotPlan(table, len(ops), max(n_slots, 1))


# widest C·S the kernel takes: at DNA Γ4 (16 rows) it beats the XLA sweep,
# at protein Γ4 (80 rows, padded to 128) its block-diagonal IEEE-f32
# product loses to XLA by far (PERF.md, Findings)
MAX_ROWS = 16


def kernel_supported(scale_mode: int, dtype, rate_cats: int,
                     states: int) -> bool:
    """Configurations the kernel computes; the wrappers use XLA for the
    rest."""
    return (scale_mode in (SCALE_NONE, SCALE_PER_SITE)
            and np.dtype(dtype) == np.float32
            and rate_cats * states <= MAX_ROWS)


def rows_padded(rate_cats: int, states: int) -> int:
    """CLV rows per site in the kernel: C·S padded to a power of two
    (at least 16, the smallest Triton product)."""
    return max(16, _pow2(rate_cats * states))


def block_diag_pmatrices(pmatrix: jax.Array, rows: int) -> jax.Array:
    """[M, C, S, S] -> [M', R, R] block-diagonal (row c·S + i, column
    c·S + j), zero-padded to R rows and to a power-of-two M'."""
    m, c, s, _ = pmatrix.shape
    eye = jnp.eye(c, dtype=pmatrix.dtype)
    bd = jnp.einsum("mcij,cd->mcidj", pmatrix, eye).reshape(m, c * s, c * s)
    pad = rows - c * s
    return jnp.pad(bd, ((0, _pow2(m) - m), (0, pad), (0, pad)))


def default_block_sites(sites: int) -> int:
    """Sites per program: the widest of 256..32 that still gives at least
    512 programs (four per SM of an H100), else 32."""
    for bl in (256, 128, 64):
        if -(-sites // bl) >= 512:
            return bl
    return 32


def pad_rows(x: jax.Array, rows: int) -> jax.Array:
    """[..., C·S, L] -> [..., R, L] with zero rows."""
    pad = rows - x.shape[-2]
    if not pad:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)])


def prepare_slab(tips_slab, tip_encoding: str, tips: int, rate_cats: int,
                 states: int, block_sites: int, dtype) -> jax.Array:
    """A tip slab in the kernel's layout: the leading dimension padded to
    a power of two, tip CLVs flattened to [tips', R, L], and the sites
    padded to a multiple of ``block_sites`` with gap columns (all states
    possible), which stay positive and scaling-free."""
    length = tips_slab.shape[-1]
    pad = -length % block_sites
    if tip_encoding == "clv":
        cs = rate_cats * states
        slab = pad_rows(tips_slab.reshape(tips, cs, length).astype(dtype),
                        rows_padded(rate_cats, states))
        return jnp.pad(slab, ((0, _pow2(tips) - tips), (0, 0), (0, pad)),
                       constant_values=1.0)
    # all bits set: every nibble (or every mask bit) of a pad column
    fill = -1 if tip_encoding == "chars" else (1 << states) - 1
    words = tips_slab.shape[0]
    slab = jnp.pad(tips_slab, ((0, _pow2(words) - words), (0, 0)))
    return jnp.pad(slab, ((0, 0), (0, pad)), constant_values=fill)


def make_kernel_score(plan: SlotPlan, tips: int, *, rate_cats: int,
                      states: int, scale_mode: int, tip_encoding: str,
                      use_pinv: bool, block_sites: int,
                      interpret: bool = False):
    """Build ``score(tips_slab, pbd, wvec, pattern_weights, inv_add) ->
    partials [n_blocks]``.

    ``tips_slab``: :func:`prepare_slab` of [ceil(tips/8), L] nibble words
    (``"chars"``), [tips, L] bitmasks (``"masks"``) or tip CLVs
    (``"clv"``).  ``pbd``: :func:`block_diag_pmatrices`.  ``wvec``:
    [R, 1] rate-weight × frequency column (zero on pad rows).
    ``pattern_weights``/``inv_add``: [1, L].
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    if scale_mode not in (SCALE_NONE, SCALE_PER_SITE):
        raise ValueError("kernel scope: per-site or no scaling")
    dtype = jnp.float32
    R = rows_padded(rate_cats, states)
    CS = rate_cats * states
    BL = block_sites
    n_slots = _pow2(plan.n_slots)
    thresh, factor = (float(v) for v in _scale_consts(dtype))
    log_scale = float(-scale_shift_bits(dtype) * np.log(2.0))
    scale = scale_mode == SCALE_PER_SITE
    hi = jax.lax.Precision.HIGHEST

    def kernel(ops_ref, tips_ref, pbd_ref, wvec_ref, pw_ref, inv_ref,
               out_ref, slot_ref, sslot_ref):
        rows = jax.lax.broadcasted_iota(jnp.int32, (R, BL), 0)
        shift = rows % states
        real = rows < CS
        zeros_s = jnp.zeros((BL,), jnp.int32)

        def tip_clv(t):
            if tip_encoding == "clv":
                return tips_ref[t]
            if tip_encoding == "chars":
                word = tips_ref[t // 8]
                code = jnp.right_shift(word, 4 * (t % 8)) & 0xF
            else:
                code = tips_ref[t]
            bits = jnp.right_shift(code[None, :], shift) & 1
            return jnp.where(real, bits.astype(dtype), 0.0)

        def child(r):
            return jax.lax.cond(
                r < tips,
                lambda: (tip_clv(r), zeros_s),
                lambda: (slot_ref[r - tips], sslot_ref[r - tips]))

        def term(r, m):
            x, s = child(r)
            return pl.dot(pbd_ref[m], x, precision=hi), s

        def body(k, carry):
            c1, m1 = ops_ref[k, _C1], ops_ref[k, _M1]
            c2, m2 = ops_ref[k, _C2], ops_ref[k, _M2]
            dst, flags = ops_ref[k, _DST], ops_ref[k, _FLAGS]
            t1, s1 = term(c1, m1)
            t2, s2 = term(c2, m2)
            x = t1 * t2
            cnt = (jnp.where((flags & _USE1) != 0, s1, 0)
                   + jnp.where((flags & _USE2) != 0, s2, 0))
            if scale:
                mask = ((jnp.max(x, axis=0) < thresh)
                        & ((flags & _HAS) != 0))
                x = x * jnp.where(mask, factor, 1.0)[None, :]
                cnt = cnt + mask.astype(jnp.int32)
            slot_ref[dst] = x
            sslot_ref[dst] = cnt
            return carry

        n_ops = ops_ref[0, 0]
        jax.lax.fori_loop(1, n_ops + 1, body, 0)
        xp, sp = child(ops_ref[0, 1])
        tb, sc = term(ops_ref[0, 2], ops_ref[0, 3])
        site = jnp.sum(xp * tb * wvec_ref[...], axis=0)
        if use_pinv:
            site = site + inv_ref[0]
        lnl = (jnp.log(site) + (sp + sc).astype(dtype) * log_scale) \
            * pw_ref[0]
        out_ref[0] = jnp.sum(lnl)

    def score(tips_slab, pbd, wvec, pattern_weights, inv_add):
        sites = tips_slab.shape[-1]
        if sites % BL:
            raise ValueError(f"site count {sites} is not a multiple of "
                             f"the block ({BL})")
        nb = sites // BL
        table = jnp.asarray(plan.table)
        if tip_encoding == "clv":
            tip_spec = pl.BlockSpec((tips_slab.shape[0], R, BL),
                                    lambda j: (0, 0, j))
        else:
            tip_spec = pl.BlockSpec((tips_slab.shape[0], BL),
                                    lambda j: (0, j))
        site_spec = pl.BlockSpec((1, BL), lambda j: (0, j))
        partials, _, _ = pl.pallas_call(
            kernel,
            grid=(nb,),
            in_specs=[
                pl.BlockSpec(table.shape, lambda j: (0, 0)),
                tip_spec,
                pl.BlockSpec(pbd.shape, lambda j: (0, 0, 0)),
                pl.BlockSpec((R, 1), lambda j: (0, 0)),
                site_spec,
                site_spec,
            ],
            out_specs=[
                pl.BlockSpec((1,), lambda j: (j,)),
                pl.BlockSpec((None, n_slots, R, BL),
                             lambda j: (j, 0, 0, 0)),
                pl.BlockSpec((None, n_slots, BL), lambda j: (j, 0, 0)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((nb,), dtype),
                jax.ShapeDtypeStruct((nb, n_slots, R, BL), dtype),
                jax.ShapeDtypeStruct((nb, n_slots, BL), jnp.int32),
            ],
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
            interpret=interpret,
            name="edge_score",
        )(table, tips_slab, pbd, wvec, pattern_weights, inv_add)
        return partials

    return score
