"""Fused device pipelines: P-matrices → CLV sweep → log-likelihood in one jit.

The Partition class mirrors the reference's step-by-step API; this module is
the composition of the same kernels into single compiled programs
(the host/device boundary of SURVEY §3.1): one call computes all transition
matrices, executes the whole post-order schedule with the level-major
throughput sweep (:mod:`libpll_tpu.ops.sweep`), and reduces the edge
log-likelihood — with every per-site array shardable over a device mesh and
the final reduction crossing the mesh as one psum inserted by XLA.

Topology (the operation schedule and evaluation edge) is baked into the
returned function as compile-time constants; model parameters and CLV state
are traced arguments, so branch-length or model changes never retrace.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import derivatives as deriv_ops
from ..ops import likelihood as lk_ops
from ..ops import score_kernel as sk
from ..ops.pmatrix import compute_pmatrices
from ..ops.sweep import LevelSchedule, build_level_schedule, make_level_sweep
from ..ops.tipcodes import (accurate_sum, check_tip_encoding, decode_tips,
                            gap_code, pack_tipchars, pack_tipmasks)
from ..utils.constants import SCALE_PER_RATE, SCALE_PER_SITE


class EvalTopology(NamedTuple):
    """Static description of one evaluation: schedule + evaluation edge.

    CLV/scaler indices are in the *level-major* space of the schedule
    (see ops/sweep.py); ``topology_from_tree`` performs the translation from
    the reference index conventions.
    """

    schedule: LevelSchedule
    matrix_indices: np.ndarray  # [B] int32
    n_pmatrices: int
    parent_clv: int
    child_clv: int
    edge_matrix: int
    sites: int
    scale_mode: int = SCALE_PER_SITE
    asc_mode: int = 0

    @property
    def dummy_scaler(self) -> int:
        return self.schedule.n_inner

    def scaler_row(self, clv_row: int) -> int:
        return (clv_row - self.schedule.tips
                if clv_row >= self.schedule.tips else self.dummy_scaler)


def topology_from_tree(tree, sites, scale_mode=SCALE_PER_SITE, asc_mode=0):
    """Static evaluation description from a UTree; returns (topo, branches)."""
    from ..tree import utree as ut

    trav = ut.traverse(tree.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    schedule = build_level_schedule(ops, tree.tip_count)
    root = tree.root

    return EvalTopology(
        schedule=schedule,
        matrix_indices=np.asarray(pmat_idx, dtype=np.int32),
        n_pmatrices=len(branches),
        parent_clv=schedule.clv_map[root.clv_index],
        child_clv=schedule.clv_map[root.back.clv_index],
        edge_matrix=root.pmatrix_index,
        sites=sites,
        scale_mode=scale_mode,
        asc_mode=asc_mode,
    ), np.asarray(branches)


def _pmatrices(model, topo, dtype):
    pmat = compute_pmatrices(
        model["branch_lengths"], model["rates"], model["prop_invar"],
        model["params_indices"], model["eigenvals"], model["left"],
        model["right"], dtype=dtype)
    pmatrix = jnp.zeros((topo.n_pmatrices,) + pmat.shape[1:],
                        dtype=pmat.dtype)
    return pmatrix.at[jnp.asarray(topo.matrix_indices)].set(pmat)


def model_from_partition(partition, branches, params_indices=None,
                         dtype=None):
    """Assemble the traced model dict for the make_* pipelines from a
    Partition's parameter state (the step-by-step API's counterpart of
    the reference's partition fields).

    ``branches``: branch lengths in traversal order (from
    create_operations).  ``params_indices``: per-category rate-matrix
    indices (defaults to all zeros).  ``dtype`` defaults to float32 (the
    scoring fast path).
    """
    from ..models.gtr import eigen_decompose

    dtype = dtype or jnp.float32
    C = partition.rate_cats
    pidx = np.zeros(C, np.int32) if params_indices is None else \
        np.asarray(params_indices, np.int32)

    evals, lefts, rights = [], [], []
    for k in range(partition.rate_matrices):
        w, left, right = eigen_decompose(partition.subst_params[k],
                                         partition.frequencies[k])
        evals.append(w)
        lefts.append(left)
        rights.append(right)

    freqs_pc = np.stack([partition.frequencies[i] for i in pidx])
    pinv_pc = np.asarray([partition.prop_invar[i] for i in pidx])
    invariant = (np.asarray(partition.invariant)
                 if getattr(partition, "invariant", None) is not None
                 else np.full(partition.sites_alloc, -1, np.int32))

    return {
        "branch_lengths": jnp.asarray(branches, dtype),
        "rates": jnp.asarray(partition.rates, dtype),
        "prop_invar": jnp.asarray(partition.prop_invar, dtype),
        "params_indices": jnp.asarray(pidx),
        "eigenvals": jnp.asarray(np.stack(evals), dtype),
        "left": jnp.asarray(np.stack(lefts), dtype),
        "right": jnp.asarray(np.stack(rights), dtype),
        "freqs_pc": jnp.asarray(freqs_pc, dtype),
        "prop_invar_pc": jnp.asarray(pinv_pc, dtype),
        "rate_weights": jnp.asarray(partition.rate_weights, dtype),
        "pattern_weights": jnp.asarray(partition.pattern_weights, dtype),
        "invariant": jnp.asarray(invariant, jnp.int32),
    }


def _forward_sweep(topo: EvalTopology):
    """``f(model, clv, scalers) -> (logl, persite, clv, scalers)``: the
    level sweep plus the edge log-likelihood, swept buffers returned."""
    sweep = make_level_sweep(topo.schedule, topo.scale_mode)
    per_rate = topo.scale_mode == SCALE_PER_RATE
    sp = topo.scaler_row(topo.parent_clv)
    sc = topo.scaler_row(topo.child_clv)

    def forward(model, clv, scalers):
        pmatrix = _pmatrices(model, topo, clv.dtype)
        clv, scalers = sweep(clv, scalers, pmatrix)
        logl, persite = lk_ops.edge_loglikelihood(
            clv[topo.parent_clv], clv[topo.child_clv],
            scalers[sp], scalers[sc],
            pmatrix[topo.edge_matrix], model["freqs_pc"],
            model["rate_weights"], model["pattern_weights"],
            model["prop_invar_pc"], model["invariant"], sites=topo.sites,
            per_rate=per_rate, asc_mode=topo.asc_mode)
        return logl, persite, clv, scalers

    return forward


def make_forward(topo: EvalTopology):
    """Build ``forward(model, clv, scalers) -> (logl, persite)``.

    model: dict of traced arrays — branch_lengths [B], rates [C],
      prop_invar [M], params_indices [C] int32, eigenvals [M,S],
      left/right [M,S,S], freqs_pc [C,S], prop_invar_pc [C],
      rate_weights [C], pattern_weights [L], invariant [L] int32.
    clv: [tips + n_inner, C, S, L] level-major; scalers [n_inner+1, (C,) L].
    """
    fwd = _forward_sweep(topo)

    def forward(model, clv, scalers):
        logl, persite, _, _ = fwd(model, clv, scalers)
        return logl, persite

    return forward


def _empty_state(topo: EvalTopology, tip_clv):
    """Full level-major CLV buffer (tips first, inner rows zero) and zero
    scalers for tip CLVs [tips, C, S, L]."""
    _, c, s, length = tip_clv.shape
    n_inner = topo.schedule.n_inner
    clv = jnp.concatenate(
        [tip_clv, jnp.zeros((n_inner, c, s, length), tip_clv.dtype)], axis=0)
    sshape = ((n_inner + 1, c, length) if topo.scale_mode == SCALE_PER_RATE
              else (n_inner + 1, length))
    return clv, jnp.zeros(sshape, jnp.int32)


def make_forward_fused(topo: EvalTopology, rate_cats: int, states: int):
    """Forward pass from tip CLVs alone, one compiled program.

    Returns ``forward(model, tip_clv) -> (logl, persite, inner, scalers)``
    with ``tip_clv`` [tips, C, S, L] (constant after setup), ``inner`` the
    swept inner CLVs [n_inner, C, S, L] in level-major order (for
    derivatives and partial re-evaluation) and ``scalers`` the level-major
    scaler rows.  Ascertainment-bias pseudo-columns ride the site axis as
    in :func:`make_forward` (L = sites + S).
    """
    del rate_cats, states  # read from the tip CLVs' shape
    fwd = _forward_sweep(topo)
    tips = topo.schedule.tips

    def forward(model, tip_clv):
        clv, scalers = _empty_state(topo, tip_clv)
        logl, persite, clv, scalers = fwd(model, clv, scalers)
        return logl, persite, clv[tips:], scalers

    return forward


def make_asc_tail(topo: EvalTopology, rate_cats: int, states: int):
    """Ascertainment-bias correction as an XLA side-sweep over the S
    pseudo-columns (one all-one-state column per state; reference
    `src/pll.c:490-495`): a full pruning pass over just S sites is a few
    thousand FLOPs even at 10k taxa, so the score paths stay asc-free and
    the correction composes with every one of them (single-device,
    chunked, sharded).  Numerics are bit-identical to
    :func:`make_forward`'s asc path (same level sweep, same fold).

    Returns ``tail(model, pmatrix) -> correction`` where ``model`` must
    carry ``asc_weights`` [S] (the per-state weights of
    `pll_set_asc_state_weights`; Lewis mode ignores them).
    """
    sweep = make_level_sweep(topo.schedule, topo.scale_mode)
    per_rate = topo.scale_mode == SCALE_PER_RATE
    tips, n_inner = topo.schedule.tips, topo.schedule.n_inner
    sp = topo.scaler_row(topo.parent_clv)
    sc = topo.scaler_row(topo.child_clv)
    asc_mode = topo.asc_mode

    def tail(model, pmatrix):
        dtype = pmatrix.dtype
        eye = jnp.eye(states, dtype=dtype)  # [state, column]
        tipclv = jnp.broadcast_to(eye[None, None],
                                  (tips, rate_cats, states, states))
        clv = jnp.concatenate(
            [tipclv, jnp.zeros((n_inner, rate_cats, states, states), dtype)],
            axis=0)
        sshape = ((n_inner + 1, rate_cats, states) if per_rate
                  else (n_inner + 1, states))
        clv, scalers = sweep(clv, jnp.zeros(sshape, jnp.int32), pmatrix)

        termb = jnp.einsum("cjk,ckn->cjn", pmatrix[topo.edge_matrix],
                           clv[topo.child_clv], preferred_element_type=dtype)
        term_r = jnp.einsum("cjn,cj,cjn->cn", clv[topo.parent_clv],
                            model["freqs_pc"].astype(dtype), termb)
        if per_rate:
            comb = scalers[sp] + scalers[sc]
            site_scal, diff = lk_ops._fold_rate_scalers(comb)
            term_r = lk_ops._apply_rate_fold(term_r, diff, dtype)
        else:
            site_scal = scalers[sp] + scalers[sc]
        sum_w_real = jnp.sum(model["pattern_weights"].astype(dtype))
        return lk_ops.asc_correction_terms(
            term_r, site_scal, model["rate_weights"].astype(dtype),
            model["asc_weights"].astype(dtype), sum_w_real, asc_mode, dtype)

    return tail


def _site_score(topo: EvalTopology, rate_cats: int, states: int,
                use_pinv: bool, tip_encoding: str):
    """(``f(pmatrix, model, tips_slab, pattern_weights, invariant) ->
    partial logL`` over the slab's sites without the asc correction, the
    :class:`_KernelScore` for the same configuration).

    ``f`` is the XLA level sweep with the edge log-likelihood; pad columns
    carry weight 0.  :func:`_dispatch` puts the kernel in front of it.
    """
    sweep = make_level_sweep(topo.schedule, topo.scale_mode)
    per_rate = topo.scale_mode == SCALE_PER_RATE
    tips = topo.schedule.tips
    sp = topo.scaler_row(topo.parent_clv)
    sc = topo.scaler_row(topo.child_clv)

    def xla(pmatrix, model, tips_slab, pattern_weights, invariant):
        dtype = pmatrix.dtype
        tip_clv = decode_tips(tips_slab, tip_encoding, tips, rate_cats,
                              states, dtype)
        clv, scalers = _empty_state(topo, tip_clv)
        clv, scalers = sweep(clv, scalers, pmatrix)
        pinv = model["prop_invar_pc"].astype(dtype)
        if not use_pinv:
            pinv = jnp.zeros_like(pinv)
        _, persite = lk_ops.edge_loglikelihood(
            clv[topo.parent_clv], clv[topo.child_clv],
            scalers[sp], scalers[sc], pmatrix[topo.edge_matrix],
            model["freqs_pc"].astype(dtype),
            model["rate_weights"].astype(dtype),
            pattern_weights, pinv, invariant,
            sites=tip_clv.shape[-1], per_rate=per_rate)
        return accurate_sum(persite)

    return xla, _KernelScore(topo, rate_cats, states, use_pinv, tip_encoding)


def _dispatch(xla, kernel):
    """``f(pmatrix, model, tips_slab, pattern_weights, invariant)``: the
    kernel of :mod:`libpll_tpu.ops.score_kernel` where the configuration
    is in its scope (float32, per-site or no scaling, C·S <= 16) and the
    computation is lowered for an NVIDIA GPU, ``xla`` otherwise."""

    def f(pmatrix, model, tips_slab, pattern_weights, invariant):
        args = (pmatrix, model, tips_slab, pattern_weights, invariant)
        if kernel.supported(pmatrix.dtype):
            return kernel.choose(xla, *args)
        return xla(*args)

    return f


class _KernelScore:
    """The GPU score kernel behind the scoring wrappers: host slot plan,
    slab padding and the second-pass sum of the per-block partials."""

    def __init__(self, topo, rate_cats, states, use_pinv, tip_encoding):
        self.topo, self.rate_cats, self.states = topo, rate_cats, states
        self.use_pinv, self.tip_encoding = use_pinv, tip_encoding

    def supported(self, dtype) -> bool:
        return sk.kernel_supported(self.topo.scale_mode, dtype,
                                   self.rate_cats, self.states)

    def choose(self, xla, *args):
        """The kernel when lowered for CUDA, ``xla`` on any other
        platform (decided by where the computation runs, not by JAX's
        default backend)."""
        return jax.lax.platform_dependent(*args, cuda=self, default=xla)

    @functools.cached_property
    def plan(self):
        topo = self.topo
        return sk.plan_slots(topo.schedule, topo.parent_clv, topo.child_clv,
                             topo.edge_matrix)

    def __call__(self, pmatrix, model, tips_slab, pattern_weights,
                 invariant, interpret=False):
        C, S = self.rate_cats, self.states
        dtype = pmatrix.dtype
        block = sk.default_block_sites(tips_slab.shape[-1])
        score = sk.make_kernel_score(
            self.plan, self.topo.schedule.tips, rate_cats=C, states=S,
            scale_mode=self.topo.scale_mode, tip_encoding=self.tip_encoding,
            use_pinv=self.use_pinv, block_sites=block, interpret=interpret)
        pad = -tips_slab.shape[-1] % block
        slab = sk.prepare_slab(tips_slab, self.tip_encoding,
                               self.topo.schedule.tips, C, S, block, dtype)
        freqs = model["freqs_pc"].astype(dtype)
        rw = model["rate_weights"].astype(dtype)
        inv_add = jnp.zeros(pattern_weights.shape, dtype)
        if self.use_pinv:
            # Σ_c w_c[(1-p_c)·term_c + p_c·f_c[inv]]: a rescaled weight
            # vector plus a per-site additive term (reference mix order,
            # `src/core_likelihood.c:960-978`)
            pinv = model["prop_invar_pc"].astype(dtype)
            inv_lk = jnp.where(invariant[None, :] >= 0,
                               freqs[:, jnp.maximum(invariant, 0)], 0.0)
            inv_add = jnp.einsum("c,cn->n", rw * pinv, inv_lk)
            freqs = freqs * (1.0 - pinv)[:, None]
        wvec = sk.pad_rows((freqs * rw[:, None]).reshape(C * S, 1),
                           sk.rows_padded(C, S))
        pw = jnp.pad(pattern_weights.astype(dtype), (0, pad))[None, :]
        inv_add = jnp.pad(inv_add, (0, pad))[None, :]
        pbd = sk.block_diag_pmatrices(pmatrix, sk.rows_padded(C, S))
        return accurate_sum(score(slab, pbd, wvec, pw, inv_add))


def _check_score_config(topo, use_pinv):
    if topo.asc_mode and use_pinv:
        raise ValueError("asc-bias and prop-invar are mutually exclusive")


def make_score(topo: EvalTopology, rate_cats: int, states: int,
               use_pinv: bool = False, tip_encoding: str = "clv"):
    """Tree-search scoring: P-matrices → pruning sweep → edge
    log-likelihood, one compiled program that returns only the logL.

    ``tip_encoding`` (:mod:`libpll_tpu.ops.tipcodes`): ``"clv"`` takes
    tip CLVs [tips, C, S, L]; ``"chars"`` nibble-packed codes from
    :func:`~libpll_tpu.ops.tipcodes.pack_tipchars` (0.5 byte per tip and
    site, DNA); ``"masks"`` one int32 bitmask per tip and site.  +I via
    ``use_pinv``; asc-bias (``topo.asc_mode``) via the pseudo-column
    side-sweep (:func:`make_asc_tail`); per-site, per-rate or no scaling
    (``topo.scale_mode``).  On a GPU in float32 with per-site or no
    scaling at DNA width the sweep runs in the kernel of
    :mod:`libpll_tpu.ops.score_kernel`; otherwise in XLA.

    Returns ``score(model, tips_packed) -> logl``.
    """
    check_tip_encoding(tip_encoding, states)
    _check_score_config(topo, use_pinv)
    local = _dispatch(*_site_score(topo, rate_cats, states, use_pinv,
                                   tip_encoding))
    asc_tail = (make_asc_tail(topo, rate_cats, states)
                if topo.asc_mode else None)

    def score(model, tips_packed):
        dtype = (tips_packed.dtype if tip_encoding == "clv"
                 else model["freqs_pc"].dtype)
        pmatrix = _pmatrices(model, topo, dtype)
        logl = local(pmatrix, model, tips_packed,
                     model["pattern_weights"].astype(dtype),
                     model["invariant"])
        if asc_tail is not None:
            logl = logl + asc_tail(model, pmatrix)
        return logl

    return score


def make_score_sharded(topo: EvalTopology, rate_cats: int, states: int,
                       mesh, use_pinv: bool = False):
    """Multi-device scoring: tip CLVs [tips, C, S, L] sharded on the sites
    axis, each device scores its local site shard (per-site scaling is
    shard-local by construction) and the partial log-likelihoods meet in
    one psum — the entire cross-device traffic of a full-tree evaluation
    (SURVEY §2.4/§5.8).  The asc-bias pseudo-column sweep runs replicated
    outside the shard_map (S columns — no reason to shard).

    Returns ``score(model, tip_clv) -> logl``; L must divide the mesh.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import SITES_AXIS

    _check_score_config(topo, use_pinv)
    local = _dispatch(*_site_score(topo, rate_cats, states, use_pinv,
                                   "clv"))
    asc_tail = (make_asc_tail(topo, rate_cats, states)
                if topo.asc_mode else None)
    shard = P(SITES_AXIS)

    def score(model, tip_clv):
        pmatrix = _pmatrices(model, topo, tip_clv.dtype)

        def part(tp, pmat, m, pw, inv):
            return jax.lax.psum(local(pmat, m, tp, pw, inv), SITES_AXIS)

        # check_vma=False: pallas_call's out_shape carries no varying-axis
        # metadata, which the vma checker would otherwise reject
        fn = shard_map(
            part, mesh=mesh,
            in_specs=(P(None, None, None, SITES_AXIS), P(), P(), shard,
                      shard),
            out_specs=P(), check_vma=False)
        logl = fn(tip_clv, pmatrix, _replicated(model),
                  model["pattern_weights"].astype(tip_clv.dtype),
                  model["invariant"])
        if asc_tail is not None:
            logl = logl + asc_tail(model, pmatrix)
        return logl

    return score


def _replicated(model):
    """The model entries the per-site score reads, without its per-site
    arrays (those travel sharded)."""
    return {k: model[k] for k in ("freqs_pc", "rate_weights",
                                  "prop_invar_pc")}


# one site chunk of the XLA score holds at most this many CLV bytes
_CHUNK_BYTES = 1 << 30


def score_chunk_sites(topo: EvalTopology, rate_cats: int, states: int,
                      sites: int, itemsize: int = 4) -> int:
    """Sites per chunk of :func:`make_score_unbounded`: the largest power
    of two (at least 128) whose full CLV buffer fits ``_CHUNK_BYTES``,
    capped at the site count rounded up to 128."""
    nodes = topo.schedule.tips + topo.schedule.n_inner
    per_site = nodes * rate_cats * states * itemsize
    chunk = 128
    while chunk * 2 * per_site <= _CHUNK_BYTES and chunk < sites:
        chunk *= 2
    return chunk


def _chunked_score(topo, rate_cats, states, use_pinv, encoding, chunk):
    """``f(pmatrix, model, slab, pattern_weights, invariant) -> logL``
    summing the XLA score of :func:`_site_score` over site chunks with
    ``lax.map`` (peak memory one chunk's CLVs, at any tree size); L a
    multiple of ``chunk``.  The kernel keeps only a few CLV slots per
    site block, so it takes the whole slab in one launch."""
    xla, kernel = _site_score(topo, rate_cats, states, use_pinv, encoding)

    def chunked(pmatrix, model, slab, pw, inv):
        n = slab.shape[-1] // chunk

        def split(x):
            return jnp.moveaxis(x.reshape(x.shape[:-1] + (n, chunk)), -2, 0)

        parts = jax.lax.map(
            lambda a: xla(pmatrix, model, *a),
            (split(slab), split(pw), split(inv)))
        return jnp.sum(parts)

    return _dispatch(chunked, kernel)


def _pad_site_inputs(masks, states, multiple):
    """Tip slab padded with gap columns to a multiple of ``multiple``;
    returns (encoding, slab, pad)."""
    pad = -masks.shape[1] % multiple
    if pad:
        masks = np.concatenate(
            [masks, np.full((masks.shape[0], pad), gap_code(states),
                            masks.dtype)], axis=1)
    if int(masks.max()) <= 0xF:
        return "chars", np.asarray(pack_tipchars(masks)), pad
    return "masks", np.asarray(pack_tipmasks(masks)), pad


def _padded_site_arrays(model, dtype, pad):
    pw = jnp.pad(model["pattern_weights"].astype(dtype), (0, pad))
    inv = jnp.pad(model["invariant"], (0, pad), constant_values=-1)
    return pw, inv


def make_score_unbounded(topo: EvalTopology, rate_cats: int, states: int,
                         tip_masks, use_pinv: bool = False):
    """Tree-search scoring for trees of any size with pattern-tip storage:
    0.5 byte per tip and site for <=4-bit alphabets (DNA), 4 bytes for
    wide alphabets (protein 20-bit ambiguity masks).  The sweep runs over
    site chunks (:func:`score_chunk_sites`) so that peak memory stays
    bounded at any tree size.  +I via ``use_pinv``; asc-bias
    (topo.asc_mode) via the pseudo-column side-sweep.

    ``tip_masks``: [tips, sites] integer ambiguity bitmasks
    (Partition._tip_masks or io.maps.encode_sequence output).
    Returns ``score(model) -> logl``; tip data is baked at build time
    (tips are constant after setup).
    """
    _check_score_config(topo, use_pinv)
    masks = np.asarray(tip_masks)
    chunk = score_chunk_sites(topo, rate_cats, states, masks.shape[1])
    enc, slab, pad = _pad_site_inputs(masks, states, chunk)
    slab = jnp.asarray(slab)
    f = _chunked_score(topo, rate_cats, states, use_pinv, enc, chunk)
    asc_tail = (make_asc_tail(topo, rate_cats, states)
                if topo.asc_mode else None)

    def score(model):
        dtype = model["freqs_pc"].dtype
        pmatrix = _pmatrices(model, topo, dtype)
        pw, inv = _padded_site_arrays(model, dtype, pad)
        logl = f(pmatrix, model, slab, pw, inv)
        if asc_tail is not None:
            logl = logl + asc_tail(model, pmatrix)
        return logl

    return score


def make_score_unbounded_sharded(topo: EvalTopology, rate_cats: int,
                                 states: int, tip_masks, mesh,
                                 use_pinv: bool = False):
    """Multi-device :func:`make_score_unbounded`: pattern-tip slabs
    sharded over the mesh's sites axis, each device sums its local chunks
    and the partial log-likelihoods meet in ONE psum.  This is the
    10k-taxa × 1M-site configuration of BASELINE.json.

    Returns ``score(model) -> logl``; sites are padded with weight-0 gap
    columns to a multiple of mesh size × chunk.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import SITES_AXIS

    _check_score_config(topo, use_pinv)
    masks = np.asarray(tip_masks)
    n_shards = int(mesh.shape[SITES_AXIS])
    chunk = score_chunk_sites(topo, rate_cats, states,
                              -(-masks.shape[1] // n_shards))
    enc, slab, pad = _pad_site_inputs(masks, states, chunk * n_shards)
    shard2 = P(None, SITES_AXIS)
    slab = jax.device_put(slab, NamedSharding(mesh, shard2))
    f = _chunked_score(topo, rate_cats, states, use_pinv, enc, chunk)
    asc_tail = (make_asc_tail(topo, rate_cats, states)
                if topo.asc_mode else None)
    shard = P(SITES_AXIS)

    def score(model):
        dtype = model["freqs_pc"].dtype
        pmatrix = _pmatrices(model, topo, dtype)
        pw, inv = _padded_site_arrays(model, dtype, pad)

        def part(sl, pmat, m, pwl, invl):
            return jax.lax.psum(f(pmat, m, sl, pwl, invl), SITES_AXIS)

        fn = shard_map(part, mesh=mesh,
                       in_specs=(shard2, P(), P(), shard, shard),
                       out_specs=P(), check_vma=False)
        logl = fn(slab, pmatrix, _replicated(model), pw, inv)
        if asc_tail is not None:
            logl = logl + asc_tail(model, pmatrix)
        return logl

    return score


def make_train_step_fused(topo: EvalTopology, rate_cats: int, states: int):
    """:func:`make_train_step` from tip CLVs alone: sweep → edge logL →
    sumtable → device-resident Newton ``while_loop`` on the evaluation
    edge, one compiled program.

    Returns ``step(model, tip_clv) -> (logl, t_star)``.
    """
    del rate_cats, states  # read from the tip CLVs' shape
    step_full = make_train_step(topo)

    def step(model, tip_clv):
        clv, scalers = _empty_state(topo, tip_clv)
        logl, t_star, _, _ = step_full(model, clv, scalers)
        return logl, t_star

    return step


def make_train_step(topo: EvalTopology):
    """Full "training" step: forward sweep + analytic Newton update of the
    evaluation edge's branch length (the optimization inner loop of SURVEY
    §3.3) — everything on device, one compiled program.

    Returns ``step(model, clv, scalers) -> (logl, t_new, clv, scalers)``.
    """
    sweep = make_level_sweep(topo.schedule, topo.scale_mode)
    per_rate = topo.scale_mode == SCALE_PER_RATE
    sp_row = topo.scaler_row(topo.parent_clv)
    sc_row = topo.scaler_row(topo.child_clv)

    MIN_T, MAX_T = 1e-8, 100.0

    def step(model, clv, scalers):
        pmatrix = _pmatrices(model, topo, clv.dtype)
        clv, scalers = sweep(clv, scalers, pmatrix)

        logl, _ = lk_ops.edge_loglikelihood(
            clv[topo.parent_clv], clv[topo.child_clv],
            scalers[sp_row], scalers[sc_row],
            pmatrix[topo.edge_matrix], model["freqs_pc"],
            model["rate_weights"], model["pattern_weights"],
            model["prop_invar_pc"], model["invariant"], sites=topo.sites,
            per_rate=per_rate, asc_mode=topo.asc_mode)

        # analytic Newton on the evaluation edge (sumtable once, then a
        # device-resident while_loop; reference examples/newton/newton.c)
        sp = scalers[sp_row]
        sc = scalers[sc_row]
        left_pc = model["left"][model["params_indices"]]
        right_pc = model["right"][model["params_indices"]]
        evals_pc = model["eigenvals"][model["params_indices"]]
        sumtable = deriv_ops.update_sumtable(
            clv[topo.parent_clv], clv[topo.child_clv], sp, sc,
            model["freqs_pc"], left_pc, right_pc, per_rate=per_rate)

        zeros_site = jnp.zeros((clv.shape[-1],), dtype=jnp.int32)
        sp_site = sp if not per_rate else zeros_site
        sc_site = sc if not per_rate else zeros_site

        t0 = model["branch_lengths"][-1]

        def cond(carry):
            t, d1, it = carry
            return (jnp.abs(d1) > 1e-9) & (it < 32)

        def body(carry):
            t, _, it = carry
            d1, d2 = deriv_ops.likelihood_derivatives(
                sumtable, t, model["rates"], model["prop_invar_pc"],
                evals_pc, model["freqs_pc"], model["rate_weights"],
                model["invariant"], model["pattern_weights"],
                sp_site, sc_site, sites=topo.sites, asc_mode=topo.asc_mode)
            step_ = jnp.where(d2 != 0.0, d1 / d2, d1)
            t_new = jnp.clip(t - step_, MIN_T, MAX_T)
            return (t_new, d1, it + 1)

        big = jnp.asarray(jnp.inf, dtype=clv.dtype)
        t_star, _, _ = jax.lax.while_loop(
            cond, body, (t0.astype(clv.dtype), big, 0))
        return logl, t_star, clv, scalers

    return step
