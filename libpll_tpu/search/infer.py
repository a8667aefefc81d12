"""End-to-end maximum-likelihood tree inference.

The complete workflow libpll users assemble by hand from the library's
pieces (reference: stepwise.c starting trees + utree_moves.c SPR loops +
the newton example's branch-length optimization), packaged as one driver:

  1. randomized stepwise-addition parsimony starting tree (seed-exact RNG,
     persistent directional Fitch vectors, batched candidate scoring);
  2. alternating rounds of
       a. full-tree Newton branch-length sweeps — the device-resident
          whole-sweep program (one dispatch per sweep), and
       b. likelihood SPR rounds — batched incremental candidate scoring
          (one dispatch per candidate batch, zero recompiles),
     until neither improves the log-likelihood.

Everything after the host-side tree bookkeeping runs on device through the
schedule-as-data executors, so the entire search triggers a fixed, small
number of compilations regardless of how many topologies it visits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..engine import blopt
from ..engine.partition import Partition
from ..errors import CapacityError
from ..io import maps
from ..models.gamma import compute_gamma_cats
from ..tree import utree as ut
from .parsimony import FastParsimony
from .spr import local_edge_set, make_round_scorer, nni_round, spr_round
from .stepwise import fastparsimony_stepwise


@dataclass
class InferResult:
    tree: ut.UTree
    partition: Partition
    logl: float
    start_parsimony_score: int
    rounds: int
    trajectory: List[float] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)
    model: Optional[object] = None  # ModelOptResult when optimize_model=True


def infer_tree(sequences: Dict[str, str], *, states: int = 4,
               rate_cats: int = 4, alpha: float = 1.0,
               frequencies: Optional[Sequence[float]] = None,
               subst_params: Optional[Sequence[float]] = None,
               charmap: Optional[np.ndarray] = None, seed: int = 42,
               radius: int = 5, max_rounds: int = 20,
               blopt_sweeps: int = 2, spr_batch: int = 32,
               min_delta: float = 1e-6, compress: bool = True,
               moves: str = "spr", mesh=None, local_blopt: int = 3,
               spr_commit: int = 8, optimize_model: bool = False,
               model_rounds: int = 2, opt_pinv: bool = False,
               dtype=jnp.float64) -> InferResult:
    """Infer an ML tree for ``sequences`` (label -> aligned sequence).

    Model: GTR(+Γ) with fixed ``frequencies``/``subst_params`` (defaults:
    uniform) and Γ shape ``alpha``.  ``dtype`` selects the numeric path
    (float64 parity path by default; float32 for throughput).
    ``compress`` dedups site patterns into weighted columns
    (`pll_compress_site_patterns`) before any device work — the standard
    real-data speedup; the inferred logL equals the uncompressed one.
    ``moves`` selects the topology search: ``"spr"`` (radius-bounded SPR
    rounds, default) or ``"nni"`` (nearest-neighbor interchanges — the
    cheaper move set users of `pll_utree_nni` assemble).
    ``mesh`` runs the whole inference sites-sharded: the stepwise build
    shards its Fitch word axis (one integer psum per insertion), the
    partition's bulk arrays shard on the site axis (weight-0 pad columns
    even out the division), and the SPR scorer / Newton sweeps partition
    automatically under GSPMD — results match the single-device run.
    ``local_blopt`` (edge radius, 0 to disable) optimizes only the
    branches within that radius of a committed move instead of paying a
    full 2n−3-edge Newton sweep every round — the changed-branch
    discipline the reference's move primitives exist to enable
    (utree_moves.c:204-251).  Full sweeps still run at the start and as
    the convergence check, so the final tree is fully optimized either
    way.  ``spr_commit`` applies up to that many non-overlapping
    improving moves per scored round (each verified exactly, rolled back
    on regression) — one neighborhood scoring pass then harvests several
    independent improvements.
    ``optimize_model`` additionally fits the model itself (GTR
    exchangeabilities + frequencies by L-BFGS through the differentiable
    eigendecomposition, Γ shape by Brent over ``model_rounds`` coordinate
    rounds, p-inv with ``opt_pinv`` — engine/modelopt.py): one fit on the
    branch-length-optimized starting tree and one refit after the
    topology search converges, each followed by a fresh Newton sweep.
    The fixed ``frequencies``/``subst_params``/``alpha`` arguments become
    the starting point.
    """
    from ..io.compress import compress_site_patterns

    if moves not in ("spr", "nni"):
        raise ValueError(f"moves must be 'spr' or 'nni', got {moves!r}")
    labels = list(sequences)
    seqs = [sequences[lab] for lab in labels]
    tips = len(labels)
    cmap = charmap if charmap is not None else (
        maps.pll_map_nt if states == 4 else maps.pll_map_aa)

    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    weights = None
    if compress:
        seqs, weights = compress_site_patterns(seqs, cmap)
    sites = len(seqs[0])
    if mesh is not None:
        # zero-weight pad columns make sites divide the mesh evenly
        # (mirroring the reference's zero-weight SIMD padding)
        pad = (-sites) % int(np.prod(list(mesh.shape.values())))
        if pad:
            if weights is None:
                weights = np.ones(sites, np.int64)
            idx = int(np.argmax(cmap > 0))
            padchar = chr(idx) * pad
            seqs = [s + padchar for s in seqs]
            weights = np.concatenate([np.asarray(weights),
                                      np.zeros(pad, np.int64)])
            sites += pad
    timings["compress"] = time.perf_counter() - t0

    # 1. parsimony starting tree
    t0 = time.perf_counter()
    pars = FastParsimony.from_sequences(
        seqs, cmap, states=states,
        pattern_weights=weights if weights is not None else None)
    tree, pscore = fastparsimony_stepwise([pars], labels, seed, mesh=mesh)
    timings["stepwise"] = time.perf_counter() - t0
    for n in tree.nodes:  # stepwise emits zero-length branches
        for m in ([n] if n.is_tip else n.ring()):
            if m.length == 0.0:
                m.length = 0.1
            m.back.length = m.length

    # 2. likelihood engine
    t0 = time.perf_counter()
    part = Partition(tips, tips - 2, states, sites, 1, 2 * tips - 3,
                     rate_cats, tips - 2, dtype=dtype)
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    for lab, s in zip(labels, seqs):
        part.set_tip_states(order[lab], cmap, s)
    if weights is not None:
        part.set_pattern_weights(weights)
    n_params = states * (states - 1) // 2
    part.set_frequencies(0, frequencies if frequencies is not None
                         else [1.0 / states] * states)
    part.set_subst_params(0, subst_params if subst_params is not None
                          else [1.0] * n_params)
    part.set_category_rates(compute_gamma_cats(alpha, rate_cats))
    if mesh is not None:
        from ..parallel.mesh import shard_partition
        shard_partition(part, mesh)
    pidx = [0] * rate_cats

    # 3. alternate branch-length sweeps and SPR rounds.  Both executors
    # are schedule-as-data: ONE blopt program and ONE SPR scorer serve
    # every round (fixed capacity envelopes, bumped only if a dirty
    # subset outgrows them).
    bl_cap = 32
    bl_program = blopt.make_sweep_program(part.nodes, part.scale_buffers,
                                          bl_cap, sites=part.sites,
                                          scale_mode=part.scale_mode)
    timings["setup"] = time.perf_counter() - t0

    # fixed local-sweep envelope (one trace per cap); sized for
    # spr_commit moves' merged radius-local_blopt neighborhoods
    LOCAL_EDGE_PAD = min(256, 1 << (2 * tips - 4).bit_length())

    def run_blopt(edges=None, sweeps=blopt_sweeps):
        # capacity overflow (a re-orientation subset outgrew the envelope)
        # is the ONLY retryable condition; the retry count is bounded by
        # the pow2 ladder up to the full schedule size
        nonlocal bl_cap, bl_program
        max_cap = 1 << (2 * tips - 3).bit_length()
        edge_pad = None
        if edges is not None:
            if len(edges) > LOCAL_EDGE_PAD:
                edges = None  # unusually wide move: pay the full sweep
            else:
                edge_pad = LOCAL_EDGE_PAD
        while True:
            try:
                return blopt.optimize_branch_lengths_scan(
                    tree, part, pidx, max_sweeps=sweeps,
                    capacity=bl_cap, program=bl_program,
                    edges=edges, edge_pad=edge_pad)
            except CapacityError:
                if bl_cap >= max_cap:
                    raise
                bl_cap *= 2
                bl_program = blopt.make_sweep_program(
                    part.nodes, part.scale_buffers, bl_cap,
                    sites=part.sites, scale_mode=part.scale_mode)

    t0 = time.perf_counter()
    # the stepwise start's crude branch lengths need the initial full
    # optimization run to (near) convergence — with local sweeps inside
    # the rounds, under-optimization here is not recovered until the
    # final convergence sweep and degrades SPR candidate ranking
    logl, _ = run_blopt(
        sweeps=max(blopt_sweeps, 6) if local_blopt else blopt_sweeps)
    timings["blopt"] = time.perf_counter() - t0
    timings["spr"] = 0.0
    trajectory = [logl]

    mres = None

    def run_modelopt():
        # fit the model on the current tree, then re-optimize branch
        # lengths under the new model (they were tuned under the old one)
        nonlocal mres, logl
        from ..engine import modelopt
        t0 = time.perf_counter()
        mres = modelopt.optimize_model(
            part, tree, opt_alpha=rate_cats > 1, opt_pinv=opt_pinv,
            alpha=mres.alpha if mres is not None else alpha,
            rounds=model_rounds, dtype=dtype)
        timings["modelopt"] = (timings.get("modelopt", 0.0)
                               + time.perf_counter() - t0)
        t0 = time.perf_counter()
        new_logl, _ = run_blopt()
        timings["blopt"] += time.perf_counter() - t0
        logl = max(logl, mres.logl, new_logl)
        trajectory.append(logl)

    if optimize_model:
        run_modelopt()
    scorer = None
    # a radius-r candidate's dirty path is bounded by the prune->regraft
    # path plus the eval-edge re-orientation: 2·radius + O(1) ops.  The
    # constant is pre-sized generously (measured 21 at radius 3 on a
    # 1024-taxon tree — the re-orientation tail is larger than the round-2
    # "+8" estimate), so the default radius never pays a scorer rebuild
    cap = 1 << (2 * radius + 16 - 1).bit_length()
    rounds = 0
    improved = False
    for rounds in range(1, max_rounds + 1):
        t0 = time.perf_counter()
        if scorer is None:
            scorer = make_round_scorer(part, cap)
        def one_round():
            if moves == "nni":
                return nni_round(tree, part, pidx, capacity=cap,
                                 batch=spr_batch, scorer=scorer,
                                 min_delta=min_delta)
            return spr_round(tree, part, pidx, radius=radius, capacity=cap,
                             batch=spr_batch, scorer=scorer,
                             min_delta=min_delta, commit=spr_commit)

        try:
            res = one_round()
        except CapacityError:
            # a candidate's dirty subset outgrew the pre-sized envelope:
            # rebuild the scorer once with a doubled envelope; any other
            # error propagates untouched
            cap *= 2
            scorer = make_round_scorer(part, cap)
            res = one_round()
        improved = res.improved
        logl = res.best_logl
        timings["spr"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if improved and local_blopt and res.best_nodes is not None:
            # optimize only the changed neighborhood; the full sweep runs
            # as the convergence check once SPR stops improving
            new_logl, _ = run_blopt(
                edges=local_edge_set(res.best_nodes, local_blopt))
            logl = max(logl, new_logl)
        else:
            new_logl, _ = run_blopt()
            improved |= new_logl > logl + min_delta
            logl = max(logl, new_logl)
        timings["blopt"] += time.perf_counter() - t0
        trajectory.append(logl)
        if not improved:
            break

    if local_blopt and improved:
        # max_rounds exit on a local sweep: leave fully optimized anyway
        t0 = time.perf_counter()
        new_logl, _ = run_blopt()
        timings["blopt"] += time.perf_counter() - t0
        logl = max(logl, new_logl)
        trajectory.append(logl)

    if optimize_model:
        # refit on the final topology (branch re-sweep included)
        run_modelopt()

    return InferResult(tree, part, float(logl), int(pscore), rounds,
                       trajectory, timings, model=mres)
