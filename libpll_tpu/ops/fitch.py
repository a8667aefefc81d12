"""Bit-packed unweighted (Fitch) parsimony kernels.

Capability parity with libpll `src/fast_parsimony.c`:

  * parsimony-informative sites (≥2 states appearing ≥2×) are detected on
    the host; uninformative sites contribute ``singleton_states × weight``
    to a constant cost (`check_informative`, fast_parsimony.c:126-190);
  * informative sites are replicated by pattern weight and bit-packed into
    per-state uint32 vectors, pad bits set to 1 (`fill_parsimony_vectors`,
    fast_parsimony.c:192-360);
  * the Fitch step per 32-site word (`fast_parsimony.c:477-513`):
        union_j = OR_j (c1_j & c2_j)
        parent_j = (c1_j & c2_j) | (~union_j & (c1_j | c2_j))
        cost += popcount(~union_j)
  * edge score: popcount of the complement of OR_j(n1_j & n2_j) plus both
    accumulated node costs plus the constant cost.

The per-state uint32 words map directly onto vector lanes —
``jax.lax.population_count`` + bitwise ops, vmapped over the operations of a
dependency level.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BITS = 32


def set_informative(tip_masks: np.ndarray, states: int,
                    pattern_weights: np.ndarray):
    """Identify parsimony-informative sites.

    tip_masks: uint32 [tips, sites] state bitmasks.
    Returns (informative bool [sites], const_cost int).
    """
    tips, sites = tip_masks.shape
    # per-column value-run analysis (vectorized over the alignment; the
    # per-site dict loop this replaces cost O(tips·sites) python time —
    # seconds at 500×10k, minutes at giant scale)
    m = np.sort(tip_masks, axis=0)                      # [tips, sites]
    start = np.ones((tips, sites), dtype=bool)
    start[1:] = m[1:] != m[:-1]
    # a run is a singleton iff its start is immediately followed by
    # another start (or by the end of the column)
    nxt = np.ones((tips, sites), dtype=bool)
    nxt[:-1] = start[1:]
    single = (start & nxt).sum(axis=0)
    multi = start.sum(axis=0) - single
    informative = multi > 1
    const_cost = int((single[~informative]
                      * np.asarray(pattern_weights)[~informative]).sum())
    return informative, const_cost


def pack_vectors(tip_masks: np.ndarray, states: int,
                 informative: np.ndarray, pattern_weights: np.ndarray,
                 n_inner: int, pad_words: int = 8) -> np.ndarray:
    """Bit-pack informative sites (×weight) into uint32 state vectors.

    Returns uint32 [tips + n_inner, states, words]; tip rows filled, inner
    rows zero. Pad bits/words are all-ones (they never contribute cost).
    """
    tips, sites = tip_masks.shape
    bitcount = int(pattern_weights[informative].sum())
    words = (bitcount + BITS - 1) // BITS
    words = ((words + pad_words - 1) // pad_words) * pad_words
    words = max(words, pad_words)

    out = np.zeros((tips + n_inner, states, words), dtype=np.uint32)

    # site index replicated by weight, bit position assignment
    rep_sites = np.repeat(np.nonzero(informative)[0],
                          pattern_weights[informative].astype(int))
    bitpos = np.arange(rep_sites.size)
    word_idx = bitpos // BITS
    bit_in_word = (bitpos % BITS).astype(np.uint32)

    for i in range(tips):
        masks = tip_masks[i, rep_sites]  # [bits]
        for k in range(states):
            hasbit = ((masks >> k) & 1).astype(bool)
            np.add.at(out[i, k], word_idx[hasbit],
                      (np.uint32(1) << bit_in_word[hasbit]))
    # pad bits within the last used word + all padding words -> ones
    used = rep_sites.size
    if used % BITS:
        last = used // BITS
        padmask = np.uint32(0xFFFFFFFF) << np.uint32(used % BITS)
        out[:tips, :, last] |= padmask
        full_from = last + 1
    else:
        full_from = used // BITS
    out[:tips, :, full_from:] = 0xFFFFFFFF
    return out


@jax.jit
def fitch_update(vectors, costs, parent, child1, child2):
    """One batched Fitch step for a level of independent operations.

    vectors: uint32 [N, S, W]; costs: uint32 [N].
    parent/child1/child2: int32 [w] score indices.
    Returns updated (vectors, costs).
    """
    a = vectors[child1]  # [w, S, W]
    b = vectors[child2]
    land = a & b
    # OR-reduce over the (small, static) state axis
    union = land[:, 0]
    for k in range(1, land.shape[1]):
        union = union | land[:, k]
    newvec = land | (~union[:, None, :] & (a | b))
    inc = jnp.sum(jax.lax.population_count(~union), axis=1)  # [w]
    newcost = costs[child1] + costs[child2] + inc.astype(costs.dtype)
    vectors = vectors.at[parent].set(newvec)
    costs = costs.at[parent].set(newcost)
    return vectors, costs


@partial(jax.jit, donate_argnums=(0, 1))
def fitch_run_waves(vectors, costs, tables):
    """Execute dependency-ordered waves of Fitch updates in ONE compiled
    call: ``tables`` int32 [n_waves, width, 3] rows of (parent, child1,
    child2), padded by repeating ops/waves (recomputing a Fitch op is
    idempotent — parent vector and cost are pure functions of the
    children).  This is the schedule-as-data executor stepwise addition
    uses so each insertion costs one device call instead of one per
    dependency level (reference partial traversal: stepwise.c:241-323)."""
    def wave(carry, tab):
        vectors, costs = carry
        vectors, costs = fitch_update(vectors, costs, tab[:, 0],
                                      tab[:, 1], tab[:, 2])
        return (vectors, costs), None

    (vectors, costs), _ = jax.lax.scan(wave, (vectors, costs), tables)
    return vectors, costs


@jax.jit
def fitch_edge_score(vectors, costs, node1, node2):
    """Parsimony score of joining node1--node2 (without const_cost)."""
    a = vectors[node1]  # [S, W]
    b = vectors[node2]
    land = a & b
    union = land[0]
    for k in range(1, land.shape[0]):
        union = union | land[k]
    score = jnp.sum(jax.lax.population_count(~union), axis=-1)
    return score.astype(costs.dtype) + costs[node1] + costs[node2]


@jax.jit
def fitch_edge_scores_batch(vectors, costs, nodes1, nodes2):
    """Vectorized edge scores for many candidate edges at once — the
    batched-candidate upgrade over the reference's sequential edge loop
    (SURVEY §3.4)."""
    a = vectors[nodes1]  # [w, S, W]
    b = vectors[nodes2]
    land = a & b
    union = land[:, 0]
    for k in range(1, land.shape[1]):
        union = union | land[:, k]
    score = jnp.sum(jax.lax.population_count(~union), axis=1)
    return score.astype(costs.dtype) + costs[nodes1] + costs[nodes2]


def _insert_scores(vectors, costs, tipvec, u_idx, v_idx):
    """Traceable body of :func:`fitch_insert_scores` (shared with the
    device-resident stepwise program)."""
    a = vectors[u_idx]  # [E, S, W]
    b = vectors[v_idx]
    t = tipvec[None]  # [1, S, W]

    land1 = a & t
    union1 = land1[:, 0]
    for k in range(1, land1.shape[1]):
        union1 = union1 | land1[:, k]
    x = land1 | (~union1[:, None, :] & (a | t))
    mut1 = jnp.sum(jax.lax.population_count(~union1), axis=1)

    land2 = x & b
    union2 = land2[:, 0]
    for k in range(1, land2.shape[1]):
        union2 = union2 | land2[:, k]
    mut2 = jnp.sum(jax.lax.population_count(~union2), axis=1)

    return (costs[u_idx] + costs[v_idx]
            + mut1.astype(costs.dtype) + mut2.astype(costs.dtype))


def _ring_co_tables(n_tips: int) -> tuple[np.ndarray, np.ndarray]:
    """Static ring co-member tables for the device-resident stepwise build.

    Direction rows: tips occupy rows 0..n-1; inner directed nodes are
    allocated in ring triples (b, b+1, b+2) — the star ring at rows
    n..n+2, then one triple per insertion.  Ring membership never changes
    after creation, so ``co1[d]``/``co2[d]`` (= d.next / d.next.next in the
    reference's ring representation, pll.h:312-334) are compile-time
    constants; tips map to themselves (never dereferenced).
    """
    D = n_tips + 3 * (n_tips - 2)
    co1 = np.arange(D, dtype=np.int32)
    co2 = np.arange(D, dtype=np.int32)
    for b in range(n_tips, D, 3):
        co1[b], co1[b + 1], co1[b + 2] = b + 1, b + 2, b
        co2[b], co2[b + 1], co2[b + 2] = b + 2, b, b + 1
    return co1, co2


def _chunk_fitch(vectors, costs, idx, c1, c2):
    """Recompute the Fitch ops of rows ``idx`` (children c1/c2, gathered
    per chunk; out-of-range sentinel rows scatter with mode='drop')."""
    a = vectors[c1]
    b = vectors[c2]
    land = a & b
    union = land[:, 0]
    for k in range(1, land.shape[1]):
        union = union | land[:, k]
    newvec = land | (~union[:, None, :] & (a | b))
    inc = jnp.sum(jax.lax.population_count(~union), axis=-1)
    newcost = costs[c1] + costs[c2] + inc.astype(costs.dtype)
    vectors = vectors.at[idx].set(newvec, mode="drop")
    costs = costs.at[idx].set(newcost, mode="drop")
    return vectors, costs


def _stepwise_build_body(n_tips: int, axis_name, vecs_t, costs_t, back,
                         edge_rows, order):
    """The WHOLE greedy stepwise-addition build as ONE compiled program.
    (Composition of :func:`_stepwise_range_body` over the full insertion
    range and :func:`_stepwise_final_body`.)

    Replaces the reference's host-side insertion loop
    (`stepwise.c:241-323`; 2 device dispatches + 1 readback per insertion
    when driven from the host) with a `lax.fori_loop` over tips:

      * topology lives on device as a ``back`` involution over direction
        rows plus the static ring tables from :func:`_ring_co_tables`
        (children of direction d are ``back[co1[d]], back[co2[d]]``);
      * all candidate edges are scored in one batched gather + argmin
        (first minimum wins — same tie-break as the reference edge list);
      * the splice is 6 scatter updates of ``back`` + 2 appended edges;
      * dirty directional vectors (the 2-per-node set whose subtree gained
        the new tip) recompute in BFS waves via a dense-mask
        ``while_loop``: dependents of row d are ``co1[back[d]],
        co2[back[d]]`` — each dirty op has exactly one dirty child, one
        BFS level below, so waves are dependency-safe.

    vecs_t/costs_t: tuples (one per parsimony partition) of uint32
    [D, S, W] / [D].  Returns (back, per-partition final edge scores).

    ``axis_name``: when run under ``shard_map`` with the word axis W
    sharded (the giant-alignment configuration), per-device costs/scores
    are word-shard partials; the ONE collective per insertion is an
    integer ``psum`` of the candidate score vector before the argmin, so
    every device picks the identical edge and applies identical topology
    updates.  ``None`` (single device) adds no collectives.
    """
    carry = _stepwise_range_body(n_tips, axis_name, vecs_t, costs_t, back,
                                 edge_rows, order, jnp.int32(3),
                                 jnp.int32(n_tips))
    vecs_t, costs_t, back, _ = carry
    return _stepwise_final_body(n_tips, axis_name, vecs_t, costs_t, back)


def _stepwise_range_body(n_tips: int, axis_name, vecs_t, costs_t, back,
                         edge_rows, order, lo, hi):
    """Insertions ``lo..hi-1`` of the greedy build.  The 3-taxon star
    initialization runs iff ``lo == 3`` (a `lax.cond`)."""
    D = back.shape[0]
    E = edge_rows.shape[0]
    co1_np, co2_np = _ring_co_tables(n_tips)
    CO1, CO2 = jnp.asarray(co1_np), jnp.asarray(co2_np)
    e_arange = jnp.arange(E, dtype=jnp.int32)

    F = 64  # queue rows processed per loop trip

    def run_bfs(vecs_t, costs_t, first_row, back):
        """Dirty-vector refresh as a compact BFS WORK QUEUE.

        Greedy trees from random data are nearly caterpillar-deep
        (~0.25·i BFS levels per insertion at tree size i, average wave
        width ~8 rows), so per-level constants dominate the whole build.
        Dense per-level recomputes pay two full [D, S, W] row-gathers per
        level, a compact-chunk consumer pays nonzero-over-D + bool scatter
        bookkeeping per chunk.  A queue removes every O(D) per-trip op:
        rows are processed from a fixed-capacity index queue in chunks of
        F, and a row's dependents are enqueued WHEN IT IS PROCESSED — any
        row later dequeued has its single dirty child already final, so
        chunk boundaries never need level alignment.  Per trip everything
        is O(F): one dynamic_slice of the queue, int gathers into the
        per-insertion child/dependent tables, one [F, S, W]
        gather+Fitch+scatter per partition, and a 2F-element compaction
        for the enqueue."""
        # per-insertion tables (back is fixed during one BFS), padded with
        # one sentinel slot so dequeued sentinel ids (D) stay inert
        c1p = jnp.concatenate([back[CO1], jnp.zeros((1,), jnp.int32)])
        c2p = jnp.concatenate([back[CO2], jnp.zeros((1,), jnp.int32)])
        live = back >= n_tips
        dep1 = jnp.where(live, CO1[back], D)
        dep2 = jnp.where(live, CO2[back], D)
        depp = jnp.concatenate(
            [jnp.stack([dep1, dep2], 1),
             jnp.full((1, 2), D, jnp.int32)])  # [D+1, 2]

        Q = D + 3 + 2 * F
        q0 = jnp.zeros((Q,), jnp.int32).at[0:3].set(
            first_row + jnp.arange(3, dtype=jnp.int32))

        def cond(s):
            return s[3] < s[4]

        def body(s):
            vecs_t, costs_t, q, head, tail = s
            pos = head + jnp.arange(F, dtype=jnp.int32)
            idx = jnp.where(pos < tail,
                            jax.lax.dynamic_slice(q, (head,), (F,)), D)
            safe = jnp.where(idx < D, idx, 0)
            c1 = c1p[safe]
            c2 = c2p[safe]
            new_vt, new_ct = [], []
            for v, c in zip(vecs_t, costs_t):
                a = v[c1]
                b = v[c2]
                land = a & b
                union = land[:, 0]
                for k in range(1, land.shape[1]):
                    union = union | land[:, k]
                newvec = land | (~union[:, None, :] & (a | b))
                inc = jnp.sum(jax.lax.population_count(~union), axis=-1)
                newc = c[c1] + c[c2] + inc.astype(c.dtype)
                new_vt.append(v.at[idx].set(newvec, mode="drop"))
                new_ct.append(c.at[idx].set(newc, mode="drop"))

            # enqueue the processed rows' dependents (both are dirty; the
            # relation is a tree, so no duplicates can occur): compact by
            # scattering each valid dep to tail + its prefix-sum slot
            deps = depp[idx].reshape(2 * F)      # sentinel-padded
            valid = deps < D
            slot = jnp.cumsum(valid.astype(jnp.int32)) - 1
            q = q.at[jnp.where(valid, tail + slot, Q)].set(deps,
                                                           mode="drop")
            # lanes at pos >= the PRE-enqueue tail were masked out, so the
            # head may only advance past rows that actually processed
            head = jnp.minimum(head + F, tail)
            tail = tail + jnp.sum(valid).astype(tail.dtype)
            return tuple(new_vt), tuple(new_ct), q, head, tail

        vecs_t, costs_t, _, _, _ = jax.lax.while_loop(
            cond, body, (vecs_t, costs_t, q0, jnp.int32(0), jnp.int32(3)))
        return vecs_t, costs_t

    # star ring ops (rows n..n+2) before the first insertion; the star
    # directions have tip children only, so this BFS runs exactly one wave
    vecs_t, costs_t = jax.lax.cond(
        lo == 3,
        lambda vc: run_bfs(vc[0], vc[1], jnp.int32(n_tips), back),
        lambda vc: vc, (vecs_t, costs_t))

    def insert(i, carry):
        vecs_t, costs_t, back, edge_rows = carry
        ne = 2 * i - 3
        base = n_tips + 3 * (i - 2)
        tip = order[i]

        u_idx = edge_rows
        v_idx = back[edge_rows]
        scores = None
        for v, c in zip(vecs_t, costs_t):
            s = _insert_scores(v, c, v[tip], u_idx, v_idx)
            scores = s if scores is None else scores + s
        if axis_name is not None:
            scores = jax.lax.psum(scores, axis_name)
        scores = jnp.where(e_arange < ne, scores, jnp.uint32(0xFFFFFFFF))
        e_star = jnp.argmin(scores)

        u = edge_rows[e_star]
        v = back[u]
        r0, r1, r2 = base, base + 1, base + 2
        back = (back.at[u].set(r0).at[r0].set(u)
                    .at[v].set(r1).at[r1].set(v)
                    .at[tip].set(r2).at[r2].set(tip))
        # chosen entry stays (now edge u--r0); two new edges appended —
        # the reference's edge-list enumeration order (stepwise.c:491-520)
        edge_rows = edge_rows.at[ne].set(r1).at[ne + 1].set(r2)

        vecs_t, costs_t = run_bfs(vecs_t, costs_t, r0, back)
        return vecs_t, costs_t, back, edge_rows

    return jax.lax.fori_loop(
        lo, hi, insert, (vecs_t, costs_t, back, edge_rows))


def _stepwise_final_body(n_tips: int, axis_name, vecs_t, costs_t, back):
    # final per-partition score at the (arbitrary) edge of row n
    u = jnp.int32(n_tips)
    v = back[u]
    finals = []
    for vec, c in zip(vecs_t, costs_t):
        a = vec[u]
        b = vec[v]
        land = a & b
        union = land[0]
        for k in range(1, land.shape[0]):
            union = union | land[k]
        s = jnp.sum(jax.lax.population_count(~union), axis=-1)
        f = s.astype(c.dtype) + c[u] + c[v]
        if axis_name is not None:
            f = jax.lax.psum(f, axis_name)
        finals.append(f)
    return back, tuple(finals)


@jax.jit
def fitch_insert_scores(vectors, costs, tipvec, u_idx, v_idx):
    """Scores of inserting a new tip on each candidate edge, batched.

    For edge (u, v) with directional subtree vectors V[u], V[v] and internal
    mutation counts C[u], C[v], splicing tip T onto the edge creates inner
    node X = fitch(V[u], T); the spliced tree's score is

        C[u] + C[v] + mut(V[u], T) + mut(X, V[v])

    (Fitch's count is rooting-invariant, so combining (V[u], T) first is
    exact.) This scores ALL candidate edges in one batched kernel — the
    reference instead re-runs a partial traversal per edge
    (stepwise.c:241-323).

    vectors: uint32 [D, S, W] directional vectors; costs: uint32 [D].
    tipvec: uint32 [S, W]. u_idx/v_idx: int32 [E].
    """
    return _insert_scores(vectors, costs, tipvec, u_idx, v_idx)


@partial(jax.jit, static_argnums=(0,))
def _stepwise_build(n_tips: int, vecs_t, costs_t, back, edge_rows, order):
    """Single-device jit of :func:`_stepwise_build_body`."""
    return _stepwise_build_body(n_tips, None, vecs_t, costs_t, back,
                                edge_rows, order)
