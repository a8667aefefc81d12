"""Randomized stepwise-addition parsimony tree construction.

Capability parity with `pll_fastparsimony_stepwise` (libpll
`src/stepwise.c:337-546`): taxa are shuffled with the bit-exact re-entrant
RNG (seed 0 = no shuffle), a 3-taxon star is grown by greedily inserting each
next taxon at the edge minimizing the Fitch parsimony score, and the final
score includes the uninformative-site constant cost.

Device-first redesign of the inner loop: instead of the reference's sequential
re-scoring of every candidate edge via partial traversals (O(n) traversals
per insertion), directional Fitch vectors persist on device across
insertions; committing an insertion recomputes only the directions whose
subtree gained the new tip (BFS waves from the splice point, executed as
one schedule-as-data call — `fitch.fitch_run_waves`), and ALL candidate
edges are scored in a single batched call (`fitch_insert_scores`).  Two
device calls per insertion per partition, total.  Supports multiple
partitions by summing their per-edge score vectors before the argmin
(reference stepwise.c:288-297).

Tie-breaking matches the reference exactly: candidate edges are enumerated
in the same order the reference maintains its edge list (the three star
edges, then the two edges created by each insertion appended at the end,
stepwise.c:491-520) and the first minimum wins — so the same seed produces
the same topology and score.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fitch
from ..tree.utree import UNode, UTree, reset_template_indices, wraptree
from ..utils.rng import shuffled_order
from .parsimony import FastParsimony


def _make_star(labels, tips) -> UNode:
    """3-taxon star; returns the center's first ring node. Tip nodes carry
    their original taxon index in ``.data`` (the packed-vector row)."""
    t = []
    for i in tips:
        node = UNode(labels[i], 0.0)
        node.data = i
        t.append(node)
    r = [UNode(None, 0.0) for _ in range(3)]
    r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
    for ri, ti in zip(r, t):
        ri.back, ti.back = ti, ri
    return r[0]




class StepwiseBuilder:
    """Grows a tree by stepwise addition over one or more FastParsimony
    partitions (all must share the same taxon set)."""

    def __init__(self, partitions: Sequence[FastParsimony],
                 labels: Sequence[str]):
        self.partitions = list(partitions)
        self.labels = list(labels)
        self.tips = partitions[0].tips
        for p in partitions:
            if p.tips != self.tips:
                raise ValueError("partitions disagree on taxon count")

    def build(self, seed: int) -> Tuple[UTree, int]:
        """Directional Fitch vectors persist across insertions in one
        device array per partition (row per directed node, tips aliasing
        their packed rows): committing an insertion recomputes only the 3
        new ring directions plus the directions whose subtree gained the
        new tip — each such direction has exactly one dirty child, so the
        recompute set orders into BFS waves from the splice point executed
        as ONE compiled call (`fitch.fitch_run_waves`); candidate edges are
        then scored in one batched call.  Per insertion: 1 update call + 1
        score call per partition, vs the reference's sequential partial
        traversal per candidate edge (stepwise.c:241-323)."""
        n = self.tips
        order = shuffled_order(n, seed)
        center = _make_star(self.labels, order[:3])
        # candidate edges in the reference's enumeration order: the three
        # star edges first, then the two edges created by each insertion
        # appended at the end (stepwise.c:491-520); first minimum wins —
        # this makes tie-breaking (and hence the resulting topology)
        # identical to the reference.
        edge_list = [center, center.next, center.next.next]

        # persistent direction rows: tips own rows 0..n-1 (their packed
        # vectors); every inner directed node gets a fresh row from n up
        n_rows = n + 3 * max(n - 2, 1)
        state = []
        for part in self.partitions:
            vecs = jnp.zeros((n_rows,) + part.vectors.shape[1:],
                             dtype=jnp.uint32)
            vecs = vecs.at[:n].set(part.vectors[:n])
            costs = jnp.zeros((n_rows,), dtype=jnp.uint32)
            state.append((vecs, costs))
        next_row = n
        for m in center.ring():
            m.data = next_row
            next_row += 1

        def row(x: UNode) -> int:
            return x.data  # taxon index for tips, direction row for inners

        def op_of(w: UNode):
            return (row(w), row(w.next.back), row(w.next.next.back))

        # fixed wave envelope: ONE compiled executor for the whole build.
        # Waves wider than P split into consecutive rows (ops within a wave
        # are independent, so any split preserves dependencies); rows are
        # grouped W per call; padding repeats ops/rows (idempotent).
        P, W = 64, 8

        def run(levels):
            nonlocal state
            rows = []
            for lv in levels:
                for j in range(0, len(lv), P):
                    chunk = lv[j:j + P]
                    rows.append(chunk + [chunk[-1]] * (P - len(chunk)))
            for i in range(0, len(rows), W):
                block = rows[i:i + W]
                block += [block[-1]] * (W - len(block))
                tab = jnp.asarray(np.asarray(block, np.int32))
                state = [fitch.fitch_run_waves(v, c, tab)
                         for (v, c) in state]

        # star directions: one wave of 3
        run([[op_of(m) for m in center.ring()]])

        for next_tip in order[3:]:
            edges = [(u, u.back) for u in edge_list]
            # pad the candidate list to a power of two (repeat the last
            # edge) so the batched scorer compiles O(log n) times total
            n_e = len(edges)
            cap_e = 1 << (n_e - 1).bit_length()
            u_rows = [row(u) for u, v in edges]
            v_rows = [row(v) for u, v in edges]
            u_rows += [u_rows[-1]] * (cap_e - n_e)
            v_rows += [v_rows[-1]] * (cap_e - n_e)
            u_idx = jnp.asarray(u_rows, jnp.int32)
            v_idx = jnp.asarray(v_rows, jnp.int32)

            total_scores = None
            for part, (vecs, costs) in zip(self.partitions, state):
                s = fitch.fitch_insert_scores(vecs, costs,
                                              part.vectors[next_tip],
                                              u_idx, v_idx)
                total_scores = (s if total_scores is None
                                else total_scores + s)

            best = int(np.argmin(np.asarray(total_scores)[:n_e]))
            u, v = edges[best]
            new_inner = self._splice(u, v, next_tip)
            ring = list(new_inner.ring())  # r0 faces u, r1 faces v, r2 tip
            for m in ring:
                m.data = next_row
                next_row += 1
            # two new candidate edges appended, matching the reference
            edge_list.append(new_inner.next)  # faces the old far endpoint
            edge_list.append(new_inner.next.next)  # faces the new tip

            # dirty BFS from the new ring: each affected direction has
            # exactly one dirty child, so BFS levels are dependency-safe
            levels = [[op_of(m) for m in ring]]
            frontier = list(ring)
            seen = {id(m) for m in ring}
            while frontier:
                nxt = []
                for c in frontier:
                    cb = c.back
                    if cb.next is None:
                        continue
                    for w in cb.ring():
                        if w is not cb and id(w) not in seen:
                            seen.add(id(w))
                            nxt.append(w)
                if nxt:
                    levels.append([op_of(w) for w in nxt])
                frontier = nxt
            run(levels)

        # finalize: score the full tree via the partitions' own buffers
        tree = self._wrap(center)
        score = self._final_score(tree)
        return tree, score

    def build_device(self, seed: int) -> Tuple[UTree, int]:
        """Fully device-resident greedy build: the whole insertion loop —
        candidate scoring, argmin, splice, dirty-vector BFS — runs inside
        ONE compiled program (`fitch._stepwise_build`); the host reads back
        only the final ``back`` topology array and the per-partition
        scores.  Replaces the per-insertion host loop of :meth:`build`
        (2 dispatches + 1 readback per insertion).  Seed/tie-break
        parity with the reference (`stepwise.c:241-323`) is identical to
        :meth:`build`: same shuffled order, same edge enumeration order,
        first minimum wins."""
        n = self.tips
        if n < 4:
            return self.build(seed)
        order = shuffled_order(n, seed)
        D = n + 3 * (n - 2)
        E = 2 * n - 3

        back0 = np.full(D, -1, np.int32)
        for k in range(3):
            back0[n + k] = order[k]
            back0[order[k]] = n + k
        edge_rows0 = np.array([n, n + 1, n + 2] + [0] * (E - 3), np.int32)

        vecs_t, costs_t = [], []
        for part in self.partitions:
            vecs = jnp.zeros((D,) + part.vectors.shape[1:], dtype=jnp.uint32)
            # through numpy: the packed vectors may be committed to an
            # accelerator while this build runs under a CPU default_device
            vecs = vecs.at[:n].set(np.asarray(part.vectors[:n]))
            vecs_t.append(vecs)
            costs_t.append(jnp.zeros((D,), dtype=jnp.uint32))

        back, finals = fitch._stepwise_build(
            n, tuple(vecs_t), tuple(costs_t), jnp.asarray(back0),
            jnp.asarray(edge_rows0), jnp.asarray(order, jnp.int32))
        back = np.asarray(back)
        score = int(sum(int(f) for f in finals)
                    + sum(p.const_cost for p in self.partitions))
        return self._reconstruct(back), score

    def build_device_sharded(self, seed: int, mesh) -> Tuple[UTree, int]:
        """Device-resident build with the Fitch *word axis* sharded over
        ``mesh`` — the stepwise configuration of the giant-alignment
        target (BASELINE.json: 10k-taxa × 1M-site alignment across ≥2
        hosts).  Each device holds its word shard of every directional
        vector plus a word-shard-partial cost array; the ONE collective
        per insertion is an integer psum of the candidate-score vector
        before the argmin (`fitch._stepwise_build_body`), so the topology
        decisions — and the resulting tree/score — are bit-identical to
        the single-device engine and the reference."""
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        n = self.tips
        if n < 4:
            return self.build(seed)
        (axis,) = mesh.axis_names
        n_dev = mesh.devices.size
        order = shuffled_order(n, seed)
        D = n + 3 * (n - 2)
        E = 2 * n - 3

        back0 = np.full(D, -1, np.int32)
        for k in range(3):
            back0[n + k] = order[k]
            back0[order[k]] = n + k
        edge_rows0 = np.array([n, n + 1, n + 2] + [0] * (E - 3), np.int32)

        vecs_t = []
        for part in self.partitions:
            v = np.asarray(part.vectors[:n])
            W = v.shape[-1]
            pad = (-W) % n_dev
            if pad:
                # extra all-ones pad words contribute zero cost (their
                # union is all-ones) and keep every shard equal-width
                v = np.concatenate(
                    [v, np.full(v.shape[:-1] + (pad,), 0xFFFFFFFF,
                                np.uint32)], axis=-1)
            full = np.zeros((D,) + v.shape[1:], np.uint32)
            full[:n] = v
            vecs_t.append(jnp.asarray(full))
        costs_t = tuple(jnp.zeros((D,), dtype=jnp.uint32)
                        for _ in self.partitions)
        vecs_t = tuple(
            jax.device_put(v, NamedSharding(mesh, P(None, None, axis)))
            for v in vecs_t)

        shard_v = P(None, None, axis)
        repl = P()
        fn = shard_map(
            lambda *a: fitch._stepwise_build_body(n, axis, *a),
            mesh=mesh,
            in_specs=(tuple(shard_v for _ in vecs_t),
                      tuple(repl for _ in costs_t), repl, repl, repl),
            out_specs=(repl, tuple(repl for _ in costs_t)),
            check_vma=False)
        back, finals = jax.jit(fn)(
            vecs_t, costs_t, jnp.asarray(back0), jnp.asarray(edge_rows0),
            jnp.asarray(order, jnp.int32))
        back = np.asarray(back)
        score = int(sum(int(f) for f in finals)
                    + sum(p.const_cost for p in self.partitions))
        return self._reconstruct(back), score

    def _reconstruct(self, back: np.ndarray) -> UTree:
        """Rebuild the UNode graph from the device ``back`` involution +
        the static ring layout (tips 0..n-1; inner rows in ring triples)."""
        n, D = self.tips, len(back)
        if not np.array_equal(back[back], np.arange(D)):
            raise RuntimeError("device stepwise returned a corrupt topology"
                               " (back[] is not an involution)")
        nodes: list = []
        for t in range(n):
            nd = UNode(self.labels[t], 0.0)
            nd.data = t
            nodes.append(nd)
        for b in range(n, D, 3):
            r = [UNode(None, 0.0) for _ in range(3)]
            r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
            nodes.extend(r)
        for d in range(D):
            nodes[d].back = nodes[back[d]]
        return self._wrap(nodes[n])

    def _splice(self, u: UNode, v: UNode, tip_index: int) -> UNode:
        """Split edge (u, v) with a new inner ring; wiring mirrors
        utree_edgesplit + utree_link (stepwise.c:215-240, 281-283):
        ring[0] faces u, ring[1] faces v (the far endpoint), ring[2] faces
        the new tip. Returns ring[0]."""
        tip = UNode(self.labels[tip_index], 0.0)
        tip.data = tip_index
        r = [UNode(None, 0.0) for _ in range(3)]
        r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
        r[0].back, u.back = u, r[0]
        r[1].back, v.back = v, r[1]
        r[2].back, tip.back = tip, r[2]
        return r[0]

    def _wrap(self, center: UNode) -> UTree:
        root = center if center.next is not None else center.back
        reset_template_indices(root, self.tips)
        return wraptree(root)

    def _final_score(self, tree: UTree) -> int:
        from ..tree import utree as ut

        trav = ut.traverse(tree.root)

        # score indices: tips use their ORIGINAL taxon index (their packed
        # vector row, kept in .data); inner nodes their canonical clv index
        def sidx(n: UNode) -> int:
            return n.data if n.is_tip else n.clv_index

        ops = [(n.clv_index, sidx(n.next.back), sidx(n.next.next.back))
               for n in trav if not n.is_tip]
        total = 0
        root = tree.root
        for part in self.partitions:
            part.update_vectors(ops)
            total += part.edge_score(sidx(root), sidx(root.back))
        return total


# "auto" runs the device build on the default backend.  First-ever
# compiles are amortized by the package's persistent compilation cache.
_AUTO_CPU_TIPS = None  # retained name: external scripts introspect it


def fastparsimony_stepwise(partitions: Sequence[FastParsimony],
                           labels: Sequence[str], seed: int,
                           engine: str = "auto",
                           mesh=None) -> Tuple[UTree, int]:
    """reference pll_fastparsimony_stepwise (stepwise.c:337-546).

    engine="device" (and the default "auto") runs the whole greedy build
    as one compiled program on the default backend;
    engine="host" keeps the insertion loop on the host with batched
    per-insertion device calls (the reference-shaped dual path, kept for
    cross-validation).  All are seed- and tie-break-exact with the
    reference.  Passing a ``mesh`` shards the Fitch word axis across its
    devices (one integer psum per insertion) — the giant-alignment
    configuration; results are bit-identical.
    """
    builder = StepwiseBuilder(partitions, labels)
    if mesh is not None:
        return builder.build_device_sharded(seed, mesh)
    if engine in ("auto", "device"):
        return builder.build_device(seed)
    if engine == "host":
        return builder.build(seed)
    raise ValueError(f"unknown stepwise engine {engine!r}")
