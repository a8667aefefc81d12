#!/usr/bin/env python3
"""Smoke test on the GPU: the engine's user entry points, each checked
against the plain float64 reference (ops/clv.py + ops/likelihood.py +
ops/derivatives.py) run on the CPU device of the same process.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the site-sharded paths only

One card:
  device     card, JAX version, matmul precision, float64 eigh on the card;
  infer      infer_tree at 1024 taxa x 16 384 sites, GTR+G4, simulated
             data, in float64 and float32, re-scored on the CPU;
  partition  the step-by-step Partition API (P-matrices, partials, edge
             logL, sumtable and derivatives) on the card vs the CPU;
  score      make_score (64 x 262 144, nibble tips), make_score_unbounded
             (1024 x 16 384), make_score (64 x 16 384 protein, bitmasks),
             make_forward_fused and make_train_step_fused (64 x 16 384),
             each against the reference, with ms per evaluation.
Four cards (--four): infer_tree on a 4-device sites mesh vs the reference,
the sharded stepwise build, make_score_sharded and
make_score_unbounded_sharded (64 x 262 144); then what each card holds
(card 0 no more than the others); then the one-card runs each is
compared with.

Exits non-zero, before printing any result, when JAX's default backend is
not a GPU or when any phase fails.  The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the f32 budget against the f64 path (tests/test_accuracy.py)
F32_REL, F32_ABS = 2e-6, 5e-3
INFER_TIPS, INFER_SITES = 1024, 16384
INFER_ROUNDS = 1  # SPR rounds: the search is cut in rounds, never in width
FLAG_TIPS, FLAG_SITES = 64, 262144
MID_SITES = 16384
SEED = 11


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cards():
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def ms_per_eval(f, *args):
    """Median ms per call ending in block_until_ready, after warm-up."""
    from libpll_tpu.utils.profiling import time_jitted

    return time_jitted(f, *args) * 1e3


def check_kernel(name, f, *args):
    """Check that the compiled ``f`` runs the GPU score kernel."""
    text = f.lower(*args).as_text()
    check("__gpu$xla.gpu.triton" in text, f"{name} did not run the kernel")


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling while open."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0

    def _listen(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self._listen)


# ---------------------------------------------------------------------------
# data and the float64 reference
# ---------------------------------------------------------------------------
class Case:
    """A random tree, a random GTR+Γ4 model in float32 and tip bitmasks
    (random states, or evolved down the tree with ``simulate``)."""

    def __init__(self, tips, sites, states=4, seed=SEED, simulate=False):
        import jax.numpy as jnp
        import numpy as np

        from libpll_tpu.engine.evaluate import topology_from_tree
        from libpll_tpu.models.gamma import compute_gamma_cats
        from libpll_tpu.models.gtr import eigen_decompose
        from libpll_tpu.tree import utree as ut
        from libpll_tpu.utils.simulate import (evolve_down_tree,
                                               random_tree_newick)

        rng = np.random.default_rng(seed)
        self.tree = ut.parse_newick_string(random_tree_newick(tips, rng))
        self.topo, branches = topology_from_tree(self.tree, sites)
        self.params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
        freqs = rng.uniform(0.1, 1.0, states)
        self.freqs = freqs / freqs.sum()
        self.rates = np.asarray(compute_gamma_cats(1.0, 4))
        w, left, right = eigen_decompose(self.params, self.freqs)
        f32 = jnp.float32
        self.model = {
            "branch_lengths": jnp.asarray(branches, f32),
            "rates": jnp.asarray(self.rates, f32),
            "prop_invar": jnp.zeros((1,), f32),
            "params_indices": jnp.zeros(4, jnp.int32),
            "eigenvals": jnp.asarray(w[None], f32),
            "left": jnp.asarray(left[None], f32),
            "right": jnp.asarray(right[None], f32),
            "freqs_pc": jnp.asarray(np.broadcast_to(self.freqs, (4, states)),
                                    f32),
            "prop_invar_pc": jnp.zeros((4,), f32),
            "rate_weights": jnp.full((4,), 0.25, f32),
            "pattern_weights": jnp.ones((sites,), f32),
            "invariant": jnp.full((sites,), -1, jnp.int32),
        }
        if simulate:
            st = evolve_down_tree(self.tree, sites, w, left, right,
                                  self.freqs, rng)
        else:
            st = rng.integers(0, states, (tips, sites))
        self.masks = (np.uint32(1) << st.astype(np.uint32))
        self.states = states

    def tip_clv(self, dtype):
        """Host tip CLVs [tips, 4, S, L] (placed by whoever uses them)."""
        import numpy as np

        from libpll_tpu.engine.reference import tip_clv_from_masks

        return np.asarray(tip_clv_from_masks(self.masks, 4, self.states),
                          dtype)

    def reference(self, branch_lengths=None):
        import numpy as np

        from libpll_tpu.engine.reference import (reference_loglikelihood,
                                                 tip_clv_from_masks)

        if branch_lengths is not None:
            self._set_lengths(np.asarray(branch_lengths, np.float64))
        return reference_loglikelihood(
            self.tree, tip_clv_from_masks(self.masks, 4, self.states),
            frequencies=self.freqs, subst_params=self.params,
            rates=self.rates, pattern_weights=np.ones(self.masks.shape[1]))

    def _set_lengths(self, lengths):
        """Write traversal-order branch lengths back onto the tree."""
        from libpll_tpu.engine.reference import edge_node
        from libpll_tpu.tree import utree as ut

        trav = ut.traverse(edge_node(self.tree))
        skip = trav[-1].back
        k = 0
        for node in trav:
            if node is not skip:
                node.length = node.back.length = float(lengths[k])
                k += 1


def within_f32_budget(name, got, want):
    delta = abs(got - want)
    budget = F32_REL * abs(want) + F32_ABS
    print(f"  {name}: logL {got:.4f}  f64 reference {want:.4f}  "
          f"|d| {delta:.4g}  budget {budget:.4g}", flush=True)
    check(delta <= budget, f"{name}: |d| {delta} > budget {budget}")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------
def phase_device(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libpll_tpu.models.gtr import eigen_decompose, eigen_decompose_jax

    print(f"  cards: {cards()}")
    print(f"  jax {jax.__version__}, devices {jax.devices()}, "
          f"default matmul precision "
          f"{jax.config.jax_default_matmul_precision}")
    rng = np.random.default_rng(SEED)
    params, freqs = rng.uniform(0.5, 2.0, 190), rng.uniform(0.1, 1.0, 20)
    freqs /= freqs.sum()
    w, left, _ = jax.jit(eigen_decompose_jax)(jnp.asarray(params),
                                               jnp.asarray(freqs))
    check(w.dtype == jnp.float64 and w.devices() == {jax.devices()[0]},
          "eigh did not run in float64 on the card")
    w_ref, left_ref, _ = eigen_decompose(params, freqs)
    err = float(np.max(np.abs(np.asarray(w) - w_ref)))
    print(f"  float64 eigh (20 states) on the card: max |d eigenvalue| "
          f"{err:.3g}")
    check(err < 1e-10, "float64 eigh on the card disagrees with numpy")


def run_infer(data, dtype, mesh=None):
    import numpy as np

    from libpll_tpu.search.infer import infer_tree
    from libpll_tpu.utils.simulate import ALPHA

    with CompileClock() as clock:
        t0 = time.perf_counter()
        res = infer_tree(data, alpha=ALPHA, seed=42, dtype=dtype,
                         min_delta=1e-2, spr_batch=128,
                         max_rounds=INFER_ROUNDS, mesh=mesh)
        total = time.perf_counter() - t0
    traj = res.trajectory
    print(f"  time {total:.1f} s (compile {clock.seconds:.1f} s, "
          f"{100 * clock.seconds / total:.0f}%), rounds {res.rounds}, "
          f"logL {traj[0]:.3f} -> {res.logl:.3f}")
    print("  phases (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in res.timings.items()))
    check(all(b >= a for a, b in zip(traj, traj[1:])),
          f"logL trajectory decreased: {traj}")
    check(np.isfinite(res.logl), "non-finite logL")
    return res


def phase_infer(ctx):
    import jax.numpy as jnp

    from libpll_tpu.engine.reference import rescore_alignment
    from libpll_tpu.tree import utree as ut
    from libpll_tpu.tree.compare import rf_distance
    from libpll_tpu.utils.simulate import ALPHA, simulate_dna

    data, truth = simulate_dna(INFER_TIPS, INFER_SITES, seed=SEED)
    truth = ut.parse_newick_string(truth)
    for dtype in (jnp.float64, jnp.float32):
        name = jnp.dtype(dtype).name
        print(f"  infer_tree {INFER_TIPS} x {INFER_SITES} {name}:")
        res = run_infer(data, dtype)
        rf = rf_distance(res.tree, truth)
        ref = rescore_alignment(res.tree, data, alpha=ALPHA)
        delta = abs(res.logl - ref)
        tol = (1e-6 * abs(ref) if dtype == jnp.float64
               else F32_REL * abs(ref) + F32_ABS)
        print(f"  RF to the generating tree {rf}/{2 * (INFER_TIPS - 3)}; "
              f"f64 CPU re-score {ref:.4f}, |d| {delta:.4g} (limit "
              f"{tol:.4g})", flush=True)
        check(delta <= tol, f"{name} infer logL off the re-score by {delta}")


def _partition_calls(device, data, newick):
    import jax
    import jax.numpy as jnp

    import libpll_tpu as pll
    from libpll_tpu.engine.reference import edge_node
    from libpll_tpu.io import maps
    from libpll_tpu.tree import utree as ut
    from libpll_tpu.utils.simulate import ALPHA, FREQS, SUBST_PARAMS

    tree = ut.parse_newick_string(newick)
    tips, sites = len(data), len(next(iter(data.values())))
    with jax.default_device(device):
        part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4,
                             tips - 2, dtype=jnp.float64)
        for node in ut.query_tipnodes(tree):
            part.set_tip_states(node.clv_index, maps.pll_map_nt,
                                data[node.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST_PARAMS)
        part.set_category_rates(pll.compute_gamma_cats(ALPHA, 4))
        root = edge_node(tree)
        ops, blens, midx = ut.create_operations(ut.traverse(root))
        part.update_prob_matrices([0] * 4, midx, blens)
        part.update_partials(ops)
        check(part.clv.devices() == {device}, "partition left its device")
        logl = part.compute_edge_loglikelihood(
            root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [0] * 4)
        st = part.update_sumtable(root.clv_index, root.back.clv_index,
                                  root.scaler_index, root.back.scaler_index,
                                  [0] * 4)
        d1, d2 = part.compute_likelihood_derivatives(
            root.scaler_index, root.back.scaler_index, root.length, [0] * 4,
            st)
    return logl, d1, d2


def phase_partition(ctx):
    import jax

    from libpll_tpu.utils.simulate import simulate_dna

    data, truth = simulate_dna(64, 4096, seed=SEED + 1)
    gpu = _partition_calls(jax.devices()[0], data, truth)
    cpu = _partition_calls(jax.devices("cpu")[0], data, truth)
    for name, a, b in zip(("edge logL", "d1", "d2"), gpu, cpu):
        print(f"  {name}: card {a:.12g}  cpu {b:.12g}")
        check(abs(a - b) <= 1e-10 * max(abs(b), 1.0),
              f"Partition {name} differs: {a} vs {b}")


def phase_score(ctx):
    import jax
    import numpy as np

    from libpll_tpu.engine import evaluate as ev
    from libpll_tpu.ops import tipcodes as tc

    card = cards().splitlines()[0]

    def report(name, f, *args):
        got = float(f(*args))
        ms = ms_per_eval(f, *args)
        print(f"  {name}: {ms:.3f} ms/eval ({card})", flush=True)
        return got

    flag = Case(FLAG_TIPS, FLAG_SITES)
    score = jax.jit(ev.make_score(flag.topo, 4, 4, tip_encoding="chars"))
    check_kernel("make_score", score, flag.model,
                 tc.pack_tipchars(flag.masks))
    got = report(f"make_score {FLAG_TIPS} x {FLAG_SITES} chars", score,
                 flag.model, tc.pack_tipchars(flag.masks))
    within_f32_budget("make_score", got, flag.reference())
    del flag

    big = Case(INFER_TIPS, MID_SITES)
    score = jax.jit(ev.make_score_unbounded(big.topo, 4, 4, big.masks))
    check_kernel("make_score_unbounded", score, big.model)
    got = report(f"make_score_unbounded {INFER_TIPS} x {MID_SITES}", score,
                 big.model)
    within_f32_budget("make_score_unbounded", got, big.reference())
    del big

    aa = Case(FLAG_TIPS, MID_SITES, states=20)
    score = jax.jit(ev.make_score(aa.topo, 4, 20, tip_encoding="masks"))
    got = report(f"make_score {FLAG_TIPS} x {MID_SITES} protein masks",
                 score, aa.model, tc.pack_tipmasks(aa.masks))
    within_f32_budget("make_score protein", got, aa.reference())
    del aa

    mid = Case(FLAG_TIPS, MID_SITES, simulate=True)
    tip_clv = jax.device_put(mid.tip_clv(np.float32))
    fwd = jax.jit(ev.make_forward_fused(mid.topo, 4, 4))
    got = report(f"make_forward_fused {FLAG_TIPS} x {MID_SITES}",
                 lambda m, t: fwd(m, t)[0], mid.model, tip_clv)
    within_f32_budget("make_forward_fused", got, mid.reference())
    step = jax.jit(ev.make_train_step_fused(mid.topo, 4, 4))
    logl, t_star = step(mid.model, tip_clv)
    ms = ms_per_eval(step, mid.model, tip_clv)
    t_star = float(t_star)
    print(f"  make_train_step_fused {FLAG_TIPS} x {MID_SITES}: {ms:.3f} ms/"
          f"step ({card}); t* {t_star:.6f}")
    within_f32_budget("make_train_step_fused", float(logl), mid.reference())
    check(1e-8 < t_star < 100.0, f"Newton collapsed onto a clamp: {t_star}")
    lengths = mid.model["branch_lengths"].at[-1].set(t_star)
    opt = float(step(dict(mid.model, branch_lengths=lengths), tip_clv)[0])
    want = mid.reference(lengths)
    print(f"  logL at t*: {opt:.4f} (from {float(logl):.4f})")
    within_f32_budget("make_train_step_fused at t*", opt, want)
    check(opt >= float(logl) - F32_ABS, "Newton made logL worse")


# ---------------------------------------------------------------------------
# four-card phases: the sharded runs first, so that what each card holds
# afterwards is theirs alone; then the one-card runs they are compared with
# ---------------------------------------------------------------------------
def _placement(x, devices):
    """Check that ``x`` is split over all ``devices``, one shard each."""
    shards = {s.device for s in x.addressable_shards}
    check(shards == set(devices),
          f"array on {sorted(d.id for d in shards)}, not on every card")


def phase_four_sharded(ctx):
    import jax
    import jax.numpy as jnp

    from libpll_tpu.engine import evaluate as ev
    from libpll_tpu.engine.reference import rescore_alignment
    from libpll_tpu.parallel.mesh import (make_sites_mesh, replicated,
                                          sharding_for_rank)
    from libpll_tpu.search.stepwise import fastparsimony_stepwise
    from libpll_tpu.utils.simulate import ALPHA, simulate_dna

    devs = ctx["devices"]
    mesh = make_sites_mesh(devs)
    data, _ = simulate_dna(INFER_TIPS, INFER_SITES, seed=SEED)
    ctx["infer_data"] = data
    print(f"  infer_tree {INFER_TIPS} x {INFER_SITES} float64, "
          f"{len(devs)}-card sites mesh:")
    res = run_infer(data, jnp.float64, mesh=mesh)
    _placement(res.partition.clv, devs)
    ref = rescore_alignment(res.tree, data, alpha=ALPHA)
    delta = abs(res.logl - ref)
    print(f"  f64 CPU re-score {ref:.4f}, |d| {delta:.4g} (limit "
          f"{1e-6 * abs(ref):.4g})", flush=True)
    check(delta <= 1e-6 * abs(ref), f"sharded infer off by {delta}")
    ctx["infer"] = res

    labels, pars = _parsimony(data)
    ctx["stepwise"] = fastparsimony_stepwise([pars], labels, 42, mesh=mesh)
    print(f"  stepwise parsimony on {len(devs)} cards: score "
          f"{ctx['stepwise'][1]}")

    flag = Case(FLAG_TIPS, FLAG_SITES)
    ctx["flag"] = flag
    tip_clv = jax.device_put(flag.tip_clv("float32"),
                             sharding_for_rank(mesh, 4))
    _placement(tip_clv, devs)
    model = {k: jax.device_put(
        v, sharding_for_rank(mesh, 1)
        if k in ("pattern_weights", "invariant") else replicated(mesh))
        for k, v in flag.model.items()}
    _placement(model["pattern_weights"], devs)
    sharded = jax.jit(ev.make_score_sharded(flag.topo, 4, 4, mesh))
    check_kernel("make_score_sharded", sharded, model, tip_clv)
    got = float(sharded(model, tip_clv))
    ms = ms_per_eval(sharded, model, tip_clv)
    sharded_u = jax.jit(ev.make_score_unbounded_sharded(
        flag.topo, 4, 4, flag.masks, mesh))
    check_kernel("make_score_unbounded_sharded", sharded_u, model)
    got_u = float(sharded_u(model))
    ms_u = ms_per_eval(sharded_u, model)
    print(f"  make_score_sharded {FLAG_TIPS} x {FLAG_SITES}: {got:.4f}, "
          f"{ms:.3f} ms/eval")
    print(f"  make_score_unbounded_sharded: {got_u:.4f}, {ms_u:.3f} ms/eval")
    ctx["scores"] = got, got_u
    ctx["held"] = (res, tip_clv, model)


def _card_bytes(devices):
    """{device: (bytes in use, peak bytes, bytes of live arrays)}; the
    allocator's numbers are None where the platform keeps none."""
    import jax

    live = {d: 0 for d in devices}
    for x in jax.live_arrays():
        for s in x.addressable_shards:
            if s.device in live:
                live[s.device] += s.data.nbytes
    out = {}
    for d in devices:
        stats = d.memory_stats() or {}
        out[d] = (stats.get("bytes_in_use"), stats.get("peak_bytes_in_use"),
                  live[d])
    return out


def phase_four_memory(ctx):
    """What each card holds after the sharded runs alone: card 0 must
    hold no more than the others, within a small margin."""
    devs = ctx["devices"]
    held = _card_bytes(devs)
    gib = 2.0 ** 30
    for d, row in held.items():
        print(f"  card {d.id}: " + ", ".join(
            f"{name} {'n/a' if v is None else f'{v / gib:.3f} GiB'}"
            for name, v in zip(("in use", "peak", "live arrays"), row)))
    for k, name in ((0, "in use"), (2, "live arrays")):
        first = held[devs[0]][k]
        rest = [held[d][k] for d in devs[1:]]
        if first is None:
            continue
        limit = 1.1 * max(rest) + (64 << 20)
        check(first <= limit, f"card 0 holds {first} bytes {name}, the "
              f"others at most {max(rest)}")
    del ctx["held"]


def phase_four_compare(ctx):
    import jax
    import jax.numpy as jnp

    from libpll_tpu.engine import evaluate as ev
    from libpll_tpu.search.stepwise import fastparsimony_stepwise
    from libpll_tpu.tree import utree as ut
    from libpll_tpu.tree.compare import rf_distance
    from libpll_tpu.utils.simulate import simulate_dna

    data = ctx["infer_data"]
    res = ctx["infer"]
    _, truth = simulate_dna(INFER_TIPS, INFER_SITES, seed=SEED)
    print(f"  infer_tree {INFER_TIPS} x {INFER_SITES} float64, one card:")
    one = run_infer(data, jnp.float64)
    print(f"  mesh logL {res.logl:.4f}, one card {one.logl:.4f}; RF one "
          f"card vs mesh {rf_distance(one.tree, res.tree)}, mesh vs "
          f"generating tree "
          f"{rf_distance(res.tree, ut.parse_newick_string(truth))}")

    labels, pars = _parsimony(data)
    tree1, score1 = fastparsimony_stepwise([pars], labels, 42)
    tree4, score4 = ctx["stepwise"]
    rf = rf_distance(tree1, tree4)
    print(f"  stepwise parsimony: one card {score1}, four cards {score4}, "
          f"RF {rf}")
    check(score1 == score4 and rf == 0, "sharded stepwise differs")

    flag = ctx["flag"]
    one = float(jax.jit(ev.make_score(flag.topo, 4, 4))(
        flag.model, flag.tip_clv("float32")))
    one_u = float(jax.jit(ev.make_score_unbounded(
        flag.topo, 4, 4, flag.masks))(flag.model))
    got, got_u = ctx["scores"]
    print(f"  make_score_sharded {got:.4f} vs one card {one:.4f}; "
          f"make_score_unbounded_sharded {got_u:.4f} vs one card "
          f"{one_u:.4f}")
    check(abs(got - one) <= 1e-5 * abs(one), "make_score_sharded differs")
    check(abs(got_u - one_u) <= 1e-5 * abs(one_u),
          "make_score_unbounded_sharded differs")


def _parsimony(data):
    from libpll_tpu.io import maps
    from libpll_tpu.io.compress import compress_site_patterns
    from libpll_tpu.search.parsimony import FastParsimony

    labels = list(data)
    seqs, weights = compress_site_patterns([data[k] for k in labels],
                                           maps.pll_map_nt)
    return labels, FastParsimony.from_sequences(
        seqs, maps.pll_map_nt, states=4, pattern_weights=weights)


def main(argv):
    four = "--four" in argv
    if not os.path.isdir(os.path.join(HERE, "libpll_tpu")):
        sys.exit("chip_smoke: the libpll_tpu package is not beside this "
                 "script")
    sys.path.insert(0, HERE)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX's default backend is {backend!r}; this "
                 f"test needs a GPU")
    import libpll_tpu  # noqa: F401  (x64, matmul precision, compile cache)

    ctx = {}
    if four:
        devs = jax.devices()
        check(len(devs) >= 4, f"--four needs four cards, found {len(devs)}")
        ctx["devices"] = devs[:4]
        phases = [("device", phase_device),
                  ("four-sharded", phase_four_sharded),
                  ("four-memory", phase_four_memory),
                  ("four-compare", phase_four_compare)]
    else:
        phases = [("device", phase_device), ("infer", phase_infer),
                  ("partition", phase_partition), ("score", phase_score)]
    for name, phase in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        phase(ctx)
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = jax.devices()[0]
    print(cards().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
