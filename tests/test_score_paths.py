"""The scoring entry points of engine/evaluate.py against the plain float64
reference (ops/clv.py + ops/likelihood.py), on both implementations: the
XLA level sweep and the GPU score kernel (ops/score_kernel.py), the latter
in Pallas interpret mode here.

The kernel path runs through the wrappers themselves (slab padding, the
+I fold, the partial sums): the tests only make the wrapper choose the
kernel on the CPU and build it in interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libpll_tpu.engine import evaluate as ev
from libpll_tpu.ops import score_kernel as sk
from libpll_tpu.ops import tipcodes as tc
from libpll_tpu.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                        SCALE_PER_SITE)

from score_cases import PATHS, TREES, _build, _use, budget, reference

SCALES = {"none": SCALE_NONE, "site": SCALE_PER_SITE, "rate": SCALE_PER_RATE}


def _slab(clv, tips, enc):
    if enc == "clv":
        return clv[:tips]
    masks = tc.tip_masks_from_clv(clv[:tips])
    return tc.pack_tipchars(masks) if enc == "chars" else \
        tc.pack_tipmasks(masks)


_ENC_CASES = ([("xla", e, s) for e in ("clv", "chars", "masks")
               for s in SCALES]
              + [("kernel", e, s) for e in ("clv", "chars", "masks")
                 for s in ("none", "site")])


@pytest.mark.parametrize("path,enc,scale", _ENC_CASES)
def test_score_encodings(path, enc, scale, monkeypatch):
    """Every tip encoding × scaling mode on a 40-taxon caterpillar (deep
    enough that float32 per-site scaling fires); 200 sites, so the kernel
    path pads to its block."""
    built = _use(path, monkeypatch)
    newick = TREES["caterpillar"]()
    mode = SCALES[scale]
    topo, model, _, clv, _ = _build(newick, sites=200, scale_mode=mode)
    tips = topo.schedule.tips
    got = float(jax.jit(ev.make_score(topo, 4, 4, tip_encoding=enc))(
        model, _slab(clv, tips, enc)))
    want = reference(newick, model, clv, scale_mode=mode)
    assert abs(got - want) <= budget(want), (got, want)
    assert len(built) == (path == "kernel")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("states", [4, 7, 20])
def test_score_states_trees(path, tree, states, monkeypatch):
    """DNA, an odd 7-state alphabet and protein on caterpillar, random and
    160-taxon trees, bitmask tips, per-site scaling."""
    _use(path, monkeypatch)
    newick = TREES[tree]()
    topo, model, _, clv, _ = _build(newick, sites=128, states=states,
                                    seed=states)
    tips = topo.schedule.tips
    got = float(ev.make_score(topo, 4, states, tip_encoding="masks")(
        model, _slab(clv, tips, "masks")))
    want = reference(newick, model, clv, seed=states)
    assert abs(got - want) <= budget(want), (got, want)


@pytest.mark.parametrize("path,scale", [("xla", "site"), ("xla", "rate"),
                                        ("kernel", "site")])
def test_score_pinv(path, scale, monkeypatch):
    """+I: 32 constant columns marked invariant, p-inv 0.2 on every
    category, against the reference's invariant-site mix."""
    _use(path, monkeypatch)
    newick = TREES["random"]()
    mode = SCALES[scale]
    topo, model, _, clv, _ = _build(newick, sites=160, scale_mode=mode)
    tips = topo.schedule.tips
    clv = np.asarray(clv).copy()
    clv[:tips, :, :, :32] = 0.0
    clv[:tips, :, 2, :32] = 1.0
    invariant = np.full(160, -1, np.int32)
    invariant[:32] = 2
    model = dict(model, prop_invar=jnp.full((1,), 0.2, jnp.float32),
                 prop_invar_pc=jnp.full((4,), 0.2, jnp.float32),
                 invariant=jnp.asarray(invariant))
    got = float(ev.make_score(topo, 4, 4, use_pinv=True)(
        model, jnp.asarray(clv[:tips])))
    want = reference(newick, model, clv, scale_mode=mode, pinv=0.2,
                     invariant=invariant)
    assert abs(got - want) <= budget(want), (got, want)


@pytest.mark.parametrize("states", [4, 20])
def test_unbounded_chunked_equals_unchunked(states, monkeypatch):
    """make_score_unbounded over several site chunks (plus gap padding)
    equals the one-shot score, in float64."""
    monkeypatch.setattr(ev, "_CHUNK_BYTES", 1 << 16)
    newick = TREES["random"]()
    topo, model, _, clv, _ = _build(newick, sites=600, states=states,
                                    dtype=jnp.float64)
    tips = topo.schedule.tips
    chunk = ev.score_chunk_sites(topo, 4, states, 600, itemsize=8)
    assert 600 // chunk >= 2
    masks = tc.tip_masks_from_clv(clv[:tips])
    got = float(ev.make_score_unbounded(topo, 4, states, masks)(model))
    want = float(ev.make_score(topo, 4, states)(model, clv[:tips]))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("scale", list(SCALES))
def test_forward_fused_matches_forward(scale):
    """make_forward_fused is make_forward from tip CLVs alone: same logL,
    per-site vector, inner CLVs and scalers."""
    mode = SCALES[scale]
    topo, model, _, clv, scalers = _build(TREES["caterpillar"](), sites=96,
                                          scale_mode=mode,
                                          dtype=jnp.float64)
    tips = topo.schedule.tips
    want = ev._forward_sweep(topo)(model, clv, scalers)
    logl, persite, inner, sc = ev.make_forward_fused(topo, 4, 4)(
        model, clv[:tips])
    np.testing.assert_allclose(float(logl), float(want[0]), rtol=1e-13)
    np.testing.assert_allclose(persite, want[1], rtol=1e-13)
    np.testing.assert_allclose(inner, want[2][tips:], rtol=1e-13)
    np.testing.assert_array_equal(sc, want[3])


def test_train_step_fused_interior_optimum():
    """make_train_step_fused matches make_train_step and lands on an
    interior Newton optimum on data simulated down the tree."""
    from __graft_entry__ import _build_flagship

    topo, model, clv, scalers = _build_flagship(tips=24, sites=512,
                                                dtype=jnp.float64,
                                                simulate=True)
    tips = topo.schedule.tips
    want, t_want, _, _ = ev.make_train_step(topo)(model, clv, scalers)
    logl, t_star = ev.make_train_step_fused(topo, 4, 4)(model, clv[:tips])
    np.testing.assert_allclose(float(logl), float(want), rtol=1e-13)
    np.testing.assert_allclose(float(t_star), float(t_want), rtol=1e-12)
    assert 1e-8 < float(t_star) < 100.0


@pytest.mark.parametrize("tree,max_slots", [("caterpillar", 2),
                                            ("random", 6),
                                            ("random160", 10)])
def test_slot_plan(tree, max_slots):
    """The kernel's host schedule: every inner CLV the edge needs is
    computed once, children are live in their slots when read, and the
    slot count stays within the Sethi–Ullman bound."""
    topo, _, _, _, _ = _build(TREES[tree](), sites=128)
    plan = sk.plan_slots(topo.schedule, topo.parent_clv, topo.child_clv,
                         topo.edge_matrix)
    tips = topo.schedule.tips
    assert plan.n_ops == topo.schedule.n_inner == tips - 2
    assert plan.n_slots <= max_slots
    assert plan.table.shape[0] & (plan.table.shape[0] - 1) == 0
    live = set()
    for c1, _, c2, _, dst, _ in plan.table[1:plan.n_ops + 1, :6]:
        for c in (c1, c2):
            if c >= tips:
                assert c - tips in live
                live.discard(c - tips)
        live.add(int(dst))
    n_ops, pref, cref, edge_m = plan.table[0, :4]
    assert pref - tips in live and edge_m == topo.edge_matrix
    assert cref < tips or cref - tips in live


@pytest.mark.parametrize("scale,dtype,states,want", [
    (SCALE_PER_SITE, np.float32, 4, True), (SCALE_NONE, np.float32, 4, True),
    (SCALE_PER_RATE, np.float32, 4, False),
    (SCALE_PER_SITE, np.float64, 4, False),
    (SCALE_PER_SITE, np.float32, 20, False)])
def test_kernel_scope(scale, dtype, states, want):
    """The wrappers' choice: the kernel for float32 DNA with per-site or
    no scaling, XLA for the rest."""
    assert sk.kernel_supported(scale, dtype, 4, states) is want


@pytest.mark.parametrize("sites,block", [(262144, 256), (131072, 256),
                                         (65536, 128), (16384, 32),
                                         (200, 32)])
def test_kernel_block_choice(sites, block):
    assert sk.default_block_sites(sites) == block


def _lowered(fn, args, platform):
    """StableHLO text of ``fn`` lowered for ``platform`` (no device of
    that platform needed)."""
    exp = jax.export.export(
        jax.jit(fn), platforms=[platform],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    return exp.mlir_module()


@pytest.mark.parametrize("wrapper,enc", [("score", "clv"),
                                         ("score", "chars"),
                                         ("score", "masks"),
                                         ("unbounded", "chars")])
def test_kernel_only_in_cuda_lowering(wrapper, enc):
    """The wrappers choose by the platform they are lowered for: a CUDA
    lowering holds the Triton kernel (its whole Triton IR is built here),
    a CPU lowering only XLA, whatever JAX's default backend is."""
    topo, model, _, clv, _ = _build(TREES["random"](), sites=256)
    tips = topo.schedule.tips
    if wrapper == "score":
        fn = ev.make_score(topo, 4, 4, tip_encoding=enc)
        args = (model, _slab(clv, tips, enc))
    else:
        fn = ev.make_score_unbounded(topo, 4, 4,
                                     tc.tip_masks_from_clv(clv[:tips]))
        args = (model,)
    triton = "__gpu$xla.gpu.triton"
    assert triton in _lowered(fn, args, "cuda")
    assert triton not in _lowered(fn, args, "cpu")


def test_kernel_out_of_scope_lowers_xla_for_cuda():
    """Outside the kernel's scope (float64) a CUDA lowering is XLA."""
    topo, model, _, clv, _ = _build(TREES["random"](), sites=128,
                                    dtype=jnp.float64)
    fn = ev.make_score(topo, 4, 4)
    text = _lowered(fn, (model, clv[:topo.schedule.tips]), "cuda")
    assert "__gpu$xla.gpu.triton" not in text


@pytest.mark.parametrize("states,enc", [(4, "chars"), (20, "masks")])
def test_tip_codes_roundtrip(states, enc):
    """Packing then decoding returns the 0/1 tip CLVs, ambiguity codes
    and all; pad columns decode as gaps."""
    rng = np.random.default_rng(states)
    masks = rng.integers(1, 1 << states, (11, 70)).astype(np.uint32)
    slab = tc.pack_tipchars(masks) if enc == "chars" else \
        tc.pack_tipmasks(masks)
    clv = tc.decode_tips(slab, enc, 11, 3, states, jnp.float32)
    bits = (masks[:, None, :] >> np.arange(states)[None, :, None]) & 1
    np.testing.assert_array_equal(np.asarray(clv[:, 1]), bits)
    np.testing.assert_array_equal(tc.tip_masks_from_clv(clv), masks)


def test_gap_code_decodes_to_ones():
    slab = tc.pack_tipchars(np.full((3, 5), tc.gap_code(4), np.uint32))
    clv = tc.decode_tips(slab, "chars", 3, 2, 4, jnp.float32)
    assert bool(jnp.all(clv == 1.0))
