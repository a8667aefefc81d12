"""Golden outputs × scoring paths: the reference's committed golden
outputs pin the scoring wrappers directly, on both implementations (the
XLA level sweep and the GPU score kernel, the latter in Pallas interpret
mode here), not just the float64 path of the sibling golden modules.

The reference's testing discipline runs every kernel implementation
against the same golden file (`test/runtest.py:43-52`,
`test/src/common.c:22-56`: {generic, SSE, AVX, AVX2} × {tip-CLV,
pattern-tip}).  Here the two in-kernel edge-score entry points are re-run
on the 0001x lkcalc programs — make_score with tip CLVs and
make_score_unbounded with pattern tips — and asserted against the golden
inner-inner logL at the float32 budget (|Δ| ≤ 2e-6·|logL| + small abs).
"""

import numpy as np
import pytest

# skips this module with test_golden_suite's when the golden outputs are
# not present
from test_golden_suite import (AA_SEQS, ODD7_FREQS, ODD7_MAP, ODD7_SEQS,
                               ODD7_SUBST, _golden, _grab_all)

import jax.numpy as jnp

from libpll_tpu.engine.evaluate import (EvalTopology, make_score,
                                        make_score_unbounded)
from libpll_tpu.engine.reference import tip_clv_from_masks
from libpll_tpu.io import maps
from libpll_tpu.models import aa_tables
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.models.gtr import eigen_decompose
from libpll_tpu.ops.sweep import build_level_schedule
from libpll_tpu.utils.constants import SCALE_PER_SITE

from score_cases import PATHS, _use

DNA_SEQS = ["WAC-CTA-ATCT", "CCC-TTA-ATGT", "A-C-TAG-CTCT",
            "CTCTTAA-A-CG", "CAC-TCA-A-TG"]

# the unrooted half of the 0001x op programs: the inner-inner evaluation
# edge is (6, 7) over matrix 0
#   5 <- (0 m1, 1 m1); 6 <- (5 m0, 2 m1); 7 <- (3 m1, 4 m1)
OPS = [
    (5, 0, 0, 1, -1, 1, 1, -1),
    (6, 1, 5, 0, 0, 2, 1, -1),
    (7, 2, 3, 1, -1, 4, 1, -1),
]
BRANCHES = [0.1, 0.2, 1, 1]
CATS, ALPHA = 4, 0.5

_DNA = dict(states=4, sites=12, seqs=DNA_SEQS, charmap=maps.pll_map_nt,
            freqs=[0.3, 0.4, 0.1, 0.2], subst=[1, 2.5, 1, 1, 2.5, 1])
_AA = dict(states=20, sites=15, seqs=AA_SEQS, charmap=maps.pll_map_aa,
           freqs=aa_tables.AA_FREQS_DAYHOFF,
           subst=aa_tables.AA_RATES_DAYHOFF)
_ODD7 = dict(states=7, sites=12, seqs=ODD7_SEQS, charmap=ODD7_MAP,
             freqs=ODD7_FREQS, subst=ODD7_SUBST)

_PROGRAMS = pytest.mark.parametrize("cfg,golden_name", [
    (_DNA, "00010_NMDU_lkcalc.out"),
    (_AA, "00011_NMAU_lkcalc.out"),
    (_ODD7, "00012_NMOU_lkcalc.out"),
], ids=["dna", "protein", "odd7"])


def _logl_tol(want):
    return 2e-6 * abs(want) + 2e-3


def _want(golden_name):
    golden = _golden(golden_name)
    return float(_grab_all(r"inner-inner logL: (-?\d+\.\d+)", golden)[0])


def _program(states, sites, seqs, charmap, freqs, subst):
    """(topo, model, tip masks [tips, sites]) of one 5-taxon program."""
    schedule = build_level_schedule(OPS, 5)
    topo = EvalTopology(
        schedule=schedule, matrix_indices=np.arange(4, dtype=np.int32),
        n_pmatrices=4, parent_clv=schedule.clv_map[6],
        child_clv=schedule.clv_map[7], edge_matrix=0, sites=sites,
        scale_mode=SCALE_PER_SITE)
    w, left, right = eigen_decompose(np.asarray(subst, float),
                                     np.asarray(freqs, float))
    dt = jnp.float32
    model = {
        "branch_lengths": jnp.asarray(BRANCHES, dt),
        "rates": jnp.asarray(compute_gamma_cats(ALPHA, CATS), dt),
        "prop_invar": jnp.zeros((1,), dt),
        "params_indices": jnp.zeros(CATS, np.int32),
        "eigenvals": jnp.asarray(w[None], dt),
        "left": jnp.asarray(left[None], dt),
        "right": jnp.asarray(right[None], dt),
        "freqs_pc": jnp.asarray(np.broadcast_to(freqs, (CATS, states)), dt),
        "prop_invar_pc": jnp.zeros((CATS,), dt),
        "rate_weights": jnp.full((CATS,), 1.0 / CATS, dt),
        "pattern_weights": jnp.ones((sites,), dt),
        "invariant": jnp.full((sites,), -1, jnp.int32),
    }
    masks = np.array([[int(charmap[ord(ch)]) for ch in s[:sites]]
                      for s in seqs], np.uint32)
    return topo, model, masks


@pytest.mark.parametrize("path", PATHS)
@_PROGRAMS
def test_fused_edge_score_kernel_vs_golden(cfg, golden_name, path,
                                           monkeypatch):
    """make_score (edge score with tip CLVs) vs the golden."""
    built = _use(path, monkeypatch)
    want = _want(golden_name)
    topo, model, masks = _program(**cfg)
    tip_clv = jnp.asarray(tip_clv_from_masks(masks, CATS, cfg["states"]),
                          jnp.float32)
    got = float(make_score(topo, CATS, cfg["states"])(model, tip_clv))
    np.testing.assert_allclose(got, want, atol=_logl_tol(want))
    assert len(built) == (path == "kernel")


@pytest.mark.parametrize("path", PATHS)
@_PROGRAMS
def test_dyn_pattern_tip_score_vs_golden(cfg, golden_name, path,
                                         monkeypatch):
    """make_score_unbounded (pattern tips: nibbles for DNA, bitmasks for
    the wider alphabets, decoded in the score) vs the golden."""
    built = _use(path, monkeypatch)
    want = _want(golden_name)
    topo, model, masks = _program(**cfg)
    got = float(make_score_unbounded(topo, CATS, cfg["states"], masks)(model))
    np.testing.assert_allclose(got, want, atol=_logl_tol(want))
    assert len(built) == (path == "kernel")
