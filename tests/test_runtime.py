"""Process-level behaviour: where the compile cache goes, what
chip_smoke.py does without a GPU, the stepwise build's single dispatch,
and the score kernel compiled for a real GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from libpll_tpu.io import maps
from libpll_tpu.ops import fitch
from libpll_tpu.search.parsimony import FastParsimony
from libpll_tpu.search.stepwise import fastparsimony_stepwise
from libpll_tpu.tree import utree as ut

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, env_extra=None, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **(env_extra or {}))
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable] + list(code_or_args))
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


_PRINT_CACHE = ("import sys; sys.path.insert(0, %r); import libpll_tpu, "
                "jax; print(jax.config.jax_compilation_cache_dir)"
                % str(REPO))


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed .jax_cache directory of the checkout, wherever the process
    runs."""
    extra = {} if env_dir is None else {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
    out = _run(_PRINT_CACHE, extra, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    want = (str(REPO / ".jax_cache") if env_dir is None
            else str(tmp_path / "cc"))
    assert out.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_cpu():
    """On a CPU backend chip_smoke.py exits non-zero and prints no
    result line."""
    out = _run([str(REPO / "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
               drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_stepwise_single_dispatch(seed, monkeypatch):
    """The device-resident stepwise build is one call of the whole-build
    program and gives the host engine's tree and score."""
    calls = []
    build = fitch._stepwise_build

    def counted(*args):
        calls.append(args[0])
        return build(*args)

    monkeypatch.setattr(fitch, "_stepwise_build", counted)
    rng = np.random.default_rng(seed)
    tips, sites = 40, 120
    seqs = ["".join(rng.choice(list("ACGT"), sites)) for _ in range(tips)]
    labels = [f"t{i}" for i in range(tips)]
    part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
    td, sd = fastparsimony_stepwise([part], labels, seed, engine="device")
    th, sh = fastparsimony_stepwise([part], labels, seed, engine="host")
    assert calls == [tips]
    assert sd == sh
    assert ut.export_newick(td.root) == ut.export_newick(th.root)


@pytest.mark.gpu
def test_score_kernel_compiled_on_gpu():
    """The score kernel as the GPU compiles it (no interpret mode) against
    the XLA score; chip_smoke.py runs the same at full width."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")
    import jax.numpy as jnp

    from libpll_tpu.engine import evaluate as ev
    from libpll_tpu.ops import tipcodes as tc

    from score_cases import TREES, _build

    topo, model, pmatrix, clv, _ = _build(TREES["random"](), sites=4096)
    masks = tc.tip_masks_from_clv(clv[:topo.schedule.tips])
    got = float(ev.make_score(topo, 4, 4, tip_encoding="chars")(
        model, tc.pack_tipchars(masks)))
    model64 = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
               for k, v in model.items()}
    want = float(ev.make_score(topo, 4, 4)(
        model64, clv[:topo.schedule.tips].astype(jnp.float64)))
    assert abs(got - want) <= 2e-6 * abs(want) + 5e-3
