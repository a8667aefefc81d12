"""Model-parameter optimization: GTR exchangeabilities and stationary
frequencies by L-BFGS through a differentiable eigendecomposition; Γ shape
(alpha) and the invariant-site proportion by derivative-free Brent; an
optional free-rate mode that optimizes the category rates and weights
directly.

The reference library has no model-optimization entry point — libpll users
assemble it from the setters (`pll_set_subst_params` /
`pll_set_frequencies`, reference src/models.c:366-400) plus
`pll_compute_gamma_cats` (src/gamma.c:220) and an external optimizer; the
shipped examples only optimize branch lengths
(reference examples/newton/newton.c:31-100).  Here it is first-class and
runs on the device:

  * the log-likelihood is differentiable end to end in the exchangeability
    and frequency parameters — the symmetrized GTR generator is
    eigendecomposed inside the traced program (``eigen_decompose_jax``,
    models/gtr.py) and XLA differentiates through ``jnp.linalg.eigh``, the
    P-matrix construction, the pruning sweep, and the scaled logL fold;
  * one jitted value-and-grad program serves every L-BFGS step;
  * alpha and p-inv ride the AS91 discretization chain (models/gamma.py),
    an iterative host-side method exactly like the reference's — so they
    are optimized by Brent's method, each trial point reusing ONE compiled
    scorer with the category rates / p-inv passed as data (no retraces).

Parameterization keeps every iterate feasible: exchangeabilities are
``exp`` of free logs with the last rate pinned to 1 (the reference's own
normalization, src/models.c:196-199), frequencies are a softmax, and the
free-rate mode renormalizes so the weighted mean rate is exactly 1 (the
same invariant the Γ discretization maintains, src/gamma.c:274-282).

Note on the uniform start: at exactly-equal exchangeabilities (JC69) the
GTR eigenvalues are degenerate and the eigh gradient is undefined, so the
optimizer nudges a flat start by a deterministic relative jitter before
differentiating.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvarError, ParamError
from ..models.gamma import compute_gamma_cats
from ..models.gtr import eigen_decompose_jax
from ..utils.constants import ALPHA_MIN, SCALE_PER_RATE
from .evaluate import make_forward, topology_from_tree


@dataclasses.dataclass
class ModelOptResult:
    """Optimized parameters + the logL trajectory (one entry per pass)."""

    logl: float
    subst_params: np.ndarray
    frequencies: np.ndarray
    alpha: Optional[float]
    rates: np.ndarray
    rate_weights: np.ndarray
    prop_invar: float
    trajectory: List[float]


# ---------------------------------------------------------------------------
# Brent's method (derivative-free 1-D maximization)
# ---------------------------------------------------------------------------
_GOLD = 0.3819660112501051  # 2 - golden ratio


def brent_maximize(fn, lo: float, hi: float, *, xtol: float = 1e-4,
                   max_iter: int = 64):
    """Maximize ``fn`` on [lo, hi]; returns ``(x_best, f_best, evals)``.

    Classic Brent parabolic-interpolation/golden-section search (the
    textbook method RAxML-family tools use for alpha/p-inv); written for
    maximization by negating internally.
    """
    evals = 0

    def f(x):
        nonlocal evals
        evals += 1
        return -float(fn(x))

    a, b = float(lo), float(hi)
    x = w = v = a + _GOLD * (b - a)
    fx = fw = fv = f(x)
    d = e = b - a
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol = xtol * abs(x) + 1e-10
        if abs(x - m) <= 2.0 * tol - 0.5 * (b - a):
            break
        p = q = r = 0.0
        if abs(e) > tol:
            # fit a parabola through (v, w, x)
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            e_prev, e = e, d
            if (abs(p) < abs(0.5 * q * e_prev) and q * (a - x) < p < q * (b - x)):
                d = p / q
                u = x + d
                if u - a < 2 * tol or b - u < 2 * tol:
                    d = tol if x < m else -tol
            else:
                e = (b - x) if x < m else (a - x)
                d = _GOLD * e
        else:
            e = (b - x) if x < m else (a - x)
            d = _GOLD * e
        u = x + d if abs(d) >= tol else x + (tol if d > 0 else -tol)
        fu = f(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, -fx, evals


# ---------------------------------------------------------------------------
# the differentiable scorer
# ---------------------------------------------------------------------------
def make_param_score(partition, tree, *, params_indices=None, dtype=None):
    """Build ``score(log_subst, freq_logits, rates, rate_weights, pinv,
    branch_lengths) -> logL`` — the full forward pass as a differentiable
    function of the model parameters (schedule and tip data closed over).

    The eigendecomposition runs inside the traced program so gradients
    flow from logL back to the exchangeabilities and frequencies; rates /
    weights / p-inv / branch lengths are plain inputs (differentiable too,
    and reusable as data by the Brent passes).

    Mixture partitions (``rate_matrices > 1``, the LG4M/LG4X pattern of
    reference examples/lg4/lg4.c:295-370) are supported: ``log_subst`` and
    ``freq_logits`` carry a leading rate-matrix axis, every matrix is
    eigendecomposed inside the trace (vmap), and ``params_indices`` maps
    each Γ category to its matrix (default: category k -> matrix k % R,
    the LG4 convention).  ``pinv`` stays a single shared proportion.
    """
    R = partition.rate_matrices
    if params_indices is None:
        pidx = (np.zeros(partition.rate_cats, np.int32) if R == 1 else
                np.arange(partition.rate_cats, dtype=np.int32) % R)
    else:
        pidx = np.asarray(params_indices, np.int32)
        if pidx.shape != (partition.rate_cats,):
            raise ParamError("params_indices must have rate_cats entries")
        if pidx.min() < 0 or pidx.max() >= R:
            raise ParamError("params_indices out of range")
    pidx_j = jnp.asarray(pidx)
    dtype = dtype or partition.dtype
    topo, branches = topology_from_tree(
        tree, partition.sites, scale_mode=partition.scale_mode,
        asc_mode=partition.asc_mode)
    T, I = topo.schedule.tips, topo.schedule.n_inner
    C, S, L = partition.rate_cats, partition.states, partition.sites_alloc

    clv0 = jnp.zeros((T + I, C, S, L), dtype).at[:T].set(
        partition.clv[:T].astype(dtype))
    if partition.scale_mode == SCALE_PER_RATE:
        scalers0 = jnp.zeros((I + 1, C, L), jnp.int32)
    else:
        scalers0 = jnp.zeros((I + 1, L), jnp.int32)
    pattern_weights = jnp.asarray(partition.pattern_weights, dtype)
    invariant = jnp.asarray(partition._invariant_arr())
    forward = make_forward(topo)

    def score(log_subst, freq_logits, rates, rate_weights, pinv,
              branch_lengths):
        # 1-D inputs are the single-matrix convenience form
        log_subst = jnp.atleast_2d(log_subst)
        freq_logits = jnp.atleast_2d(freq_logits)
        # [R, E-1] free logs -> [R, E] with the last rate pinned to 1
        subst = jnp.concatenate(
            [jnp.exp(log_subst), jnp.ones((R, 1), log_subst.dtype)],
            axis=1)
        freqs = jax.nn.softmax(freq_logits, axis=-1)  # [R, S]
        w, left, right = jax.vmap(eigen_decompose_jax)(subst, freqs)
        model = {
            "branch_lengths": branch_lengths.astype(dtype),
            "rates": rates.astype(dtype),
            "prop_invar": jnp.broadcast_to(pinv.astype(dtype), (R,)),
            "params_indices": pidx_j,
            "eigenvals": w.astype(dtype),
            "left": left.astype(dtype),
            "right": right.astype(dtype),
            "freqs_pc": freqs[pidx_j].astype(dtype),
            "prop_invar_pc": jnp.broadcast_to(pinv.astype(dtype), (C,)),
            "rate_weights": rate_weights.astype(dtype),
            "pattern_weights": pattern_weights,
            "invariant": invariant,
        }
        logl, _ = forward(model, clv0, scalers0)
        return logl

    return score, np.asarray(branches, np.float64)


def _jitter_flat(params: np.ndarray) -> np.ndarray:
    """Deterministically perturb exactly-equal exchangeabilities: eigh
    gradients are undefined at the degenerate (JC-like) point.  2-D input
    ([rate_matrices, E]) is jittered row by row."""
    if params.ndim == 2:
        return np.stack([_jitter_flat(r) for r in params])
    if np.ptp(params) > 1e-9 * abs(params).max():
        return params
    k = np.arange(params.shape[0], dtype=np.float64)
    return params * (1.0 + 1e-3 * (k - k.mean()) / max(len(k) - 1, 1))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def optimize_model(partition, tree, *, opt_subst: bool = True,
                   opt_freqs: bool = True, opt_alpha: bool = True,
                   opt_pinv: bool = False, rate_mode: str = "gamma",
                   alpha: Optional[float] = None,
                   alpha_bounds=(0.02, 100.0), pinv_max: float = 0.99,
                   rounds: int = 3, lbfgs_steps: int = 80,
                   gtol: float = 1e-3, min_delta: float = 1e-4,
                   params_indices=None, dtype=None) -> ModelOptResult:
    """Optimize the partition's model parameters in place on the fixed
    topology/branch lengths of ``tree``; returns a :class:`ModelOptResult`.

    Coordinate rounds alternate (a) one L-BFGS pass over the enabled
    gradient parameters — exchangeabilities, frequencies, and in
    ``rate_mode="free"`` the category rates/weights — and (b) Brent passes
    for alpha (``rate_mode="gamma"``) and p-inv, until the logL gain of a
    full round drops under ``min_delta``.  An explicit ``alpha`` re-seeds
    the Γ discretization up front; by default the partition's current
    rates stand until the Brent pass improves on them (the result's
    ``alpha`` is then None unless Brent accepted a shape).  On exit the
    partition's ``subst_params``,
    ``frequencies``, ``rates``, ``rate_weights`` and ``prop_invar`` are
    updated through the ordinary setters, so the eigen cache invalidates
    exactly like the reference's (src/models.c:373,397).
    """
    import optax

    if rate_mode not in ("gamma", "free", "fixed"):
        raise ParamError(f"invalid rate_mode {rate_mode!r}")
    if opt_pinv:
        if partition.asc_mode != 0:
            raise InvarError(
                "p-inv optimization is incompatible with asc-bias")
        if partition.invariant is None:
            partition.update_invariant_sites()
        if not np.any(partition.invariant >= 0):
            raise InvarError("no invariant sites found")

    score, branches = make_param_score(partition, tree,
                                       params_indices=params_indices,
                                       dtype=dtype)
    f64 = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

    # current parameter state ([R, E] / [R, S]; R = rate_matrices — the
    # LG4-style mixtures optimize weights/rates/freqs over fixed
    # per-category empirical matrices, reference examples/lg4/lg4.c)
    R = partition.rate_matrices
    subst = _jitter_flat(np.asarray(partition.subst_params, np.float64))
    subst = subst / subst[:, -1:]
    freqs = np.asarray(partition.frequencies, np.float64)
    rates = np.asarray(partition.rates, np.float64)
    rweights = np.asarray(partition.rate_weights, np.float64)
    pinv = float(partition.prop_invar[0])
    C = partition.rate_cats
    # an explicit alpha re-seeds the Γ discretization; otherwise the
    # partition's current rates stand until Brent improves on them
    if alpha is not None and rate_mode == "gamma" and opt_alpha and C > 1:
        rates = compute_gamma_cats(alpha, C)

    bl = jnp.asarray(branches, f64)

    # --- the gradient block -------------------------------------------------
    grad_keys = []
    if opt_subst:
        grad_keys.append("log_subst")
    if opt_freqs:
        grad_keys.append("freq_logits")
    if rate_mode == "free":
        grad_keys += ["log_rates", "rweight_logits"]

    def full_args(p, rates_np, pinv_val):
        """Merge optimized leaves with the fixed current values."""
        ls = p.get("log_subst", jnp.asarray(np.log(subst[:, :-1]), f64))
        fl = p.get("freq_logits", jnp.asarray(np.log(freqs), f64))
        if rate_mode == "free":
            r = jnp.exp(p["log_rates"])
            w = jax.nn.softmax(p["rweight_logits"])
            r = r / jnp.sum(w * r)  # weighted mean rate pinned to 1
        else:
            r = jnp.asarray(rates_np, f64)
            w = jnp.asarray(rweights, f64)
        return ls, fl, r, w, jnp.asarray(pinv_val, f64)

    def loss_fn(p, rates_np, pinv_val):
        ls, fl, r, w, pv = full_args(p, rates_np, pinv_val)
        return -score(ls, fl, r, w, pv, bl)

    def run_lbfgs(p0, rates_np, pinv_val):
        opt = optax.lbfgs()
        loss = lambda p: loss_fn(p, rates_np, pinv_val)  # noqa: E731
        value_and_grad = optax.value_and_grad_from_state(loss)

        @jax.jit
        def step(p, state):
            value, grad = value_and_grad(p, state=state)
            updates, state = opt.update(grad, state, p, value=value,
                                        grad=grad, value_fn=loss)
            return optax.apply_updates(p, updates), state, value, grad

        state = opt.init(p0)
        p, value = p0, np.inf
        for _ in range(lbfgs_steps):
            p, state, value, grad = step(p, state)
            gmax = max(float(jnp.abs(g).max())
                       for g in jax.tree_util.tree_leaves(grad))
            if gmax < gtol or not np.isfinite(float(value)):
                break
        return p, -float(value)

    # one reusable compiled scorer for the Brent passes (rates/pinv = data)
    score_j = jax.jit(score)

    def eval_at(rates_np, pinv_val):
        ls = jnp.asarray(np.log(subst[:, :-1]), f64)
        fl = jnp.asarray(np.log(freqs), f64)
        return float(score_j(ls, fl, jnp.asarray(rates_np, f64),
                             jnp.asarray(rweights, f64),
                             jnp.asarray(pinv_val, f64), bl))

    trajectory: List[float] = [eval_at(rates, pinv)]
    logl = trajectory[0]

    for _ in range(rounds):
        round_start = logl

        if grad_keys:
            p0: Dict[str, jnp.ndarray] = {}
            if "log_subst" in grad_keys:
                p0["log_subst"] = jnp.asarray(np.log(subst[:, :-1]), f64)
            if "freq_logits" in grad_keys:
                p0["freq_logits"] = jnp.asarray(np.log(freqs), f64)
            if rate_mode == "free":
                p0["log_rates"] = jnp.asarray(np.log(rates), f64)
                p0["rweight_logits"] = jnp.asarray(np.log(rweights), f64)
            p, cand = run_lbfgs(p0, rates, pinv)
            if np.isfinite(cand) and cand > logl:
                logl = cand
                if "log_subst" in p:
                    subst = np.concatenate(
                        [np.exp(np.asarray(p["log_subst"], np.float64)),
                         np.ones((R, 1))], axis=1)
                if "freq_logits" in p:
                    e = np.exp(np.asarray(p["freq_logits"], np.float64))
                    freqs = e / e.sum(axis=1, keepdims=True)
                if rate_mode == "free":
                    r = np.exp(np.asarray(p["log_rates"], np.float64))
                    e = np.exp(np.asarray(p["rweight_logits"], np.float64))
                    rweights = e / e.sum()
                    rates = r / (rweights * r).sum()
            trajectory.append(logl)

        if rate_mode == "gamma" and opt_alpha and C > 1:
            a, cand, _ = brent_maximize(
                lambda a: eval_at(compute_gamma_cats(a, C), pinv),
                max(alpha_bounds[0], ALPHA_MIN), alpha_bounds[1])
            if cand > logl:
                alpha, logl = a, cand
                rates = compute_gamma_cats(alpha, C)
            trajectory.append(logl)

        if opt_pinv:
            pv, cand, _ = brent_maximize(
                lambda v: eval_at(rates, v), 0.0, pinv_max)
            if cand > logl:
                pinv, logl = pv, cand
            trajectory.append(logl)

        if logl - round_start < min_delta:
            break

    # write back through the ordinary setters (invalidates the eigen cache)
    for k in range(R):
        partition.set_subst_params(k, subst[k])
        partition.set_frequencies(k, freqs[k])
    partition.set_category_rates(rates)
    partition.set_category_weights(rweights)
    if opt_pinv and pinv > 0.0:
        for k in range(R):
            partition.update_invariant_sites_proportion(k, pinv)

    return ModelOptResult(
        logl=float(logl),
        subst_params=(subst[0] if R == 1 else subst),
        frequencies=(freqs[0] if R == 1 else freqs),
        alpha=(float(alpha) if rate_mode == "gamma" and alpha is not None
               else None),
        rates=rates, rate_weights=rweights, prop_invar=float(pinv),
        trajectory=trajectory)
