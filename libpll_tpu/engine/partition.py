"""Partition: the stateful instance owning CLVs, P-matrices and parameters.

Capability parity with `pll_partition_create` and its setter/compute API
(libpll `src/pll.c:399-1116`, `src/partials.c`, `src/likelihood.c`,
`src/derivatives.c`, `src/models.c`), redesigned for an accelerator:

  * all bulk state is a handful of dense jax arrays — CLVs
    ``[nodes, rate_cats, states, sites]`` with sites on the lane axis (and
    shardable across a device mesh), exponent counters as int32, P-matrices
    batched ``[matrices, rate_cats, states, states]``;
  * no SIMD padding games: XLA lays out tiles itself;
  * scalar-ish parameters (frequencies, substitution rates, Γ rates, p-inv)
    live host-side in float64 numpy; the eigendecomposition is computed
    lazily on the host exactly like the reference caches it
    (`models.c:342-349`);
  * the operation schedule produced by the tree layer is data (an int32
    table), executed on-device by a single jitted scan — the host/device
    boundary falls between schedule generation and numeric execution.

Index conventions match the reference: CLV buffers 0..tips-1 are tips,
tips..tips+clv_buffers-1 are inner nodes; scaler index -1 means "none".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import AscBiasError, InvarError, ParamError, TipDataError
from ..io.maps import encode_sequence, tipmask_to_clv
from ..models.gtr import eigen_decompose
from ..ops import clv as clv_ops
from ..ops import derivatives as deriv_ops
from ..ops import likelihood as lk_ops
from ..ops.pmatrix import compute_pmatrices
from ..utils.constants import (SCALE_BUFFER_NONE, SCALE_NONE, SCALE_PER_RATE,
                               SCALE_PER_SITE)

ASC_NONE = lk_ops.ASC_NONE
ASC_LEWIS = lk_ops.ASC_LEWIS
ASC_FELSENSTEIN = lk_ops.ASC_FELSENSTEIN
ASC_STAMATAKIS = lk_ops.ASC_STAMATAKIS


@dataclasses.dataclass(frozen=True)
class Operation:
    """One CLV update: mirrors pll_operation_t (reference pll.h:249-259)."""

    parent_clv_index: int
    parent_scaler_index: int
    child1_clv_index: int
    child1_matrix_index: int
    child1_scaler_index: int
    child2_clv_index: int
    child2_matrix_index: int
    child2_scaler_index: int

    def as_tuple(self):
        # NOT dataclasses.astuple: that routes through deepcopy and
        # dominates candidate-encoding host time in tree search
        return (self.parent_clv_index, self.parent_scaler_index,
                self.child1_clv_index, self.child1_matrix_index,
                self.child1_scaler_index, self.child2_clv_index,
                self.child2_matrix_index, self.child2_scaler_index)


def operations_to_array(operations, n_scale_buffers: int) -> np.ndarray:
    """Flatten operations into the int32 table consumed by the CLV kernels.

    Scaler index -1 is remapped to the dummy row ``n_scale_buffers``.
    """
    rows = []
    for op in operations:
        t = op.as_tuple() if isinstance(op, Operation) else tuple(op)
        t = list(t)
        for k in (1, 4, 7):
            if t[k] == SCALE_BUFFER_NONE:
                t[k] = n_scale_buffers
        rows.append(t)
    return np.asarray(rows, dtype=np.int32)


class Partition:
    """Phylogenetic likelihood partition instance."""

    def __init__(self, tips: int, clv_buffers: int, states: int, sites: int,
                 rate_matrices: int, prob_matrices: int, rate_cats: int,
                 scale_buffers: int, *, scaling: str = "site",
                 asc_bias_alloc: bool = False, dtype=jnp.float64):
        if tips < 3:
            raise ParamError("tips must be >= 3")
        if states < 2 or sites < 1 or rate_cats < 1:
            raise ParamError("invalid partition dimensions")
        if scaling not in ("none", "site", "rate"):
            raise ParamError(f"invalid scaling mode {scaling!r}")

        self.tips = tips
        self.clv_buffers = clv_buffers
        self.nodes = tips + clv_buffers
        self.states = states
        self.sites = sites
        self.rate_matrices = rate_matrices
        self.prob_matrices = prob_matrices
        self.rate_cats = rate_cats
        self.scale_buffers = scale_buffers
        self.asc_bias_alloc = asc_bias_alloc
        self.asc_mode = ASC_NONE
        self.dtype = dtype
        self.scale_mode = {"none": SCALE_NONE, "site": SCALE_PER_SITE,
                           "rate": SCALE_PER_RATE}[scaling]

        # asc-bias correction appends `states` pseudo-sites (pll.c:490-495)
        self.sites_alloc = sites + (states if asc_bias_alloc else 0)
        L, C, S = self.sites_alloc, rate_cats, states

        # the CLV tensor is allocated at its first read, where
        # ``place_clv`` says (default device otherwise), so that a
        # site-sharded partition never holds it whole on one device
        self.clv_shape = (self.nodes, C, S, L)
        self._clv = None
        self._clv_sharding = None
        # tip rows staged host-side and flushed in ONE scatter on first
        # read: a per-tip .at[i].set() copies the whole tensor, turning
        # giant-tree setup O(nodes²) (274 GB of memcpy at 2048 taxa)
        self._staged_tips: dict = {}
        if self.scale_mode == SCALE_PER_RATE:
            self.scalers = jnp.zeros((scale_buffers + 1, C, L), dtype=jnp.int32)
        elif self.scale_mode == SCALE_PER_SITE:
            self.scalers = jnp.zeros((scale_buffers + 1, L), dtype=jnp.int32)
        else:
            self.scalers = jnp.zeros((1, L), dtype=jnp.int32)
        self.pmatrix = jnp.zeros((prob_matrices, C, S, S), dtype=dtype)

        # host-side (small) model parameters, float64 like the reference
        n_params = states * (states - 1) // 2
        self.subst_params = np.ones((rate_matrices, n_params))
        self.frequencies = np.full((rate_matrices, states), 1.0 / states)
        self.rates = np.ones(rate_cats)
        self.rate_weights = np.full(rate_cats, 1.0 / rate_cats)
        self.prop_invar = np.zeros(rate_matrices)
        self.pattern_weights = np.ones(self.sites_alloc, dtype=np.int64)
        self.pattern_weights[sites:] = 0  # pseudo-sites weigh 0 by default
        self.invariant: Optional[np.ndarray] = None

        # eigen cache (host, lazy — models.c:342-349)
        self.eigenvals = np.zeros((rate_matrices, states))
        self.eigen_left = np.zeros((rate_matrices, states, states))
        self.eigen_right = np.zeros((rate_matrices, states, states))
        self.eigen_valid = np.zeros(rate_matrices, dtype=bool)

        # tip state bitmasks, kept for invariant-site detection
        self._tip_masks = np.zeros((tips, sites), dtype=np.uint32)

    # ------------------------------------------------------------------
    # setters (reference: pll.c / models.c)
    # ------------------------------------------------------------------
    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Encode an ASCII sequence into a bit-encoded tip CLV
        (`set_tipclv`, pll.c:905-964)."""
        if not (0 <= tip_index < self.tips):
            raise TipDataError(f"tip index {tip_index} out of range")
        if len(sequence) != self.sites:
            raise TipDataError(
                f"sequence length {len(sequence)} != sites {self.sites}")
        masks = encode_sequence(sequence, charmap)
        self._tip_masks[tip_index] = masks
        site_clv = tipmask_to_clv(masks, self.states)  # [sites, S]
        self._install_tip_clv(tip_index, site_clv.T)  # [S, sites]

    def set_tip_clv(self, tip_index: int, tip_clv: np.ndarray) -> None:
        """Set an explicit per-site tip CLV [sites, states]
        (`pll_set_tip_clv`, pll.c:1001-1045)."""
        arr = np.asarray(tip_clv, dtype=np.float64)
        if arr.shape != (self.sites, self.states):
            raise TipDataError(
                f"expected tip CLV of shape {(self.sites, self.states)}")
        # approximate the bitmask for invariant detection: nonzero -> bit set
        self._tip_masks[tip_index] = (
            (arr > 0).astype(np.uint32)
            << np.arange(self.states, dtype=np.uint32)[None, :]
        ).sum(axis=1).astype(np.uint32)
        self._install_tip_clv(tip_index, arr.T)

    def _install_tip_clv(self, tip_index: int, clv_sl: np.ndarray) -> None:
        """clv_sl: [S, sites]; broadcasts over rate cats, appends asc
        pseudo-sites (identity states) when allocated.  Staged host-side;
        all staged tips land in one scatter at the next ``clv`` read."""
        L, S = self.sites_alloc, self.states
        full = np.zeros((S, L), dtype=np.dtype(self.dtype))
        full[:, :self.sites] = clv_sl
        if self.asc_bias_alloc:
            full[:, self.sites:] = np.eye(S)
        self._staged_tips[tip_index] = full

    def _flush_tips(self) -> None:
        if self._clv is None:
            self._clv = jnp.zeros(self.clv_shape, self.dtype,
                                  device=self._clv_sharding)
        if not self._staged_tips:
            return
        staged, self._staged_tips = self._staged_tips, {}
        idx = np.fromiter(staged.keys(), np.int64, len(staged))
        tiles = np.stack([staged[i] for i in idx])      # [k, S, L]
        tiles = np.broadcast_to(
            tiles[:, None], (len(idx), self.rate_cats) + tiles.shape[1:])
        # host-side broadcast, then each device receives only its shard
        tiles = jax.device_put(tiles, self._clv.sharding)
        self._clv = self._clv.at[jnp.asarray(idx)].set(tiles)

    @property
    def clv(self) -> jnp.ndarray:
        self._flush_tips()
        return self._clv

    @clv.setter
    def clv(self, value) -> None:
        self._clv = value

    def place_clv(self, sharding) -> None:
        """Put the CLV tensor on ``sharding`` (a device or a sharding);
        before the tensor's first read, allocate it there instead."""
        self._clv_sharding = sharding
        if self._clv is not None:
            self._clv = jax.device_put(self._clv, sharding)

    def set_subst_params(self, params_index: int, params) -> None:
        p = np.asarray(params, dtype=np.float64)
        if p.shape != (self.states * (self.states - 1) // 2,):
            raise ParamError("wrong number of substitution parameters")
        self.subst_params[params_index] = p
        self.eigen_valid[params_index] = False

    def set_frequencies(self, freqs_index: int, frequencies) -> None:
        f = np.asarray(frequencies, dtype=np.float64)
        if f.shape != (self.states,):
            raise ParamError("wrong number of frequencies")
        self.frequencies[freqs_index] = f
        self.eigen_valid[freqs_index] = False

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64).reshape(self.rate_cats)

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64).reshape(
            self.rate_cats)

    def set_pattern_weights(self, weights) -> None:
        w = np.asarray(weights)
        if w.shape != (self.sites,):
            raise ParamError("pattern weights must have length sites")
        self.pattern_weights[:self.sites] = w

    @property
    def pattern_weight_sum(self) -> int:
        return int(self.pattern_weights[:self.sites].sum())

    def set_asc_bias_type(self, asc_mode: int) -> None:
        """reference: pll_set_asc_bias_type (pll.c:1061-1107)."""
        if not self.asc_bias_alloc and asc_mode != ASC_NONE:
            raise AscBiasError(
                "partition was not created with ascertainment bias support")
        if asc_mode != ASC_NONE and np.any(self.prop_invar > 0):
            raise InvarError(
                "invariant sites are not compatible with asc bias correction")
        if asc_mode not in (ASC_NONE, ASC_LEWIS, ASC_FELSENSTEIN,
                            ASC_STAMATAKIS):
            raise AscBiasError(f"illegal ascertainment bias type {asc_mode}")
        self.asc_mode = asc_mode

    def set_asc_state_weights(self, weights) -> None:
        if not self.asc_bias_alloc:
            raise AscBiasError("partition has no asc-bias pseudo-sites")
        w = np.asarray(weights)
        if w.shape != (self.states,):
            raise ParamError("asc state weights must have length states")
        self.pattern_weights[self.sites:] = w

    # ------------------------------------------------------------------
    # invariant sites (reference: models.c:402-647)
    # ------------------------------------------------------------------
    def update_invariant_sites(self) -> None:
        gap_state = (1 << self.states) - 1
        state = np.full(self.sites, gap_state, dtype=np.uint32)
        for t in range(self.tips):
            state &= self._tip_masks[t]
        popcount = np.array([bin(x).count("1") for x in state])
        inv = np.where(popcount == 1,
                       np.array([(int(x) & -int(x)).bit_length() - 1
                                 for x in state]),
                       -1).astype(np.int32)
        full = np.full(self.sites_alloc, -1, dtype=np.int32)
        full[:self.sites] = inv
        self.invariant = full

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        if prop_invar != 0.0 and self.asc_mode != ASC_NONE:
            raise InvarError(
                "invariant sites are not compatible with asc bias correction")
        if prop_invar < 0 or prop_invar >= 1:
            raise InvarError(
                f"invalid proportion of invariant sites ({prop_invar})")
        if params_index >= self.rate_matrices:
            raise InvarError(f"invalid params index ({params_index})")
        if prop_invar > 0.0 and self.invariant is None:
            self.update_invariant_sites()
            if not np.any(self.invariant >= 0):
                raise InvarError("no invariant sites found")
        self.prop_invar[params_index] = prop_invar

    def count_invariant_sites(self) -> int:
        if self.invariant is None:
            self.update_invariant_sites()
        mask = self.invariant[:self.sites] >= 0
        return int(self.pattern_weights[:self.sites][mask].sum())

    # ------------------------------------------------------------------
    # eigen / P-matrices (reference: models.c:251-364, core_pmatrix.c)
    # ------------------------------------------------------------------
    def update_eigen(self, params_index: int) -> None:
        w, left, right = eigen_decompose(self.subst_params[params_index],
                                         self.frequencies[params_index])
        self.eigenvals[params_index] = w
        self.eigen_left[params_index] = left
        self.eigen_right[params_index] = right
        self.eigen_valid[params_index] = True

    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        pi = np.asarray(params_indices, dtype=np.int32).reshape(self.rate_cats)
        mi = np.asarray(matrix_indices, dtype=np.int32)
        bl = np.asarray(branch_lengths, dtype=np.float64)
        if np.any(bl < 0):
            raise ParamError("negative branch length")
        for idx in np.unique(pi):
            if not self.eigen_valid[idx]:
                self.update_eigen(int(idx))
        new = compute_pmatrices(
            jnp.asarray(bl, dtype=self.dtype),
            jnp.asarray(self.rates, dtype=self.dtype),
            jnp.asarray(self.prop_invar, dtype=self.dtype),
            jnp.asarray(pi),
            jnp.asarray(self.eigenvals, dtype=self.dtype),
            jnp.asarray(self.eigen_left, dtype=self.dtype),
            jnp.asarray(self.eigen_right, dtype=self.dtype),
        )
        self.pmatrix = self.pmatrix.at[jnp.asarray(mi)].set(new)

    # ------------------------------------------------------------------
    # CLV updates (reference: partials.c:177-212)
    # ------------------------------------------------------------------
    def update_partials(self, operations: Sequence[Operation],
                        pad_to: Optional[int] = None) -> None:
        """``pad_to``: pad the op table to a fixed capacity by repeating the
        final op (idempotent), so incremental updates of varying size reuse
        one compiled schedule executor (search loops; ops/incremental.py)."""
        ops = operations_to_array(operations, self.scale_buffers)
        if pad_to is not None:
            from ..ops.incremental import pad_op_table
            ops = pad_op_table(ops, pad_to)
        self.clv, self.scalers = clv_ops.update_partials(
            self.clv, self.scalers, jnp.asarray(ops), self.pmatrix,
            scale_mode=self.scale_mode)

    # ------------------------------------------------------------------
    # likelihood (reference: likelihood.c)
    # ------------------------------------------------------------------
    def _freqs_pc(self, freqs_indices) -> jnp.ndarray:
        fi = np.asarray(freqs_indices, dtype=np.int64).reshape(self.rate_cats)
        return jnp.asarray(self.frequencies[fi], dtype=self.dtype)

    def _pinv_pc(self, freqs_indices) -> jnp.ndarray:
        fi = np.asarray(freqs_indices, dtype=np.int64).reshape(self.rate_cats)
        return jnp.asarray(self.prop_invar[fi], dtype=self.dtype)

    def _scaler_row(self, scaler_index: int) -> jnp.ndarray:
        if self.scale_mode == SCALE_NONE:
            return self.scalers[0]
        idx = self.scale_buffers if scaler_index == SCALE_BUFFER_NONE \
            else scaler_index
        return self.scalers[idx]

    def _invariant_arr(self) -> jnp.ndarray:
        if self.invariant is None:
            return jnp.full((self.sites_alloc,), -1, dtype=jnp.int32)
        return jnp.asarray(self.invariant)

    def _pattern_weights_arr(self) -> jnp.ndarray:
        return jnp.asarray(self.pattern_weights, dtype=self.dtype)

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, persite: bool = False):
        logl, ps = lk_ops.root_loglikelihood(
            self.clv[clv_index], self._scaler_row(scaler_index),
            self._freqs_pc(freqs_indices),
            jnp.asarray(self.rate_weights, dtype=self.dtype),
            self._pattern_weights_arr(), self._pinv_pc(freqs_indices),
            self._invariant_arr(), sites=self.sites,
            per_rate=self.scale_mode == SCALE_PER_RATE,
            asc_mode=self.asc_mode)
        return (float(logl), np.asarray(ps)) if persite else float(logl)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int, freqs_indices,
                                   persite: bool = False):
        logl, ps = lk_ops.edge_loglikelihood(
            self.clv[parent_clv_index], self.clv[child_clv_index],
            self._scaler_row(parent_scaler_index),
            self._scaler_row(child_scaler_index),
            self.pmatrix[matrix_index], self._freqs_pc(freqs_indices),
            jnp.asarray(self.rate_weights, dtype=self.dtype),
            self._pattern_weights_arr(), self._pinv_pc(freqs_indices),
            self._invariant_arr(), sites=self.sites,
            per_rate=self.scale_mode == SCALE_PER_RATE,
            asc_mode=self.asc_mode)
        return (float(logl), np.asarray(ps)) if persite else float(logl)

    # ------------------------------------------------------------------
    # derivatives (reference: derivatives.c)
    # ------------------------------------------------------------------
    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices) -> jnp.ndarray:
        pi = np.asarray(params_indices, dtype=np.int64).reshape(self.rate_cats)
        for idx in np.unique(pi):
            if not self.eigen_valid[idx]:
                self.update_eigen(int(idx))
        per_rate = self.scale_mode == SCALE_PER_RATE
        zeros = jnp.zeros_like(self._scaler_row(SCALE_BUFFER_NONE))
        sp = self._scaler_row(parent_scaler_index) if per_rate else zeros
        sc = self._scaler_row(child_scaler_index) if per_rate else zeros
        return deriv_ops.update_sumtable(
            self.clv[parent_clv_index], self.clv[child_clv_index], sp, sc,
            self._freqs_pc(pi),
            jnp.asarray(self.eigen_left[pi], dtype=self.dtype),
            jnp.asarray(self.eigen_right[pi], dtype=self.dtype),
            per_rate=per_rate)

    def compute_likelihood_derivatives(self, parent_scaler_index: int,
                                       child_scaler_index: int,
                                       branch_length: float, params_indices,
                                       sumtable) -> tuple[float, float]:
        pi = np.asarray(params_indices, dtype=np.int64).reshape(self.rate_cats)
        if self.asc_mode != ASC_NONE and self.scale_mode == SCALE_PER_SITE:
            sp = self._scaler_row(parent_scaler_index)
            sc = self._scaler_row(child_scaler_index)
        else:
            # per-rate scalers were folded into the sumtable already; the
            # per-site asc part below then sees zero scalers like the
            # reference's rate-scaler asc path
            z = jnp.zeros((self.sites_alloc,), dtype=jnp.int32)
            sp = sc = z
        d1, d2 = deriv_ops.likelihood_derivatives(
            sumtable, jnp.asarray(branch_length, dtype=self.dtype),
            jnp.asarray(self.rates, dtype=self.dtype),
            self._pinv_pc(pi),
            jnp.asarray(self.eigenvals[pi], dtype=self.dtype),
            self._freqs_pc(pi),
            jnp.asarray(self.rate_weights, dtype=self.dtype),
            self._invariant_arr(), self._pattern_weights_arr(), sp, sc,
            sites=self.sites, asc_mode=self.asc_mode)
        return float(d1), float(d2)
