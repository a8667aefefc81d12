"""Pattern-tip storage for the scoring paths.

The reference keeps tips as state codes instead of full CLVs when
``PLL_ATTRIB_PATTERN_TIP`` is set (`src/pll.c:825-903`); the scoring
entry points of :mod:`libpll_tpu.engine.evaluate` take the same idea as
their ``tip_encoding``:

* ``"clv"``   — [tips, C, S, L] 0/1 (or partial) tip CLVs as stored by a
  Partition;
* ``"chars"`` — 4-bit ambiguity codes nibble-packed eight tips to an int32
  word, [ceil(tips/8), L] (0.5 byte per tip and site; states <= 4);
* ``"masks"`` — one int32 ambiguity bitmask per tip and site, [tips, L]
  (wide alphabets).

Codes decode to 0/1 CLV rows by the reference's bit walk
(`set_tipclv`, `src/pll.c:925-931`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TIP_ENCODINGS = ("clv", "chars", "masks")


def check_tip_encoding(tip_encoding: str, states: int) -> None:
    if tip_encoding not in TIP_ENCODINGS:
        raise ValueError(f"unknown tip encoding {tip_encoding!r}")
    if tip_encoding == "chars" and states > 4:
        raise ValueError("tip_encoding='chars' requires states <= 4; "
                         "use 'masks' for wider alphabets")


def pack_tipchars(tip_masks) -> jax.Array:
    """[tips, L] 4-bit ambiguity codes -> nibble-packed [ceil(tips/8), L]
    int32 words; word row g holds tips 8g..8g+7, tip 8g+k in bits
    4k..4k+3."""
    masks = np.asarray(tip_masks, dtype=np.uint32)
    if masks.max() > 0xF:
        raise ValueError("tipchars mode supports 4-bit codes (states<=4)")
    tips, sites = masks.shape
    words = -(-tips // 8)
    slab = np.zeros((words * 8, sites), np.uint32)
    slab[:tips] = masks
    packed = np.zeros((words, sites), np.uint32)
    for k in range(8):
        packed |= slab[k::8][:words] << np.uint32(4 * k)
    return jnp.asarray(packed.astype(np.int32))


def pack_tipmasks(tip_masks) -> jax.Array:
    """[tips, L] ambiguity bitmasks as the int32 ``"masks"`` encoding."""
    return jnp.asarray(np.asarray(tip_masks, np.uint32).astype(np.int32))


def tip_masks_from_clv(tip_clv) -> np.ndarray:
    """[tips, C, S, L] 0/1 tip CLVs -> [tips, L] uint32 ambiguity bitmasks
    (bit s set where state s is possible; rate category 0 is read, tip
    CLVs are equal across categories)."""
    clv = np.asarray(tip_clv)[:, 0]  # [tips, S, L]
    bits = np.uint32(1) << np.arange(clv.shape[1], dtype=np.uint32)
    return ((clv > 0).astype(np.uint32) * bits[None, :, None]).sum(
        1).astype(np.uint32)


def tip_codes(tips_packed, tip_encoding: str, tips: int) -> jax.Array:
    """[tips, L] int32 ambiguity codes from a ``"chars"``/``"masks"``
    slab."""
    if tip_encoding == "masks":
        return tips_packed[:tips]
    t = np.arange(tips)
    words = tips_packed[t // 8]  # [tips, L]
    shift = jnp.asarray(4 * (t % 8), jnp.int32)[:, None]
    return jnp.right_shift(words, shift) & 0xF


def decode_tips(tips_packed, tip_encoding: str, tips: int, rate_cats: int,
                states: int, dtype) -> jax.Array:
    """Tip CLVs [tips, C, S, L] in ``dtype`` from any tip encoding."""
    if tip_encoding == "clv":
        return tips_packed[:tips].astype(dtype)
    codes = tip_codes(tips_packed, tip_encoding, tips)
    s = jnp.arange(states, dtype=jnp.int32)[None, :, None]
    bits = (jnp.right_shift(codes[:, None, :], s) & 1).astype(dtype)
    return jnp.broadcast_to(bits[:, None],
                            (tips, rate_cats, states, codes.shape[-1]))


def gap_code(states: int) -> int:
    """Ambiguity code of a gap (every state possible): the padding value
    that keeps pad columns positive and scaling-free."""
    return (1 << states) - 1


def accurate_sum(x: jax.Array) -> jax.Array:
    """Sum of per-site (or per-block) log-likelihoods.

    In float32 the global site reduction is the accuracy bottleneck:
    |logL| reaches 1e6-1e7 at benchmark scale, where one f32 ulp is
    ~0.1-1 logL units.  With x64 enabled the terms are summed in float64
    (a few hundred thousand adds); otherwise XLA's pairwise f32 sum."""
    if jax.config.jax_enable_x64 and x.dtype != jnp.float64:
        return jnp.sum(x.astype(jnp.float64))
    return jnp.sum(x)
