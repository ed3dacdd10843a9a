"""FM/AM discriminators, batched.

Re-implements the six selectable algorithms of fm_Demodulator
(src/fm/fm-demodulator.cpp:111-241) as vectorized block transforms.  The
reference normalises each sample to the unit circle, applies the selected
per-sample rule against the previous (normalised) sample, tracks a DC/AFC
component with a one-pole, and scales by 20/K_FM.  None of the rules are
recursive in the *signal* (they only look back 1-2 samples), so a block maps
to pure shifts + elementwise math; the only carried state is the 1-2 sample
history, the AFC tracker and the AM carrier tracker.

The reference's atan2/arcsine lookup tables (Xtan2.cpp, fm-demodulator.cpp:
74-77) are replaced by exact vectorised transcendentals.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .blockops import ema_apply

Array = jax.Array

DECODERS = (
    "am",                     # AM_DECODER
    "pll",                    # PLL_DECODER (batched equivalent, see below)
    "mixed",                  # MIXED_DECODER — fast atan2 of conj product
    "complex_baseband",       # COMPLEX_BB_DECODER — same math as mixed
    "real_baseband",          # REAL_BB_DECODER — arcsine of quadrature inner
    "difference",             # DIFF_DECODER
)


class DemodState(NamedTuple):
    prev1: Array        # normalised z[-1]  (Imin1 + j Qmin1)
    prev2: Array        # normalised z[-2]  (Imin2 + j Qmin2)
    fm_afc: Array       # post-demod DC tracker (fm-demodulator.cpp:197-198)
    am_carr: Array      # carrier amplitude tracker (:128-130)
    pll_phase: Array    # PLL decoder NCO phase (pllC state)
    pll_incr: Array     # PLL decoder frequency estimate


def demod_zero_state() -> DemodState:
    z = jnp.asarray(0.01 + 0.01j, jnp.complex64)
    f = jnp.float32
    return DemodState(z, z, jnp.asarray(0, f), jnp.asarray(0, f),
                      jnp.asarray(0, f), jnp.asarray(0, f))


def _normalize(z: Array) -> Array:
    """Unit-circle projection with the reference's small-signal clamp
    (fm-demodulator.cpp:119-126): |z| <= 0.001 -> (0.001, 0.001)."""
    mag = jnp.abs(z)
    small = mag <= 1e-3
    safe = jnp.where(small, 1.0, mag)
    zn = z / safe
    return jnp.where(small, jnp.asarray(0.001 + 0.001j, z.dtype), zn)


def demodulate_block(z: Array, state: DemodState, decoder: str = "mixed",
                     rate: int = C.FM_RATE,
                     shard_axis=None,
                     defer_tail: bool = False
                     ) -> Tuple[Array, DemodState, Array]:
    """Demodulate a block of complex baseband at the fm rate.

    Returns (audio-rate-192k demod [T] float32, new state, carrier amplitude
    track [T] for the level squelch).  Output scaling matches the reference:
    20*(res - afc)/K_FM (fm-demodulator.cpp:205).

    With `shard_axis` (inside shard_map over a time mesh) the 1-2 sample
    lookback crosses the device boundary via ppermute and the trackers use
    the distributed recurrence decomposition; the AM-carrier and AFC
    trackers share ONE gather (dist_ema2).  `defer_tail` (sharded callers
    only) leaves state.prev1/prev2 as LOCAL candidates — the caller
    resolves them to the last device's in its fused end-of-chain gather
    instead of paying a dedicated collective here.
    """
    if shard_axis is None:
        _ema = lambda x, a, y0: ema_apply(x, a, y0)
    else:
        from ..parallel.distributed import dist_ema
        _ema = lambda x, a, y0: dist_ema(x, a, y0, shard_axis)

    mag = jnp.abs(z)
    if shard_axis is None:
        am_track, am_last = _ema(mag, C.CARRIER_ALPHA, state.am_carr)
    elif decoder == "am":
        # AM needs am_track before res, but its AFC drive is zeros — the
        # two trackers are still independent, so they share one gather
        from ..parallel.distributed import dist_ema2
        (am_track, am_last), (afc_track_am, afc_last_am) = dist_ema2(
            mag, C.CARRIER_ALPHA, state.am_carr,
            jnp.zeros_like(mag), C.FM_DC_ALPHA, state.fm_afc, shard_axis)
    else:
        am_track = am_last = None      # paired with the AFC gather below

    zn = _normalize(z)
    if shard_axis is None:
        prev1_in = state.prev1
    else:
        from ..parallel.distributed import left_halo
        prev1_in = left_halo(zn, 1, state.prev1[None], shard_axis)[0]
    p1 = jnp.concatenate([prev1_in[None], zn[:-1]])

    if decoder == "am":
        res = _decode_am(mag, am_track)
        if shard_axis is None:
            afc_track, afc_last = _ema(res * 0, C.FM_DC_ALPHA, state.fm_afc)
        else:
            afc_last = afc_last_am      # from the shared gather above
        p1n, p2n = _stream_tail2(zn, state, shard_axis, defer_tail)
        new = state._replace(prev1=p1n, prev2=p2n, am_carr=am_last,
                             fm_afc=afc_last)
        return res, new, am_track

    if decoder in ("mixed", "complex_baseband"):
        # atan2(Q*I1 - I*Q1, I*I1 + Q*Q1) == arg(z * conj(prev))
        # (fm-demodulator.cpp:168-177; the two branches are the same math)
        d = zn * jnp.conj(p1)
        res = jnp.arctan2(jnp.imag(d), jnp.real(d))
    elif decoder == "real_baseband":
        # (I1*Q - Q1*I + 1)/2 -> asin(2u-1)/2 via the 32769-entry LUT
        # (fm-demodulator.cpp:179-187); exact asin here.
        u = (jnp.real(p1) * jnp.imag(zn) - jnp.imag(p1) * jnp.real(zn) + 1.0) / 2.0
        u = jnp.clip(u, 0.0, 1.0)
        res = jnp.arcsin(2.0 * u - 1.0) / 2.0
    elif decoder == "difference":
        if shard_axis is None:
            p2 = jnp.concatenate([state.prev2[None], state.prev1[None],
                                  zn[:-2]])
        else:
            from ..parallel.distributed import left_halo
            halo2 = left_halo(zn, 2, jnp.stack([state.prev2, state.prev1]),
                              shard_axis)
            p2 = jnp.concatenate([halo2, zn[:-2]])
        num = (jnp.real(p1) * (jnp.imag(zn) - jnp.imag(p2))
               - jnp.imag(p1) * (jnp.real(zn) - jnp.real(p2)))
        den = (jnp.real(p1) ** 2 + jnp.imag(p1) ** 2) * jnp.sqrt(2.0)
        res = num / den
    elif decoder == "pll":
        res, pll_incr_last = _decode_pll_block(zn, p1, state, rate,
                                               shard_axis)
    else:
        raise ValueError(f"unknown decoder {decoder!r}")

    if shard_axis is None:
        afc_track, afc_last = _ema(res, C.FM_DC_ALPHA, state.fm_afc)
    else:
        # one gather serves the AM-carrier and AFC trackers (dist_ema2)
        from ..parallel.distributed import dist_ema2
        (am_track, am_last), (afc_track, afc_last) = dist_ema2(
            mag, C.CARRIER_ALPHA, state.am_carr,
            res, C.FM_DC_ALPHA, state.fm_afc, shard_axis)
    out = C.DEMOD_GAIN * (res - afc_track) / C.k_fm(rate)

    prev1_new, prev2_new = _stream_tail2(zn, state, shard_axis, defer_tail)
    new = state._replace(prev1=prev1_new, prev2=prev2_new,
                         fm_afc=afc_last, am_carr=am_last)
    if decoder == "pll":
        new = new._replace(pll_incr=pll_incr_last)
    return out.astype(jnp.float32), new, am_track


def _stream_tail2(zn: Array, state: DemodState, shard_axis,
                  defer_tail: bool = False):
    """(z[-1], z[-2]) of the global stream — on the last device when sharded.

    With `defer_tail` the LOCAL tail is returned as a candidate; the
    caller resolves it to the last device's in its fused end-of-chain
    gather (see Receiver.fm_chain) instead of a dedicated collective."""
    if shard_axis is None or defer_tail:
        return zn[-1], (zn[-2] if zn.shape[0] >= 2 else state.prev1)
    tail2 = jax.lax.all_gather(zn[-2:], shard_axis, tiled=True)
    return tail2[-1], tail2[-2]


def _decode_am(mag: Array, carr: Array) -> Array:
    """AM envelope path (fm_Demodulator::decodeAM, fm-demodulator.cpp:215-241)."""
    gain_limit = 0.01
    res = (mag - carr) / jnp.maximum(carr, gain_limit)
    return jnp.clip(res, -1.0, 1.0)


def _decode_pll_block(zn: Array, p1: Array, state: DemodState, rate: int,
                      shard_axis=None) -> Array:
    """Batched equivalent of the PLL discriminator (pllC.cpp:67-90).

    The reference PLL's phase-increment output is, in steady state, the
    instantaneous frequency low-passed by a one-pole with
    Beta = exp(-2*pi*(0.85*rate)/2/rate) ~= exp(-2.67) (fm-demodulator.cpp:
    68-73).  The instantaneous frequency of a unit-circle signal is exactly
    arg(z[n]*conj(z[n-1])); we apply the identical one-pole to it with the
    carried phaseIncr as initial state.  This replaces the nonlinear
    feedback loop by its linearised steady-state equivalent (valid when the
    loop is in lock, which for a wideband 0.85*rate loop is immediate).

    p1 is the 1-sample-lookback stream (already halo-exchanged when
    sharded); with `shard_axis` the one-pole runs through the distributed
    prefix decomposition.
    """
    beta = jnp.exp(-2.0 * jnp.pi * (0.85 * rate) / 2.0 / rate)
    d = zn * jnp.conj(p1)
    inst = jnp.arctan2(jnp.imag(d), jnp.real(d))
    if shard_axis is None:
        from .blockops import linrec_apply
        y, y_last = linrec_apply((1.0 - beta) * inst, beta, state.pll_incr)
    else:
        from ..parallel.distributed import dist_linrec
        y, y_last = dist_linrec((1.0 - beta) * inst, beta, state.pll_incr,
                                shard_axis)
    return y, y_last
