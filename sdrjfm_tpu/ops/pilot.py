"""19 kHz pilot recovery — block-parallel analytic-signal estimator.

The reference tracks the pilot with a per-sample first-order PLL
(src/fm/pilot-recover.cpp:54-83, loop gain 10*2pi/fmRate, fm-processor.cpp:
78-80).  A sequential 192 kHz loop is the worst possible shape for an accelerator, so
the native design extracts the pilot's *analytic signal* with a narrow
one-sided FFT bandpass and reads phase and amplitude directly:

    p[n]   = (h_analytic * 5*demod)[n]        (complex, |p| = 5*A_pilot/2)
    phi[n] = angle(p[n]) + w19*D + pi

which is fully parallel.  Calibration to the reference's convention: the
reference PLL locks in *anti-phase* (its phase detector err = pilot*sin(phi)
has its stable equilibrium at phi = theta_pilot + pi), so downstream
consumers that form 2*(phi + pi/4) / 3*phi see exactly the same carriers when
we add pi; w19*D compensates the bandpass group delay (exact for the
constant-frequency pilot).  The lock metric is calibrated the same way: the
reference smooths -quadRef*pilot with alpha = 1/3000, whose DC term at lock
is amplitude/2 == |p|; we smooth |p| with the same alpha and apply the same
0.07 / 500 ms hold rule (pilot-recover.cpp:66-80).

A faithful per-sample scan implementation lives in
`reference_scans.pilot_pll_scan` and the equivalence of the two is asserted
in tests/test_pilot.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import design
from .blockops import ema_apply, fft_filter_zero_state, runlength_true

Array = jax.Array

PILOT_BP_TAPS = 1537          # ~±500 Hz one-sided bandpass at 192 kHz
PILOT_BP_HALF_WIDTH = 500.0


class PilotConfig(NamedTuple):
    fft_size: int
    hop: int
    response: np.ndarray      # [fft] complex64
    group_delay: int          # (taps-1)/2
    rate: int


def make_pilot_config(rate: int = C.FM_RATE, fft_size: int = 8192,
                      taps: int = PILOT_BP_TAPS,
                      half_width: float = PILOT_BP_HALF_WIDTH,
                      hop: int = 0) -> PilotConfig:
    k = design.bandpass_complex(taps, C.PILOT_FREQUENCY - half_width,
                                C.PILOT_FREQUENCY + half_width, rate)
    H = design.fft_filter_response(k, fft_size).astype(np.complex64)
    # hop: overlap-save stride; defaults to fft_size//2, but must shrink
    # to the receiver's fm_hop for sub-4096 low-latency blocks (and to
    # keep the shared-forward-FFT fusion geometry matched)
    hop = hop or fft_size // 2
    assert hop + taps - 1 <= fft_size
    return PilotConfig(fft_size=fft_size, hop=hop, response=H,
                       group_delay=(taps - 1) // 2, rate=rate)


class PilotState(NamedTuple):
    filt: Array               # fft-filter carry
    lock_metric: Array        # smoothed strength (pilot_Lock equivalent)
    lock_run: Array           # consecutive above-threshold run length


def pilot_zero_state(cfg: PilotConfig) -> PilotState:
    return PilotState(
        filt=fft_filter_zero_state(cfg.fft_size, cfg.hop),
        lock_metric=jnp.asarray(0.0, jnp.float32),
        lock_run=jnp.asarray(0, jnp.int32),
    )


class PilotBlock(NamedTuple):
    phase: Array              # [T] reference-convention pilot phase
    locked: Array             # [T] bool
    strength: Array           # [T] lock strength track


def recover_pilot(demod: Array, cfg: PilotConfig, state: PilotState,
                  shard_axis=None, pre=None) -> Tuple[PilotBlock, PilotState]:
    """Estimate per-sample pilot phase/lock over a block of demod at fmRate.

    With `shard_axis` the bandpass halo rides ppermute and the lock
    metric/counter use the distributed decompositions.

    `pre`, when given, is `(p, filt_tail)` — the analytic pilot signal
    (filter of demod with 5x the config response) and its carry, already
    computed by the caller.  The receiver uses this to share one forward
    FFT of demod between the pilot and RDS bandpasses
    (blockops.fft_filter_apply_multi); the ×5 input gain of the reference
    chain (fm-processor.cpp:695) is folded into the response so the carry
    holds plain demod samples in both paths.
    """
    if pre is not None:
        p, filt = pre
    else:
        from .blockops import fft_filter_apply_multi
        H = 5.0 * jnp.asarray(cfg.response)
        if shard_axis is None:
            ys, filt = fft_filter_apply_multi(demod, H[None, :], cfg.hop,
                                              state.filt)
        else:
            from ..parallel.distributed import dist_fft_filter_multi
            ys, filt = dist_fft_filter_multi(demod, H[None, :], cfg.hop,
                                             state.filt, shard_axis)
        p = ys[0]
    w19 = 2.0 * jnp.pi * C.PILOT_FREQUENCY / cfg.rate
    phase = jnp.angle(p) + (w19 * cfg.group_delay + jnp.pi)
    if shard_axis is None:
        strength, metric_last = ema_apply(jnp.abs(p), C.PILOT_LOCK_ALPHA,
                                          state.lock_metric)
        run, run_last = runlength_true(
            strength > C.PILOT_LOCK_THRESHOLD, state.lock_run)
    else:
        from ..parallel.distributed import dist_ema, dist_runlength
        strength, metric_last = dist_ema(jnp.abs(p), C.PILOT_LOCK_ALPHA,
                                         state.lock_metric, shard_axis)
        run, run_last = dist_runlength(
            strength > C.PILOT_LOCK_THRESHOLD, state.lock_run, shard_axis)
    hold = int(C.PILOT_LOCK_STABLE_S * cfg.rate)
    locked = run > hold
    new = PilotState(filt=filt, lock_metric=metric_last, lock_run=run_last)
    return PilotBlock(phase=phase, locked=locked, strength=strength), new
