"""Faithful per-sample re-implementations of the reference's feedback loops.

These are `lax.scan` translations of the *semantics* (not the code) of the
reference's recursive components.  They are far too sequential to be the device
fast path; their role is:

  1. validation oracles — tests assert the fast block-parallel estimators in
     ops/pilot.py / ops/pss.py / rds/bitrecovery.py agree with these within
     the documented tolerances;
  2. selectable compatibility algorithms for small offline runs.

Semantics sources:
  pilot_pll_scan  : src/fm/pilot-recover.cpp:54-83
  pss_scan        : src/fm/stereo-separation.cpp:60-110
  pll_scan        : src/various/pllC.cpp:67-90
  costas_scan     : includes/various/costas.h:21-33
  agc_scan        : includes/various/agc.h:13-18
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C

Array = jax.Array


def wrap_2pi_ref(x):
    """PI_Constrain-equivalent wrap into (-pi, pi]."""
    return x - 2.0 * jnp.pi * jnp.round(x / (2.0 * jnp.pi))


class PilotPLLState(NamedTuple):
    osc_phase: Array
    old_value: Array
    lock: Array
    locked: Array
    stable_cnt: Array


def pilot_pll_zero_state() -> PilotPLLState:
    f = jnp.float32
    return PilotPLLState(jnp.asarray(0, f), jnp.asarray(0, f),
                         jnp.asarray(0, f), jnp.asarray(False),
                         jnp.asarray(0, jnp.int32))


def pilot_pll_scan(pilot_signal: Array, state: PilotPLLState,
                   rate: int = C.FM_RATE,
                   omega: float = C.OMEGA_PILOT,
                   gain: float = C.PILOT_PLL_GAIN):
    """Per-sample pilot PLL (pilotRecovery::getPilotPhase).

    pilot_signal is the already-scaled input (the engine passes 5*demod,
    fm-processor.cpp:695-696).  Returns (phase [T], locked [T], lock_strength
    [T], new state).
    """
    alpha = 1.0 / 3000.0
    hold = rate >> 1

    def step(st: PilotPLLState, pilot):
        osc = jnp.sin(st.osc_phase)
        err = pilot * osc
        ph = st.osc_phase + err * gain
        current = wrap_2pi_ref(ph)
        ph = wrap_2pi_ref(ph + omega)
        quad_ref = (osc - st.old_value) / omega
        lock = alpha * (-quad_ref * pilot) + st.lock * (1.0 - alpha)
        tmp = lock > C.PILOT_LOCK_THRESHOLD
        cnt = jnp.where(tmp, st.stable_cnt + 1, 0)
        locked = tmp & (st.locked | (cnt > hold))
        new = PilotPLLState(ph, osc, lock, locked, cnt)
        return new, (current, locked, lock)

    state, (phase, locked, strength) = jax.lax.scan(step, state, pilot_signal)
    return phase, locked, strength, state


class PSSScanState(NamedTuple):
    acc: Array
    buf: Array                # [294] complex FIR history of the 15k lowpass
    mean_error: Array
    minimized: Array
    lock_cnt: Array
    unlock_cnt: Array


def pss_scan_zero_state(klen: int) -> PSSScanState:
    f = jnp.float32
    return PSSScanState(jnp.asarray(0, f), jnp.zeros(klen - 1, jnp.complex64),
                        jnp.asarray(0, f), jnp.asarray(False),
                        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))


def pss_scan(demod: Array, base_phase: Array, kernel: Array,
             state: PSSScanState, rate: int = C.FM_RATE):
    """Per-sample PSS (PerfectStereoSeparation::process_sample) with the
    fft-filter replaced by the equivalent time-domain FIR of its kernel."""
    alpha = jnp.float32(C.PSS_ALPHA)
    lock_alpha = jnp.float32(1.0 / rate)
    hold = jnp.int32(3 * rate)
    klen = kernel.shape[0]

    def step(st: PSSScanState, inp):
        d, bp = inp
        phase = bp - st.acc
        mixed = jax.lax.complex(jnp.cos(phase), jnp.sin(phase)) * d
        buf = jnp.concatenate([st.buf, mixed[None]])
        filt = jnp.sum(buf * kernel[::-1])
        err = jnp.real(filt) * jnp.imag(filt)
        err = jnp.where(st.minimized, err, err * C.PSS_ERROR_BOOST)
        acc = jnp.clip(st.acc + alpha * err, -C.PSS_CLAMP, C.PSS_CLAMP)
        me = lock_alpha * err + st.mean_error * (1.0 - lock_alpha)
        below = jnp.abs(me) < C.PSS_LOCK_THRESHOLD
        lock_cnt = jnp.where(below, st.lock_cnt + 1, 0)
        unlock_cnt = jnp.where(below, 0, st.unlock_cnt + 1)
        minimized = jnp.where(below, st.minimized | (lock_cnt > hold),
                              st.minimized & ~(unlock_cnt > hold))
        new = PSSScanState(acc, buf[1:], me, minimized, lock_cnt, unlock_cnt)
        return new, st.acc

    state, accs = jax.lax.scan(step, state, (demod, base_phase))
    return accs, state


def pll_scan(z: Array, rate: int, cf: float, lofreq: float, hifreq: float,
             bandwidth: float, phase0=0.0, incr0=0.0):
    """Generic complex PLL (pllC::do_pll)."""
    fac = 2.0 * jnp.pi / rate
    beta = jnp.exp(-2.0 * jnp.pi * bandwidth / 2.0 / rate)
    lo, hi = lofreq * fac, hifreq * fac

    def step(st, zi):
        ph, incr = st
        nco = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
        d = jnp.conj(nco) * zi
        err = jnp.arctan2(jnp.imag(d), jnp.real(d))
        incr = (1.0 - beta) * err + beta * incr
        incr = jnp.where((incr < lo) | (incr > hi), cf * fac, incr)
        ph = jnp.mod(ph + incr, 2.0 * jnp.pi)
        return (ph, incr), (incr, err)

    (phase, incr), (incrs, errs) = jax.lax.scan(
        step, (jnp.asarray(phase0, jnp.float32), jnp.asarray(incr0, jnp.float32)), z)
    return incrs, errs, (phase, incr)


def costas_scan(z: Array, rate: float, alpha: float, beta: float,
                freq_limit_hz: float, freq0=0.0, phase0=0.0):
    """2nd-order Costas loop (costas.h:21-33). Returns (rotated z, state)."""
    limit = 2.0 * jnp.pi * freq_limit_hz / rate

    def step(st, zi):
        freq, phase = st
        r = zi * jax.lax.complex(jnp.cos(phase), -jnp.sin(phase))
        err = jnp.real(r) * jnp.imag(r)
        freq = freq + beta * err
        freq = jnp.where(jnp.abs(freq) > limit, 0.0, freq)
        phase = wrap_2pi_ref(phase + freq + alpha * err)
        return (freq, phase), r

    st0 = (jnp.asarray(freq0, jnp.float32), jnp.asarray(phase0, jnp.float32))
    st, out = jax.lax.scan(step, st0, z)
    return out, st


def agc_scan(z: Array, adj_rate: float, ref_level: float, gain0=1.0):
    """1-tap gain servo (agc.h:13-18). Returns (scaled z, final gain)."""
    def step(g, zi):
        out = zi * g
        g = g + adj_rate * (ref_level - jnp.abs(out))
        return g, out

    g, out = jax.lax.scan(step, jnp.asarray(gain0, jnp.float32), z)
    return out, g
