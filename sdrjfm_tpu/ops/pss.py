"""Perfect Stereo Separation (PSS) — batched-conv + scalar-scan adaptation.

The reference adapts a phase offset for the reconstructed 38 kHz carrier with
a per-sample Costas criterion whose error signal passes through a 15 kHz
fft-filter *inside* the feedback loop (src/fm/stereo-separation.cpp:60-110,
alpha = 10/fmRate, clamp ±pi/4, x10 boost until converged).  This is the one
loop in the receiver that cannot be flattened into a pure parallel transform
(SURVEY.md §7 "the hard parts").

Block-parallel shape, two steps beyond the naive sub-block port:

1. The offset `acc` moves by <~5e-4 rad/sample, so it is held constant over a
   SUBBLOCK and updated once per sub-block.
2. The filter is linear and the offset enters only as the rotation
   e^{-j acc}, so with F = lowpass(e^{j base} * demod) computed ONCE for the
   whole block (batched conv), the Costas error under rotation is

       err[n] = Re(e^{-j acc} F[n]) * Im(e^{-j acc} F[n])
              = Im(e^{-2j acc} F[n]^2) / 2.

   Per-sub-block error sums and mean-error-EMA weighted sums of F^2 are
   precomputed vectorized; the remaining `lax.scan` is pure scalar math —
   nanoseconds per step instead of a conv per step.

Approximations vs the per-sample reference (all asserted benign in
tests/test_pilot_pss.py against the faithful `reference_scans.pss_scan`):
the filter tail spanning a sub-block boundary uses the new acc for its halo
samples, and the 3 s lock/unlock hysteresis counts in sub-block (21 ms)
granularity.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import design
from .blockops import fir_apply

Array = jax.Array

SUBBLOCK = 4096


class PSSConfig(NamedTuple):
    kernel: np.ndarray        # [295] float32 15 kHz lowpass (PSS_FILTER_DEGREE)
    ema_weights: np.ndarray   # [SUBBLOCK] lockAlpha*(1-lockAlpha)^(S-1-n)
    ema_decay: float          # (1-lockAlpha)^SUBBLOCK
    rate: int
    subblock: int


def make_pss_config(rate: int = C.FM_RATE, subblock: int = SUBBLOCK) -> PSSConfig:
    k = design.lowpass_sinc(C.PSS_FILTER_DEGREE, 15000.0, rate).astype(np.float32)
    lam = 1.0 / rate
    n = np.arange(subblock)
    w = lam * (1.0 - lam) ** (subblock - 1 - n)
    return PSSConfig(kernel=k, ema_weights=w.astype(np.float32),
                     ema_decay=float((1.0 - lam) ** subblock),
                     rate=rate, subblock=subblock)


class PSSState(NamedTuple):
    acc: Array                # accPhaseShift (stereo-separation.cpp:82-85)
    tail: Array               # [294] complex u = e^{j base} demod history
    mean_error: Array
    minimized: Array          # bool: error_minimized
    lock_run: Array           # samples below threshold (consecutive)
    unlock_run: Array


def pss_zero_state(cfg: PSSConfig) -> PSSState:
    return PSSState(
        acc=jnp.asarray(0.0, jnp.float32),
        tail=jnp.zeros(len(cfg.kernel) - 1, jnp.complex64),
        mean_error=jnp.asarray(0.0, jnp.float32),
        minimized=jnp.asarray(False),
        lock_run=jnp.asarray(0, jnp.int32),
        unlock_run=jnp.asarray(0, jnp.int32),
    )


def pss_zero_state_like(st: PSSState) -> PSSState:
    return jax.tree.map(lambda a: jnp.zeros_like(a), st)


def pss_adapt(demod: Array, base_phase: Array, locked: Array,
              cfg: PSSConfig, state: PSSState,
              active: bool = True, shard_axis=None) -> Tuple[Array, PSSState]:
    """Adapt the PSS phase offset over one block.

    demod      : [T] demodulated MPX at fmRate
    base_phase : [T] 2*(pilot_phase + pi/4) — the uncorrected carrier phase
    locked     : [T] pilot lock flags; while unlocked the PSS is held reset
                 (fm-processor.cpp:698-701)
    Returns (per-sample offset `pilotDelayPSS` [T], new state).
    """
    if not active:
        z = jnp.zeros_like(demod)
        return z, state

    T = demod.shape[0]
    S = cfg.subblock
    assert T % S == 0
    nsub = T // S
    alpha = jnp.float32(C.PSS_ALPHA)
    hold = jnp.int32(int(C.PSS_LOCK_STABLE_S * cfg.rate))

    # batched part: filter the rotated-to-baseband L-R band once
    u = jax.lax.complex(jnp.cos(base_phase), jnp.sin(base_phase)) \
        * demod.astype(jnp.float32)
    if shard_axis is None:
        F, tail = fir_apply(u, jnp.asarray(cfg.kernel), state.tail)
    else:
        from ..parallel.distributed import dist_fir
        F, tail = dist_fir(u, jnp.asarray(cfg.kernel), state.tail, shard_axis)
    G = (F * F).reshape(nsub, S)                       # complex
    S_k = jnp.sum(G, axis=1)                           # [nsub]
    W_k = jnp.sum(G * jnp.asarray(cfg.ema_weights)[None, :], axis=1)
    sub_locked = locked.reshape(nsub, S)[:, 0]
    if shard_axis is not None:
        # gather the tiny per-sub-block reductions; the scalar scan then
        # runs replicated (identical on every device).  One packed
        # all_gather instead of three — each extra collective on a 1-D
        # mesh costs a full latency hop (r3 verdict Weak #2); the f32
        # packing is lossless so the scan sees bit-identical inputs.
        packed = jnp.stack([jnp.real(S_k), jnp.imag(S_k),
                            jnp.real(W_k), jnp.imag(W_k),
                            sub_locked.astype(jnp.float32)])
        g = jax.lax.all_gather(packed, shard_axis, axis=1, tiled=True)
        S_k = jax.lax.complex(g[0], g[1])
        W_k = jax.lax.complex(g[2], g[3])
        sub_locked = g[4] > 0.5

    decay = jnp.float32(cfg.ema_decay)

    def step(st: PSSState, inp):
        s_k, w_k, lk = inp
        boost = jnp.where(st.minimized, 1.0, C.PSS_ERROR_BOOST
                          ).astype(jnp.float32)
        rot = jax.lax.complex(jnp.cos(-2.0 * st.acc), jnp.sin(-2.0 * st.acc))
        err_sum = 0.5 * jnp.imag(rot * s_k) * boost
        acc = jnp.clip(st.acc + alpha * err_sum, -C.PSS_CLAMP, C.PSS_CLAMP)
        me = decay * st.mean_error + 0.5 * boost * jnp.imag(rot * w_k)
        below = jnp.abs(me) < C.PSS_LOCK_THRESHOLD
        lock_run = jnp.where(below, st.lock_run + S, 0)
        unlock_run = jnp.where(below, 0, st.unlock_run + S)
        minimized = jnp.where(below, st.minimized | (lock_run > hold),
                              st.minimized & ~(unlock_run > hold))
        new = PSSState(acc=acc, tail=st.tail, mean_error=me,
                       minimized=minimized, lock_run=lock_run,
                       unlock_run=unlock_run)
        # pilot unlock resets the analyzer (fm-processor.cpp:698-701)
        zero = pss_zero_state_like(st)
        new = jax.tree.map(lambda a, b: jnp.where(lk, a, b), new, zero)
        out_acc = jnp.where(lk, st.acc, 0.0)
        return new, out_acc

    scan_state = state._replace(tail=jnp.zeros((0,), jnp.complex64))
    new_state, accs = jax.lax.scan(step, scan_state, (S_k, W_k, sub_locked))
    new_state = new_state._replace(tail=tail)
    if shard_axis is not None:
        # slice this device's segment of the global offset sequence
        idx = jax.lax.axis_index(shard_axis)
        accs = jax.lax.dynamic_slice(accs, (idx * nsub,), (nsub,))
    offsets = jnp.repeat(accs, S)
    return offsets, new_state
