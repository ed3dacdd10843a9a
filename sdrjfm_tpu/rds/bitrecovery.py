"""RDS BPSK bit recovery — block-parallel demodulator for the accelerator.

The reference offers three per-sample bit decoders at 24 kS/s
(src/rds/rds-decoder-1/2/3.cpp: cuteSDR peak-slope, tomneda M&M + Costas,
Feilen clock-correlation).  All three are sequential sample loops; this
module is the block-parallel fourth design ("block" mode) built from their
ingredients but fully vectorised:

  matched filter : decoder-2's complex RRC, Ts = 1/(2*1187.5), 45 taps
                   (rds-decoder-2.cpp:63-69) as a batched conv
  carrier phase  : per-sub-block BPSK squared-signal estimate
                   psi = angle(mean(y^2))/2 with continuity unwrap — the
                   block equivalent of the shared Costas loop
                   (rds-decoder.cpp:40-41)
  bit timing     : the bit clock is exactly 384/19 samples at 24 kHz
                   (1187.5 = 19000/16 is pilot-locked); a per-block energy
                   maximisation over fractional offsets replaces decoder-2's
                   Mueller&Muller recursion, and the bit grid is sampled by
                   linear-interpolation gather
  differential   : b[k] = s[k] XOR s[k-1]   (all three reference decoders)

The per-sample reference decoders are also available as scan-based
compatibility modes in rds/scan_decoders.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..ops import design
from ..ops.blockops import fir_apply

Array = jax.Array

SPS_NUM = 384                 # samples per bit = 384/19 at 24 kHz
SPS_DEN = 19
SPS = SPS_NUM / SPS_DEN
PHASE_SUB = 2048              # default carrier-phase sub-block (~101 bits)
PHASE_SUB_MIN = 512           # low-latency floor (~25 bits; squared-BPSK
                              # phase over 25 bits is still well-averaged)
TIMING_GRID = 64              # fractional-offset candidates over one bit


class BitRecoveryConfig(NamedTuple):
    mf_taps: np.ndarray       # [45] float32 RRC matched filter
    rate: int
    phase_sub: int = PHASE_SUB


def make_bitrecovery_config(rate: int = C.RDS_RATE,
                            phase_sub: int = PHASE_SUB) -> BitRecoveryConfig:
    """phase_sub: carrier-phase estimation sub-block.  2048 (~101 bits) by
    default; small-block (low-latency) receivers shrink it to their
    block_rds, floor 512 — the reference's engine granularity is 16384
    input samples ~= 7 ms (fm-processor.cpp:388), and a 512-sample RDS
    grid admits block_fm=4096 ~= 21 ms of accumulation."""
    assert phase_sub >= PHASE_SUB_MIN and phase_sub % 2 == 0, phase_sub
    taps = design.root_raised_cosine(1.0, rate, 2 * C.RDS_BITCLK_HZ, 1.0, 45)
    return BitRecoveryConfig(mf_taps=taps.astype(np.float32), rate=rate,
                             phase_sub=phase_sub)


class BitRecoveryState(NamedTuple):
    mf_carry: Array           # [44] complex matched-filter history
    psi: Array                # carrier phase estimate (continuity anchor)
    tau: Array                # fractional position of the next bit centre
    prev_sym: Array           # last hard symbol (for differential decode)
    timing_locked: Array      # False until the first block-level acquisition
    last_iq: Array            # last emitted constellation point (the
                              # reference's static magCplx hold across
                              # calls, fm-processor.cpp:554-573)


def bitrecovery_zero_state(cfg: BitRecoveryConfig) -> BitRecoveryState:
    return BitRecoveryState(
        mf_carry=jnp.zeros(len(cfg.mf_taps) - 1, jnp.complex64),
        psi=jnp.asarray(0.0, jnp.float32),
        tau=jnp.asarray(0.0, jnp.float32),
        prev_sym=jnp.asarray(False),
        timing_locked=jnp.asarray(False),
        last_iq=jnp.asarray(0.0 + 0.0j, jnp.complex64),
    )


class BitBlock(NamedTuple):
    bits: Array               # [capacity] int8 differential-decoded bits
    valid: Array              # [capacity] bool
    count: Array              # number of valid bits
    iq: Array                 # [capacity] complex constellation samples


def bit_capacity(block_len: int) -> int:
    return int(np.ceil(block_len / SPS)) + 2


def recover_bits(z: Array, cfg: BitRecoveryConfig,
                 state: BitRecoveryState
                 ) -> Tuple[BitBlock, Array, BitRecoveryState]:
    """Demodulate one block of RDS baseband (24 kS/s complex) into bits.

    Returns (BitBlock, demod24, new_state); demod24 is the 24 kHz
    "decoder output view" — each sample holds the most recently emitted
    constellation point, the block equivalent of the reference's static
    magCplx driving the ELfPlot::RDS_DEMOD scope tap
    (fm-processor.cpp:554-573, fm-processor.h:84-86)."""
    T = z.shape[0]
    phase_sub = cfg.phase_sub
    assert T % phase_sub == 0, (T, phase_sub)
    taps = jnp.asarray(cfg.mf_taps)
    y, mf_carry = fir_apply(z, taps, state.mf_carry)

    # --- carrier phase: squared-BPSK estimate per sub-block, continuity-
    # unwrapped against the carried estimate ----------------------------------
    nsub = T // phase_sub
    y2 = (y * y).reshape(nsub, phase_sub)
    raw = 0.5 * jnp.angle(jnp.mean(y2, axis=1))          # psi mod pi

    def unwrap(prev, r):
        k = jnp.round((prev - r) / jnp.pi)
        psi = r + k * jnp.pi
        return psi, psi

    psi_last, psi_seq = jax.lax.scan(unwrap, state.psi, raw)
    psi_full = jnp.repeat(psi_seq, phase_sub)
    yr = y * jax.lax.complex(jnp.cos(psi_full), -jnp.sin(psi_full))

    # --- bit timing: energy over candidate fractional offsets ---------------
    # E(tau) = sum_k |yr(tau + k*SPS)|^2, tau in [0, SPS) on a TIMING_GRID.
    nbits_probe = int(T // SPS) - 1
    k = jnp.arange(nbits_probe, dtype=jnp.float32)
    offs = (jnp.arange(TIMING_GRID, dtype=jnp.float32) / TIMING_GRID) * SPS
    pos = offs[:, None] + k[None, :] * SPS               # [G, nbits]
    e = jnp.abs(_interp_linear(yr, pos)) ** 2
    energy = jnp.sum(e, axis=1)
    tau_best = offs[jnp.argmax(energy)]
    # acquisition: first block snaps to the estimate; afterwards the
    # carried timing slews toward the per-block estimate at a rate that is
    # constant per BIT (not per block): a 25-bit low-latency block has a
    # noisy estimate, so it gets a proportionally tighter clamp — the same
    # drift-tracking bandwidth per second at every block size (validated
    # to track the independent-capture oracle's ~80 ppm clock offset with
    # zero CRC errors at block_rds 512..16384)
    dt = tau_best - jnp.mod(state.tau, SPS)
    dt = dt - SPS * jnp.round(dt / SPS)                  # wrap to ±SPS/2
    # capped at ONE grid step so large blocks keep the originally
    # validated clamp — the per-bit scaling only TIGHTENS small blocks
    max_step = (SPS / TIMING_GRID) * min(1.0, nbits_probe / 190.0)
    # continue the carried bit grid (state.tau is the next bit's position
    # relative to this block's start), slewing by at most one grid step
    tracked = state.tau + jnp.clip(dt, -max_step, max_step)
    tau0 = jnp.where(state.timing_locked, tracked, tau_best)

    # --- sample the bit grid -------------------------------------------------
    capacity = bit_capacity(T)
    bk = jnp.arange(capacity, dtype=jnp.float32)
    bit_pos = tau0 + bk * SPS
    valid = bit_pos <= (T - 2)
    sym = _interp_linear(yr, jnp.clip(bit_pos, 0.0, T - 2))
    hard = jnp.real(sym) >= 0.0

    prev = jnp.concatenate([state.prev_sym[None], hard[:-1]])
    bits = (hard ^ prev).astype(jnp.int8)

    count = jnp.sum(valid.astype(jnp.int32))
    last_idx = count - 1
    prev_sym_last = hard[last_idx]
    # position of the next bit relative to the next block's start
    tau_next = tau0 + count.astype(jnp.float32) * SPS - T

    # --- RDS_DEMOD view: sample-hold of the last emitted point ---------------
    sym4 = sym * 4.0
    t = jnp.arange(T, dtype=jnp.float32)
    j = jnp.floor((t - tau0) / SPS).astype(jnp.int32)    # last bit at/before t
    j = jnp.minimum(j, count - 1)
    held = sym4[jnp.clip(j, 0, capacity - 1)]
    demod24 = jnp.where(j < 0, state.last_iq, held)
    last_iq = jnp.where(count > 0, sym4[jnp.clip(count - 1, 0, capacity - 1)],
                        state.last_iq)

    new = BitRecoveryState(mf_carry=mf_carry, psi=psi_last, tau=tau_next,
                           prev_sym=prev_sym_last,
                           timing_locked=jnp.asarray(True),
                           last_iq=last_iq)
    blk = BitBlock(bits=bits, valid=valid, count=count, iq=sym4)
    return blk, demod24, new


def _interp_linear(y: Array, pos: Array) -> Array:
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - i0.astype(jnp.float32)).astype(jnp.float32)
    a = y[i0]
    b = y[i0 + 1]
    return a + (b - a) * frac
