"""Core batched block-processing primitives.

The reference receiver advances one sample at a time through stateful C++
objects (`Pass(sample)` chains, src/various/fir-filters.cpp,
fft-filters.cpp).  Here every primitive maps a whole time block `[T]` at once
and threads an explicit, minimal carry so that consecutive blocks stitch
bit-exactly to a single long-array computation:

- FIR / decimating FIR      -> strided convolution over `concat(carry, x)`
                               (carry = last taps-1 inputs, the block analogue
                               of the reference's circular buffer
                               fir-filters.h:80-93)
- fftFilter (overlap-add)   -> overlap-save batched FFT convolution (carry =
                               last F-hop inputs, the analogue of the
                               `Overloop` tail fft-filters.cpp:156-159) with
                               ZERO block latency (the reference delays by
                               fftSize-degree samples; we don't, which removes
                               the need for its RDS_SAMPLE_DELAY phase buffer,
                               fm-processor.h:53)
- one-pole trackers         -> exact first-order linear recurrences via
                               `lax.associative_scan` (parallel prefix), carry
                               = last output
- biquad cascades           -> pole/zero decomposition into complex first-order
                               recurrences, each an associative scan
- lock counters             -> run-length-of-true computed with a cummax
                               trick, carry = run length at block end

Everything is shape-static and jit/scan/shard_map friendly.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# ---------------------------------------------------------------------------
# FIR convolution with explicit left context
# ---------------------------------------------------------------------------


def _conv_valid_real(xp: Array, kernel: Array) -> Array:
    """VALID correlation of real xp [T+K-1] with time-reversed kernel [K].

    Returns y [T] with y[n] = sum_k kernel[k] * xp[n + K-1 - k]  (causal FIR
    once xp = concat(carry, x)).
    """
    k = kernel[::-1].astype(xp.dtype)
    out = jax.lax.conv_general_dilated(
        xp[None, None, :], k[None, None, :],
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)
    return out[0, 0]


def fir_apply(x: Array, kernel: Array, carry: Array) -> Tuple[Array, Array]:
    """Causal FIR over a block.

    x      : [T] float or complex block
    kernel : [K] float or complex taps (kernel[0] multiplies the newest sample)
    carry  : [K-1] previous input samples (zeros at stream start)

    Returns (y [T], new_carry [K-1]).  Matches Basic_FIR::Pass semantics
    (fir-filters.h:80-108) applied T times.
    """
    K = kernel.shape[0]
    xp = jnp.concatenate([carry, x])
    new_carry = xp[-(K - 1):] if K > 1 else carry
    if jnp.iscomplexobj(xp) or jnp.iscomplexobj(kernel):
        y = _conv_complex(xp, kernel, stride=1)
    else:
        y = _conv_valid_real(xp, kernel)
    return y, new_carry


def _conv_complex(xp: Array, kernel: Array, stride: int) -> Array:
    """Strided VALID causal conv for complex data / possibly complex kernel."""
    k = kernel[::-1]
    kr = jnp.real(k).astype(jnp.float32)
    ki = jnp.imag(k).astype(jnp.float32)
    xr = jnp.real(xp).astype(jnp.float32)
    xi = jnp.imag(xp).astype(jnp.float32)
    inp = jnp.stack([xr, xi])[:, None, :]              # [2, 1, T+K-1]

    def conv(w):
        return jax.lax.conv_general_dilated(
            inp, w[None, None, :], window_strides=(stride,), padding="VALID",
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST)[:, 0, :]

    yr_i = conv(kr)                                     # [2, T]
    if jnp.iscomplexobj(kernel):
        yi_i = conv(ki)
        yr = yr_i[0] - yi_i[1]
        yi = yr_i[1] + yi_i[0]
    else:
        yr, yi = yr_i[0], yr_i[1]
    return jax.lax.complex(yr, yi)


def fir_decimate(x: Array, kernel: Array, factor: int,
                 carry: Array) -> Tuple[Array, Array]:
    """Decimating causal FIR over a block (DecimatingFIR::Pass,
    fir-filters.cpp:394-436 — 'the real cpu killer' — as one strided conv).

    x      : [T] with T % factor == 0
    kernel : [K] real or complex taps
    carry  : [K-1] previous inputs
    Returns (y [T//factor], new_carry).

    Alignment matches the reference: its decimation counter emits an output
    when the counter reaches `factor`, i.e. output m is computed at input
    sample m*factor + factor - 1 of the stream.
    """
    K = kernel.shape[0]
    T = x.shape[0]
    assert T % factor == 0, (T, factor)
    xp = jnp.concatenate([carry, x])
    new_carry = xp[-(K - 1):]
    # output m taps xp at [m*factor + factor - 1 + (K-1) - k] for kernel[k];
    # drop the first factor-1 columns so the conv starts at the right phase.
    xp = xp[factor - 1:]
    if jnp.iscomplexobj(xp) or jnp.iscomplexobj(kernel):
        y = _conv_complex(xp, kernel, stride=factor)
    else:
        k = kernel[::-1].astype(xp.dtype)
        y = jax.lax.conv_general_dilated(
            xp[None, None, :], k[None, None, :],
            window_strides=(factor,), padding="VALID",
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST)[0, 0]
    return y, new_carry


def fir_interpolate(x: Array, kernel: Array, factor: int,
                    carry: Array) -> Tuple[Array, Array]:
    """Polyphase interpolation by `factor` (zero-stuff + lowpass, gain
    compensated).  The block-batched equivalent of the reference's
    workingRate->audioRate libsamplerate converter (newconverter.cpp, used
    by sendSampletoOutput for the -m 192 kHz audio mode, main.cpp:57-60).

    kernel length must be a multiple of factor plus 1; carry holds the last
    ceil((K-1)/factor) inputs.
    """
    K = kernel.shape[0]
    phases = (K + factor - 1) // factor          # taps per polyphase branch
    xp = jnp.concatenate([carry, x])
    new_carry = xp[-(phases - 1):] if phases > 1 else carry
    k_pad = jnp.concatenate([kernel, jnp.zeros(phases * factor - K,
                                               kernel.dtype)])
    # branch p uses taps k[p::factor]; y[m*factor + p] = sum_j k[p+j*L] x[m-j]
    outs = []
    for ph in range(factor):
        kp = k_pad[ph::factor]
        if jnp.iscomplexobj(xp) or jnp.iscomplexobj(kp):
            y = _conv_complex(xp, kp, stride=1)
        else:
            y = _conv_valid_real(xp, kp)
        outs.append(y)
    y = jnp.stack(outs, axis=-1).reshape(-1) * factor
    return y, new_carry


def fir_zero_state(kernel_len: int, dtype=jnp.complex64) -> Array:
    return jnp.zeros((kernel_len - 1,), dtype=dtype)


# ---------------------------------------------------------------------------
# Overlap-save FFT fast convolution (the fftFilter equivalent)
# ---------------------------------------------------------------------------


def fft_filter_apply(x: Array, response: Array, hop: int,
                     carry: Array) -> Tuple[Array, Array]:
    """Batched overlap-save convolution of a block with a frozen kernel.

    x        : [T] block, T % hop == 0
    response : [F] complex frequency response of the (degree<=F-hop+1) kernel
    carry    : [F-hop] trailing input samples of the previous block
    Returns (y [T] causal filtered block, new_carry).

    Functional equivalent of fftFilter::Pass (fft-filters.cpp:97-163) without
    the fftSize-degree sample block latency: y[n] here is the causal
    convolution at n.  The real-input variant of the reference multiplies the
    filtered spectrum by 3 (fft-filters.cpp:108-110); that constant gain is
    not reproduced (downstream consumers are gain-invariant).
    """
    F = response.shape[0]
    halo = F - hop
    T = x.shape[0]
    # T may be SMALLER than the halo (low-latency blocks): the carry is
    # simply 'the trailing halo input samples', which xp[-halo:] yields
    # for any T — block-split == whole-array still holds exactly
    assert T % hop == 0, (T, hop, F)
    xp = jnp.concatenate([carry, x])                    # [T + halo]
    new_carry = xp[-halo:]
    nframes = T // hop
    idx = (jnp.arange(nframes) * hop)[:, None] + jnp.arange(F)[None, :]
    frames = xp[idx]                                    # [nframes, F]
    spec = jnp.fft.fft(frames.astype(jnp.complex64), axis=-1)
    out = jnp.fft.ifft(spec * response[None, :], axis=-1)
    y = out[:, halo:].reshape(-1)
    if not jnp.iscomplexobj(x):
        y = jnp.real(y)
    return y, new_carry


def fft_filter_apply_multi(x: Array, responses: Array, hop: int,
                           carry: Array) -> Tuple[Array, Array]:
    """M overlap-save convolutions of ONE block sharing one forward FFT.

    The receiver filters the same demodulated MPX with several frozen
    kernels (19 kHz pilot bandpass + 57 kHz RDS bandpass, the reference's
    separate fftFilter instances fm-processor.cpp:83-86 and pilot chain):
    their forward transform is identical, so batching them shares it — and
    for a real input the forward runs as an rfft (half the points) with the
    negative-frequency half mirrored by conjugate symmetry.

    x         : [T] real or complex block, T % hop == 0
    responses : [M, F] complex frequency responses (degree <= F-hop+1 each)
    carry     : [F-hop] trailing input samples of the previous block
                (complex storage is fine for a real stream; the imaginary
                part must be zero)
    Returns (ys [M, T], new_carry).  Row m matches
    fft_filter_apply(x, responses[m], hop, carry) up to fp rounding of the
    shared forward transform.
    """
    M, F = responses.shape
    halo = F - hop
    T = x.shape[0]
    assert T % hop == 0, (T, hop, F)   # T < halo is fine (see above)
    dt = jnp.result_type(carry.dtype, x.dtype)
    xp = jnp.concatenate([carry.astype(dt), x.astype(dt)])
    new_carry = xp[-halo:]
    nframes = T // hop
    idx = (jnp.arange(nframes) * hop)[:, None] + jnp.arange(F)[None, :]
    frames = xp[idx]                                    # [nframes, F]
    if jnp.iscomplexobj(x):
        spec = jnp.fft.fft(frames.astype(jnp.complex64), axis=-1)
    else:
        r = jnp.fft.rfft(jnp.real(frames).astype(jnp.float32), axis=-1)
        spec = jnp.concatenate([r, jnp.conj(r[:, -2:0:-1])], axis=-1)
    out = jnp.fft.ifft(spec[None, :, :] * responses[:, None, :], axis=-1)
    ys = out[:, :, halo:].reshape(M, T)
    return ys, new_carry


def fft_filter_zero_state(fft_size: int, hop: int, dtype=jnp.complex64) -> Array:
    return jnp.zeros((fft_size - hop,), dtype=dtype)


# ---------------------------------------------------------------------------
# Integer sample delay with carry
# ---------------------------------------------------------------------------


def delay_apply(x: Array, carry: Array) -> Tuple[Array, Array]:
    """Delay a stream by len(carry) samples. Returns (delayed [T], new carry)."""
    d = carry.shape[0]
    if d == 0:
        return x, carry
    xp = jnp.concatenate([carry, x])
    return xp[: x.shape[0]], xp[x.shape[0]:]


# ---------------------------------------------------------------------------
# First-order linear recurrences (one-pole trackers) via associative scan
# ---------------------------------------------------------------------------


def _first_order_combine(a, b):
    (g1, v1), (g2, v2) = a, b
    return g1 * g2, v1 * g2 + v2


def linrec_apply(drive: Array, g, y0) -> Tuple[Array, Array]:
    """y[n] = g[n]*y[n-1] + drive[n], computed with a parallel prefix scan.

    drive : [T] (real or complex)
    g     : scalar or [T] decay(s)
    y0    : scalar initial state (y[-1])
    Returns (y [T], y[T-1]).
    """
    T = drive.shape[0]
    g = jnp.broadcast_to(jnp.asarray(g, drive.dtype), (T,))
    gc, v = jax.lax.associative_scan(_first_order_combine, (g, drive))
    y = v + gc * y0
    return y, y[-1]


def ema_apply(x: Array, alpha: float, y0) -> Tuple[Array, Array]:
    """Exponential moving average y[n] = (1-alpha)*y[n-1] + alpha*x[n].

    The block equivalent of every one-pole tracker in the reference
    (fm_afc/am_carr_ampl fm-demodulator.cpp:128-205, deemphasis
    fm-processor.cpp:593-595, pilot lock metric pilot-recover.cpp:66, RfDC
    fm-processor.cpp:423-427, ...).
    """
    return linrec_apply(alpha * x, 1.0 - alpha, y0)


# ---------------------------------------------------------------------------
# Biquad cascades as complex first-order recurrences
# ---------------------------------------------------------------------------


class IIRSpec:
    """Frozen pole/zero form of a biquad cascade (host-side construction).

    The reference designs Chebyshev/Butterworth cascades and runs them as
    per-sample Direct-Form-II quads (iir-filters.h:71-105).  Here we factor
    the cascade into complex one-pole recurrences (each solved by a parallel
    associative scan) plus a short FIR numerator.
    """

    def __init__(self, sos: np.ndarray):
        from scipy import signal
        sos = np.asarray(sos, dtype=np.float64)
        z, p, k = signal.sos2zpk(sos)
        # SOS padding introduces matched zero/pole pairs at the origin
        # ((z-0)/(z-0) == 1); cancel them before partial fractions.
        z = np.asarray(z, dtype=np.complex128)
        p = np.asarray(p, dtype=np.complex128)
        z0 = np.abs(z) < 1e-12
        p0 = np.abs(p) < 1e-12
        ncancel = min(z0.sum(), p0.sum())
        if ncancel:
            z = np.concatenate([z[~z0], z[z0][: z0.sum() - ncancel]])
            p = np.concatenate([p[~p0], p[p0][: p0.sum() - ncancel]])
        assert not np.any(np.abs(p) < 1e-12), "unmatched pole at origin"
        # numerator as real FIR taps
        b = np.real(np.poly(z)) * k
        self.num = b.astype(np.float32)          # [nz+1]
        # perturb (near-)repeated poles so partial fractions stay finite
        p = np.asarray(p, dtype=np.complex128)
        for i in range(len(p)):
            for j in range(i):
                if abs(p[i] - p[j]) < 1e-9:
                    p[i] += 1e-6 * (1 + 1j)
        self.poles = p.astype(np.complex64)      # [np]
        # residues of 1/prod(1 - p_i z^-1) over the poles
        res = []
        for i, pi in enumerate(p):
            others = np.prod([1.0 - (pj / pi) for j, pj in enumerate(p) if j != i])
            res.append(1.0 / others)
        self.residues = np.asarray(res, dtype=np.complex64)

    def zero_state(self):
        return (jnp.zeros((len(self.poles),), dtype=jnp.complex64),
                jnp.zeros((max(len(self.num) - 1, 0),), dtype=jnp.float32))


def iir_apply(x: Array, spec: IIRSpec, state) -> Tuple[Array, Array]:
    """Apply a biquad cascade to a real block.

    x     : [T] float32
    state : (pole states [P] complex, numerator input history [nz])
    Returns (y [T], new state).  Algebraically identical to scipy.signal
    sosfilt with the same design (fp32 round-off aside).
    """
    wstate, fir_carry = state
    num = jnp.asarray(spec.num)
    poles = jnp.asarray(spec.poles)
    residues = jnp.asarray(spec.residues)
    if num.shape[0] > 1:
        xb, fir_carry = fir_apply(x, num, fir_carry)
    else:
        xb = x * num[0]

    xc = xb.astype(jnp.complex64)

    def pole_scan(w0, p):
        return linrec_apply(xc, p, w0)

    ys, wT = jax.vmap(pole_scan, in_axes=(0, 0))(wstate, poles)   # [P, T]
    y = jnp.real(jnp.sum(residues[:, None] * ys, axis=0))
    return y, (wT, fir_carry)


# ---------------------------------------------------------------------------
# Run-length / lock-counter logic
# ---------------------------------------------------------------------------


def runlength_true(flags: Array, r0) -> Tuple[Array, Array]:
    """Consecutive-true run length ending at each sample, with carry-in r0.

    Vectorises the reference's SampleLockStableCnt pattern
    (pilot-recover.cpp:71-80, stereo-separation.cpp:88-101): the PLL/PSS is
    'locked' at n iff runlength(n) exceeds the hold threshold.
    """
    T = flags.shape[0]
    idx = jnp.arange(T, dtype=jnp.int32)
    last_false = jax.lax.associative_scan(
        jnp.maximum, jnp.where(flags, jnp.int32(-1), idx))
    rl = jnp.where(last_false >= 0, idx - last_false,
                   idx + 1 + jnp.asarray(r0, jnp.int32))
    rl = jnp.where(flags, rl, 0)
    return rl, rl[-1]


# ---------------------------------------------------------------------------
# Phase helpers
# ---------------------------------------------------------------------------


_NCO_BASE = 512  # digit base for int32-safe modular products (base*rate < 2^31)


def _digits3(v, base: int):
    d0 = v % base
    d1 = (v // base) % base
    d2 = v // (base * base)
    return d0, d1, d2


def oscillator_phases(freq_hz, rate: int, n0_mod, count: int) -> Array:
    """Exact integer NCO phase ramp: 2*pi*((f*(n0+i)) mod rate)/rate.

    This is precisely the arithmetic of the reference's table oscillator
    (src/various/oscillator.cpp:49-57 keeps an integer phase index mod rate),
    vectorized without the rate-sized table.  All products are kept below
    2^31 by base-512 digit decomposition so the ramp is exact for unbounded
    stream lengths with x64 disabled — no f32 phase drift, and the phase is a
    pure function of the global sample index (shard-invariant).

    freq_hz : traced int32 scalar (may be negative), |f| < 2^31/2
    rate    : static int sample rate, rate*512 < 2^31
    n0_mod  : traced int32, global block start index mod rate
    count   : static block length
    """
    q = int(rate)
    assert q * _NCO_BASE < 2**31
    f = jnp.asarray(freq_hz, jnp.int32) % q              # into [0, q)
    # c_k = (512^k * f) mod q  (traced scalars)
    c0 = f
    c1 = (c0 * _NCO_BASE) % q
    c2 = (c1 * _NCO_BASE) % q
    # start offset (f * n0) mod q via digit split of n0_mod
    a0, a1, a2 = _digits3(jnp.asarray(n0_mod, jnp.int32) % q, _NCO_BASE)
    start = ((a0 * c0) % q + (a1 * c1) % q) % q
    start = (start + (a2 * c2) % q) % q
    # per-sample ramp
    i = jnp.arange(count, dtype=jnp.int32)
    d0, d1, d2 = _digits3(i, _NCO_BASE)
    t = ((d0 * c0) % q + (d1 * c1) % q) % q
    t = (t + (d2 * c2) % q) % q
    t = (t + start) % q
    return (2.0 * jnp.pi / q) * t.astype(jnp.float32)


def mix_lo(x: Array, freq_hz, rate: int, n0_mod) -> Array:
    """Multiply block by e^{-j 2 pi f n / rate} starting at global index n0.

    Sign convention matches the reference LO (Oscillator::nextValue with a
    *decrementing* phase step, oscillator.cpp:49-57, used at
    fm-processor.cpp:466): a station at +f Hz offset lands at baseband.
    `n0_mod` is the global start index mod rate (carried as
    (n0_mod + T) % rate between blocks).
    """
    ph = oscillator_phases(freq_hz, rate, n0_mod, x.shape[0])
    return x * jax.lax.complex(jnp.cos(ph), -jnp.sin(ph))


def wrap_pi(x: Array) -> Array:
    """Wrap angles to (-pi, pi] (the PI_Constrain equivalent)."""
    return x - 2.0 * jnp.pi * jnp.round(x / (2.0 * jnp.pi))


def rate_map_linear(x: Array, num: int, den: int, n_out: int,
                    carry: Array) -> Tuple[Array, Array]:
    """Linear-interpolation rate conversion: n_out outputs spanning
    n_out*num/den inputs (must be integral — validated by the caller).

    The block equivalent of the reference's device-side mapTable
    converters (airspy-handler.cpp:118-127 builds mapTable_int/_float for
    inputRate -> 2304 samples/ms; the identical scheme appears in the
    hackrf and lime handlers): out[j] lerps between input samples at the
    exact rational position j*num/den.  Positions use integer arithmetic
    (no fp phase accumulation — drift-free for unbounded streams, like
    `oscillator_phases`), and `carry` is the previous block's last input
    sample (the reference's convBuffer[0] hand-over,
    airspy-handler.cpp:299-303), so consecutive blocks stitch exactly.

    x     : [T_in] input block (any dtype; complex64 in the ingest path)
    carry : scalar, same dtype — input sample x[-1] of the previous block
    returns (out [n_out], new carry = x[-1])
    """
    T_in = x.shape[0]
    assert n_out * num == T_in * den, (n_out, num, T_in, den)
    assert n_out * num < 2 ** 31          # int32 position arithmetic
    j = jnp.arange(n_out)
    pos_num = j * num                        # exact: j*num < n_out*num
    base = pos_num // den                    # in [0, T_in-1]
    frac = (pos_num - base * den).astype(jnp.float32) / den
    xx = jnp.concatenate([carry[None], x])   # window spans prev_last..x
    a = xx[base]
    b = xx[base + 1]
    out = a + (b - a) * frac                 # f32*complex promotes
    return out, x[-1]
