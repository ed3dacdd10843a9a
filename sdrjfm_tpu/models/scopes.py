"""Spectrum / waterfall / constellation computation — the scopes, headless.

The reference renders HF/LF spectra, a waterfall, and the RDS IQ
constellation with Qt/Qwt (src/scopes-qwt6/, SURVEY.md C4-C7).  This
framework computes the same displays as arrays for file export or downstream
UIs:

  hf_spectrum  : windowed segment FFT of the raw input, bin-averaged to
                 display size, exponentially averaged over frames
                 (hs-scope.cpp:96-203)
  lf_spectrum  : same machinery on a selectable tap of the chain
                 (ls-scope.cpp:76-192; tap selection = ELfPlot,
                 fm-processor.h:84-86 — here the receiver's emit_taps dict)
  waterfall    : stacked per-block spectra
  iq_points    : decimated RDS constellation samples (iqdisplay.cpp:32-79)
"""

from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

Window = Literal["hann", "blackman"]


def _window(n: int, kind: Window = "blackman") -> jnp.ndarray:
    i = jnp.arange(n)
    if kind == "hann":
        return 0.5 - 0.5 * jnp.cos(2 * jnp.pi * i / (n - 1))
    return (0.42 - 0.5 * jnp.cos(2 * jnp.pi * i / (n - 1))
            + 0.08 * jnp.cos(4 * jnp.pi * i / (n - 1)))


def spectrum(x: jnp.ndarray, display_size: int = 512,
             window: Window = "blackman", average: float = 0.5,
             prev: jnp.ndarray | None = None):
    """Averaged power spectrum of a block, fftshifted, bin-averaged down to
    display_size (the hs-scope recipe: segments of 4*displaySize)."""
    seg = 4 * display_size
    n = (x.shape[0] // seg) * seg
    frames = x[:n].reshape(-1, seg) * _window(seg, window)[None, :]
    spec = jnp.abs(jnp.fft.fftshift(jnp.fft.fft(frames, axis=-1),
                                    axes=-1)) ** 2
    spec = spec.mean(axis=0)
    binned = spec.reshape(display_size, 4).mean(axis=-1)
    if prev is not None:
        binned = average * prev + (1.0 - average) * binned
    return binned


def spectrum_db(x, display_size: int = 512, **kw):
    p = spectrum(x, display_size, **kw)
    return 10.0 * jnp.log10(jnp.maximum(p, 1e-20))


def map_spectrum(bins: jnp.ndarray, display_size: int, zoom_factor: int = 1,
                 show_full: bool = True):
    """The LF scope's display fold (ls_scope::mapSpectrum,
    ls-scope.cpp:131-176): amplitude bins averaged `factor` at a time into
    the display, with the zoom factor narrowing the folded span.  Reference
    quirks preserved: `factor /= 2` is unconditional (the half-spectrum
    branch is commented out upstream), and a too-large zoom is clamped to
    the available factor.  Full mode maps DC..+f up from mid-display and
    the top bins (negative frequencies) mirrored below mid.

    Returns (display [display_size], effective_zoom).
    """
    mag = jnp.abs(bins)
    n = mag.shape[-1]
    factor = n // display_size
    factor //= 2
    if factor // max(zoom_factor, 1) >= 1:
        factor //= zoom_factor
        eff_zoom = zoom_factor
    else:
        eff_zoom = factor
        factor = 1
    if show_full:
        half = display_size // 2
        up = mag[: half * factor].reshape(half, factor).mean(-1)
        rev = mag[::-1][: half * factor].reshape(half, factor).mean(-1)
        out = jnp.concatenate([rev[::-1], up])
    else:
        out = mag[: display_size * factor].reshape(display_size,
                                                   factor).mean(-1)
    return out, eff_zoom


def lf_spectrum(x: jnp.ndarray, sample_rate: float, display_size: int = 512,
                zoom_factor: int = 1, show_full: bool = True,
                window: Window = "blackman"):
    """LF scope spectrum (ls_scope::processLFSpectrum, ls-scope.cpp:76-128):
    windowed FFT of 4*display_size segments, amplitude-averaged across
    segments, folded through `map_spectrum`.  Returns
    (x_axis_khz [display_size], amplitudes [display_size], effective_zoom)
    — the x axis follows the reference's labeling (±rate/2/zoom for full,
    0..rate/2/zoom for half, ls-scope.cpp:106-120).
    """
    seg = 4 * display_size
    n = (x.shape[0] // seg) * seg
    frames = x[:n].reshape(-1, seg) * _window(seg, window)[None, :]
    bins = jnp.abs(jnp.fft.fft(frames, axis=-1)).mean(axis=0)
    out, eff_zoom = map_spectrum(bins, display_size, zoom_factor, show_full)
    temp = sample_rate / 2.0 / display_size
    i = np.arange(display_size)
    if show_full:
        xa = (-(sample_rate / 2.0) + 2 * i * temp) / 1000.0 / eff_zoom
    else:
        xa = (i * temp) / 1000.0 / eff_zoom
    return xa, out, eff_zoom


def waterfall(blocks_spectra: np.ndarray) -> np.ndarray:
    """Stack per-block spectra [n_blocks, display] into a waterfall image."""
    return np.stack(blocks_spectra, axis=0)


def iq_constellation(iq_points: np.ndarray, extent: float = 2.0,
                     grid: int = 101) -> np.ndarray:
    """Histogram RDS symbols onto the reference's 101x101 display grid."""
    img = np.zeros((grid, grid), np.float32)
    pts = np.clip((np.stack([iq_points.real, iq_points.imag], -1) / extent
                   + 0.5) * (grid - 1), 0, grid - 1).astype(np.int32)
    np.add.at(img, (pts[:, 1], pts[:, 0]), 1.0)
    return img
