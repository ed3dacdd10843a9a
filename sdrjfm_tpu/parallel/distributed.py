"""Distributed building blocks for sharding the fm-rate chain.

These are the shard_map-side equivalents of the core recurrences in
ops/blockops.py, for use inside a 1-D `time` mesh (SCALING.md roadmap):

  dist_fir / dist_fir_decimate : convolution with a ppermute left halo
  dist_linrec                  : y[n] = g*y[n-1] + d[n] across devices —
                                 local prefix scan + all-gathered
                                 (g^T_local, y_free_last) pairs folded in a
                                 fixed order on every device (deterministic
                                 for a given mesh size)
  dist_runlength               : consecutive-true run length across devices
                                 via all-gathered (all_true, end_run) pairs

Each helper is written to be called INSIDE shard_map over axis `axis`; unit
tests (tests/test_distributed.py) assert equality with the single-device
primitives on an 8-way CPU mesh.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import blockops as B

Array = jax.Array


def left_halo(x_local: Array, halo_len: int, first_carry: Array,
              axis: str) -> Array:
    """Tail of the left ring neighbour; device 0 takes `first_carry`."""
    n = jax.lax.axis_size(axis)
    tail = x_local[-halo_len:]
    left = jax.lax.ppermute(tail, axis, perm=[(i, i + 1) for i in range(n - 1)])
    idx = jax.lax.axis_index(axis)
    return jnp.where(idx == 0, first_carry, left)


def dist_fir(x_local: Array, kernel: Array, stream_carry: Array,
             axis: str) -> Tuple[Array, Array]:
    """Sharded causal FIR; returns (y_local, candidate tail).

    The *stream* carry for the next block is the last device's tail — the
    caller gathers tails (or slices the global input) to update state.
    """
    halo = left_halo(x_local, kernel.shape[0] - 1, stream_carry, axis)
    y, tail = B.fir_apply(x_local, kernel, halo)
    return y, tail


def dist_fir_decimate(x_local: Array, kernel: Array, factor: int,
                      stream_carry: Array, axis: str) -> Tuple[Array, Array]:
    halo = left_halo(x_local, kernel.shape[0] - 1, stream_carry, axis)
    y, tail = B.fir_decimate(x_local, kernel, factor, halo)
    return y, tail


def dist_fft_filter(x_local: Array, response: Array, hop: int,
                    stream_carry: Array, axis: str) -> Tuple[Array, Array]:
    halo_len = response.shape[0] - hop
    halo = left_halo(x_local, halo_len, stream_carry, axis)
    y, tail = B.fft_filter_apply(x_local, response, hop, halo)
    return y, tail


def dist_fft_filter_multi(x_local: Array, responses: Array, hop: int,
                          stream_carry: Array, axis: str
                          ) -> Tuple[Array, Array]:
    """Sharded shared-forward-FFT filter bank (fft_filter_apply_multi).

    One ppermute halo of the shared input serves every response; returns
    (ys_local [M, T_local], candidate tail)."""
    halo_len = responses.shape[1] - hop
    halo = left_halo(x_local.astype(stream_carry.dtype), halo_len,
                     stream_carry, axis)
    return B.fft_filter_apply_multi(x_local, responses, hop, halo)


def dist_linrec(drive_local: Array, g: float, y0, axis: str
                ) -> Tuple[Array, Array]:
    """First-order recurrence across the mesh.

    y[n] = g*y[n-1] + drive[n] over the concatenated stream; y0 is the
    stream state entering device 0.  Returns (y_local, y_final) where
    y_final (the stream carry) is identical on every device.

    Decomposition: with local free response f (zero entry state) and
    G = g^T_local, the entry state of device d is
        c_d = G^d * y0 + sum_{k<d} G^(d-1-k) * f_k[-1]
    computed identically on every device from the all-gathered pairs, then
    y_local = f + g^(n+1) * c_d.
    """
    T = drive_local.shape[0]
    y_free, _ = B.linrec_apply(drive_local, g, jnp.zeros((), drive_local.dtype))
    G = jnp.asarray(g, drive_local.dtype) ** T
    last = y_free[-1]
    lasts = jax.lax.all_gather(last, axis)            # [P]
    P = lasts.shape[0]

    def fold(c, k):
        return c * G + lasts[k], None

    idx = jax.lax.axis_index(axis)
    # entry state for THIS device: fold predecessors 0..idx-1
    def body(k, c):
        return jnp.where(k < idx, c * G + lasts[k], c)

    c_d = jax.lax.fori_loop(0, P, body,
                            jnp.asarray(y0, drive_local.dtype))
    decay = jnp.asarray(g, drive_local.dtype) ** (
        jnp.arange(1, T + 1, dtype=jnp.float32).astype(
            jnp.float32 if drive_local.dtype != jnp.complex64 else jnp.float32))
    decay = decay.astype(drive_local.dtype)
    y_local = y_free + decay * c_d

    def body_all(k, c):
        return c * G + lasts[k]

    y_final = jax.lax.fori_loop(0, P, body_all,
                                jnp.asarray(y0, drive_local.dtype))
    return y_local, y_final


def dist_ema(x_local: Array, alpha: float, y0, axis: str):
    return dist_linrec(alpha * x_local, 1.0 - alpha, y0, axis)


def _linrec_finish(y_free: Array, g, y0, lasts: Array, axis: str):
    """Entry-state fold shared by dist_linrec/dist_linrec2: given the local
    free response and the gathered per-device last free samples [P],
    return (y_local, y_final) exactly as dist_linrec computes them."""
    T = y_free.shape[0]
    G = jnp.asarray(g, y_free.dtype) ** T
    P = lasts.shape[0]
    idx = jax.lax.axis_index(axis)

    def body(k, c):
        return jnp.where(k < idx, c * G + lasts[k], c)

    c_d = jax.lax.fori_loop(0, P, body, jnp.asarray(y0, y_free.dtype))
    # same power expression as dist_linrec (f32 exponent) so the two paths
    # round identically
    decay = jnp.asarray(g, y_free.dtype) ** jnp.arange(
        1, T + 1, dtype=jnp.float32)
    decay = decay.astype(y_free.dtype)
    y_local = y_free + decay * c_d

    def body_all(k, c):
        return c * G + lasts[k]

    y_final = jax.lax.fori_loop(0, P, body_all,
                                jnp.asarray(y0, y_free.dtype))
    return y_local, y_final


def dist_linrec2(d1: Array, g1: float, y01, d2: Array, g2: float, y02,
                 axis: str):
    """TWO independent first-order recurrences sharing ONE all_gather.

    Equivalent to (dist_linrec(d1,g1,y01), dist_linrec(d2,g2,y02)) —
    bit-identical, the gather just carries both last-free-samples in one
    packed [P, 2] matrix (collective budget: each extra sub-KB gather on a
    1-D mesh is a full latency hop).  Returns ((y1, f1), (y2, f2))."""
    z1 = jnp.zeros((), d1.dtype)
    z2 = jnp.zeros((), d2.dtype)
    y1_free, _ = B.linrec_apply(d1, g1, z1)
    y2_free, _ = B.linrec_apply(d2, g2, z2)
    lasts = jax.lax.all_gather(jnp.stack([y1_free[-1], y2_free[-1]]),
                               axis)                      # [P, 2]
    r1 = _linrec_finish(y1_free, g1, y01, lasts[:, 0], axis)
    r2 = _linrec_finish(y2_free, g2, y02, lasts[:, 1], axis)
    return r1, r2


def dist_ema2(x1: Array, a1: float, y01, x2: Array, a2: float, y02,
              axis: str):
    """Two independent EMAs sharing one gather (see dist_linrec2)."""
    return dist_linrec2(a1 * x1, 1.0 - a1, y01, a2 * x2, 1.0 - a2, y02,
                        axis)


def dist_linrec_multi(drive_local: Array, gs: Array, y0s: Array,
                      axis: str) -> Tuple[Array, Array]:
    """P first-order recurrences sharing one drive, across the mesh.

    y_p[n] = gs[p] * y_p[n-1] + drive[n]; y0s [P] enters device 0.
    Returns (y_local [P, T_local], y_final [P] replicated).  The batched
    cousin of `dist_linrec`, used for the pole bank of a sharded IIR
    cascade (blockops.IIRSpec poles are complex one-pole recurrences).
    """
    T = drive_local.shape[0]
    gs = jnp.asarray(gs, drive_local.dtype)

    def one(g):
        y, _ = B.linrec_apply(drive_local, g,
                              jnp.zeros((), drive_local.dtype))
        return y

    y_free = jax.vmap(one)(gs)                          # [P, T]
    # exact cumulative decay (same multiplication tree as linrec_apply's
    # prefix product, so the entry-state term rounds identically)
    decay = jax.lax.associative_scan(
        jnp.multiply, jnp.broadcast_to(gs[:, None], y_free.shape), axis=1)
    G = decay[:, -1]                                    # gs^T
    lasts = jax.lax.all_gather(y_free[:, -1], axis)     # [D, P]
    Dn = lasts.shape[0]
    idx = jax.lax.axis_index(axis)
    c0 = jnp.asarray(y0s, drive_local.dtype)

    def body(k, c):
        return jnp.where(k < idx, c * G + lasts[k], c)

    c_d = jax.lax.fori_loop(0, Dn, body, c0)            # entry state [P]
    y_local = y_free + decay * c_d[:, None]

    def body_all(k, c):
        return c * G + lasts[k]

    y_final = jax.lax.fori_loop(0, Dn, body_all, c0)
    return y_local, y_final


def dist_iir(x_local: Array, spec, state, axis: str):
    """Sharded biquad cascade (blockops.iir_apply on a time mesh).

    The numerator FIR takes a ppermute halo; the pole bank runs through the
    distributed prefix decomposition.  Returned state is fully replicated
    (pole states by construction, FIR history resolved to the stream tail),
    so it can be threaded directly as the next block's carry.
    """
    wstate, fir_carry = state
    num = jnp.asarray(spec.num)
    if num.shape[0] > 1:
        xb, tail_cand = dist_fir(x_local, num, fir_carry, axis)
        fir_tail = jax.lax.all_gather(tail_cand, axis)[-1]
    else:
        xb = x_local * num[0]
        fir_tail = fir_carry
    xc = xb.astype(jnp.complex64)
    ys, wT = dist_linrec_multi(xc, jnp.asarray(spec.poles), wstate, axis)
    y = jnp.real(jnp.sum(jnp.asarray(spec.residues)[:, None] * ys, axis=0))
    return y, (wT, fir_tail)


def dist_fir_interpolate(x_local: Array, kernel: Array, factor: int,
                         stream_carry: Array, axis: str
                         ) -> Tuple[Array, Array]:
    """Sharded polyphase interpolation; returns (y_local, candidate tail).

    Each device emits factor*T_local outputs, so the concatenation over the
    mesh is the global interpolated stream.  Caller resolves the stream
    carry to the last device's tail.
    """
    K = kernel.shape[0]
    phases = (K + factor - 1) // factor
    if phases > 1:
        halo = left_halo(x_local, phases - 1, stream_carry, axis)
    else:
        halo = stream_carry
    return B.fir_interpolate(x_local, kernel, factor, halo)


def pack_f32(arrays):
    """Flatten mixed float32/complex64/bool/int arrays into one f32 vector.

    Returns (packed [total], specs) for `unpack_rows`.  Complex is stored
    as separate real/imag runs (lossless — complex64 is two f32); bool and
    int32 are value-cast (exact for the small counters packed here).  Used
    to fuse many small per-device collectives into ONE all_gather: on a
    1-D mesh every extra collective costs a full latency hop, and the
    fully-sharded step used to issue ~12 distinct sub-KB gathers per block
    (tests/test_collective_budget.py now pins the count).
    """
    flats, specs = [], []
    for a in arrays:
        if jnp.iscomplexobj(a):
            flats += [jnp.real(a).ravel(), jnp.imag(a).ravel()]
        else:
            flats.append(a.astype(jnp.float32).ravel())
        specs.append((a.shape, a.dtype, int(a.size)))
    return jnp.concatenate(flats), specs


def unpack_rows(g: Array, specs):
    """Invert `pack_f32` on a gathered [n_devices, total] matrix.

    Returns a list of [n_devices, *shape] arrays in the original dtypes;
    row d holds device d's values, so `rows[-1]` is the stream tail,
    `rows.max(0)` a cross-device max, and `rows.reshape(-1, ...)` the
    tiled (time-concatenated) gather."""
    out, off = [], 0
    for shape, dtype, size in specs:
        n = g.shape[0]
        if jnp.issubdtype(dtype, jnp.complexfloating):
            re = g[:, off:off + size]
            im = g[:, off + size:off + 2 * size]
            out.append(jax.lax.complex(re, im).reshape((n,) + shape))
            off += 2 * size
        else:
            out.append(g[:, off:off + size].astype(dtype)
                       .reshape((n,) + shape))
            off += size
    return out


def fused_gather(arrays, axis: str):
    """ONE all_gather for a heterogeneous list of small per-device arrays.

    Returns the list of [n_devices, *shape] row views (see unpack_rows).
    The packed values are bit-identical to what per-array all_gathers
    would produce (complex split to f32 pairs is lossless), so replacing
    N gathers with this one does not perturb any downstream math."""
    packed, specs = pack_f32(arrays)
    g = jax.lax.all_gather(packed, axis)          # [n, total]
    return unpack_rows(g, specs)


def dist_runlength(flags_local: Array, r0, axis: str) -> Tuple[Array, Array]:
    """Consecutive-true run length across the mesh; r0 enters device 0."""
    T = flags_local.shape[0]
    rl_zero, _ = B.runlength_true(flags_local, 0)
    all_true = jnp.all(flags_local)
    end_zero = rl_zero[-1]
    pairs = jax.lax.all_gather(jnp.stack([all_true.astype(jnp.int32),
                                          jnp.asarray(end_zero, jnp.int32)]),
                               axis)                   # [P, 2]
    P = pairs.shape[0]
    idx = jax.lax.axis_index(axis)

    def body(k, c):
        run_in = jnp.where(pairs[k, 0] == 1, c + T, pairs[k, 1])
        return jnp.where(k < idx, run_in, c)

    r_in = jax.lax.fori_loop(0, P, body, jnp.asarray(r0, jnp.int32))
    # prefix of leading Trues extends the incoming run
    lead_true = jnp.cumsum(flags_local.astype(jnp.int32)) \
        == jnp.arange(1, T + 1)
    rl = jnp.where(flags_local & lead_true, rl_zero + r_in, rl_zero)

    def body_all(k, c):
        return jnp.where(pairs[k, 0] == 1, c + T, pairs[k, 1])

    r_final = jax.lax.fori_loop(0, P, body_all, jnp.asarray(r0, jnp.int32))
    return rl, r_final
