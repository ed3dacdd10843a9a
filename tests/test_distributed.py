"""Distributed recurrence/halo helpers == single-device primitives (8-way mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from sdrjfm_tpu.ops import blockops as B
from sdrjfm_tpu.parallel import distributed as D
from sdrjfm_tpu.parallel.sharding import make_mesh

AXIS = "time"
RNG = np.random.default_rng(0)


def _smap(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def test_dist_fir_matches_single():
    mesh = make_mesh(8)
    x = RNG.standard_normal(8 * 1024).astype(np.float32)
    k = RNG.standard_normal(33).astype(np.float32)
    carry = RNG.standard_normal(32).astype(np.float32)
    want, _ = B.fir_apply(jnp.asarray(x), jnp.asarray(k), jnp.asarray(carry))

    def f(xl, kk, c):
        y, _ = D.dist_fir(xl, kk, c, AXIS)
        return y

    got = _smap(f, mesh, (P(AXIS), P(), P()), P(AXIS))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(carry))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dist_fft_filter_matches_single():
    mesh = make_mesh(8)
    x = (RNG.standard_normal(8 * 2048)).astype(np.float32)
    from sdrjfm_tpu.ops import design
    kern = design.lowpass_sinc(251, 0.1, 1.0)
    H = jnp.asarray(design.fft_filter_response(kern, 1024), jnp.complex64)
    carry = jnp.asarray(RNG.standard_normal(512), jnp.float32
                        ).astype(jnp.complex64)
    want, _ = B.fft_filter_apply(jnp.asarray(x), H, 512, carry)

    def f(xl, c):
        y, _ = D.dist_fft_filter(xl, H, 512, c, AXIS)
        return y

    got = _smap(f, mesh, (P(AXIS), P()), P(AXIS))(jnp.asarray(x), carry)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_dist_linrec_matches_single():
    mesh = make_mesh(8)
    d = RNG.standard_normal(8 * 512).astype(np.float32)
    g, y0 = 0.999, 0.37
    want, want_last = B.linrec_apply(jnp.asarray(d), g, y0)

    def f(dl):
        y, yf = D.dist_linrec(dl, g, y0, AXIS)
        return y, yf

    got, got_last = _smap(f, mesh, (P(AXIS),), (P(AXIS), P()))(jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=5e-4)  # fp32 prefix reassociation
    np.testing.assert_allclose(np.asarray(got_last), np.asarray(want_last),
                               atol=5e-4)


def test_dist_runlength_matches_single():
    mesh = make_mesh(8)
    flags = RNG.random(8 * 512) > 0.2
    # force a long run crossing device boundaries
    flags[1000:2600] = True
    r0 = 7
    want, want_last = B.runlength_true(jnp.asarray(flags), r0)

    def f(fl):
        rl, rf = D.dist_runlength(fl, r0, AXIS)
        return rl, rf

    got, got_last = _smap(f, mesh, (P(AXIS),), (P(AXIS), P()))(
        jnp.asarray(flags))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(got_last) == int(want_last)


def test_dist_iir_matches_single():
    mesh = make_mesh(8)
    from sdrjfm_tpu.ops.squelch import make_squelch_config
    spec = make_squelch_config(192000).hp          # order-10 cheby1 highpass
    x = RNG.standard_normal(8 * 2048).astype(np.float32)
    from sdrjfm_tpu.ops.blockops import iir_apply
    import jax.numpy as jnp
    state0 = (jnp.zeros((len(spec.poles),), jnp.complex64),
              jnp.zeros((len(spec.num) - 1,), jnp.float32))
    want, (want_w, want_f) = iir_apply(jnp.asarray(x), spec, state0)

    def f(xl):
        y, (wT, ft) = D.dist_iir(xl, spec, state0, AXIS)
        return y, wT, ft

    got, got_w, got_f = _smap(f, mesh, (P(AXIS),), (P(AXIS), P(), P()))(
        jnp.asarray(x))
    scale = np.max(np.abs(np.asarray(want))) + 1e-9
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4 * scale)
    np.testing.assert_allclose(np.asarray(got_w), np.asarray(want_w),
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want_f))


def test_dist_fir_interpolate_matches_single():
    mesh = make_mesh(8)
    from sdrjfm_tpu.ops import design
    k = jnp.asarray(design.polyphase_resampler_kernel(4), jnp.float32)
    phases = (k.shape[0] + 3) // 4
    x = RNG.standard_normal(8 * 512).astype(np.float32)
    carry = jnp.asarray(RNG.standard_normal(phases - 1), jnp.float32
                        ).astype(jnp.complex64)
    xc = jnp.asarray(x).astype(jnp.complex64)
    want, want_tail = B.fir_interpolate(xc, k, 4, carry)

    def f(xl):
        y, tail = D.dist_fir_interpolate(xl, k, 4, carry, AXIS)
        return y, tail

    got, got_tails = _smap(f, mesh, (P(AXIS),), (P(AXIS), P(AXIS)))(xc)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_tails)[-(phases - 1):],
                                  np.asarray(want_tail))


def test_dist_runlength_all_true():
    mesh = make_mesh(8)
    flags = np.ones(8 * 256, bool)
    want, want_last = B.runlength_true(jnp.asarray(flags), 3)

    def f(fl):
        return D.dist_runlength(fl, 3, AXIS)

    got, got_last = _smap(f, mesh, (P(AXIS),), (P(AXIS), P()))(
        jnp.asarray(flags))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(got_last) == int(want_last)
