"""Collective-count budget for the fully-sharded step.

Every sub-KB collective on a 1-D mesh costs a full latency hop between
devices, and the fully-sharded step used to issue ~12 separate small
all_gathers (stream tails, peaks, z24, DC subsample).  They are fused:

  - demod AM-carrier + AFC trackers share one gather (dist_ema2)
  - PSS S_k/W_k/lock flags share one packed gather
  - noise-squelch band averages share one gather
  - stream tails + peak maxima + the 24 kS/s RDS stream + the DC-servo
    subsample ride ONE end-of-chain fused gather (fused_gather)

Budget for the flagship config (stereo+RDS block decoder, audio filter):
5 all_gathers (demod ema pair, pilot lock EMA, pilot lock runlength, PSS
pack, end-of-chain pack) + 8 collective_permutes (the stage halos, which
are neighbour-only and inherently sequential).  This test pins those
numbers so new code cannot silently regress the budget.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu.parallel import distributed as DD
from sdrjfm_tpu.parallel.sharding import FullyShardedReceiver, make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")


def _counts(txt):
    return {op: len(re.findall(rf'"stablehlo\.{op}"', txt))
            for op in ("all_gather", "collective_permute", "all_reduce",
                       "all_to_all")}


def test_fully_sharded_collective_budget():
    cfg = ReceiverConfig(block_fm=131072, rds="block",
                         audio_filter_hz=15000)
    rx = Receiver(cfg)
    fsr = FullyShardedReceiver(rx, make_mesh(8))
    iq = jnp.zeros((cfg.block_in,), jnp.complex64)
    txt = fsr._step.lower(fsr.init_state(), rx.initial_controls(),
                          iq).as_text()
    c = _counts(txt)
    assert c["all_gather"] <= 5, c
    assert c["collective_permute"] <= 8, c
    assert c["all_reduce"] == 0 and c["all_to_all"] == 0, c


def _shmap(fn, mesh, n_in, axis="time"):
    from jax.sharding import PartitionSpec as P
    return jax.shard_map(fn, mesh=mesh, in_specs=(P(axis),) * n_in,
                         out_specs=P(), check_vma=False)


def test_dist_ema2_matches_two_dist_emas():
    """The paired gather is bit-identical to two separate dist_emas."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(7)
    x1 = jnp.asarray(rng.normal(size=4096).astype(np.float32))
    x2 = jnp.asarray(rng.normal(size=4096).astype(np.float32))
    a1, a2 = 1e-3, 2.5e-4

    def pair(x1, x2):
        (y1, f1), (y2, f2) = DD.dist_ema2(x1, a1, 0.1, x2, a2, -0.2, "time")
        return y1, f1, y2, f2

    def single(x1, x2):
        y1, f1 = DD.dist_ema(x1, a1, 0.1, "time")
        y2, f2 = DD.dist_ema(x2, a2, -0.2, "time")
        return y1, f1, y2, f2

    with mesh:
        got = jax.jit(_shmap(pair, mesh, 2))(x1, x2)
        want = jax.jit(_shmap(single, mesh, 2))(x1, x2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fused_gather_roundtrip():
    """pack_f32/unpack_rows is lossless for mixed dtypes and the row view
    reproduces per-array all_gathers exactly."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    c = jnp.asarray((rng.normal(size=128) + 1j * rng.normal(size=128))
                    .astype(np.complex64))
    f = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))
    b = jnp.asarray(rng.random(64) > 0.5)

    def fused(c, f, b):
        rows = DD.fused_gather([c, f, b], "time")
        return tuple(rows)

    def plain(c, f, b):
        return (jax.lax.all_gather(c, "time"),
                jax.lax.all_gather(f, "time"),
                jax.lax.all_gather(b, "time"))

    with mesh:
        got = jax.jit(_shmap(fused, mesh, 3))(c, f, b)
        want = jax.jit(_shmap(plain, mesh, 3))(c, f, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_fully_sharded_rejects_emit_taps():
    """Debug taps are per-device slices; the fully-sharded output spec
    would silently replicate one shard — must be a loud config error."""
    cfg = ReceiverConfig(block_fm=131072, rds="block", emit_taps=True)
    with pytest.raises(AssertionError, match="emit_taps"):
        FullyShardedReceiver(Receiver(cfg), make_mesh(8))
