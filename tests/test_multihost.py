"""Multi-host ingest utilities on the single-process 8-device CPU mesh.

`global_iq_block` + `FullyShardedReceiver` is the multi-host recipe
(parallel/multihost.py); with process_count == 1 the same code path runs
here and must be bit-identical to staging the block directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                        default_controls)
from sdrjfm_tpu.parallel import multihost as MH
from sdrjfm_tpu.parallel.sharding import FullyShardedReceiver, make_mesh

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")


def test_host_slice_partition():
    starts = [MH.host_slice(1024, pi, 4) for pi in range(4)]
    assert starts == [(0, 256), (256, 512), (512, 768), (768, 1024)]
    with pytest.raises(AssertionError):
        MH.host_slice(1000, 0, 3)


def test_two_process_distributed_matches_single():
    """TRUE multi-process multihost: 2 jax.distributed CPU processes x 2
    devices each run the FullyShardedReceiver over a global 4-device mesh,
    each staging only its own host_slice across hosts
    (make_array_from_process_local_data).  Replicated outputs must agree
    across processes and match a single-process 4-device run bit-for-bit
    (same mesh size -> same collective order)."""
    import json
    import pathlib
    import socket
    import subprocess
    import sys
    import tempfile

    with socket.socket() as s:                   # free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = (pathlib.Path(__file__).parents[1] / "sdrjfm_tpu" / "parallel"
              / "multihost_worker.py")
    outs = []
    procs = []
    tmp = tempfile.mkdtemp()
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("XLA_FLAGS",)}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(worker.parents[2])
    for pid in range(2):
        out = f"{tmp}/proc{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid), "2", "2",
             out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    r0 = json.load(open(outs[0]))
    r1 = json.load(open(outs[1]))
    assert r0["devices"] == r1["devices"] == 4
    # replicated outputs identical on both hosts
    assert r0["bits"] == r1["bits"] and r0["rms"] == r1["rms"]
    assert len(r0["bits"]) > 200

    # single-process reference on a 4-device mesh (same mesh size ->
    # deterministic collectives -> bit-exact)
    from sdrjfm_tpu.rds import encode
    nblocks = 3
    cfg = ReceiverConfig(block_fm=16384, rds="block", iq_format="i16")
    n_fm = cfg.block_fm * nblocks
    t = np.arange(n_fm) / C.FM_RATE
    bits = encode.make_bitstream(pi=0x4242, station="MULTIHST", repeats=2)
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams(rds_level=0.07),
                          rds_bits=encode.differential_encode(bits))
    i16 = synth.iq_to_i16(synth.fm_modulate(mpx, C.FM_RATE)
                          [: cfg.block_in * nblocks])
    srx = FullyShardedReceiver(Receiver(cfg), make_mesh(4))
    st = srx.init_state()
    ref_bits, ref_rms = [], []
    T = cfg.block_in
    for b in range(nblocks):
        st, out = srx.step(st, default_controls(),
                           jnp.asarray(i16[b * T:(b + 1) * T]))
        nb = int(out.rds.count)
        ref_bits.extend(int(v) for v in np.asarray(out.rds.bits)[:nb])
        ref_rms.append(float(jax.jit(
            lambda a: jnp.sqrt(jnp.mean(a ** 2)))(out.audio)))
    assert r0["bits"] == ref_bits
    np.testing.assert_allclose(r0["rms"], ref_rms, rtol=1e-6)


@needs_mesh
def test_global_block_feeds_sharded_receiver():
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 iq_format="i16"))
    n = rx.cfg.block_in
    t = np.arange(rx.cfg.block_fm) / C.FM_RATE
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams())
    iq = synth.fm_modulate(mpx, C.FM_RATE)[:n]
    i16 = synth.iq_to_i16(iq)

    mesh = MH.make_global_mesh()
    lo, hi = MH.host_slice(n)
    assert (lo, hi) == (0, n)          # single process holds everything
    gblk = MH.global_iq_block(i16[lo:hi], mesh)
    assert gblk.shape == (n, 2)
    assert len(gblk.sharding.device_set) == len(jax.devices())

    srx = FullyShardedReceiver(rx, mesh)
    st = srx.init_state()
    st, out = srx._step(st, default_controls(), gblk)

    st1 = rx.init_state()
    st1, out1 = rx.jit_step()(st1, default_controls(), jnp.asarray(i16))
    np.testing.assert_allclose(np.asarray(out.audio), np.asarray(out1.audio),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(out.rds.bits),
                                  np.asarray(out1.rds.bits))
