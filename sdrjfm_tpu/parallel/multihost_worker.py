"""Worker process for the true multi-process multihost path.

Launched N times (by tests/test_multihost.py::test_two_process_distributed
and by __graft_entry__.dryrun_multichip) with
`python -m sdrjfm_tpu.parallel.multihost_worker <coord_port> <proc_id>
<num_procs> <devices_per_proc> <out_json> [nblocks]`.  Each process owns
`devices_per_proc` virtual CPU devices, initializes jax.distributed
against the shared coordinator, stages ONLY its own contiguous time slice
of each block (parallel/multihost.host_slice + global_iq_block — the
multi-host ingest recipe), and runs the FullyShardedReceiver over the
global mesh.  Replicated outputs (RDS bits, audio RMS) are written as JSON
for the parent to compare with a single-process run of the same mesh size.

The worker forces the CPU platform on purpose: it is a rehearsal of the
multi-process mesh on virtual devices, not a measurement path, and it
never stands in for an accelerator run.
"""

import json
import os
import sys


def main():
    port, pid, nproc, dpp, out_path = sys.argv[1:6]
    nblocks = int(sys.argv[6]) if len(sys.argv) > 6 else 3
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dpp}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=int(nproc),
                               process_id=int(pid))
    assert jax.process_count() == int(nproc)
    assert len(jax.local_devices()) == int(dpp)

    import numpy as np
    import jax.numpy as jnp
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                            default_controls)
    from sdrjfm_tpu.parallel import multihost as MH
    from sdrjfm_tpu.parallel.sharding import FullyShardedReceiver

    # deterministic capture, built identically on every host (a real
    # deployment reads per-host slices from its own front end / shard)
    cfg = ReceiverConfig(block_fm=16384, rds="block", iq_format="i16")
    n_fm = cfg.block_fm * nblocks
    t = np.arange(n_fm) / C.FM_RATE
    from sdrjfm_tpu.rds import encode
    bits = encode.make_bitstream(pi=0x4242, station="MULTIHST", repeats=2)
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams(rds_level=0.07),
                          rds_bits=encode.differential_encode(bits))
    iq = synth.fm_modulate(mpx, C.FM_RATE)[: cfg.block_in * nblocks]
    i16 = synth.iq_to_i16(iq)

    mesh = MH.make_global_mesh()
    srx = FullyShardedReceiver(Receiver(cfg), mesh)
    controls = default_controls()
    state = srx.init_state()

    T = cfg.block_in
    all_bits, rms = [], []
    for b in range(nblocks):
        lo, hi = MH.host_slice(T)
        local = i16[b * T + lo: b * T + hi]      # ONLY this host's slice
        gblk = MH.global_iq_block(local, mesh)
        state, out = srx._step(state, controls, gblk)
        nb = int(out.rds.count)                  # replicated outputs
        all_bits.extend(int(v) for v in np.asarray(out.rds.bits)[:nb])
        r = jax.jit(lambda a: jnp.sqrt(jnp.mean(a ** 2)))(out.audio)
        rms.append(float(r))

    with open(out_path, "w") as f:
        json.dump({"process": int(pid), "bits": all_bits, "rms": rms,
                   "devices": len(jax.devices())}, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
