#!/usr/bin/env python
"""Multi-device throughput + scaling-efficiency benchmark.

Per-device samples/s for the plain receiver and both sharded
configurations, efficiency vs the single-device number, and the
n=1 sharding tax (what shard_map costs when it buys nothing).

Run on real hardware as-is (it uses every visible device), or in CPU-mesh
shape mode for CI:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_multichip.py --blocks 8 --reps 3 --out /tmp/m.json

All configurations are measured the same way: per-block dispatch of the
designed `step` entry (state carried), best-of-reps.  One JSON line per
measurement; --out additionally writes the whole list.  CPU-mesh numbers
measure SHAPE (the collectives ride shared memory); only accelerator
numbers speak to scaling — the "platform" field says which kind a record
is.
"""

import argparse
import json
import sys
import time


def _throughput(step_fn, init_state, controls, block_list, reps):
    """Best-of-reps wall time to stream every block through step_fn."""
    import jax

    st, out = step_fn(init_state, controls, block_list[0])   # compile
    jax.block_until_ready(out.audio)
    best = float("inf")
    for _ in range(reps):
        st = init_state
        t0 = time.perf_counter()
        for blk in block_list:
            st, out = step_fn(st, controls, blk)
        jax.block_until_ready(out.audio)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block-fm", type=int, default=131072)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="write the record list to this JSON file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                            default_controls)
    from sdrjfm_tpu.parallel.sharding import (FullyShardedReceiver,
                                              ShardedReceiver, make_mesh)

    devs = jax.devices()
    platform = devs[0].platform
    n_max = len(devs)
    # the block must split across the largest mesh: block_fm % (4096*n) == 0
    block_fm = args.block_fm
    while block_fm % (4096 * n_max) != 0:
        block_fm *= 2
    cfg = ReceiverConfig(block_fm=block_fm, rds="block",
                         audio_filter_hz=15000)
    rx = Receiver(cfg)
    controls = default_controls()

    nb = args.blocks
    t = np.arange(cfg.block_fm * nb) / C.FM_RATE
    rng = np.random.default_rng(0)
    bits = (rng.random(30000) > 0.5).astype(np.int8)
    mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                          0.6 * np.sin(2 * np.pi * 440.0 * t),
                          synth.MPXParams(), rds_bits=bits)
    iq_np = synth.fm_modulate(mpx, C.FM_RATE)[: cfg.block_in * nb]
    n_in = cfg.block_in * nb
    seconds_of_signal = n_in / C.INPUT_RATE
    blocks_np = iq_np.reshape(nb, cfg.block_in)

    records = []

    def record(metric, dt, devices, **extra):
        rec = {"metric": metric, "devices": devices,
               "value": round(seconds_of_signal / dt, 1),
               "unit": "x_realtime", "platform": platform,
               "samples_per_s": round(n_in / dt),
               "samples_per_s_per_device": round(n_in / dt / devices),
               **extra}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        return rec

    # --- single-device plain receiver: the efficiency denominator --------
    plain_blocks = [jax.device_put(jnp.asarray(b), devs[0])
                    for b in blocks_np]
    dt1 = _throughput(rx.jit_step(), rx.init_state(), controls,
                      plain_blocks, args.reps)
    record("plain_1dev", dt1, 1)

    # --- sharded configurations over growing meshes ----------------------
    sizes = []
    n = 1
    while n <= n_max:
        sizes.append(n)
        n *= 2
    if sizes[-1] != n_max:
        sizes.append(n_max)
    for n in sizes:
        mesh = make_mesh(n)
        for name, cls in (("sharded_frontend", ShardedReceiver),
                          ("fully_sharded", FullyShardedReceiver)):
            srx = cls(rx, mesh)
            sh_blocks = [jax.device_put(jnp.asarray(b), srx.iq_sharding)
                         for b in blocks_np]
            dt = _throughput(srx.step, srx.init_state(), controls,
                             sh_blocks, args.reps)
            speedup = dt1 / dt
            record(f"{name}_{n}dev", dt, n,
                   speedup_vs_1dev=round(speedup, 3),
                   efficiency=round(speedup / n, 3),
                   **({"sharding_tax_pct": round(100 * (dt / dt1 - 1), 1)}
                      if n == 1 else {}))

    # --- station-axis sharding: whole stations per device ----------------
    # The zero-collective configuration (models/multistation.py): N
    # stations demodulated from one shared capture, station axis on the
    # mesh.  The denominator is the SAME N stations vmapped on one device.
    from sdrjfm_tpu.models.multistation import (MultiStationReceiver,
                                                ShardedMultiStationReceiver)
    n_st = n_max
    offsets = [((i % 5) - 2) * 100_000 for i in range(n_st)]
    msr = MultiStationReceiver(rx)
    dt_v = _throughput(msr.step, msr.init_states(n_st),
                       msr.controls_for(offsets), plain_blocks, args.reps)
    record("stations_vmap_1dev", dt_v, 1, stations=n_st)
    for n in sizes:
        if n_st % n != 0:
            continue
        smsr = ShardedMultiStationReceiver(rx, make_mesh(n, axis="stations"))
        rep_blocks = [jax.device_put(jnp.asarray(b), smsr.replicated)
                      for b in blocks_np]
        dt = _throughput(smsr.step, smsr.init_states(n_st),
                         smsr.controls_for(offsets), rep_blocks, args.reps)
        speedup = dt_v / dt
        record(f"stations_sharded_{n}dev", dt, n, stations=n_st,
               speedup_vs_vmap_1dev=round(speedup, 3),
               efficiency=round(speedup / n, 3))

    # --- 2-D stations x time mesh (both parallel dimensions) -------------
    if n_max >= 4 and n_max % 2 == 0:
        from sdrjfm_tpu.parallel.sharding import (StationTimeShardedReceiver,
                                                  make_mesh_2d)
        n_t = n_max // 2
        if (cfg.block_fm % (n_t * cfg.fm_hop) == 0
                and (cfg.block_fm // n_t) % rx.pss_cfg.subblock == 0):
            st2 = StationTimeShardedReceiver(rx, make_mesh_2d(2, n_t))
            offsets2 = offsets[:2] if len(offsets) >= 2 else [0, 100_000]
            iq2_blocks = [jax.device_put(jnp.asarray(b), st2.iq_sharding)
                          for b in blocks_np]
            dt = _throughput(st2.step, st2.init_states(2),
                             st2.controls_for(offsets2), iq2_blocks,
                             args.reps)
            record(f"stations2_time{n_t}_2d", dt, n_max, stations=2)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"block_fm": cfg.block_fm, "blocks": nb,
                       "platform": platform, "records": records}, f,
                      indent=2)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(main())
