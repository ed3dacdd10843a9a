#!/usr/bin/env python
"""Stage-level timing on the accelerator: full step vs front end vs fm chain.

Each variant is a separate lax.scan-over-blocks jit (same shapes as bench.py)
so the numbers decompose the headline metric.  Prints one JSON line per
variant.  Run on the accelerator.
"""

import json
import time

import numpy as np


def timed(fn, *args, reps=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    dt = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        dt = min(dt, time.time() - t0)
    return dt


def main():
    import jax
    import jax.numpy as jnp
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                            default_controls)
    cfg = ReceiverConfig(block_fm=131072, rds="block", audio_filter_hz=15000)
    rx = Receiver(cfg)
    controls = default_controls()
    state = rx.init_state()

    nblocks = 16
    n_fm = cfg.block_fm * nblocks
    t = np.arange(n_fm) / C.FM_RATE
    rng = np.random.default_rng(0)
    bits = (rng.random(30000) > 0.5).astype(np.int8)
    mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                          0.6 * np.sin(2 * np.pi * 440.0 * t),
                          synth.MPXParams(), rds_bits=bits)
    iq_np = synth.fm_modulate(mpx, C.FM_RATE)[: cfg.block_in * nblocks]
    blocks = jax.device_put(jnp.asarray(iq_np, jnp.complex64)
                            .reshape(nblocks, cfg.block_in))
    sig_s = nblocks * cfg.block_in / C.INPUT_RATE

    @jax.jit
    def run_full(state, controls, blocks):
        def body(st, blk):
            st, out = rx.step(st, controls, blk)
            return st, out
        return jax.lax.scan(body, state, blocks)

    @jax.jit
    def run_frontend(state, controls, blocks):
        def body(st, blk):
            v, _ = rx.front_end(st, controls, blk)
            return st, v
        return jax.lax.scan(body, state, blocks)

    # fm chain on precomputed 192k blocks
    _, vs = run_frontend(state, controls, blocks)
    vs = jax.block_until_ready(vs)

    @jax.jit
    def run_chain(state, controls, vs):
        def body(st, v):
            fe = dict(n0_mod=st.n0_mod, rf_dc=st.rf_dc, input_filt=None,
                      band1=st.band1, band2=st.band2)
            st, out = rx.fm_chain(st, controls, v, fe)
            return st, out
        return jax.lax.scan(body, state, vs)

    for name, fn, args in (("full_step", run_full, (state, controls, blocks)),
                           ("front_end", run_frontend,
                            (state, controls, blocks)),
                           ("fm_chain", run_chain, (state, controls, vs))):
        dt = timed(fn, *args)
        print(json.dumps({"stage": name,
                          "ms_per_block": round(dt / nblocks * 1e3, 4),
                          "x_realtime": round(sig_s / dt, 1)}), flush=True)


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(main())
