#!/usr/bin/env python
"""Throughput of the full stereo+RDS receive chain on one GPU.

Prints ONE JSON line:
  {"metric": "fm_stereo_rds_realtime_x", "value": N, "unit": "x_realtime",
   "device": {...}, "gpu": "<name>, <power limit>", ...}

The metric is how many times faster than real time (2.304 MS/s complex IQ
in, 48 kHz stereo audio + RDS bits out) one GPU runs the complete receive
chain: the default receiver (block_fm=131072, i16 wire, rds="block",
15 kHz audio filter) as ONE jitted `lax.scan` over 64 distinct blocks of
synthesized stereo+RDS IQ held on the device, best of 20 runs after two
warm-ups, each ending in `block_until_ready`.  The reference's implicit
bar is 1.0x real time on a desktop CPU core (BASELINE.md).

Exits 1 without a GPU: there is no CPU fallback.
"""

import json
import sys
import time

import numpy as np

NBLOCKS = 64


def _capture(block_in: int, nblocks: int) -> np.ndarray:
    """`nblocks` distinct blocks of stereo+RDS IQ in the i16 wire format
    (distinct data, so nothing can be hoisted out of the scan)."""
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth

    n_fm = block_in // 12 * nblocks
    t = np.arange(n_fm) / C.FM_RATE
    rng = np.random.default_rng(0)
    bits = (rng.random(30000) > 0.5).astype(np.int8)
    mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                          0.6 * np.sin(2 * np.pi * 440.0 * t),
                          synth.MPXParams(), rds_bits=bits)
    iq = synth.fm_modulate(mpx, C.FM_RATE)[: block_in * nblocks]
    return synth.iq_to_i16(iq).reshape(nblocks, block_in, 2)


def main() -> int:
    from sdrjfm_tpu.runtime.accelerator import (device_record,
                                                nvidia_smi_line, require_gpu)
    from sdrjfm_tpu.runtime.compile_cache import enable_compile_cache

    devs = require_gpu()
    enable_compile_cache()
    import jax
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig

    rx = Receiver(ReceiverConfig(block_fm=131072, rds="block",
                                 audio_filter_hz=15000, iq_format="i16"))
    controls = rx.initial_controls()
    state = rx.init_state()
    blocks = jax.device_put(_capture(rx.cfg.block_in, NBLOCKS))
    run = rx.jit_scan()

    t0 = time.perf_counter()
    st, outs = run(state, controls, blocks)
    jax.block_until_ready(outs)
    first_call_s = time.perf_counter() - t0
    for _ in range(2):
        st, outs = run(st, controls, blocks)
        jax.block_until_ready(outs)
    dt = float("inf")
    for _ in range(20):
        t0 = time.perf_counter()
        st, outs = run(st, controls, blocks)
        jax.block_until_ready(outs)
        dt = min(dt, time.perf_counter() - t0)
    x = NBLOCKS * rx.cfg.block_in / dt / C.INPUT_RATE
    print(json.dumps({
        "metric": "fm_stereo_rds_realtime_x", "value": x,
        "unit": "x_realtime", "method": "block_until_ready, best of 20",
        "blocks_per_dispatch": NBLOCKS, "s_per_dispatch": dt,
        "first_call_s": first_call_s,
        "device": device_record(devs), "gpu": nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
