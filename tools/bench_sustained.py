#!/usr/bin/env python
"""Sustained wav→audio throughput INCLUDING ingest (host→device staging).

bench.py isolates device compute (device-resident input, outputs kept on
device).  This measures the other honest number: the streaming driver
(`runtime.stream.run_streaming`) pulling a host-resident capture through
the chain block by block — double-buffered H2D staging of the i16 wire
frames, per-block D2H of the 48 kHz audio, RDS bits fetched per block.
This is what a production `rx` run sustains end-to-end.

One JSON line per variant:
  {"metric": "fm_sustained_realtime_x", ...}        per-block dispatch
  {"metric": "fm_sustained_meta_realtime_x", ...}   + per-block meta fetch
  {"metric": "fm_sustained_chunk64_realtime_x", ...} one 64-block scan
  {"metric": "fm_sustained_wire_realtime_x", ...}   per-block, meta +
      emit_audio_i16 (the --pcm-out production path: PCM16 quantized on
      device, meta packed into one vector)
  {"metric": "fm_sustained_chunk64_wire_realtime_x", ...} both combined

Run on the accelerator: every block pays its H2D/D2H round trips on top of
compute, so take best-of-N passes over long runs.
"""

import json
import sys
import time

import numpy as np


def main():
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                            default_controls)
    from sdrjfm_tpu.runtime.stream import run_streaming

    cfg = ReceiverConfig(block_fm=131072, rds="block", audio_filter_hz=15000,
                         iq_format="i16")
    rx = Receiver(cfg)
    import dataclasses
    rx_wire = Receiver(dataclasses.replace(cfg, emit_audio_i16=True))
    controls = default_controls()

    nblocks = 64
    n_fm = cfg.block_fm * nblocks
    t = np.arange(n_fm) / C.FM_RATE
    rng = np.random.default_rng(0)
    bits = (rng.random(30000) > 0.5).astype(np.int8)
    mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                          0.6 * np.sin(2 * np.pi * 440.0 * t),
                          synth.MPXParams(), rds_bits=bits)
    iq_np = synth.iq_to_i16(
        synth.fm_modulate(mpx, C.FM_RATE))[: cfg.block_in * nblocks]

    # warmup/compile: per-block + chunk-64 programs, f32 and wire variants
    for r in (rx, rx_wire):
        run_streaming(r, iq_np[: 2 * cfg.block_in], controls,
                      keep_outputs=False, collect_meta=False)
        run_streaming(r, iq_np[: 64 * cfg.block_in], controls,
                      keep_outputs=False, collect_meta=False,
                      chunk_blocks=64)

    def timed(r, collect_meta: bool, chunk: int = 1,
              passes: int = 3, dbuf: bool = True) -> float:
        consumed = [0]

        def on_audio(frames):
            consumed[0] += len(frames)

        dt = float("inf")
        for _ in range(passes):
            consumed[0] = 0
            t0 = time.time()
            run_streaming(r, iq_np, controls, on_audio=on_audio,
                          keep_outputs=False, collect_meta=collect_meta,
                          chunk_blocks=chunk, double_buffer=dbuf)
            d = time.time() - t0
            assert consumed[0] == nblocks * cfg.block_fm // 4
            dt = min(dt, d)
        return dt

    # the nodbuf rows are the A/B control for the double-buffered H2D:
    # identical driver with staging serialized (upload, wait, dispatch) —
    # the difference IS what the overlap buys on this link
    for name, r, meta_on, chunk, dbuf in (
            ("fm_sustained_realtime_x", rx, False, 1, True),
            ("fm_sustained_nodbuf_realtime_x", rx, False, 1, False),
            ("fm_sustained_meta_realtime_x", rx, True, 1, True),
            ("fm_sustained_chunk64_realtime_x", rx, False, 64, True),
            ("fm_sustained_wire_realtime_x", rx_wire, True, 1, True),
            ("fm_sustained_wire_nodbuf_realtime_x", rx_wire, True, 1,
             False),
            ("fm_sustained_chunk64_wire_realtime_x", rx_wire, False, 64,
             True)):
        dt = timed(r, meta_on, chunk, dbuf=dbuf)
        sps = nblocks * cfg.block_in / dt
        print(json.dumps({
            "metric": name,
            "value": round(sps / C.INPUT_RATE, 1),
            "unit": "x_realtime",
            "vs_baseline": round(sps / C.INPUT_RATE, 1),
            "ms_per_block": round(dt / nblocks * 1e3, 3),
            "signal_s": round(nblocks * cfg.block_in / C.INPUT_RATE, 2),
            "wall_s": round(dt, 3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
