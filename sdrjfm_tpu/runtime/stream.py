"""Offline/streaming drivers for the block receiver.

The reference's engine thread pulls 16384-sample chunks from the device ring
buffer (fm-processor.cpp:387-417); here the equivalent is a host loop (or a
`lax.scan` over a pre-staged array) feeding fixed-size blocks through the
jitted step and collecting outputs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.receiver import (Controls, Output, Receiver,
                               meta_dict_from_vec)


def _wire_dtype(cfg):
    import jax.numpy as jnp
    return {"c64": jnp.complex64, "i16": jnp.int16,
            "i8": jnp.int8, "u8": jnp.uint8}[cfg.iq_format]


def _stage_blocks(iq: np.ndarray, cfg, nblocks: int):
    """Stack the capture into the step's wire format ([n,T] complex64 or
    [n,T,2] int16/uint8 — see ReceiverConfig.iq_format)."""
    T = cfg.wire_len
    x = jnp.asarray(iq[: nblocks * T], _wire_dtype(cfg))
    if cfg.iq_format == "c64":
        return x.reshape(nblocks, T)
    return x.reshape(nblocks, T, 2)


@dataclass
class StreamResult:
    audio: np.ndarray                 # [n, 2] float32 at working rate
    meta: List[dict] = field(default_factory=list)
    rds_bits: Optional[np.ndarray] = None
    rds_iq: Optional[np.ndarray] = None
    taps: dict = field(default_factory=dict)
    final_state: object = None
    dropped_total: int = 0    # ingest overrun drops (live sources only)


def run_offline_scan(rx: Receiver, iq: np.ndarray,
                     controls: Optional[Controls] = None,
                     init_state=None):
    """Whole-capture processing as ONE jitted `lax.scan` over blocks.

    A single dispatch for the entire run — the throughput path (the per-call
    dispatch latency of the Python block loop dominates once a block's
    compute is short).  Returns (final_state, stacked Output pytree with a leading
    block axis).
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    nblocks = len(iq) // T
    assert nblocks > 0
    blocks = _stage_blocks(iq, cfg, nblocks)
    state = init_state if init_state is not None else rx.init_state()
    return rx.jit_scan()(state, controls, blocks)


def run_offline_scanned(rx: Receiver, iq: np.ndarray,
                        controls: Optional[Controls] = None,
                        drop_blocks: int = 0,
                        collect_taps: bool = False,
                        init_state=None,
                        chunk_blocks: Optional[int] = None) -> StreamResult:
    """`run_offline_scan` with the stacked Output unpacked to a StreamResult.

    Same result contract as `run_offline`, but the capture runs as scan
    dispatches (lax.scan over blocks) — the throughput path for long
    captures, where the per-block dispatch and transfer latency of the
    Python loop would otherwise add to every block.

    chunk_blocks: if set, dispatch the scan in chunks of this many blocks,
    threading the carry state between chunks — bounds device memory to
    chunk_blocks of input+output for arbitrarily long captures, bit-exactly
    (the scan body is the same program; only the leading axis is split).
    """
    if chunk_blocks is not None:
        T = rx.cfg.wire_len
        total = (len(iq) // T) * T
        state = init_state
        parts = []
        for lo in range(0, total, chunk_blocks * T):
            hi = min(lo + chunk_blocks * T, total)
            part = run_offline_scanned(rx, iq[lo:hi], controls,
                                       collect_taps=collect_taps,
                                       init_state=state)
            state = part.final_state
            parts.append(part)
        first = parts[0]
        res = StreamResult(
            audio=np.concatenate([p.audio for p in parts], axis=0),
            meta=[m for p in parts for m in p.meta],
            final_state=state)
        if first.rds_bits is not None:
            res.rds_bits = np.concatenate([p.rds_bits for p in parts])
            res.rds_iq = np.concatenate([p.rds_iq for p in parts])
        if first.taps:
            res.taps = {k: np.concatenate([p.taps[k] for p in parts])
                        for k in first.taps}
        if drop_blocks:
            nb_a = len(res.audio) // max(len(res.meta), 1)
            res.audio = res.audio[drop_blocks * nb_a:]
            res.meta = res.meta[drop_blocks:]
        return res
    state, outs = run_offline_scan(rx, iq, controls, init_state=init_state)
    nblocks = outs.audio.shape[0]
    audio = np.asarray(outs.audio)[drop_blocks:].reshape(-1, 2)
    mv_np = np.asarray(outs.meta_vec)           # one fetch for all blocks
    metas = [meta_dict_from_vec(mv_np[b])[0]
             for b in range(drop_blocks, nblocks)]
    res = StreamResult(audio=audio, meta=metas, final_state=state)
    if outs.rds is not None:
        all_bits = np.asarray(outs.rds.bits)
        all_iq = np.asarray(outs.rds.iq)
        counts = np.asarray(outs.rds.count)
        bits, biq = [], []
        for b in range(drop_blocks, nblocks):
            n = int(counts[b])
            bits.append(all_bits[b, :n])
            biq.append(all_iq[b, :n])
        res.rds_bits = np.concatenate(bits)
        res.rds_iq = np.concatenate(biq)
    if collect_taps and outs.taps:
        res.taps = {k: np.asarray(v)[drop_blocks:].reshape(-1)
                    for k, v in outs.taps.items()}
    return res


def _prefetch_outputs(out, meta: bool = True, rds_iq: bool = True) -> None:
    """Kick off async device→host copies for every output the block loop
    will read, so the transfers drain while the host stages the next block
    (run_streaming) or waits on the ring (run_live) instead of serializing
    inside np.asarray.  No-op on buffers without the method (CPU arrays)."""
    arrs = [out.audio_i16 if out.audio_i16 is not None else out.audio]
    if meta:
        arrs.append(out.meta_vec)
    if out.rds is not None:
        arrs.append(out.rds.bits)
        if rds_iq:
            arrs.append(out.rds.iq)
    for a in arrs:
        copy = getattr(a, "copy_to_host_async", None)
        if copy is not None:
            copy()


def run_streaming(rx: Receiver, iq: np.ndarray,
                  controls: Optional[Controls] = None,
                  init_state=None,
                  on_audio=None, on_meta=None, on_rds_bits=None,
                  drop_blocks: int = 0,
                  keep_outputs: bool = True,
                  collect_taps: bool = False,
                  collect_meta: bool = True,
                  chunk_blocks: int = 1,
                  rds_feedback=None,
                  controls_update=None,
                  command_hook=None,
                  on_state=None,
                  double_buffer: bool = True) -> StreamResult:
    """Streaming block driver: per-block callbacks + double-buffered input.

    Block k+1's host→device transfer is issued (async `jax.device_put`)
    right after block k's compute is dispatched, so staging overlaps compute
    — the block-world analogue of the reference's device reader thread
    filling the ring buffer ahead of the engine (fm-processor.cpp:387-417,
    ROADMAP 'double-buffered input staging').  Callbacks fire as each block's
    outputs materialise:

        on_audio(frames)   : [block_audio, 2] float32 — feed a live sink
                             (io.pcmout.PCMSink) while later blocks are
                             still in flight
        on_meta(dict)      : per-block metadata
        on_rds_bits(bits)  : the block's decoded RDS bits (np.uint8)

    keep_outputs=False skips accumulating outputs in memory (long/endless
    captures); the returned StreamResult then carries only meta+final state.
    collect_meta=False skips the per-block metadata fetch entirely — the
    Meta pytree is ~12 scalar device→host reads per block, a fixed cost
    that dominates once compute is sub-millisecond (the production
    equivalent of the reference emitting metadata every 500 ms rather than
    per chunk, fm-processor.cpp:662-684).

    chunk_blocks>1 is the throughput mode: each dispatch is a lax.scan over
    that many blocks (state threads through identically; bit-exact vs the
    scan runner `run_offline_scanned`, fp-close vs chunk_blocks=1 — the
    scan body compiles with different fusion than the per-block jit), H2D
    stages whole chunks, and each output crosses D2H
    once per chunk instead of once per block.  Callbacks still fire per
    block, just `chunk_blocks` at a time; latency rises from 1 to
    chunk_blocks block periods.  This amortizes the fixed per-dispatch and
    per-transfer costs that dominate sustained throughput when a block's
    compute is microseconds (tools/bench_sustained.py measures both).
    Taps collection is per-block-path only (assert).

    rds_feedback(bits) -> bool and controls_update(controls, meta) ->
    Controls close the same per-block host loops as run_live/run_offline
    (decoder-3 bit-clock resync, rds-decoder-3.cpp:94-99; AFC,
    radio.cpp:1786-1809) — per-block path only (chunked dispatches can't
    react inside a chunk).

    on_state(blocks_done, state) fires after each block with the carry the
    *next* block will consume (post-resync) — the periodic-checkpoint hook
    (runtime.checkpoint.CheckpointManager): resuming run_streaming with
    init_state=that carry on the remaining blocks is bit-identical.
    """
    if chunk_blocks > 1:
        assert not collect_taps, "taps need the per-block path"
        assert rds_feedback is None and controls_update is None \
            and on_state is None and command_hook is None, \
            "per-block host feedback needs chunk_blocks=1"
        return _run_streaming_chunked(rx, iq, controls, init_state,
                                      on_audio, on_meta, on_rds_bits,
                                      drop_blocks, keep_outputs,
                                      collect_meta, chunk_blocks)
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    nblocks = len(iq) // T
    assert nblocks > 0, f"need at least {T} samples, got {len(iq)}"
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()

    wire = _wire_dtype(cfg)
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    tap_acc: dict = {}
    # double_buffer=False serializes staging (upload block k, wait, then
    # dispatch) — the A/B control for measuring what the overlap buys
    # (tools/bench_sustained.py 'nodbuf' rows); production always overlaps
    dev_blk = (jax.device_put(jnp.asarray(iq[:T], wire))
               if double_buffer else None)
    for b in range(nblocks):
        if not double_buffer:
            dev_blk = jax.device_put(jnp.asarray(iq[b * T:(b + 1) * T],
                                                 wire))
            jax.block_until_ready(dev_blk)
        state, out = step(state, controls, dev_blk)
        if double_buffer and b + 1 < nblocks:
            # stage the next block while this one computes
            dev_blk = jax.device_put(
                jnp.asarray(iq[(b + 1) * T:(b + 2) * T], wire))
        if b < drop_blocks:
            jax.block_until_ready(out.audio)
            continue
        _prefetch_outputs(out)       # D2H starts as compute drains
        frames = np.asarray(out.audio_i16 if out.audio_i16 is not None
                            else out.audio)
        meta = n = None
        if collect_meta or on_meta is not None or controls_update is not None \
                or command_hook is not None:
            meta, n = meta_dict_from_vec(np.asarray(out.meta_vec))
        blk_bits = None
        if out.rds is not None:
            if n is None:
                n = int(out.rds.count)
            blk_bits = np.asarray(out.rds.bits)[:n]
        if on_audio is not None:
            on_audio(frames)
        if on_meta is not None:
            on_meta(meta)
        if blk_bits is not None:
            if on_rds_bits is not None:
                on_rds_bits(blk_bits)
            if rds_feedback is not None and rds_feedback(blk_bits):
                state = rx.request_rds_resync(state)
        if controls_update is not None:
            controls = controls_update(controls, meta) or controls
        stop = False
        if command_hook is not None:
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        if meta is not None:
            metas.append(meta)
        if keep_outputs:
            audio_acc.append(frames)
            if blk_bits is not None:
                bits_acc.append(blk_bits)
                biq_acc.append(np.asarray(out.rds.iq)[:n])
        if collect_taps and out.taps:
            for k, v in out.taps.items():
                tap_acc.setdefault(k, []).append(np.asarray(v))
        if stop:
            break

    res = StreamResult(
        audio=(np.concatenate(audio_acc, axis=0) if audio_acc
               else np.zeros((0, 2), np.float32)),
        meta=metas, final_state=state)
    if bits_acc:
        res.rds_bits = np.concatenate(bits_acc)
        res.rds_iq = np.concatenate(biq_acc)
    if tap_acc:
        res.taps = {k: np.concatenate(v) for k, v in tap_acc.items()}
    return res


def _run_streaming_chunked(rx: Receiver, iq: np.ndarray, controls,
                           init_state, on_audio, on_meta, on_rds_bits,
                           drop_blocks: int, keep_outputs: bool,
                           collect_meta: bool, chunk_blocks: int
                           ) -> StreamResult:
    """run_streaming's throughput mode: one lax.scan dispatch per chunk.

    State threads through the scan exactly as through per-block steps;
    outputs are bit-identical to the scan runner and fp-close to
    chunk_blocks=1 (guarded by tests/test_cli.py).  A trailing partial
    chunk runs as a second, shorter scan (one extra compile, same program).
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    nblocks = len(iq) // T
    assert nblocks > 0, f"need at least {T} samples, got {len(iq)}"
    wire = _wire_dtype(cfg)
    state = init_state if init_state is not None else rx.init_state()
    runc = rx.jit_scan()

    def stage(lo: int, k: int):
        x = jnp.asarray(iq[lo * T:(lo + k) * T], wire)
        shp = (k, T) if cfg.iq_format == "c64" else (k, T, 2)
        return jax.device_put(x.reshape(shp))

    want_meta = collect_meta or on_meta is not None
    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    lo = 0
    k = min(chunk_blocks, nblocks)
    dev = stage(0, k)
    while lo < nblocks:
        cur_k = dev.shape[0]
        state, outs = runc(state, controls, dev)
        nxt = lo + cur_k
        if nxt < nblocks:          # stage the next chunk while this computes
            dev = stage(nxt, min(chunk_blocks, nblocks - nxt))
        # whole-chunk D2H drains behind compute
        _prefetch_outputs(outs, meta=want_meta, rds_iq=keep_outputs)
        audio = np.asarray(outs.audio_i16 if outs.audio_i16 is not None
                           else outs.audio)                 # [cur_k, Ta, 2]
        mv_np = np.asarray(outs.meta_vec) if want_meta else None
        bits_np = counts = biq_np = None
        if outs.rds is not None:
            counts = np.asarray(outs.rds.count)
            bits_np = np.asarray(outs.rds.bits)
            if keep_outputs:
                biq_np = np.asarray(outs.rds.iq)
        for j in range(cur_k):
            b = lo + j
            if b < drop_blocks:
                continue
            frames = audio[j]
            if on_audio is not None:
                on_audio(frames)
            if mv_np is not None:
                meta, _ = meta_dict_from_vec(mv_np[j])
                if on_meta is not None:
                    on_meta(meta)
                if collect_meta:
                    metas.append(meta)
            blk_bits = (bits_np[j, : int(counts[j])]
                        if bits_np is not None else None)
            if on_rds_bits is not None and blk_bits is not None:
                on_rds_bits(blk_bits)
            if keep_outputs:
                audio_acc.append(frames)
                if blk_bits is not None:
                    bits_acc.append(blk_bits)
                    biq_acc.append(biq_np[j, : int(counts[j])])
        lo = nxt

    res = StreamResult(
        audio=(np.concatenate(audio_acc, axis=0) if audio_acc
               else np.zeros((0, 2), np.float32)),
        meta=metas, final_state=state)
    if bits_acc:
        res.rds_bits = np.concatenate(bits_acc)
        res.rds_iq = np.concatenate(biq_acc)
    return res


def run_live(rx: Receiver, source,
             controls: Optional[Controls] = None,
             init_state=None,
             max_blocks: Optional[int] = None,
             on_audio=None, on_meta=None, on_rds_bits=None,
             keep_outputs: bool = True,
             rds_feedback=None,
             controls_update=None,
             command_hook=None,
             on_state=None,
             on_taps=None,
             timeout_ms: int = 30_000) -> StreamResult:
    """Live block driver: pull paced blocks from a streaming Source's ring.

    This is the reference's engine thread (fm-processor.cpp:387-417: wait for
    Samples(), getSamples(16384), process) in block form: `source` is a
    runtime.native_source.NativeWavSource / NativeRawSource (C++ producer
    thread -> lock-free SPSC ring, real-time paced like the filereader's
    10 ms emission loop, filehulp.cpp:159-202) and each iteration blocks on
    `read_block` until one receiver block is available, then demodulates it
    while the host pre-reads the next block from the ring (so ring drain
    overlaps device compute).  Runs until EOF, `max_blocks`, or a read
    timeout (a stalled producer).

    Overrun accounting: a paced source drops frames when the ring fills (the
    live-SDR failure mode); the per-block delta is surfaced as
    meta['ingest_dropped'] and the total in StreamResult.dropped_total.

    rds_feedback(bits) -> bool: called with each block's decoded RDS bits;
    returning True requests a bit-clock re-acquisition in the next block
    (Receiver.request_rds_resync — the decoder-3 resync contract,
    rds-decoder-3.cpp:94-99).  The source's wire format must match
    rx.cfg.iq_format (NativeWavSource -> 'c64', NativeRawSource -> its fmt).

    on_state(blocks_done, state): periodic-checkpoint hook, same contract
    as run_streaming's.
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()
    wire = _wire_dtype(cfg)

    audio_acc, metas, bits_acc, biq_acc = [], [], [], []
    dropped_last = source.dropped
    b = 0
    blk_np = source.read_block(T, timeout_ms)
    # latency reference: read_block returns when the block's last sample is
    # available, so (audio-delivered - block-ready) is the end-to-end
    # processing+delivery latency on top of the 1-block accumulation time.
    # (When the chain lags the pacing, the pre-read returns from backlog
    # and this understates the true signal age — drops surface that case.)
    t_ready = time.perf_counter()
    blk_dev = (jax.device_put(jnp.asarray(blk_np, wire))
               if len(blk_np) == T else None)
    while blk_dev is not None and (max_blocks is None or b < max_blocks):
        state, out = step(state, controls, blk_dev)
        _prefetch_outputs(out)       # D2H overlaps the ring wait below
        # pre-read the next block from the ring while the device computes,
        # and stage it onto the device IMMEDIATELY (double buffering):
        # device_put is async, so block k+1's H2D rides along while block
        # k's outputs drain instead of adding its latency to every block
        blk_np = source.read_block(T, timeout_ms)
        t_next_ready = time.perf_counter()
        blk_dev = (jax.device_put(jnp.asarray(blk_np, wire))
                   if len(blk_np) == T else None)
        frames = np.asarray(out.audio_i16 if out.audio_i16 is not None
                            else out.audio)
        drops_total = source.dropped
        # one packed D2H instead of ~9 scalar round trips
        meta, n = meta_dict_from_vec(np.asarray(out.meta_vec))
        meta["ingest_dropped"] = int(drops_total - dropped_last)
        dropped_last = drops_total
        blk_bits = None
        if out.rds is not None:
            blk_bits = np.asarray(out.rds.bits)[:n]
        if on_audio is not None:
            on_audio(frames)
        meta["latency_ms"] = (time.perf_counter() - t_ready) * 1e3
        t_ready = t_next_ready
        if on_taps is not None and out.taps:
            # incremental live dumps (fm-processor.cpp:338-349,448-455
            # dump while receiving) — values stay device arrays so the
            # callback only pays D2H for the taps it actually writes
            on_taps(dict(out.taps))
        if on_meta is not None:
            on_meta(meta)
        if blk_bits is not None:
            if on_rds_bits is not None:
                on_rds_bits(blk_bits)
            if rds_feedback is not None and rds_feedback(blk_bits):
                state = rx.request_rds_resync(state)
        if controls_update is not None:
            controls = controls_update(controls, meta) or controls
        stop = False
        if command_hook is not None:
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        metas.append(meta)
        if keep_outputs:
            audio_acc.append(frames)
            if blk_bits is not None:
                bits_acc.append(blk_bits)
                biq_acc.append(np.asarray(out.rds.iq)[:n])
        b += 1
        if stop:
            break

    res = StreamResult(
        audio=(np.concatenate(audio_acc, axis=0) if audio_acc
               else np.zeros((0, 2), np.float32)),
        meta=metas, final_state=state)
    res.dropped_total = int(source.dropped)
    if bits_acc:
        res.rds_bits = np.concatenate(bits_acc)
        res.rds_iq = np.concatenate(biq_acc)
    return res


def run_offline(rx: Receiver, iq: np.ndarray,
                controls: Optional[Controls] = None,
                drop_blocks: int = 0,
                collect_taps: bool = False,
                init_state=None,
                rds_feedback=None,
                controls_update=None,
                command_hook=None,
                on_state=None) -> StreamResult:
    """Process a full IQ array through the receiver, block by block.

    drop_blocks: number of leading blocks to exclude from the result (filter
    warm-up), while still advancing state through them.
    rds_feedback(bits) -> bool: per-block host feedback from the block
    synchronizer into the bit decoder (rds.live.LiveRDSDecoder.feed); True
    requests a bit-clock re-acquisition before the next block
    (Receiver.request_rds_resync, the decoder-3 contract).
    controls_update(controls, meta) -> Controls|None: per-block control
    closure — the host control loop of the reference's 500 ms metadata
    tick (AFC, radio.cpp:1786-1809); returning a Controls replaces the
    controls for subsequent blocks (traced args: no recompile).
    """
    cfg = rx.cfg
    controls = controls if controls is not None else rx.initial_controls()
    T = cfg.wire_len
    nblocks = len(iq) // T
    assert nblocks > 0, f"need at least {T} samples, got {len(iq)}"
    step = rx.jit_step()
    state = init_state if init_state is not None else rx.init_state()

    wire = _wire_dtype(cfg)
    audio, metas, bits, biq = [], [], [], []
    tap_acc: dict = {}
    for b in range(nblocks):
        blk = jnp.asarray(iq[b * T : (b + 1) * T], wire)
        state, out = step(state, controls, blk)
        # one packed D2H for the meta scalars + RDS count
        meta, n = meta_dict_from_vec(np.asarray(out.meta_vec))
        if out.rds is not None and rds_feedback is not None:
            if rds_feedback(np.asarray(out.rds.bits)[:n]):
                state = rx.request_rds_resync(state)
        if controls_update is not None:
            controls = controls_update(controls, meta) or controls
        stop = False
        if command_hook is not None:
            state, controls, stop = command_hook(state, controls, meta)
        if on_state is not None:
            on_state(b + 1, state)
        if b < drop_blocks:
            if stop:
                break
            continue
        audio.append(np.asarray(out.audio))
        metas.append(meta)
        if out.rds is not None:
            bits.append(np.asarray(out.rds.bits)[:n])
            biq.append(np.asarray(out.rds.iq)[:n])
        if collect_taps and out.taps:
            for k, v in out.taps.items():
                tap_acc.setdefault(k, []).append(np.asarray(v))
        if stop:
            break

    res = StreamResult(audio=(np.concatenate(audio, axis=0) if audio
                              else np.zeros((0, 2), np.float32)),
                       meta=metas, final_state=state)
    if bits:
        res.rds_bits = np.concatenate(bits)
        res.rds_iq = np.concatenate(biq)
    if tap_acc:
        res.taps = {k: np.concatenate(v) for k, v in tap_acc.items()}
    return res
