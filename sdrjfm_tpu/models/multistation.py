"""Multi-station receiver: demodulate N stations from ONE capture at once.

The reference tunes one station at a time — retuning is an LO-offset change
(radio.cpp:1056-1066) and the band scan identifies hits serially.  On an
accelerator the natural formulation is a vmap of the flagship `Receiver.step` over a
station axis: the wideband input block is shared (broadcast), each station
carries its own Controls (LO offset, gains) and its own state pytree, and
the N front ends batch into one conv/FFT program — identifying every
station in a band costs roughly one station's wall time.

No reference equivalent (its engine is strictly single-station); this is
the block-batched design paying off.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .receiver import Controls, Receiver

Array = jax.Array


class MultiStationReceiver:
    """vmap(Receiver.step) over a leading station axis."""

    def __init__(self, rx: Receiver):
        assert rx.cfg.rds in ("off", "block"), \
            "scan RDS decoders are per-sample sequential; use rds='block'"
        self.rx = rx
        self._step = jax.jit(jax.vmap(rx.step, in_axes=(0, 0, None)))

    def init_states(self, n_stations: int):
        st = self.rx.init_state()
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (n_stations,) + x.shape),
            st)

    def controls_for(self, offsets_hz: Sequence[int]) -> Controls:
        n = len(offsets_hz)
        ones = jnp.ones((n,), jnp.float32)
        base = self.rx.initial_controls()   # seeds pano + sound mix
        return Controls(
            lo_freq_hz=jnp.asarray(list(offsets_hz), jnp.int32),
            volume=ones, left_gain=ones, right_gain=ones,
            input_lgain=ones, input_rgain=ones,
            squelch_level=jnp.zeros((n,), jnp.float32),
            # every Controls leaf is vmapped along the station axis
            pano=jnp.broadcast_to(jnp.asarray(base.pano, jnp.float32),
                                  (n,)),
            sound_mix=jnp.broadcast_to(
                jnp.asarray(base.sound_mix, jnp.float32)[None], (n, 2, 2)),
            tone_gate=jnp.broadcast_to(
                jnp.asarray(base.tone_gate, jnp.float32), (n,)))

    def step(self, states, controls: Controls, iq: Array):
        """One shared input block -> per-station (states, Output) with a
        leading station axis on every output leaf."""
        return self._step(states, controls, iq)


class ShardedMultiStationReceiver(MultiStationReceiver):
    """The station axis on a device mesh: shard_map(vmap(rx.step)).

    Each device runs `n_stations / n_devices` COMPLETE stations against a
    replicated copy of the wideband block — zero collectives (the station
    axis is embarrassingly parallel), so scaling is near-linear by
    construction: this is the flagship multi-chip configuration.  It is
    the parallel replacement for the reference's serial scan loop
    (radio.cpp:1115-1158), which retunes and listens to one station at a
    time.

    n_stations must be a multiple of the mesh size — `pad_offsets` rounds
    a hit list up with dummy stations (offset 0) whose results callers
    drop.  Per-station results are bit-identical to the vmap path: the
    program inside shard_map IS the vmapped step, just over a sliced
    station batch (tests/test_multistation.py asserts this on an 8-way
    CPU mesh).
    """

    def __init__(self, rx: Receiver, mesh=None, axis: str = "stations"):
        from ..parallel.sharding import make_mesh

        super().__init__(rx)
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.n_devices = self.mesh.devices.size
        from jax.sharding import NamedSharding, PartitionSpec as P
        self.station_sharding = NamedSharding(self.mesh, P(axis))
        self.replicated = NamedSharding(self.mesh, P())
        vstep = jax.vmap(rx.step, in_axes=(0, 0, None))
        body = jax.shard_map(
            vstep, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=(P(axis), P(axis)), check_vma=False)
        self._step = jax.jit(body)

    def pad_offsets(self, offsets_hz: Sequence[int]) -> List[int]:
        """Round a station list up to a multiple of the mesh size (dummy
        stations at offset 0; callers slice results back to len(offsets))."""
        offsets = list(offsets_hz)
        pad = (-len(offsets)) % self.n_devices
        return offsets + [0] * pad

    def init_states(self, n_stations: int):
        assert n_stations % self.n_devices == 0, \
            f"{n_stations} stations over {self.n_devices} devices " \
            "(use pad_offsets)"
        return jax.device_put(super().init_states(n_stations),
                              self.station_sharding)

    def controls_for(self, offsets_hz: Sequence[int]) -> Controls:
        assert len(offsets_hz) % self.n_devices == 0
        return jax.device_put(super().controls_for(offsets_hz),
                              self.station_sharding)


def demodulate_stations(rx: Receiver, iq: np.ndarray,
                        offsets_hz: Sequence[int],
                        mesh=None, scan: bool = True) -> List[dict]:
    """Offline helper: run the whole capture for every offset at once.
    Returns per-station dicts with 'audio' [n, 2], 'rds_bits' (np.uint8)
    and 'meta' (last block's metadata).

    mesh: a jax.sharding.Mesh puts the station axis on devices
    (ShardedMultiStationReceiver) — the hit list is padded to the mesh
    size and the dummy results dropped.
    scan: dispatch the whole capture as ONE jitted lax.scan over blocks
    (the throughput path — per-block Python dispatch overhead dominates
    once a block computes in microseconds); False runs the per-block
    loop.  The two drives decode identical RDS bits and agree in audio
    to float tolerance (the scan body fuses differently than the
    standalone step — same caveat as run_offline_scanned).
    """
    n_real = len(offsets_hz)
    if mesh is not None:
        msr = ShardedMultiStationReceiver(rx, mesh)
        offsets_hz = msr.pad_offsets(offsets_hz)
    else:
        msr = MultiStationReceiver(rx)
    n = len(offsets_hz)
    T = rx.cfg.block_in
    nblocks = len(iq) // T
    assert nblocks > 0
    states = msr.init_states(n)
    controls = msr.controls_for(offsets_hz)
    audio, bits = [], [[] for _ in range(n)]
    meta = None
    if scan:
        blocks = jnp.asarray(iq[: nblocks * T]).reshape(nblocks, T)
        if mesh is not None:           # the wideband blocks replicate
            blocks = jax.device_put(blocks, msr.replicated)

        @jax.jit
        def run(states, controls, blocks):
            def body(st, blk):
                st, out = msr._step(st, controls, blk)
                return st, out
            return jax.lax.scan(body, states, blocks)

        states, outs = run(states, controls, blocks)
        audio = [a for a in np.asarray(outs.audio)]    # nb x [n, Tb, 2]
        if outs.rds is not None:
            counts = np.asarray(outs.rds.count)        # [nb, n]
            all_bits = np.asarray(outs.rds.bits)       # [nb, n, cap]
            for b in range(nblocks):
                for s in range(n):
                    bits[s].append(all_bits[b, s, : int(counts[b, s])])
        meta = {k: np.asarray(v)[-1]
                for k, v in outs.meta._asdict().items()}
    else:
        for b in range(nblocks):
            blk = jnp.asarray(iq[b * T:(b + 1) * T])
            states, out = msr.step(states, controls, blk)
            audio.append(np.asarray(out.audio))        # [n, Tb, 2]
            if out.rds is not None:
                counts = np.asarray(out.rds.count)
                all_bits = np.asarray(out.rds.bits)
                for s in range(n):
                    bits[s].append(all_bits[s, : int(counts[s])])
            meta = {k: np.asarray(v)
                    for k, v in out.meta._asdict().items()}
    results = []
    for s in range(n_real):      # padded dummy stations are dropped
        results.append({
            "offset_hz": int(offsets_hz[s]),
            "audio": np.concatenate([a[s] for a in audio], axis=0),
            "rds_bits": (np.concatenate(bits[s]) if bits[s] else None),
            "meta": {k: v[s].item() for k, v in meta.items()},
        })
    return results
