"""Multi-chip sharding of the receive chain over a jax.sharding.Mesh.

The reference's only concurrency is thread-pipeline-over-ring-buffers on one
host (SURVEY.md §2.6).  This framework's device scaling model is *data
parallelism over time*:

  - the 2.304 MS/s front end (gains, DC servo, LO mix, optional 65536-pt
    channel filter, ÷12 decimation cascade) runs inside `shard_map` with the
    input block laid out over the mesh's `time` axis.  Convolution left-halos
    come from the ring neighbour via `ppermute`; device 0 uses the
    inter-block carry.  The per-block DC estimate uses a strided subsample
    `all_gather`ed and reduced identically on every device, so the update is
    bit-exact regardless of device count.
  - the 192 kS/s fm chain (discriminator, pilot, PSS, matrix, RDS, audio) is
    replicated: its inputs are 12x smaller than the input stream and its
    sequential glue (PSS sub-block scan, RDS bit grid) is inherently
    stream-ordered.  Sharding it further (fm-rate conv halos + carry
    composition for the linear recurrences) is the planned next scaling step.

Because the sharded front end computes exactly the same per-sample values as
the single-device path (same convolution shapes per output, same constant DC
correction, LO phase a pure function of the global sample index), the N-way
step is bit-exact vs the 1-device step — asserted by tests/test_sharding.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.receiver import Controls, Receiver, ReceiverState

AXIS = "time"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


class FullyShardedReceiver:
    """Receiver step with BOTH the front end and the fm chain partitioned
    over a 1-D time mesh (SCALING.md roadmap realised): convolutions take
    ppermute halos, trackers use the distributed prefix decomposition, and
    only the tiny sequential glue (PSS scalar scan, 24 kS/s RDS bit grid)
    runs replicated on all-gathered reductions.

    Audio is numerically equivalent (not bit-exact) to the single-chip run:
    the distributed prefix reassociates fp32 sums (~1e-5).  The front-end-
    only `ShardedReceiver` below remains the bit-exact configuration.
    """

    def __init__(self, rx: Receiver, mesh: Mesh, axis: str = AXIS):
        self.rx = rx
        self.mesh = mesh
        self.axis = axis
        n = int(mesh.devices.size)
        cfg = rx.cfg
        # the debug taps are per-device time slices; this class's output
        # spec replicates them, which would silently export one shard as
        # if it were the whole block — use ShardedReceiver (or the
        # single-device step) for tap/scope work
        assert not cfg.emit_taps, \
            "emit_taps is not supported by FullyShardedReceiver"
        t_fm_local = cfg.block_fm // n
        assert cfg.block_in % n == 0
        assert t_fm_local % cfg.fm_hop == 0, (t_fm_local, cfg.fm_hop)
        assert t_fm_local % rx.pss_cfg.subblock == 0
        assert (cfg.block_in // n) % 12 == 0
        assert (cfg.block_in // n) % rx.DC_SUBSAMPLE == 0
        if cfg.squelch != "off":
            assert t_fm_local % rx.squelch_cfg.hold_period == 0, \
                (t_fm_local, rx.squelch_cfg.hold_period)
        if cfg.audio_rate != cfg.working_rate:
            assert t_fm_local % (cfg.fm_rate // cfg.working_rate) == 0
        if cfg.input_filter:
            assert (cfg.block_in // n) % cfg.input_hop == 0
        self.iq_sharding = NamedSharding(mesh, P(axis))
        self.replicated = NamedSharding(mesh, P())

        def body(state, controls, iq_local):
            # defer_dc: the DC-servo gather folds into fm_chain's fused
            # end-of-chain collective (dc carries the local subsample)
            v_local, (dc, in_tail, t1, t2, _, _) = rx.front_end(
                state, controls, iq_local, shard_axis=axis, defer_dc=True)
            tails = tuple(t[None] if t is not None else None
                          for t in (in_tail, t1, t2))
            fe_updates = dict(
                n0_mod=(state.n0_mod + cfg.block_in) % cfg.input_rate,
                rf_dc=dc, input_filt=None, band1=None, band2=None)
            new_state, out = rx.fm_chain(state, controls, v_local,
                                         fe_updates, shard_axis=axis)
            return new_state, out, tails

        from ..models.receiver import Output
        out_spec_output = Output(audio=P(axis), meta=P(), rds=P(), taps=P(),
                                 meta_vec=P(), audio_i16=P(axis))
        self._body = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(axis)),
            out_specs=(P(), out_spec_output, P(axis)),
            check_vma=False)

        def step(state, controls, iq):
            new_state, out, (in_tails, tails1, tails2) = self._body(
                state, controls, iq)
            new_state = new_state._replace(
                input_filt=(in_tails[-1] if cfg.input_filter
                            else state.input_filt),
                band1=tails1[-1], band2=tails2[-1])
            return new_state, out

        self._step = jax.jit(step, in_shardings=(None, None, self.iq_sharding))

    def init_state(self):
        return jax.device_put(self.rx.init_state(), self.replicated)

    def step(self, state, controls, iq):
        iq = jax.device_put(iq, self.iq_sharding)
        return self._step(state, controls, iq)


class StationTimeShardedReceiver:
    """BOTH parallel dimensions on one 2-D mesh: stations × time.

    The mesh is `Mesh(devices.reshape(S, T), ('stations', 'time'))`: the
    embarrassingly-parallel station axis (zero collectives, whole
    stations per device group — models/multistation.py) composes with the
    fully-sharded time axis (ppermute halos + distributed prefix
    recurrences within each station's block — FullyShardedReceiver).
    Each device holds `n_stations/S` stations' `block/T` time slice; all
    collectives ride the 'time' axis only, so the station axis adds no
    traffic between devices.

    This is the band-scale production shape: identify/demodulate every
    station of a wideband capture with the per-station latency of a
    T-way-sharded chain.  Per-station outputs are numerically equivalent
    (~1e-5) to the vmapped single-device run — same caveat as
    FullyShardedReceiver (fp32 prefix reassociation), same capability
    caps (rds off|block, no taps).
    """

    def __init__(self, rx: Receiver, mesh: Mesh,
                 station_axis: str = "stations", time_axis: str = AXIS):
        self.rx = rx
        self.mesh = mesh
        self.station_axis = station_axis
        self.time_axis = time_axis
        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.n_station_groups = axes[station_axis]
        n_t = axes[time_axis]
        cfg = rx.cfg
        assert cfg.rds in ("off", "block") and not cfg.emit_taps
        assert cfg.block_fm % (n_t * cfg.fm_hop) == 0
        assert (cfg.block_fm // n_t) % rx.pss_cfg.subblock == 0
        self.iq_sharding = NamedSharding(mesh, P(time_axis))
        self.station_sharding = NamedSharding(mesh, P(station_axis))
        self.replicated = NamedSharding(mesh, P())

        def one_station(state, controls, iq_local):
            # the FullyShardedReceiver body, collectives on 'time'
            v_local, (dc, in_tail, t1, t2, _, _) = rx.front_end(
                state, controls, iq_local, shard_axis=time_axis,
                defer_dc=True)
            tails = tuple(t[None] if t is not None else None
                          for t in (in_tail, t1, t2))
            fe_updates = dict(
                n0_mod=(state.n0_mod + cfg.block_in) % cfg.input_rate,
                rf_dc=dc, input_filt=None, band1=None, band2=None)
            new_state, out = rx.fm_chain(state, controls, v_local,
                                         fe_updates, shard_axis=time_axis)
            return new_state, out, tails

        # station axis via vmap inside the shard_map body: collectives
        # inside the vmap name only the mesh 'time' axis, so each
        # station's halos/reductions stay within its own time group
        vbody = jax.vmap(one_station, in_axes=(0, 0, None))

        from ..models.receiver import Output
        S, T = station_axis, time_axis
        out_spec = Output(audio=P(S, T), meta=P(S), rds=P(S), taps=P(S),
                          meta_vec=P(S), audio_i16=P(S, T))
        self._body = jax.shard_map(
            vbody, mesh=mesh,
            in_specs=(P(S), P(S), P(T)),
            out_specs=(P(S), out_spec, P(S, T)), check_vma=False)

        def step(states, controls, iq):
            new_states, out, (in_tails, tails1, tails2) = self._body(
                states, controls, iq)
            new_states = new_states._replace(
                input_filt=(in_tails[:, -1] if cfg.input_filter
                            else states.input_filt),
                band1=tails1[:, -1], band2=tails2[:, -1])
            return new_states, out

        self._step = jax.jit(
            step, in_shardings=(self.station_sharding, self.station_sharding,
                                self.iq_sharding))

    def pad_offsets(self, offsets_hz):
        offsets = list(offsets_hz)
        pad = (-len(offsets)) % self.n_station_groups
        return offsets + [0] * pad

    def init_states(self, n_stations: int):
        assert n_stations % self.n_station_groups == 0
        st = self.rx.init_state()
        states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (n_stations,) + x.shape),
            st)
        return jax.device_put(states, self.station_sharding)

    def controls_for(self, offsets_hz):
        # reuse the per-station Controls builder (broadcasts every leaf
        # along the station axis)
        from ..models.multistation import MultiStationReceiver
        assert len(offsets_hz) % self.n_station_groups == 0
        msr = MultiStationReceiver.__new__(MultiStationReceiver)
        msr.rx = self.rx
        return jax.device_put(msr.controls_for(offsets_hz),
                              self.station_sharding)

    def step(self, states, controls, iq):
        iq = jax.device_put(iq, self.iq_sharding)
        return self._step(states, controls, iq)


def make_mesh_2d(n_stations: int, n_time: int,
                 station_axis: str = "stations",
                 time_axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    assert len(devs) >= n_stations * n_time
    grid = np.asarray(devs[: n_stations * n_time]).reshape(n_stations,
                                                           n_time)
    return Mesh(grid, (station_axis, time_axis))


class ShardedReceiver:
    """Receiver step partitioned over a 1-D time mesh."""

    def __init__(self, rx: Receiver, mesh: Mesh, axis: str = AXIS):
        self.rx = rx
        self.mesh = mesh
        self.axis = axis
        n = int(mesh.devices.size)
        cfg = rx.cfg
        t_local = cfg.block_in // n
        assert cfg.block_in % n == 0
        assert t_local % 12 == 0 and t_local % rx.DC_SUBSAMPLE == 0
        if cfg.input_filter:
            assert t_local % cfg.input_hop == 0, (t_local, cfg.input_hop)
        self.iq_sharding = NamedSharding(mesh, P(axis))
        self.replicated = NamedSharding(mesh, P())

        def front(state, controls, iq_local):
            v_local, (dc, in_tail, t1, t2, _, _) = rx.front_end(
                state, controls, iq_local, shard_axis=axis)
            tails = tuple(t[None] if t is not None else None
                          for t in (in_tail, t1, t2))
            return v_local, dc, tails

        self._front = jax.shard_map(
            front, mesh=mesh,
            in_specs=(P(), P(), P(axis)),
            out_specs=(P(axis), P(), P(axis)),
            check_vma=False)

        def step(state: ReceiverState, controls: Controls, iq):
            v, dc_last, (in_tails, tails1, tails2) = self._front(
                state, controls, iq)
            v = jax.lax.with_sharding_constraint(v, self.replicated)
            fe_updates = dict(
                n0_mod=(state.n0_mod + cfg.block_in) % cfg.input_rate,
                rf_dc=dc_last,
                input_filt=(in_tails[-1] if cfg.input_filter else None),
                band1=tails1[-1], band2=tails2[-1])
            return rx.fm_chain(state, controls, v, fe_updates)

        self._step = jax.jit(step, in_shardings=(None, None, self.iq_sharding))

    def init_state(self) -> ReceiverState:
        return jax.device_put(self.rx.init_state(), self.replicated)

    def step(self, state: ReceiverState, controls: Controls, iq):
        iq = jax.device_put(iq, self.iq_sharding)
        return self._step(state, controls, iq)
