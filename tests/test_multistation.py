"""Whole-radio integration: multi-station capture -> scan -> tune -> identify.

The closest thing to the reference's real-world use: a wideband capture
containing several transmissions; the band scan finds them, retuning is pure
LO offset, and each station's RDS identifies it.
"""

import numpy as np
import jax
import jax.numpy as jnp

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                        default_controls)
from sdrjfm_tpu.models.tuner import RadioController
from sdrjfm_tpu.rds.blocksync import BlockSynchronizer, Group
from sdrjfm_tpu.rds.groups import GroupDecoder
from sdrjfm_tpu.runtime.stream import run_offline

STATIONS = [
    dict(offset=-500_000, pi=0x1111, name="STATION1", tone=700.0),
    dict(offset=400_000, pi=0x2222, name="STATION2", tone=1300.0),
]


def make_capture(seconds=3.0, noise=0.01):
    return synth.multistation_iq(STATIONS, seconds=seconds, noise=noise)


def test_scan_tune_identify():
    iq = make_capture()
    rc = RadioController(Receiver(ReceiverConfig(block_fm=32768, rds="off")))
    T = rc.rx.cfg.block_in
    found = rc.scan(iq[:T], grid_hz=100_000)
    for st in STATIONS:
        assert st["offset"] in found, (st["offset"], found)
    # no spurious hits far from real stations
    for f in found:
        assert any(abs(f - st["offset"]) <= 100_000 for st in STATIONS), found

    for st in STATIONS:
        rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                     audio_filter_hz=15000))
        controls = default_controls()._replace(
            lo_freq_hz=jnp.asarray(st["offset"], jnp.int32))
        res = run_offline(rx, iq, controls)
        assert res.meta[-1]["pilot_locked"] == 1.0
        sync, dec, grp = BlockSynchronizer(), GroupDecoder(), Group()
        sync.push_bits(res.rds_bits, grp, on_group=dec.decode)
        assert dec.result.pi_code == st["pi"], st
        assert dec.result.station_label == st["name"], st
        # audio tone present and clean
        x = res.audio[len(res.audio) // 2:, 0]
        w = np.hanning(len(x))
        X = np.abs(np.fft.rfft(x * w)) ** 2
        b = int(round(st["tone"] * len(x) / C.WORKING_RATE))
        sig = X[b - 3:b + 4].sum()
        snr = 10 * np.log10(sig / max(X[8:].sum() - sig, 1e-30))
        assert snr > 25.0, (st, snr)


def test_batched_multistation_matches_serial():
    """One vmapped dispatch demodulating BOTH stations == per-station runs."""
    from sdrjfm_tpu.models.multistation import demodulate_stations

    iq = make_capture(seconds=3.0)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 audio_filter_hz=15000))
    offsets = [st["offset"] for st in STATIONS]
    batched = demodulate_stations(rx, iq, offsets)

    for res, st in zip(batched, STATIONS):
        # serial single-station run of the same capture at the same offset
        controls = default_controls()._replace(
            lo_freq_hz=jnp.asarray(st["offset"], jnp.int32))
        serial = run_offline(rx, iq, controls)
        np.testing.assert_allclose(res["audio"], serial.audio, atol=2e-5)
        assert res["meta"]["pilot_locked"]
        # identical decoded RDS identity
        for bits_src, tag in ((res["rds_bits"], "batched"),
                              (serial.rds_bits, "serial")):
            sync = BlockSynchronizer()
            dec = GroupDecoder()
            grp = Group()
            sync.push_bits(bits_src, grp, on_group=dec.decode)
            assert dec.result.pi_code == st["pi"], (tag, st)
            assert dec.result.station_label.strip() == st["name"], (tag, st)


def test_scan_cli_batched_identify(tmp_path):
    """CLI scan --identify (one vmapped dispatch for all hits) finds and
    names both stations."""
    import json
    from sdrjfm_tpu.app import main
    from sdrjfm_tpu.io.wavio import write_iq_wav

    iq = make_capture(seconds=3.0)
    cap = str(tmp_path / "band.wav")
    write_iq_wav(cap, iq, C.INPUT_RATE, float32=False)
    stations = str(tmp_path / "stations.json")
    import io
    import contextlib
    import sys as _sys
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["scan", "--iq", cap, "--identify",
                   "--stations", stations, "--block-fm", "32768"])
    assert rc == 0
    hits = json.loads(buf.getvalue())["hits"]
    by_pi = {h.get("pi_code"): h for h in hits if "pi_code" in h}
    assert "0x1111" in by_pi and "0x2222" in by_pi
    assert by_pi["0x1111"]["station"] == "STATION1"
    assert by_pi["0x2222"]["station"] == "STATION2"
    sl = json.load(open(stations))
    names = {e["name"] for e in sl["stations"]}
    assert {"STATION1", "STATION2"} <= names


def test_sharded_station_axis_matches_vmap():
    """Station axis on the 8-device CPU mesh == plain vmap, bit-exactly:
    the program inside shard_map IS the vmapped step over a sliced station
    batch (models/multistation.ShardedMultiStationReceiver) — zero
    collectives, whole stations per device."""
    from sdrjfm_tpu.models.multistation import (MultiStationReceiver,
                                                ShardedMultiStationReceiver)
    from sdrjfm_tpu.parallel.sharding import make_mesh

    iq = make_capture(seconds=1.5)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 audio_filter_hz=15000))
    mesh = make_mesh(axis="stations")
    smsr = ShardedMultiStationReceiver(rx, mesh)
    offsets = smsr.pad_offsets([st["offset"] for st in STATIONS])
    assert len(offsets) % smsr.n_devices == 0

    vmsr = MultiStationReceiver(rx)
    T = rx.cfg.block_in
    blk = jnp.asarray(iq[:T])
    sst, sout = smsr.step(smsr.init_states(len(offsets)),
                          smsr.controls_for(offsets), blk)
    vst, vout = vmsr.step(vmsr.init_states(len(offsets)),
                          vmsr.controls_for(offsets), blk)
    np.testing.assert_array_equal(np.asarray(sout.audio),
                                  np.asarray(vout.audio))
    np.testing.assert_array_equal(np.asarray(sout.rds.bits),
                                  np.asarray(vout.rds.bits))
    for leaf_s, leaf_v in zip(jax.tree_util.tree_leaves(sst),
                              jax.tree_util.tree_leaves(vst)):
        np.testing.assert_array_equal(np.asarray(leaf_s),
                                      np.asarray(leaf_v))


def test_sharded_identify_end_to_end():
    """demodulate_stations over the stations mesh (with hit-list padding)
    returns the same station identities as the vmap path."""
    from sdrjfm_tpu.models.multistation import demodulate_stations
    from sdrjfm_tpu.parallel.sharding import make_mesh

    iq = make_capture(seconds=3.0)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 audio_filter_hz=15000))
    offsets = [st["offset"] for st in STATIONS]
    sharded = demodulate_stations(rx, iq, offsets,
                                  mesh=make_mesh(axis="stations"))
    assert len(sharded) == len(STATIONS)
    for res, st in zip(sharded, STATIONS):
        assert res["meta"]["pilot_locked"]
        sync = BlockSynchronizer()
        dec = GroupDecoder()
        grp = Group()
        sync.push_bits(res["rds_bits"], grp, on_group=dec.decode)
        assert dec.result.pi_code == st["pi"]
        assert dec.result.station_label.strip() == st["name"]


def test_scan_dispatch_equals_block_loop():
    """demodulate_stations' one-dispatch lax.scan path == the per-block
    loop on both the vmap and the stations-mesh configurations: identical
    RDS bits, audio to float tolerance (the scan body compiles with
    different fusion than the standalone step — same caveat as the
    chunked stream runner)."""
    from sdrjfm_tpu.models.multistation import demodulate_stations
    from sdrjfm_tpu.parallel.sharding import make_mesh

    iq = make_capture(seconds=1.5)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 audio_filter_hz=15000))
    offsets = [st["offset"] for st in STATIONS]
    for mesh in (None, make_mesh(axis="stations")):
        a = demodulate_stations(rx, iq, offsets, mesh=mesh, scan=True)
        b = demodulate_stations(rx, iq, offsets, mesh=mesh, scan=False)
        for ra, rb, st in zip(a, b, STATIONS):
            np.testing.assert_allclose(ra["audio"], rb["audio"],
                                       atol=2e-5)
            # bit STREAMS may differ by a boundary tick (a marginal
            # bit-clock decision lands on the other side of a block
            # edge under the scan body's different fusion); the decoded
            # identity must be identical and error-free on both drives
            for bits in (ra["rds_bits"], rb["rds_bits"]):
                sync = BlockSynchronizer()
                dec = GroupDecoder()
                sync.push_bits(bits, Group(), on_group=dec.decode)
                assert sync.num_crc_errors == 0
                assert dec.result.pi_code == st["pi"]
                assert dec.result.station_label.strip() == st["name"]
            for k, v in ra["meta"].items():
                assert np.isclose(v, rb["meta"][k], atol=1e-4), (k, v)
