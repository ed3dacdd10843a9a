"""Wire-format tests: i16/u8 on-device conversion == c64 path, bit for bit.

Narrow formats (ReceiverConfig.iq_format) cut the bytes the front end
reads per 2.304 MS/s input sample; these tests pin
that they are a pure layout change, not a numerics change: int16/32768 and
(uint8-127)/128 are exact in float32, so feeding raw integers must reproduce
the complex64 run sample-for-sample.
"""

import numpy as np
import pytest

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu.runtime.stream import run_offline


@pytest.fixture(scope="module")
def capture_i16():
    n = 3 * 32768
    t = np.arange(n) / C.FM_RATE
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams())
    iq = synth.fm_modulate(mpx, C.FM_RATE)
    return synth.iq_to_i16(iq)


def _run(iq, fmt, **cfg_kw):
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 iq_format=fmt, **cfg_kw))
    return run_offline(rx, iq)


class TestI16:
    def test_bit_exact_vs_c64(self, capture_i16):
        i16 = capture_i16
        c64 = ((i16[:, 0].astype(np.float32)
                + 1j * i16[:, 1].astype(np.float32)) / 32768.0
               ).astype(np.complex64)
        r_c = _run(c64, "c64")
        r_i = _run(i16, "i16")
        np.testing.assert_array_equal(r_c.audio, r_i.audio)
        np.testing.assert_array_equal(r_c.rds_bits, r_i.rds_bits)
        assert r_c.meta == r_i.meta

    def test_decodes_stereo_and_rds(self, capture_i16):
        from sdrjfm_tpu.rds.blocksync import BlockSynchronizer, Group
        n = 5 * 32768
        t = np.arange(n) / C.FM_RATE
        from sdrjfm_tpu.rds import encode
        bits = encode.make_bitstream(pi=0x1234, pty=7, station="I16FMT  ",
                                     radiotext="x", repeats=4)
        syms = encode.differential_encode(bits)
        mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                              0.5 * np.sin(2 * np.pi * 300 * t),
                              synth.MPXParams(rds_level=0.07), rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE)
        i16 = synth.iq_to_i16(iq)
        res = _run(i16, "i16", audio_filter_hz=15000)
        sync = BlockSynchronizer()
        grp = Group()
        names = []
        from sdrjfm_tpu.rds.groups import GroupDecoder
        dec = GroupDecoder()
        sync.push_bits(res.rds_bits, grp, on_group=dec.decode)
        assert sync.groups_decoded > 5
        assert dec.result.pi_code == 0x1234


class TestU8:
    def test_bit_exact_vs_c64(self, capture_i16):
        u8 = ((capture_i16.astype(np.int32) >> 9) + 127).clip(0, 255
                                                              ).astype(np.uint8)
        c64 = (((u8[:, 0].astype(np.float32) - 127.0)
                + 1j * (u8[:, 1].astype(np.float32) - 127.0)) / 128.0
               ).astype(np.complex64)
        r_c = _run(c64, "c64")
        r_u = _run(u8, "u8")
        np.testing.assert_array_equal(r_c.audio, r_u.audio)


class TestShardedI16:
    def test_front_end_sharded_matches_single(self, capture_i16):
        """8-way sharded front end on i16 input == single-device, bit-exact."""
        import jax
        from sdrjfm_tpu.parallel.sharding import ShardedReceiver, make_mesh
        from sdrjfm_tpu.models.receiver import default_controls
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                     iq_format="i16"))
        sh = ShardedReceiver(rx, make_mesh(8))
        controls = default_controls()
        st1 = rx.init_state()
        st8 = sh.init_state()
        import jax.numpy as jnp
        blk = capture_i16[: rx.cfg.block_in]
        st1, out1 = rx.jit_step()(st1, controls, jnp.asarray(blk))
        st8, out8 = sh.step(st8, controls, jnp.asarray(blk))
        np.testing.assert_array_equal(np.asarray(out1.audio),
                                      np.asarray(out8.audio))


class TestI8:
    """The hackrf wire format: SIGNED bytes /128
    (hackrf-handler.cpp:360-365 — hackrf_transfer raw captures)."""

    def test_bit_exact_vs_c64(self, capture_i16):
        i8 = (capture_i16.astype(np.int32) >> 8).clip(-128, 127
                                                      ).astype(np.int8)
        c64 = ((i8[:, 0].astype(np.float32)
                + 1j * i8[:, 1].astype(np.float32)) / 128.0
               ).astype(np.complex64)
        r_c = _run(c64, "c64")
        r_i = _run(i8, "i8")
        np.testing.assert_array_equal(r_c.audio, r_i.audio)
        np.testing.assert_array_equal(r_c.rds_bits, r_i.rds_bits)
        assert r_c.meta == r_i.meta

    def test_cli_reads_hackrf_style_raw(self, tmp_path):
        """End-to-end: a headerless SIGNED-byte capture (what
        `hackrf_transfer -r` writes) through `rx --iq-format i8`."""
        import json
        from sdrjfm_tpu.app import main
        from sdrjfm_tpu.rds import encode

        # >= 2 name rotations must AIR: sync acquisition consumes most
        # of the first group, and one rotation is 20 groups ~ 1.7 s
        n = 16 * 32768
        t = np.arange(n) / C.FM_RATE
        bits = encode.make_bitstream(pi=0xBEEF, station="HACKRF  ",
                                     radiotext="x", repeats=8)
        syms = encode.differential_encode(bits)
        mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                              0.5 * np.sin(2 * np.pi * 300 * t),
                              synth.MPXParams(rds_level=0.08),
                              rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE)
        path = str(tmp_path / "capture.i8")
        synth.iq_to_i8(iq * 0.95).tofile(path)   # i8 headroom like a real
        report = str(tmp_path / "rep.json")      # front end's AGC leaves
        rc = main(["rx", "--iq", path, "--iq-format", "i8", "--rds",
                   "--report", report, "--block-fm", "32768"])
        assert rc == 0
        rep = json.load(open(report))
        assert rep["rds"]["pi_code"] == "0xBEEF"
        assert rep["rds"]["station_label"] == "HACKRF  "
        assert rep["meta_last"]["pilot_locked"] is True
        # and live through the native raw ring (--follow: signed bytes
        # pass the C SPSC untouched, dtype applied host-side)
        report2 = str(tmp_path / "rep2.json")
        rc = main(["rx", "--iq", path, "--iq-format", "i8", "--rds",
                   "--report", report2, "--block-fm", "32768",
                   "--follow", "--no-pace"])
        assert rc == 0
        rep2 = json.load(open(report2))
        assert rep2["rds"]["pi_code"] == "0xBEEF"
        assert rep2["rds"]["station_label"] == "HACKRF  "
