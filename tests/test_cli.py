"""CLI surface tests: synth -> rx roundtrip, runners, meta log, state flags.

The CLI is the framework's user surface (the reference's GUI equivalent,
radio.cpp/main.cpp); these drive it in-process through app.main.
"""

import json

import numpy as np
import pytest

from sdrjfm_tpu.app import main
from sdrjfm_tpu.io.wavio import read_wav


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    iq = str(d / "iq.wav")
    rc = main(["synth", "--out", iq, "--seconds", "3",
               "--station", "CLITEST", "--radiotext", "CLI ROUNDTRIP",
               "--pi", "0xBEEF", "--pty", "4"])
    assert rc == 0
    return iq


def _rx(capture, tmp_path, *extra):
    audio = str(tmp_path / "audio.wav")
    report = str(tmp_path / "report.json")
    rc = main(["rx", "--iq", capture, "--audio", audio, "--rds",
               "--report", report, "--block-fm", "32768", *extra])
    assert rc == 0
    return audio, json.load(open(report))


def test_rx_roundtrip_report(capture, tmp_path):
    audio, rep = _rx(capture, tmp_path)
    assert rep["rds"]["pi_code"] == "0xBEEF"
    assert rep["rds"]["station_label"].strip() == "CLITEST"
    assert rep["rds"]["bit_error_rate"] == 0.0
    assert rep["meta_last"]["pilot_locked"] is True
    x, info = read_wav(audio)
    assert info.rate == 48000 and info.channels == 2
    assert 0.2 < float((x ** 2).mean() ** 0.5) < 0.9


def test_scan_runner_matches_loop(capture, tmp_path):
    a1, r1 = _rx(capture, tmp_path, "--runner", "loop")
    (tmp_path / "s").mkdir()
    a2, r2 = _rx(capture, tmp_path / "s", "--runner", "scan")
    assert r2["rds"]["station_label"] == r1["rds"]["station_label"]
    assert r2["rds"]["groups_decoded"] == r1["rds"]["groups_decoded"]
    x1, _ = read_wav(a1)
    x2, _ = read_wav(a2)
    # scan-body fusion differs from standalone jit at fp level; PCM16 rounds
    # identically almost everywhere
    assert np.mean(x1 != x2) < 0.01
    assert r2["blocks"] == r1["blocks"]


def test_log_meta_jsonl(capture, tmp_path):
    log = str(tmp_path / "meta.jsonl")
    audio = str(tmp_path / "a.wav")
    rc = main(["rx", "--iq", capture, "--audio", audio,
               "--block-fm", "32768", "--log-meta", log])
    assert rc == 0
    recs = [json.loads(line) for line in open(log)]
    assert len(recs) >= 5
    assert recs[0]["block"] == 0 and recs[1]["t_s"] > recs[0]["t_s"]
    for k in ("pilot_locked", "pilot_strength", "dc_rf_db", "pss_phase_deg",
              "peak_left_db", "freq_offset_hz"):
        assert k in recs[0]
    assert recs[-1]["pilot_locked"] is True


def test_save_load_state_roundtrip(capture, tmp_path):
    st = str(tmp_path / "state.npz")
    a1 = str(tmp_path / "a1.wav")
    rc = main(["rx", "--iq", capture, "--audio", a1,
               "--block-fm", "32768", "--save-state", st])
    assert rc == 0
    a2 = str(tmp_path / "a2.wav")
    rc = main(["rx", "--iq", capture, "--audio", a2,
               "--block-fm", "32768", "--load-state", st])
    assert rc == 0
    # resumed run starts with converged trackers -> no startup ramp repeat
    x2, _ = read_wav(a2)
    assert float(np.abs(x2[:100]).mean()) > 0.0


def test_load_state_config_mismatch_fails(capture, tmp_path):
    st = str(tmp_path / "state.npz")
    a = str(tmp_path / "a.wav")
    rc = main(["rx", "--iq", capture, "--audio", a,
               "--block-fm", "32768", "--save-state", st])
    assert rc == 0
    from sdrjfm_tpu.runtime.checkpoint import CheckpointError
    with pytest.raises(CheckpointError):
        main(["rx", "--iq", capture, "--audio", a, "--block-fm", "32768",
              "--deemphasis", "75", "--load-state", st])


def test_pcm_out_streaming(capture, tmp_path):
    """--pcm-out streams s16le PCM identical to the wav-file PCM path."""
    pcm = str(tmp_path / "live.pcm")
    audio = str(tmp_path / "audio.wav")
    rc = main(["rx", "--iq", capture, "--audio", audio, "--block-fm", "32768",
               "--pcm-out", pcm])
    assert rc == 0
    raw = np.fromfile(pcm, dtype="<i2").reshape(-1, 2)
    x, info = read_wav(audio)
    assert info.rate == 48000
    assert raw.shape[0] == x.shape[0]
    # same quantizer, same samples: x was read back as i/32768, so
    # re-quantizing is exact
    want = (np.clip(x, -1.0, 1.0 - 1.0 / 32768) * 32768.0).astype("<i2")
    np.testing.assert_array_equal(raw, want)


def test_streaming_runner_bit_exact_vs_loop():
    """run_streaming (double-buffered staging) == run_offline, bit for bit."""
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu.runtime.stream import run_offline, run_streaming

    n = 3 * 32768
    t = np.arange(n) / C.FM_RATE
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams())
    iq = synth.fm_modulate(mpx, C.FM_RATE)
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block"))
    r1 = run_offline(rx, iq)
    heard = []
    r2 = run_streaming(rx, iq, on_audio=heard.append)
    np.testing.assert_array_equal(r1.audio, r2.audio)
    np.testing.assert_array_equal(np.concatenate(heard, axis=0), r1.audio)
    assert r1.meta == r2.meta
    if r1.rds_bits is not None:
        np.testing.assert_array_equal(r1.rds_bits, r2.rds_bits)
    # throughput mode: scan-of-2 chunks + a trailing partial chunk (3 = 2+1).
    # lax.scan compiles the block body with different fusion than the
    # standalone per-block jit (fp-level reassociation), so the oracle is
    # the scan runner (same program shape), bit for bit; the loop is
    # fp-close.
    from sdrjfm_tpu.runtime.stream import run_offline_scanned
    rs = run_offline_scanned(rx, iq, chunk_blocks=2)
    heard3 = []
    r3 = run_streaming(rx, iq, on_audio=heard3.append, chunk_blocks=2)
    np.testing.assert_array_equal(rs.audio, r3.audio)
    np.testing.assert_array_equal(np.concatenate(heard3, axis=0), r3.audio)
    np.testing.assert_allclose(r1.audio, r3.audio, atol=1e-5)
    assert rs.meta == r3.meta
    assert len(r3.meta) == len(r1.meta)
    if r1.rds_bits is not None:
        np.testing.assert_array_equal(rs.rds_bits, r3.rds_bits)
        np.testing.assert_array_equal(rs.rds_iq, r3.rds_iq)


def test_audio_i16_wire_matches_host_quantizer():
    """emit_audio_i16: the on-device PCM16 quantizer is bit-identical to
    io.pcmout/io.wavio's host quantizer (trunc-toward-zero, same clip)."""
    import jax.numpy as jnp
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                            default_controls)

    n = 32768
    t = np.arange(n) / C.FM_RATE
    mpx = synth.synth_mpx(0.7 * np.sin(2 * np.pi * 700 * t),
                          0.7 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams())
    iq = synth.fm_modulate(mpx, C.FM_RATE)
    rx = Receiver(ReceiverConfig(block_fm=32768, emit_audio_i16=True,
                                 rds="off"))
    state, out = rx.jit_step()(rx.init_state(), default_controls(),
                               jnp.asarray(iq[: rx.cfg.block_in]))
    a = np.asarray(out.audio)
    host = (np.clip(a, -1.0, 1.0 - 1.0 / 32768) * 32768.0).astype(np.int16)
    np.testing.assert_array_equal(np.asarray(out.audio_i16), host)
    # and the packed meta vector round-trips the Meta scalars exactly
    from sdrjfm_tpu.models.receiver import meta_dict_from_vec
    md, n_rds = meta_dict_from_vec(np.asarray(out.meta_vec))
    ref = {k: np.asarray(v).item() for k, v in out.meta._asdict().items()}
    assert md == ref
    assert n_rds == -1                    # rds off in this config


def test_orbax_checkpoint_roundtrip(capture, tmp_path):
    """--ckpt-backend orbax writes a directory; --load-state auto-detects it
    and resumes bit-identically to the npz backend."""
    st_npz = str(tmp_path / "state.npz")
    st_orb = str(tmp_path / "state_orbax")
    a0 = str(tmp_path / "a0.wav")
    rc = main(["rx", "--iq", capture, "--audio", a0, "--block-fm", "32768",
               "--save-state", st_npz])
    assert rc == 0
    rc = main(["rx", "--iq", capture, "--audio", a0, "--block-fm", "32768",
               "--save-state", st_orb, "--ckpt-backend", "orbax"])
    assert rc == 0
    import os
    assert os.path.isdir(st_orb)
    a1 = str(tmp_path / "a1.wav")
    a2 = str(tmp_path / "a2.wav")
    assert main(["rx", "--iq", capture, "--audio", a1, "--block-fm", "32768",
                 "--load-state", st_npz]) == 0
    assert main(["rx", "--iq", capture, "--audio", a2, "--block-fm", "32768",
                 "--load-state", st_orb]) == 0
    x1, _ = read_wav(a1)
    x2, _ = read_wav(a2)
    np.testing.assert_array_equal(x1, x2)


def test_orbax_config_mismatch_fails(capture, tmp_path):
    st = str(tmp_path / "state_orbax")
    a = str(tmp_path / "a.wav")
    assert main(["rx", "--iq", capture, "--audio", a, "--block-fm", "32768",
                 "--save-state", st, "--ckpt-backend", "orbax"]) == 0
    from sdrjfm_tpu.runtime.checkpoint import CheckpointError
    with pytest.raises(CheckpointError):
        main(["rx", "--iq", capture, "--audio", a, "--block-fm", "32768",
              "--deemphasis", "75", "--load-state", st])


def test_deemphasis_presets(capture, tmp_path):
    """--deemphasis accepts eu/us/off presets; 'us' == numeric 75."""
    a_us = str(tmp_path / "us.wav")
    a_75 = str(tmp_path / "n75.wav")
    assert main(["rx", "--iq", capture, "--audio", a_us,
                 "--block-fm", "32768", "--deemphasis", "us"]) == 0
    assert main(["rx", "--iq", capture, "--audio", a_75,
                 "--block-fm", "32768", "--deemphasis", "75"]) == 0
    x1, _ = read_wav(a_us)
    x2, _ = read_wav(a_75)
    np.testing.assert_array_equal(x1, x2)
    # 'off' must differ (more treble energy)
    a_off = str(tmp_path / "off.wav")
    assert main(["rx", "--iq", capture, "--audio", a_off,
                 "--block-fm", "32768", "--deemphasis", "off"]) == 0
    x3, _ = read_wav(a_off)
    assert float((x3 ** 2).mean()) > float((x1 ** 2).mean())


def test_squelch_auto_level(capture, tmp_path):
    """--squelch nsq --squelch-level auto keeps a clean station open."""
    audio = str(tmp_path / "sq.wav")
    rc = main(["rx", "--iq", capture, "--audio", audio, "--block-fm", "32768",
               "--squelch", "nsq", "--squelch-level", "auto"])
    assert rc == 0
    x, _ = read_wav(audio)
    # clean synth station: squelch must stay open (audio not muted)
    assert float((x[48000:] ** 2).mean() ** 0.5) > 0.2


def test_squelch_auto_closes_on_noise(tmp_path):
    """Pure-noise capture: the auto profile picks a level that mutes."""
    from sdrjfm_tpu.ops.squelch import auto_squelch_level
    rng = np.random.default_rng(7)
    demod = rng.standard_normal(131072).astype(np.float32)
    lvl = auto_squelch_level(demod)
    # noise: band ratio ~1 -> level near 0 -> thr near 1 -> squelch closes
    assert lvl < 20.0
    t = np.arange(131072) / 192000.0
    station = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    assert auto_squelch_level(station) > lvl + 20.0


def test_profile_trace(capture, tmp_path):
    trace = str(tmp_path / "trace")
    audio = str(tmp_path / "a.wav")
    assert main(["rx", "--iq", capture, "--audio", audio,
                 "--block-fm", "32768", "--profile", trace]) == 0
    import glob
    import os
    assert os.path.isdir(trace)
    assert glob.glob(trace + "/**/*.xplane.pb", recursive=True) or \
        glob.glob(trace + "/**/*.trace.json.gz", recursive=True)


def test_iq_format_i16_auto(tmp_path):
    """synth --int16 -> rx --iq-format auto reads raw PCM16 and matches the
    float-read run exactly."""
    iq = str(tmp_path / "iq16.wav")
    assert main(["synth", "--out", iq, "--seconds", "2", "--int16",
                 "--station", "I16TEST", "--pi", "0x1A2B"]) == 0
    a1 = str(tmp_path / "a1.wav")
    r1 = str(tmp_path / "r1.json")
    a2 = str(tmp_path / "a2.wav")
    r2 = str(tmp_path / "r2.json")
    assert main(["rx", "--iq", iq, "--audio", a1, "--rds", "--report", r1,
                 "--block-fm", "32768", "--iq-format", "auto"]) == 0
    assert main(["rx", "--iq", iq, "--audio", a2, "--rds", "--report", r2,
                 "--block-fm", "32768", "--iq-format", "c64"]) == 0
    x1, _ = read_wav(a1)
    x2, _ = read_wav(a2)
    np.testing.assert_array_equal(x1, x2)
    rep1, rep2 = json.load(open(r1)), json.load(open(r2))
    assert rep1["rds"]["pi_code"] == rep2["rds"]["pi_code"] == "0x1A2B"


def test_raw_u8_capture(tmp_path):
    """Headerless u8 capture (the rtl_sdr file convention) decodes RDS."""
    import numpy as np
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.rds import encode

    n = 17 * 32768              # ~2.9 s, same shape as the synth CLI fixture
    t = np.arange(n) / C.FM_RATE
    bits = encode.make_bitstream(pi=0xCAFE, pty=1, station="RAWU8   ",
                                 radiotext="raw capture", repeats=3)
    mpx = synth.synth_mpx(0.4 * np.sin(2 * np.pi * 900 * t),
                          0.4 * np.sin(2 * np.pi * 500 * t),
                          synth.MPXParams(rds_level=0.07),
                          rds_bits=encode.differential_encode(bits))
    iq = synth.fm_modulate(mpx, C.FM_RATE)
    u8 = synth.iq_to_u8(iq)
    raw = str(tmp_path / "cap.bin")
    u8.tofile(raw)
    rep = str(tmp_path / "rep.json")
    audio = str(tmp_path / "a.wav")
    assert main(["rx", "--iq", raw, "--iq-format", "u8", "--audio", audio,
                 "--rds", "--report", rep, "--block-fm", "32768"]) == 0
    r = json.load(open(rep))
    assert r["rds"]["pi_code"] == "0xCAFE"
    assert r["rds"]["station_label"].strip() == "RAWU8"
    # missing format flag on a raw file is a clean error, not a crash
    assert main(["rx", "--iq", raw, "--audio", audio,
                 "--block-fm", "32768"]) == 2


def test_squelch_auto_requires_nsq(capture, tmp_path):
    audio = str(tmp_path / "a.wav")
    assert main(["rx", "--iq", capture, "--audio", audio,
                 "--block-fm", "32768", "--squelch", "lsq",
                 "--squelch-level", "auto"]) == 2


def test_checkpoint_survives_iq_format_switch(tmp_path):
    """A state saved from an i16 run resumes a c64 run (wire format is not
    part of the DSP fingerprint)."""
    iq = str(tmp_path / "iq16.wav")
    assert main(["synth", "--out", iq, "--seconds", "2", "--int16"]) == 0
    st = str(tmp_path / "state.npz")
    a = str(tmp_path / "a.wav")
    assert main(["rx", "--iq", iq, "--audio", a, "--block-fm", "32768",
                 "--iq-format", "i16", "--save-state", st]) == 0
    assert main(["rx", "--iq", iq, "--audio", a, "--block-fm", "32768",
                 "--iq-format", "c64", "--load-state", st]) == 0


def test_chunked_scan_runner_bit_exact():
    """Chunked scan dispatches (bounded device memory) == one whole-capture dispatch."""
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu.runtime.stream import run_offline_scanned

    n = 6 * 32768
    t = np.arange(n) / C.FM_RATE
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 700 * t),
                          0.5 * np.sin(2 * np.pi * 300 * t),
                          synth.MPXParams())
    iq = synth.iq_to_i16(synth.fm_modulate(mpx, C.FM_RATE))
    rx = Receiver(ReceiverConfig(block_fm=32768, rds="block",
                                 iq_format="i16"))
    r1 = run_offline_scanned(rx, iq)
    r2 = run_offline_scanned(rx, iq, chunk_blocks=2)
    np.testing.assert_array_equal(r1.audio, r2.audio)
    np.testing.assert_array_equal(r1.rds_bits, r2.rds_bits)
    assert r1.meta == r2.meta


class TestDeviceLoadContract:
    """The reference's device-load contract (radio.cpp:758-831): every
    handler constructor throws, the radio catches and warns 'loading
    device failed' instead of dying.  The CLI mirror: clean message +
    exit 2, never a traceback."""

    def test_missing_capture(self, tmp_path, capsys):
        rc = main(["rx", "--iq", str(tmp_path / "nope.wav"),
                   "--audio", str(tmp_path / "a.wav")])
        assert rc == 2
        assert "loading device failed" in capsys.readouterr().err

    def test_corrupt_riff(self, tmp_path, capsys):
        p = tmp_path / "bad.wav"
        p.write_bytes(b"RIFF\x10\x00\x00\x00JUNKjunkjunk")
        rc = main(["rx", "--iq", str(p), "--audio",
                   str(tmp_path / "a.wav")])
        assert rc == 2
        assert "loading device failed" in capsys.readouterr().err

    def test_dead_rtltcp_server(self, tmp_path, capsys):
        # port 1 on localhost: connection refused, immediately
        rc = main(["rx", "--iq", "rtltcp://127.0.0.1:1",
                   "--audio", str(tmp_path / "a.wav"),
                   "--reconnect-timeout", "0"])
        assert rc == 2
        assert "loading device failed" in capsys.readouterr().err

    def test_scan_missing_capture(self, tmp_path, capsys):
        rc = main(["scan", "--iq", str(tmp_path / "nope.wav")])
        assert rc == 2
        assert "loading device failed" in capsys.readouterr().err
