"""A/B the JAX chain against the REFERENCE receiver's own compiled code.

tools/reference_oracle/ builds /root/reference's Qt-free DSP core
(fm-demodulator.cpp, pilot-recover.cpp, stereo-separation.cpp, the filter
primitives, and the complete RDS stack) unmodified into a .so; oracle.cc
replicates only the fmProcessor hot-loop glue (stage order of
fm-processor.cpp:423-759).  These tests run the SAME synthesized capture
through both receivers and assert the chain tracks the reference's actual
output — discharging BASELINE.md row 3 ("audio within the reference's SNR
bound on recorded IQ") with the reference's own code rather than
re-derived oracles (ops/reference_scans.py / the independent modulator).

Measured levels this asserts against (6 s capture, settled 3-6 s window):
  demod stream   SNR ~89 dB, unit gain, zero lag
  mono (L+R)/2   SNR ~100 dB (deemphasis path)
  L / R channels SNR ~57 dB  (stereo path incl. pilot-phase dynamics)
  (L-R)/2        SNR ~53 dB  (pure stereo-difference path)
RDS: both decode PI 0x10F0 / 'TPU FM  ' / 'ORACLE RUN' at BER 0.
"""

import numpy as np
import pytest

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu.rds import encode
from sdrjfm_tpu.rds.live import LiveRDSDecoder
from sdrjfm_tpu.runtime.stream import run_offline

from tests.reference_oracle_binding import ReferenceOracle, build_oracle

SECONDS = 6
SETTLED = slice(3 * C.FM_RATE, 6 * C.FM_RATE)  # both PLLs/PSS locked


@pytest.fixture(scope="module")
def capture():
    n_fm = SECONDS * C.FM_RATE
    t = np.arange(n_fm) / C.FM_RATE
    left = 0.6 * np.sin(2 * np.pi * 1000.0 * t)
    right = 0.6 * np.sin(2 * np.pi * 440.0 * t)
    bits = encode.make_bitstream(pi=0x10F0, pty=10, station="TPU FM",
                                 radiotext="ORACLE RUN\r", repeats=8)
    syms = encode.differential_encode(bits)
    mpx = synth.synth_mpx(left, right, synth.MPXParams(rds_level=0.07),
                          rds_bits=syms)
    return synth.fm_modulate(mpx, C.FM_RATE).astype(np.complex64)


@pytest.fixture(scope="module")
def oracle_out(capture):
    build_oracle()
    o = ReferenceOracle(rds_mode=1, decoder=3, audio_filter_hz=0)
    out = o.process(capture)
    out["rds"] = o.rds_status()
    o.close()
    return out


@pytest.fixture(scope="module")
def chain_out(capture):
    cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                         decoder="mixed", audio_filter_hz=0, rds="block",
                         emit_taps=True)
    rx = Receiver(cfg)
    res = run_offline(rx, capture, collect_taps=True)
    dec = LiveRDSDecoder()
    dec.feed(np.asarray(res.rds_bits).ravel())
    return res, dec.report()


def _snr_gain(ref, mine, window=SETTLED):
    m = min(len(ref), len(mine))
    r = np.asarray(ref)[:m][window].astype(np.float64)
    y = np.asarray(mine)[:m][window].astype(np.float64)
    g = np.dot(r, y) / np.dot(y, y)
    err = r - g * y
    return 10 * np.log10(np.dot(r, r) / max(np.dot(err, err), 1e-30)), g


class TestReferenceStandalone:
    """The compiled reference code, by itself, decodes the synth capture —
    validating the oracle build AND the synthesizer against the real
    receiver."""

    def test_reference_decodes_capture(self, oracle_out):
        rds = oracle_out["rds"]
        assert rds["pilot_locked"]
        assert rds["pss_established"]
        assert rds["pi"] == 0x10F0
        assert rds["station"] == "TPU FM  "
        assert rds["radio_text"] == "ORACLE RUN"
        assert rds["pty"] == 10
        assert rds["ber"] == 0.0
        assert rds["synchronized"]
        assert rds["groups"] > 30
        # bit clock: 1187.5 b/s once the 57 kHz carrier is acquired
        assert rds["bits"] > 0.9 * (SECONDS - 1) * 1187.5

    def test_reference_locks_quickly(self, oracle_out):
        # locked for the whole settled window
        assert oracle_out["locked"][SETTLED].all()


class TestChainVsReference:
    """The JAX chain against the reference's own code, same capture."""

    def test_demod_stream_matches(self, oracle_out, chain_out):
        res, _ = chain_out
        mine = np.asarray(res.taps["demod"]).ravel()
        snr, g = _snr_gain(oracle_out["demod"], mine)
        assert snr > 70.0, f"demod SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 2e-3, f"demod gain {g:.5f}"

    def test_demod_zero_lag(self, oracle_out, chain_out):
        """Group delay through LO+÷12 cascade matches the reference's to
        the sample (the strongest structural alignment claim)."""
        res, _ = chain_out
        mine = np.asarray(res.taps["demod"]).ravel()
        m = min(len(mine), len(oracle_out["demod"]))
        a = oracle_out["demod"][SETTLED].astype(np.float64)
        b = np.asarray(mine)[:m][SETTLED].astype(np.float64)
        a -= a.mean()
        b -= b.mean()
        n = len(a)
        xc = np.fft.irfft(np.fft.rfft(a, 2 * n) *
                          np.conj(np.fft.rfft(b, 2 * n)))
        lags = np.concatenate([np.arange(0, n), np.arange(-n, 0)])
        assert lags[int(np.argmax(np.abs(xc)))] == 0

    def test_mono_path_matches(self, oracle_out, chain_out):
        """(L+R)/2 isolates demod+deemphasis — near-bit-level agreement."""
        res, _ = chain_out
        ml = np.asarray(res.taps["af_left_filtered"]).ravel()
        mr = np.asarray(res.taps["af_right_filtered"]).ravel()
        ref_sum = (oracle_out["audio"][:, 0] + oracle_out["audio"][:, 1]) / 2
        snr, g = _snr_gain(ref_sum, (ml + mr) / 2)
        assert snr > 80.0, f"mono SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 1e-3

    def test_stereo_audio_matches(self, oracle_out, chain_out):
        res, _ = chain_out
        ml = np.asarray(res.taps["af_left_filtered"]).ravel()
        mr = np.asarray(res.taps["af_right_filtered"]).ravel()
        for ref_ch, mine_ch, name in (
                (oracle_out["audio"][:, 0], ml, "L"),
                (oracle_out["audio"][:, 1], mr, "R")):
            snr, g = _snr_gain(ref_ch, mine_ch)
            assert snr > 45.0, f"{name} SNR {snr:.1f} dB"
            assert abs(g - 1.0) < 5e-3, f"{name} gain {g:.5f}"

    def test_stereo_difference_matches(self, oracle_out, chain_out):
        """(L-R)/2 isolates the pilot-phase/PSS-driven stereo path."""
        res, _ = chain_out
        ml = np.asarray(res.taps["af_left_filtered"]).ravel()
        mr = np.asarray(res.taps["af_right_filtered"]).ravel()
        ref_d = (oracle_out["audio"][:, 0] - oracle_out["audio"][:, 1]) / 2
        snr, _ = _snr_gain(ref_d, (ml - mr) / 2)
        assert snr > 40.0, f"diff SNR {snr:.1f} dB"

    def test_rds_groups_match(self, oracle_out, chain_out):
        _, mine = chain_out
        ref = oracle_out["rds"]
        assert int(mine["pi_code"], 16) == ref["pi"]
        assert mine["station_label"] == ref["station"]
        assert mine["radio_text"] == ref["radio_text"]
        assert mine["bit_error_rate"] == 0.0 and ref["ber"] == 0.0

    def test_pss_settles_to_same_phase(self, oracle_out, chain_out):
        res, _ = chain_out
        ref_pss_deg = float(oracle_out["pss"][-1]) / np.pi * 180.0
        mine_deg = res.meta[-1]["pss_phase_deg"]
        assert abs(ref_pss_deg - mine_deg) < 1.0, (ref_pss_deg, mine_deg)


class TestSecondDiscriminator:
    """Same A/B for a second demod algorithm (ComplexBasebandDelay),
    fm-demodulator.cpp:168-177 vs ops/demod.py complex_baseband."""

    def test_complex_baseband_demod_matches(self, capture):
        build_oracle()
        o = ReferenceOracle(rds_mode=0, decoder=4, audio_filter_hz=0)
        ref = o.process(capture)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="complex_baseband", audio_filter_hz=0,
                             rds="off", emit_taps=True)
        res = run_offline(Receiver(cfg), capture, collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()
        snr, g = _snr_gain(ref["demod"], mine)
        assert snr > 70.0, f"complex_baseband demod SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 2e-3


def _find_int_lag(ref, mine, window=SETTLED):
    m = min(len(ref), len(mine))
    a = np.asarray(ref)[:m][window].astype(np.float64)
    b = np.asarray(mine)[:m][window].astype(np.float64)
    a = a - a.mean()
    b = b - b.mean()
    n = len(a)
    xc = np.fft.irfft(np.fft.rfft(a, 2 * n) * np.conj(np.fft.rfft(b, 2 * n)))
    lags = np.concatenate([np.arange(0, n), np.arange(-n, 0)])
    return int(lags[int(np.argmax(np.abs(xc)))])


def _frac_delay(x, tau):
    n = len(x)
    f = np.fft.rfftfreq(n)
    return np.fft.irfft(np.fft.rfft(x) * np.exp(-2j * np.pi * f * tau), n)


class TestMoreDiscriminators:
    """The remaining demod algorithms against the reference's own
    fm_Demodulator (fm-demodulator.cpp:111-205), same capture."""

    def _ab(self, capture, ref_idx, mine_name):
        build_oracle()
        o = ReferenceOracle(rds_mode=0, decoder=ref_idx, audio_filter_hz=0)
        ref = o.process(capture)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder=mine_name, audio_filter_hz=0,
                             rds="off", emit_taps=True)
        res = run_offline(Receiver(cfg), capture, collect_taps=True)
        return _snr_gain(ref["demod"],
                         np.asarray(res.taps["demod"]).ravel())

    def test_real_baseband(self, capture):
        snr, g = self._ab(capture, 5, "real_baseband")
        assert snr > 55.0, f"real_baseband SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 2e-3

    def test_difference(self, capture):
        snr, g = self._ab(capture, 6, "difference")
        assert snr > 100.0, f"difference SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 1e-3

    def test_pll(self, capture):
        """The reference integrates a per-sample 1-pole PLL; the JAX
        decoder is its batched equivalent (ops/demod.py) — dynamics agree
        to ~28 dB, looser than the memoryless discriminators."""
        snr, g = self._ab(capture, 2, "pll")
        assert snr > 20.0, f"pll SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 0.05


class TestOptionalStages:
    """Optional-filter configs.  The reference's fftFilter carries an
    inherent fftSize-degree block latency (overlap-ADD buffering,
    fft-filters.cpp:97-163); the JAX overlap-save is causal with zero
    block latency (ops/blockops.py) — so these A/Bs align at exactly the
    documented latency before comparing."""

    def test_input_filter_matches_at_reference_latency(self, capture):
        build_oracle()
        o = ReferenceOracle(rds_mode=0, decoder=3, input_filter=True,
                            audio_filter_hz=0)
        ref = o.process(capture)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0,
                             rds="off", input_filter=True, emit_taps=True)
        res = run_offline(Receiver(cfg), capture, collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()
        m = min(len(mine), len(ref["demod"]))
        # inputFilter(2*32768, 251) at 2.304 MS/s -> (65536-251)/12
        # fm-rate samples, a FRACTIONAL delay after the ÷12 cascade
        tau = (2 * 32768 - 251) / 12.0
        shifted = _frac_delay(np.asarray(mine)[:m].astype(np.float64), tau)
        snr, g = _snr_gain(ref["demod"][:m], shifted,
                           slice(2 * C.FM_RATE, m - 4096))
        assert snr > 30.0, f"input-filter demod SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 5e-3

    def test_audio_filter_matches(self, capture):
        """fmAudioFilter(8192, 756) path: matches at a small constant lag
        up to the reference real-path's constant sign/gain factor
        (fft-filters.cpp:108-110 multiplies the real branch by 3; the
        lsq gain absorbs constants, sign included)."""
        build_oracle()
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=15000)
        ref = o.process(capture)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=15000,
                             rds="off", emit_taps=True)
        res = run_offline(Receiver(cfg), capture, collect_taps=True)
        ml = np.asarray(res.taps["af_left_filtered"]).ravel()
        ref_l = ref["audio"][:, 0]
        lag = _find_int_lag(ref_l, ml)
        m = min(len(ml), len(ref_l))
        ii = np.arange(2 * C.FM_RATE, m - abs(lag) - 1)
        r = np.asarray(ref_l)[ii].astype(np.float64)
        y = np.asarray(ml)[ii - lag].astype(np.float64)
        g = np.dot(r, y) / np.dot(y, y)
        err = r - g * y
        snr = 10 * np.log10(np.dot(r, r) / max(np.dot(err, err), 1e-30))
        assert snr > 45.0, f"audio-filter L SNR {snr:.1f} dB (lag {lag})"
        assert abs(abs(g) - 1.0) < 0.02, g   # sign-free constant gain

    def test_deemphasis_75us(self, capture):
        build_oracle()
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0,
                            deemphasis_us=75.0)
        ref = o.process(capture)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0,
                             deemphasis_us=75.0, rds="off", emit_taps=True)
        res = run_offline(Receiver(cfg), capture, collect_taps=True)
        ml = np.asarray(res.taps["af_left_filtered"]).ravel()
        mr = np.asarray(res.taps["af_right_filtered"]).ravel()
        ref_sum = (ref["audio"][:, 0] + ref["audio"][:, 1]) / 2
        snr, g = _snr_gain(ref_sum, (ml + mr) / 2)
        assert snr > 70.0, f"75us mono SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 1e-3


class TestRdsDecoderModes:
    """The reference's per-sample RDS decoders 2 and 3 vs the JAX scan
    re-expressions — identical decoded identity at BER 0."""

    @pytest.mark.parametrize("ref_mode,mine", [(1, "scan1"), (2, "scan2"),
                                               (3, "scan3")])
    def test_group_parity(self, capture, ref_mode, mine):
        from sdrjfm_tpu.rds.live import LiveRDSDecoder

        build_oracle()
        o = ReferenceOracle(rds_mode=ref_mode, decoder=3, audio_filter_hz=0)
        o.process(capture)
        ref = o.rds_status()
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0, rds=mine)
        res = run_offline(Receiver(cfg), capture)
        dec = LiveRDSDecoder()
        dec.feed(np.asarray(res.rds_bits).ravel())
        rep = dec.report()
        assert ref["ber"] == 0.0 and rep["bit_error_rate"] == 0.0
        assert int(rep["pi_code"], 16) == ref["pi"] == 0x10F0
        assert rep["station_label"] == ref["station"] == "TPU FM  "
        assert rep["radio_text"] == ref["radio_text"] == "ORACLE RUN"


class TestAmAndSquelch:
    def test_am_demod_matches(self):
        """AM path (carrier-normalised envelope, fm-demodulator.cpp:
        215-241) on a 40%-depth AM capture."""
        build_oracle()
        n_in = 3 * C.INPUT_RATE
        t_in = np.arange(n_in) / C.INPUT_RATE
        env = 0.5 * (1.0 + 0.4 * np.sin(2 * np.pi * 1000.0 * t_in))
        iq_am = (env.astype(np.float32) + 0j).astype(np.complex64)
        o = ReferenceOracle(rds_mode=0, decoder=1, audio_filter_hz=0)
        ref = o.process(iq_am)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="am", audio_filter_hz=0, rds="off",
                             emit_taps=True)
        res = run_offline(Receiver(cfg), iq_am, collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()
        snr, g = _snr_gain(ref["demod"], mine,
                           slice(C.FM_RATE, 3 * C.FM_RATE))
        assert snr > 80.0, f"AM demod SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 1e-3

    def test_noise_squelch_behavior_matches(self):
        """Signal then carrier-drop: both receivers pass the station open
        and close on the noise (the A/B that found the pre/post-squelch
        demod-tap placement divergence — the tap is post-squelch now,
        matching the reference scope)."""
        build_oracle()
        nf = 2 * C.FM_RATE
        t = np.arange(nf) / C.FM_RATE
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                              0.6 * np.sin(2 * np.pi * 1000.0 * t),
                              synth.MPXParams(rds_level=0.0))
        sig = synth.fm_modulate(mpx, C.FM_RATE)
        rng = np.random.default_rng(1)
        noise = 0.02 * (rng.standard_normal(len(sig))
                        + 1j * rng.standard_normal(len(sig)))
        iq = np.concatenate([sig, noise.astype(np.complex64)]) \
            .astype(np.complex64)
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0,
                            squelch_mode=1, squelch_value=70)
        ref = o.process(iq)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0, rds="off",
                             squelch="nsq", emit_taps=True)
        rx = Receiver(cfg)
        ctl = rx.initial_controls()._replace(
            squelch_level=np.float32(70.0))
        res = run_offline(rx, iq, controls=ctl, collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()

        def rms(x, a, b):
            return float(np.sqrt(np.mean(np.asarray(x)[a:b] ** 2)))

        # both open on the station.  30 dB bound: this capture is only
        # 2 s of signal, so the slow DC-servo transients are still inside
        # the window on both sides (squelch itself is a bit-exact
        # passthrough when open — measured 348 dB vs the no-squelch run
        # on BOTH implementations; the settled fidelity numbers live in
        # TestChainVsReference).  The claim here is the GATING parity.
        snr, g = _snr_gain(ref["demod"], mine,
                           slice(C.FM_RATE, int(1.9 * C.FM_RATE)))
        assert snr > 30.0, f"open-squelch demod SNR {snr:.1f} dB"
        # ...and both closed on the noise (skip half a second of
        # transition skew: hold cadences differ, 9600 vs 8192 samples)
        a, b = int(2.6 * C.FM_RATE), int(3.6 * C.FM_RATE)
        assert rms(ref["demod"], a, b) == 0.0
        assert rms(mine, a, b) < 1e-6, rms(mine, a, b)


class TestPssConvergence:
    def test_both_converge_to_injected_subcarrier_offset(self):
        """The DO_STEREO_SEPARATION_TEST scenario (fm-constants.h:36-42)
        without the compile switch: inject a 0.2 rad (11.46 deg) phase
        error on the 38 kHz subcarrier and both PSS loops must converge
        to correct it — the reference's own PerfectStereoSeparation and
        the JAX sub-block Costas land within 1 degree of each other AND
        of the injected value."""
        build_oracle()
        n_fm = 6 * C.FM_RATE
        t = np.arange(n_fm) / C.FM_RATE
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                              0.6 * np.sin(2 * np.pi * 440.0 * t),
                              synth.MPXParams(rds_level=0.0,
                                              pss_phase_error=0.2))
        iq = synth.fm_modulate(mpx, C.FM_RATE).astype(np.complex64)
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0)
        ref = o.process(iq)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0, rds="off")
        res = run_offline(Receiver(cfg), iq)
        ref_deg = float(ref["pss"][-1]) / np.pi * 180.0
        mine_deg = res.meta[-1]["pss_phase_deg"]
        injected_deg = -0.2 / np.pi * 180.0      # correction = -error
        assert abs(ref_deg - mine_deg) < 1.0, (ref_deg, mine_deg)
        assert abs(ref_deg - injected_deg) < 1.0, (ref_deg, injected_deg)
        assert abs(mine_deg - injected_deg) < 1.0, (mine_deg, injected_deg)


class TestIndependentModulatorVsReference:
    def test_reference_decodes_the_independent_capture(self):
        """Close the evidence triangle: the INDEPENDENT second oracle
        (tests/independent_modulator.py, re-derived from the published
        standards, sharing no code with the package) must decode on the
        REFERENCE'S own compiled receiver — spec-modulator -> real
        receiver, no framework code in either role."""
        import sys
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).parent))
        import independent_modulator as im

        build_oracle()
        iq = im.make_capture(seconds=4.0).astype(np.complex64)
        o = ReferenceOracle(rds_mode=1, decoder=3, audio_filter_hz=0)
        o.process(iq)
        rds = o.rds_status()
        o.close()
        assert rds["pilot_locked"]
        assert rds["pi"] == 0xA1B2
        assert rds["station"] == "INDEPMOD"
        assert rds["ber"] == 0.0
        assert rds["groups"] > 20


class TestTuningAndLock:
    def test_lo_offset_retune_matches(self):
        """Pure LO-offset retune (radio.cpp:1056-1066): a station at
        +300 kHz demodulated via the NCO by both receivers — the exact
        integer NCO against the reference's table oscillator."""
        import jax.numpy as jnp
        from sdrjfm_tpu.models.receiver import default_controls

        build_oracle()
        n_fm = 4 * C.FM_RATE
        t = np.arange(n_fm) / C.FM_RATE
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                              0.6 * np.sin(2 * np.pi * 440.0 * t),
                              synth.MPXParams(rds_level=0.0))
        iq = synth.fm_modulate(mpx, C.FM_RATE,
                               carrier_offset_hz=300_000) \
            .astype(np.complex64)
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0,
                            lo_freq=300_000)
        ref = o.process(iq)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0,
                             rds="off", emit_taps=True)
        ctl = default_controls()._replace(
            lo_freq_hz=jnp.asarray(300_000, jnp.int32))
        res = run_offline(Receiver(cfg), iq, controls=ctl,
                          collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()
        snr, g = _snr_gain(ref["demod"], mine,
                           slice(2 * C.FM_RATE, 4 * C.FM_RATE))
        assert snr > 60.0, f"LO-offset demod SNR {snr:.1f} dB"
        assert abs(g - 1.0) < 1e-3

    def test_pilot_lock_transitions_match(self):
        """Pilot dropout scenario (2 s pilot / 1 s none / 2 s pilot):
        the lock detector's 0.07-for-500 ms rule (pilot-recover.cpp:
        54-80) transitions at the same times on both receivers, to
        block granularity."""
        build_oracle()

        def seg(pilot_level, secs):
            n = int(secs * C.FM_RATE)
            tt = np.arange(n) / C.FM_RATE
            return synth.synth_mpx(
                0.5 * np.sin(2 * np.pi * 1000.0 * tt),
                0.5 * np.sin(2 * np.pi * 440.0 * tt),
                synth.MPXParams(rds_level=0.0, pilot_level=pilot_level))

        mpx = np.concatenate([seg(0.1, 2.0), seg(0.0, 1.0),
                              seg(0.1, 2.0)])
        iq = synth.fm_modulate(mpx, C.FM_RATE).astype(np.complex64)
        o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0)
        ref = o.process(iq)
        o.close()
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0,
                             rds="off")
        res = run_offline(Receiver(cfg), iq)
        block_s = cfg.block_fm / C.FM_RATE
        # reference lock flag at each my-block end
        ref_at_block = [bool(ref["locked"][min(
            int((b + 1) * cfg.block_fm) - 1, len(ref["locked"]) - 1)])
            for b in range(len(res.meta))]
        mine = [bool(m["pilot_locked"]) for m in res.meta]
        # agree everywhere except at most 1 block around each of the 3
        # transitions (measured: lock 0.507 s vs block 2, unlock 2.025 s
        # vs block 11, relock 3.503 s vs block 20 — all within a block)
        disagree = sum(a != b for a, b in zip(ref_at_block, mine))
        assert disagree <= 3, (ref_at_block, mine)
        # and the coarse shape is right on both: locked mid-segment 1,
        # unlocked mid-dropout, locked again at the end
        for flags in (ref_at_block, mine):
            assert flags[int(1.5 / block_s)]
            assert not flags[int(2.8 / block_s)]
            assert flags[-1]


class TestAfcObservable:
    def test_demod_dc_component_tracks_offset(self):
        """The AFC's input (the demodulator's DC tracker,
        fm-demodulator.cpp:197-198 / get_DcComponent — radio.cpp's AFC
        loop :1786-1809 closes around it): on a 5 kHz off-tuned carrier
        both receivers read the same settled DC component; on-tune both
        read ~0."""
        build_oracle()
        n_fm = 4 * C.FM_RATE
        t = np.arange(n_fm) / C.FM_RATE
        mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 1000.0 * t),
                              0.5 * np.sin(2 * np.pi * 440.0 * t),
                              synth.MPXParams(rds_level=0.0))
        cfg = ReceiverConfig(block_fm=32768, frontend="reference",
                             decoder="mixed", audio_filter_hz=0,
                             rds="off")
        for off_hz, expect_near_zero in ((5000, False), (0, True)):
            iq = synth.fm_modulate(mpx, C.FM_RATE,
                                   carrier_offset_hz=off_hz) \
                .astype(np.complex64)
            o = ReferenceOracle(rds_mode=0, decoder=3, audio_filter_hz=0)
            o.process(iq)
            ref_dc = o.rds_status()["dc_component"]
            o.close()
            res = run_offline(Receiver(cfg), iq)
            mine_dc = res.meta[-1]["dc_if"]
            if expect_near_zero:
                assert abs(ref_dc) < 0.01 and abs(mine_dc) < 0.01, \
                    (ref_dc, mine_dc)
            else:
                assert ref_dc > 0.1 and mine_dc > 0.1, (ref_dc, mine_dc)
                assert abs(mine_dc - ref_dc) < 0.05 * abs(ref_dc), \
                    (ref_dc, mine_dc)


class TestAlternativeFrequencies:
    def test_af_decode_matches(self):
        """0A groups carrying an AF pair (98.0/98.2 MHz): both group
        decoders surface the same frequencies (reference emits
        af*100+87500 kHz via setAFDisplay, rds-groupdecoder.cpp:208-217)."""
        build_oracle()
        bits = []
        af_pair = (105 << 8) | 107      # 98.0 / 98.2 MHz
        for _ in range(10):
            for seg in range(4):
                bits.extend(encode.group_0a(
                    0x10F0, 10, seg, "TPU FM  "[2 * seg:2 * seg + 2],
                    af_pair=af_pair))
        syms = encode.differential_encode(np.asarray(bits, np.int8))
        n = 4 * C.FM_RATE
        t = np.arange(n) / C.FM_RATE
        mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 1000.0 * t),
                              0.5 * np.sin(2 * np.pi * 440.0 * t),
                              synth.MPXParams(rds_level=0.08),
                              rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE).astype(np.complex64)
        o = ReferenceOracle(rds_mode=1, decoder=3, audio_filter_hz=0)
        o.process(iq)
        ref = o.rds_status()
        o.close()
        assert ref["af_khz"] == [98000, 98200], ref["af_khz"]
        res = run_offline(Receiver(ReceiverConfig(
            block_fm=32768, frontend="reference", decoder="mixed",
            audio_filter_hz=0, rds="block")), iq)
        dec = LiveRDSDecoder()
        dec.feed(np.asarray(res.rds_bits).ravel())
        mine = dec.report()["af_frequencies_khz"]
        assert [int(round(f * 1000)) for f in mine] == [98000, 98200], mine


class TestLongRunStability:
    def test_no_drift_over_16_seconds(self):
        """Long-capture A/B with time-varying program content (slow AM on
        the tones keeps the DC/AFC trackers active): agreement with the
        reference must NOT degrade over time — guards against slow state
        drift between the block-carry formulation and the reference's
        per-sample recursion.  Measured: ~53 dB in every window."""
        build_oracle()
        sec = 16
        n_fm = sec * C.FM_RATE
        t = np.arange(n_fm) / C.FM_RATE
        left = 0.6 * np.sin(2 * np.pi * 1000.0 * t) \
            * (0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t))
        right = 0.6 * np.sin(2 * np.pi * 440.0 * t) \
            * (0.6 + 0.4 * np.cos(2 * np.pi * 0.2 * t))
        bits = encode.make_bitstream(pi=0x10F0, station="TPU FM",
                                     radiotext="LONG RUN\r", repeats=24)
        syms = encode.differential_encode(bits)
        mpx = synth.synth_mpx(left, right,
                              synth.MPXParams(rds_level=0.07),
                              rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE).astype(np.complex64)
        o = ReferenceOracle(rds_mode=1, decoder=3, audio_filter_hz=0)
        ref = o.process(iq)
        st = o.rds_status()
        o.close()
        res = run_offline(Receiver(ReceiverConfig(
            block_fm=32768, frontend="reference", decoder="mixed",
            audio_filter_hz=0, rds="block", emit_taps=True)), iq,
            collect_taps=True)
        mine = np.asarray(res.taps["demod"]).ravel()

        def win_snr(lo_s, hi_s):
            snr, _ = _snr_gain(ref["demod"], mine,
                               slice(lo_s * C.FM_RATE, hi_s * C.FM_RATE))
            return snr

        early, mid, late = win_snr(3, 6), win_snr(8, 11), win_snr(13, 16)
        for w, name in ((early, "early"), (mid, "mid"), (late, "late")):
            assert w > 45.0, f"{name} window SNR {w:.1f} dB"
        assert late > early - 3.0, (early, late)
        assert st["ber"] == 0.0 and st["groups"] > 150
