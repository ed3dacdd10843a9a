"""Pilot/PSS: block-parallel estimators vs faithful per-sample scan oracles."""

import numpy as np
import jax.numpy as jnp

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.ops import reference_scans as R
from sdrjfm_tpu.ops.pilot import make_pilot_config, pilot_zero_state, recover_pilot
from sdrjfm_tpu.ops.pss import make_pss_config, pss_adapt, pss_zero_state


def make_demod(seconds=1.5, pilot_amp=0.15, phase0=0.3, noise=0.0, seed=0):
    """Synthetic demodulated MPX: pilot + audio-ish content."""
    n = int(seconds * C.FM_RATE)
    t = np.arange(n)
    theta = C.OMEGA_PILOT * t + phase0
    rng = np.random.default_rng(seed)
    d = pilot_amp * np.sin(theta)
    d = d + 0.5 * np.sin(2 * np.pi * 1000.0 / C.FM_RATE * t)
    if noise:
        d = d + noise * rng.standard_normal(n)
    return d.astype(np.float32), theta


class TestPilotEquivalence:
    def test_carrier_matches_scan_pll(self):
        """The reconstructed 38 kHz carrier from the analytic estimator must
        agree with the faithful PLL's after both lock."""
        demod, _ = make_demod(seconds=1.5)
        # oracle: per-sample PLL fed 5*demod (fm-processor.cpp:695-696)
        phase_ref, locked_ref, strength_ref, _ = R.pilot_pll_scan(
            jnp.asarray(5.0 * demod), R.pilot_pll_zero_state())
        assert bool(locked_ref[-1])

        cfg = make_pilot_config()
        blk = 32768
        phases, locked, strength = [], [], []
        st = pilot_zero_state(cfg)
        for i in range(len(demod) // blk):
            pb, st = recover_pilot(jnp.asarray(demod[i * blk:(i + 1) * blk]),
                                   cfg, st)
            phases.append(np.asarray(pb.phase))
            locked.append(np.asarray(pb.locked))
            strength.append(np.asarray(pb.strength))
        phase_est = np.concatenate(phases)
        assert bool(np.concatenate(locked)[-1])

        # compare carriers over the settled tail (common prefix length)
        m = len(phase_est)
        sl = slice(m - 100000, m)
        c_ref = np.cos(2 * (np.asarray(phase_ref)[sl] + np.pi / 4))
        c_est = np.cos(2 * (phase_est[sl] + np.pi / 4))
        corr = np.mean(c_ref * c_est) / np.mean(c_ref * c_ref)
        assert corr > 0.98, f"carrier correlation {corr:.4f}"

    def test_lock_strength_calibration(self):
        demod, _ = make_demod(seconds=1.0, pilot_amp=0.12)
        _, _, strength_ref, _ = R.pilot_pll_scan(
            jnp.asarray(5.0 * demod), R.pilot_pll_zero_state())
        cfg = make_pilot_config()
        st = pilot_zero_state(cfg)
        pb, st = recover_pilot(jnp.asarray(demod[:131072]), cfg, st)
        # both metrics settle to 5*A/2 = 0.3
        assert abs(float(pb.strength[-1]) - 0.3) < 0.05
        assert abs(float(np.asarray(strength_ref)[131071]) - 0.3) < 0.05

    def test_no_pilot_no_lock(self):
        rng = np.random.default_rng(1)
        demod = (0.3 * rng.standard_normal(65536)).astype(np.float32)
        cfg = make_pilot_config()
        pb, _ = recover_pilot(jnp.asarray(demod), cfg, pilot_zero_state(cfg))
        assert not bool(pb.locked[-1])


class TestPSSEquivalence:
    def test_block_pss_converges_to_scan_pss(self):
        """Both adapters must converge to the same phase offset for a
        deliberately mis-phased subcarrier."""
        err = 0.35                      # injected carrier phase error (rad)
        n = int(2.0 * C.FM_RATE)
        t = np.arange(n)
        theta = C.OMEGA_PILOT * t
        ldiff = 0.4 * np.sin(2 * np.pi * 800.0 / C.FM_RATE * t)
        # demod MPX whose subcarrier is offset by `err`
        demod = (0.1 * np.sin(theta)
                 + np.sin(2 * theta + err) * ldiff).astype(np.float32)
        base_phase = (2 * theta + np.pi / 2).astype(np.float32)  # receiver's
        # reconstruction: sin-pilot convention -> cos(base) = sin(2 theta)

        pss_cfg = make_pss_config()
        kernel = jnp.asarray(pss_cfg.kernel)

        # scan oracle (subsampled run: it's slow) on the first 0.75 s
        m = int(0.75 * C.FM_RATE)
        accs_ref, st_ref = R.pss_scan(jnp.asarray(demod[:m]),
                                      jnp.asarray(base_phase[:m]), kernel,
                                      R.pss_scan_zero_state(len(kernel)))
        # block adapter over the full 2 s in 131072-sample blocks
        st = pss_zero_state(pss_cfg)
        blk = 131072
        locked = jnp.ones(blk, dtype=bool)
        off2 = None
        for i in range(n // blk):
            off2, st = pss_adapt(jnp.asarray(demod[i * blk:(i + 1) * blk]),
                                 jnp.asarray(base_phase[i * blk:(i + 1) * blk]),
                                 locked, pss_cfg, st)

        ref_final = float(np.asarray(accs_ref)[-1])
        blk_final = float(np.asarray(off2)[-1])
        # both must move toward the injected offset with matching sign and
        # comparable magnitude; the block adapter gets longer to settle
        assert abs(blk_final - (-err)) < 0.08 or abs(blk_final - err) < 0.08, \
            (blk_final, err)
        assert np.sign(ref_final) == np.sign(blk_final), (ref_final, blk_final)

    def test_pss_improves_separation_in_receiver(self):
        """End-to-end: with a mis-phased transmitter subcarrier, PSS on must
        beat PSS off."""
        from sdrjfm_tpu.io import synth
        from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
        from sdrjfm_tpu.runtime.stream import run_offline

        n = int(2.5 * C.FM_RATE)
        t = np.arange(n) / C.FM_RATE
        left = 0.8 * np.sin(2 * np.pi * 1000.0 * t)
        right = np.zeros(n)
        mpx = synth.synth_mpx(left, right,
                              synth.MPXParams(pss_phase_error=0.7))
        iq = synth.fm_modulate(mpx, C.FM_RATE)

        def sep(pss_active):
            rx = Receiver(ReceiverConfig(block_fm=32768, rds="off",
                                         audio_filter_hz=15000,
                                         pss_active=pss_active))
            res = run_offline(rx, iq, drop_blocks=10)
            w = np.hanning(len(res.audio))
            L = np.abs(np.fft.rfft(res.audio[:, 0] * w)) ** 2
            Rp = np.abs(np.fft.rfft(res.audio[:, 1] * w)) ** 2
            b = int(round(1000 * len(res.audio) / C.WORKING_RATE))
            return 10 * np.log10(L[b - 3:b + 4].sum() / Rp[b - 3:b + 4].sum())

        s_on, s_off = sep(True), sep(False)
        # 0.7 rad phase error caps separation near 17 dB; PSS recovers it
        assert s_on > s_off + 6.0, (s_on, s_off)
        assert s_on > 24.0, s_on
