"""CheckpointManager: periodic snapshots, retention policy, async writes.

The reference persists only GUI settings between runs (radio.cpp:466-531);
periodic DSP-state checkpointing is this framework's production addition so
a long streaming run can resume bit-exactly after preemption (ROADMAP
'Engineering').
"""

import os

import numpy as np
import pytest

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import (Receiver, ReceiverConfig,
                                        default_controls)
from sdrjfm_tpu.runtime.checkpoint import (CheckpointError, CheckpointManager,
                                           load_state)
from sdrjfm_tpu.runtime.stream import run_streaming


def _tiny_state(step):
    return {"a": np.full(4, step, np.float32), "b": np.int32(step)}


class TestRetention:
    def test_keep_newest_plus_period_multiples(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3,
                                keep_period=4)
        for s in range(1, 11):
            mgr.save(s, _tiny_state(s))
        mgr.close()
        # newest 3 = {8,9,10}; multiples of 4 among the doomed = {4}
        assert mgr.all_steps() == [4, 8, 9, 10]

    def test_keep_newest_only(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
        for s in (1, 2, 3):
            mgr.save(s, _tiny_state(s))
        mgr.close()
        assert mgr.all_steps() == [2, 3]

    def test_restore_latest_and_specific(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
        for s in (1, 2, 3):
            mgr.save(s, _tiny_state(s))
        st, extra = mgr.restore(_tiny_state(0))
        assert extra["step"] == 3
        np.testing.assert_array_equal(st["a"], _tiny_state(3)["a"])
        st2, _ = mgr.restore(_tiny_state(0), step=2)
        np.testing.assert_array_equal(st2["a"], _tiny_state(2)["a"])
        mgr.close()

    def test_restore_empty_dir_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck"))
        with pytest.raises(CheckpointError, match="no checkpoints"):
            mgr.restore(_tiny_state(0))
        mgr.close()

    def test_fingerprint_verified(self, tmp_path):
        cfg_a = ReceiverConfig(block_fm=32768, rds="off")
        cfg_b = ReceiverConfig(block_fm=32768, rds="off", deemphasis_us=75.0)
        mgr = CheckpointManager(str(tmp_path / "ck"), cfg=cfg_a)
        mgr.save(1, _tiny_state(1))
        mgr.close()
        rd = CheckpointManager(str(tmp_path / "ck"), cfg=cfg_b)
        with pytest.raises(CheckpointError, match="different receiver"):
            rd.restore(_tiny_state(0))
        rd.close()

    def test_orbax_backend_roundtrip_and_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ck"), backend="orbax",
                                max_to_keep=2)
        for s in (1, 2, 3):
            mgr.save(s, _tiny_state(s))
        mgr.wait_until_finished()
        assert mgr.all_steps() == [2, 3]
        st, extra = mgr.restore(_tiny_state(0))
        np.testing.assert_array_equal(st["a"], _tiny_state(3)["a"])
        mgr.close()

    def test_load_state_resolves_manager_dir(self, tmp_path):
        d = str(tmp_path / "ck")
        mgr = CheckpointManager(d, max_to_keep=3)
        for s in (1, 2):
            mgr.save(s, _tiny_state(s))
        mgr.close()
        st, extra = load_state(d, _tiny_state(0))
        assert extra["step"] == 2
        np.testing.assert_array_equal(st["b"], _tiny_state(2)["b"])


def _iq(seconds):
    n = int(seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    mpx = synth.synth_mpx(0.5 * np.sin(2 * np.pi * 1000 * t),
                          0.5 * np.sin(2 * np.pi * 500 * t),
                          synth.MPXParams())
    return synth.fm_modulate(mpx, C.FM_RATE)


class TestStreamingCheckpoint:
    def test_periodic_snapshot_resumes_bit_exact(self, tmp_path):
        """run_streaming(on_state=mgr) every 2 blocks; resuming from the
        midpoint snapshot reproduces the tail audio bit for bit."""
        rx = Receiver(ReceiverConfig(block_fm=32768, rds="off"))
        iq = _iq(6 * 32768 / C.FM_RATE)
        ctl = default_controls()
        mgr = CheckpointManager(str(tmp_path / "ck"), cfg=rx.cfg,
                                max_to_keep=10)

        def on_state(done, state):
            if done % 2 == 0:
                mgr.save(done, state)

        full = run_streaming(rx, iq, ctl, on_state=on_state)
        mgr.wait_until_finished()
        assert mgr.all_steps() == [2, 4, 6]
        st, extra = mgr.restore(rx.init_state(), step=4)
        T = rx.cfg.block_in
        tail = run_streaming(rx, iq[4 * T:], ctl, init_state=st)
        ba = rx.cfg.block_audio
        np.testing.assert_array_equal(full.audio[4 * ba:], tail.audio)
        mgr.close()


class TestCLI:
    def test_rx_ckpt_dir_writes_and_resumes(self, tmp_path):
        from sdrjfm_tpu.app import main
        iq = str(tmp_path / "iq.wav")
        assert main(["synth", "--out", iq, "--seconds", "2",
                     "--station", "CKPT"]) == 0
        d = str(tmp_path / "ck")
        audio = str(tmp_path / "a.wav")
        assert main(["rx", "--iq", iq, "--audio", audio,
                     "--block-fm", "32768", "--ckpt-dir", d,
                     "--ckpt-every", "2", "--ckpt-keep", "2"]) == 0
        names = sorted(os.listdir(d))
        assert names and all(n.startswith("ckpt_") for n in names)
        assert len(names) <= 2
        # resume from the manager directory (latest step auto-resolved)
        audio2 = str(tmp_path / "b.wav")
        assert main(["rx", "--iq", iq, "--audio", audio2,
                     "--block-fm", "32768", "--load-state", d]) == 0

    def test_rx_ckpt_dir_rejects_scan_runner(self, tmp_path):
        from sdrjfm_tpu.app import main
        iq = str(tmp_path / "iq.wav")
        assert main(["synth", "--out", iq, "--seconds", "1"]) == 0
        with pytest.raises(SystemExit, match="per-block host loop"):
            main(["rx", "--iq", iq, "--audio", str(tmp_path / "a.wav"),
                  "--block-fm", "32768", "--runner", "scan",
                  "--ckpt-dir", str(tmp_path / "ck")])


def test_orbax_backend_missing_exits_cleanly(tmp_path, monkeypatch, capsys):
    """Without orbax installed, --ckpt-backend orbax is a clean exit 2
    pointing to npz, before any input is read."""
    import sys
    from sdrjfm_tpu.app import main
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    rc = main(["rx", "--iq", str(tmp_path / "absent.wav"),
               "--ckpt-backend", "orbax",
               "--save-state", str(tmp_path / "state")])
    assert rc == 2
    assert "--ckpt-backend npz" in capsys.readouterr().err
