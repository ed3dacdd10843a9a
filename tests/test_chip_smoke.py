"""CPU checks of the GPU entry points: chip_smoke.py, bench.py, the compile
cache placement, and the pieces the smoke compares with."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu.runtime import compile_cache

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_placement(monkeypatch, restore_cache_dir, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the
    cache goes to the fixed <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        got = compile_cache.enable_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
        assert compile_cache.enable_compile_cache() == env_dir
        assert jax.config.jax_compilation_cache_dir == before


def _run_without_gpu(argv, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu(tmp_path):
    r = _run_without_gpu([str(ROOT / "chip_smoke.py"), "--out",
                          str(tmp_path / "out")], tmp_path)
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_bench_fails_without_gpu(tmp_path):
    r = _run_without_gpu([str(ROOT / "bench.py")], tmp_path)
    assert r.returncode != 0, r.stdout
    assert r.stdout.strip() == ""
    assert "no GPU" in r.stderr


def test_backend_parity_cpu_against_cpu():
    """The smoke's GPU-vs-CPU comparison, run between two CPU devices:
    every stage agrees exactly and the RDS bits are identical."""
    rx = Receiver(ReceiverConfig(block_fm=16384, rds="block",
                                 audio_filter_hz=15000, iq_format="i16",
                                 emit_taps=True))
    T = rx.cfg.wire_len
    n = chip_smoke.PARITY_BLOCKS * T
    t = np.arange(n // 12) / C.FM_RATE
    from sdrjfm_tpu.rds import encode
    bits = encode.differential_encode(encode.make_bitstream(repeats=2))
    mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000.0 * t),
                          0.6 * np.sin(2 * np.pi * 440.0 * t),
                          synth.MPXParams(), rds_bits=bits)
    wire = synth.iq_to_i16(synth.fm_modulate(mpx, C.FM_RATE))
    blocks = [wire[b * T:(b + 1) * T]
              for b in range(chip_smoke.PARITY_BLOCKS)]
    cpus = jax.devices("cpu")
    r = chip_smoke.backend_parity(rx, blocks, cpus[0], cpus[1])
    assert set(r) == {"front_end_db", "demod_db", "audio_db", "rds_bits",
                      "rds_bits_differ"}
    assert r["rds_bits"] > 0
    assert r["rds_bits_differ"] == 0
    assert r["front_end_db"] >= 100.0 and r["audio_db"] >= 60.0


def test_agreement_and_bit_counts():
    x = np.ones(100)
    assert chip_smoke.agreement_db(x, x) == float("inf")
    assert abs(chip_smoke.agreement_db(x, x * 1.001) - 60.0) < 1e-6
    assert chip_smoke.bits_differ([0, 1, 1], [0, 0, 1, 1]) == 2


def test_tone_snr_excludes_other_program_tone():
    """A second program tone counts as noise unless it is excluded."""
    t = np.arange(48000) / 48000.0
    x = np.sin(2 * np.pi * 1000 * t) + 0.01 * np.sin(2 * np.pi * 440 * t)
    assert synth.tone_snr_db(x, 48000, 1000.0) < 41.0
    assert synth.tone_snr_db(x, 48000, 1000.0, exclude_hz=(440.0,)) > 100.0


def _old_two_station_fixture(stations, seconds, noise):
    """tests/test_multistation.py's capture builder as it was written
    before it moved into synth.multistation_iq."""
    from sdrjfm_tpu.rds import encode
    n = int(seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    total = None
    for st in stations:
        name_bits = []
        for _ in range(40):
            for seg in range(4):
                name_bits.extend(encode.group_0a(
                    st["pi"], 10, seg, st["name"][2 * seg:2 * seg + 2]))
        syms = encode.differential_encode(np.asarray(name_bits, np.int8))
        mpx = synth.synth_mpx(0.6 * np.sin(2 * np.pi * st["tone"] * t),
                              0.6 * np.sin(2 * np.pi * st["tone"] * t),
                              synth.MPXParams(rds_level=0.08), rds_bits=syms)
        iq = synth.fm_modulate(mpx, C.FM_RATE,
                               carrier_offset_hz=st["offset"])
        total = iq if total is None else total + iq
    rng = np.random.default_rng(0)
    total = total + noise * (rng.standard_normal(len(total))
                             + 1j * rng.standard_normal(len(total)))
    return total.astype(np.complex64)


def test_multistation_builder_reproduces_old_fixture():
    stations = [
        dict(offset=-500_000, pi=0x1111, name="STATION1", tone=700.0),
        dict(offset=400_000, pi=0x2222, name="STATION2", tone=1300.0),
    ]
    got = synth.multistation_iq(stations, seconds=0.5, noise=0.01)
    want = _old_two_station_fixture(stations, 0.5, 0.01)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("phases", ["ONE_GPU", "FOUR_GPU"])
def test_smoke_phases_rehearse_on_cpu(tmp_path, phases):
    """The smoke's phases after `env`, on the CPU mesh at a small
    geometry: the same CLI calls and checks the card runs, so a phase
    broken by a CLI or receiver change shows here before a chip call.
    (The station-axis phase shards over the 8 virtual devices.)"""
    s = chip_smoke.Smoke(tmp_path, block_fm=16384, seconds=6.0,
                         station_seconds=1.5)
    for _, phase in getattr(chip_smoke, phases):
        phase(s)
