#!/usr/bin/env python
"""Smoke run of the FM receive chain on the GPU, through its entry points.

    python chip_smoke.py [--out DIR]          # one GPU, every phase below
    python chip_smoke.py --four [--out DIR]   # four GPUs: station-axis
                                              # identify and its one-card
                                              # comparison, nothing else

Everything runs in ONE process: a second JAX process on the card would
find most of its memory already reserved.  The only child is nvidia-smi.
Each phase prints what it found; a phase that fails raises, and the script
exits non-zero without the final line.  The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases on one GPU, at the CLI's default geometry (2.304 MS/s, block_fm
131072, stereo with PSS, rds="block"):

  env         the device must be a GPU; versions, card, compile cache
  rx_loop     `synth` a 10 s stereo+RDS capture, `rx` it with the default
              loop runner: RDS identity at BER 0, pilot lock, PSS, 48 kHz
              stereo audio, left-tone SNR > 30 dB, separation > 25 dB
  rx_scan     the same with `--runner scan`: the same decoded RDS
  rx_u8       the same signal as a raw rtl_sdr u8 file: the same RDS
  cpu_parity  `Receiver.step` on 4 blocks on the GPU vs this process's CPU
              backend (the path the test suite holds against the plain
              references): front end >= 100 dB, audio >= 60 dB from block
              2 on, identical RDS bits
  identify    an 8-station capture through `scan --identify`: every
              station's PI and PS back
  footprint   memory, compile time and per-block times of the default
              step — a smoke reading, not a benchmark
  gpu tests   none: no test in this repository needs the card
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

CLI_BLOCK_FM = 131072          # `rx`'s default --block-fm
SMOKE_PI, SMOKE_PS, SMOKE_RT = 0x10F0, "SMOKE FM", "CHIP SMOKE RUN"
LEFT_HZ, RIGHT_HZ = 1000.0, 440.0     # `synth`'s default tones
# 8 stations inside the 2.304 MHz window, on the 100 kHz scan raster, at
# least 200 kHz apart (a dense urban band); amplitudes keep the sum in range
STATIONS = [dict(offset=o * 1000, pi=0x1000 + i, name=f"STATION{i}",
                 tone=500.0 + 100.0 * i, amplitude=0.125)
            for i, o in enumerate([-800, -600, -300, -100, 100, 300, 600,
                                   800])]
STATION_NOISE = 0.00125
PARITY_BLOCKS = 4
PARITY_SETTLED = 2          # audio is compared from this block on


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def agreement_db(ref, x) -> float:
    """10 log10(|ref|^2 / |ref - x|^2); inf when identical."""
    ref = np.asarray(ref, np.complex128 if np.iscomplexobj(ref)
                     else np.float64)
    err = float(np.sum(np.abs(ref - np.asarray(x, ref.dtype)) ** 2))
    sig = float(np.sum(np.abs(ref) ** 2))
    return float("inf") if err == 0.0 else 10.0 * np.log10(sig / err)


def bits_differ(a, b) -> int:
    """Differing bits over the common length plus the length mismatch."""
    m = min(len(a), len(b))
    return int(np.count_nonzero(np.asarray(a[:m]) != np.asarray(b[:m]))
               + abs(len(a) - len(b)))


def backend_parity(rx, blocks, ref_device, device) -> dict:
    """Run `rx.step` (a receiver built with emit_taps=True) over `blocks`
    on `ref_device` and on `device`; agreement per stage, in dB.

    front_end: the ÷12 output (the if_filtered tap); demod: the
    discriminator output; audio: from block PARITY_SETTLED on, after pilot
    lock; rds: the per-block decoded bits."""
    import jax

    def run(dev):
        stages = {"front_end": [], "demod": [], "audio": [], "rds": []}
        with jax.default_device(dev):
            step = jax.jit(rx.step)
            state, controls = rx.init_state(), rx.initial_controls()
            for blk in blocks:
                state, out = step(state, controls, jax.device_put(blk, dev))
                out = jax.device_get(out)
                stages["front_end"].append(out.taps["if_filtered"])
                stages["demod"].append(out.taps["demod"])
                stages["audio"].append(out.audio)
                stages["rds"].append(out.rds.bits[: int(out.rds.count)])
        return {k: np.concatenate(v) for k, v in stages.items()}

    ref, got = run(ref_device), run(device)
    settled = PARITY_SETTLED * rx.cfg.block_audio
    return {
        "front_end_db": agreement_db(ref["front_end"], got["front_end"]),
        "demod_db": agreement_db(ref["demod"], got["demod"]),
        "audio_db": agreement_db(ref["audio"][settled:],
                                 got["audio"][settled:]),
        "rds_bits": len(ref["rds"]),
        "rds_bits_differ": bits_differ(ref["rds"], got["rds"]),
    }


def rds_identity(rds: dict) -> dict:
    """The decoded content two runs of one capture must agree on."""
    return {k: rds[k] for k in ("pi_code", "station_label", "radio_text",
                                "pty", "groups_decoded", "group_counts",
                                "bit_error_rate")}


class CompileLog:
    """Backend compiles and persistent-cache hits, from jax.monitoring."""

    def __init__(self):
        self.compiles, self.seconds, self.hits = 0, 0.0, 0

    def on_duration(self, event, duration_secs, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1
            self.seconds += duration_secs

    def on_event(self, event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def snapshot(self):
        return self.compiles, self.seconds, self.hits

    def since(self, snap) -> str:
        c, s, h = snap
        return (f"{self.compiles - c} compiles, {self.seconds - s:.1f} s "
                f"compiling, {self.hits - h} persistent-cache hits")


class Smoke:
    """State shared by the phases.  `block_fm=None` runs the CLI defaults;
    a smaller block_fm and capture length let the phases be rehearsed on
    the CPU at a small size."""

    def __init__(self, out: Path, block_fm=None, seconds: float = 10.0,
                 station_seconds: float = 3.0):
        self.out = out
        self.block_fm = block_fm
        self.seconds = seconds
        self.station_seconds = station_seconds
        self.compile_log = CompileLog()
        self.gpu_line = ""
        self.reports = {}
        self.audio = {}

    def path(self, name: str) -> str:
        return str(self.out / name)

    def geometry(self) -> list:
        return [] if self.block_fm is None else ["--block-fm",
                                                 str(self.block_fm)]

    def cli(self, argv) -> str:
        """Run the CLI in this process; returns its stdout."""
        from sdrjfm_tpu.app import main as cli_main
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv))
        check(rc == 0, f"CLI {argv[0]} exited {rc}")
        return buf.getvalue()

    def rx(self, name: str, iq: str, extra=()) -> dict:
        from sdrjfm_tpu.io.wavio import read_wav
        audio, report = self.path(f"{name}.wav"), self.path(f"{name}.json")
        self.cli(["rx", "--iq", iq, "--audio", audio, "--rds",
                  "--report", report, *self.geometry(), *extra])
        with open(report) as f:
            rep = json.load(f)
        x, info = read_wav(audio)
        check(info.rate == 48000 and x.ndim == 2 and x.shape[1] == 2,
              f"{name}: audio is {x.shape} at {info.rate} Hz, not 48 kHz "
              "stereo")
        rds = rep.get("rds", {})
        check(rds.get("pi_code") == f"0x{SMOKE_PI:04X}"
              and rds.get("station_label", "").strip() == SMOKE_PS
              and SMOKE_RT in rds.get("radio_text", ""),
              f"{name}: RDS identity not recovered: {rds}")
        check(rds.get("bit_error_rate") == 0.0,
              f"{name}: RDS BER {rds.get('bit_error_rate')}")
        meta = rep["meta_last"]
        check(meta["pilot_locked"] and meta["pss_established"],
              f"{name}: pilot_locked={meta['pilot_locked']} "
              f"pss_established={meta['pss_established']}")
        self.reports[name], self.audio[name] = rep, x
        print(f"  {name}: PI={rds['pi_code']} PS={rds['station_label']!r} "
              f"RT={rds['radio_text']!r} groups={rds['groups_decoded']} "
              f"BER={rds['bit_error_rate']} pilot_locked=True "
              f"pss_established=True audio={x.shape[0]} frames x 2 at "
              f"48 kHz, CLI throughput "
              f"{rep['throughput_x_realtime']:.2f}x real time (compile "
              "included)")
        return rep


# ---------------------------------------------------------------- phases

def phase_env(s: Smoke, want_count: int):
    import jax
    import jaxlib
    from sdrjfm_tpu.runtime.accelerator import nvidia_smi_line, require_gpu
    from sdrjfm_tpu.runtime.compile_cache import enable_compile_cache

    devs = require_gpu()
    check(len(devs) == want_count,
          f"need {want_count} GPUs, JAX sees {len(devs)}")
    jax.monitoring.register_event_duration_secs_listener(
        s.compile_log.on_duration)
    jax.monitoring.register_event_listener(s.compile_log.on_event)
    cache = enable_compile_cache()
    entries = (len(list(Path(cache).iterdir()))
               if Path(cache).is_dir() else 0)
    s.gpu_line = nvidia_smi_line()
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"{len(devs)} x {devs[0].device_kind} ({devs[0].platform})")
    print(f"  nvidia-smi name, power.limit: {s.gpu_line}")
    print(f"  compile cache: {cache} ({entries} entries at start)")
    return devs


def _capture_paths(s: Smoke):
    return s.path("capture.wav"), s.path("capture_u8.bin")


def phase_rx_loop(s: Smoke):
    from sdrjfm_tpu.io.synth import band_power, tone_snr_db
    cap, _ = _capture_paths(s)
    s.cli(["synth", "--out", cap, "--seconds", str(s.seconds), "--int16",
           "--station", SMOKE_PS, "--radiotext", SMOKE_RT,
           "--pi", f"0x{SMOKE_PI:04X}", "--pty", "10"])
    s.rx("rx_loop", cap)
    x = s.audio["rx_loop"]
    settled = x[len(x) // 3:]      # past pilot lock and PSS settling
    # the right channel's own tone leaking into the left is crosstalk,
    # measured as separation, so it is left out of the left tone's noise
    snr = tone_snr_db(settled[:, 0], 48000, LEFT_HZ, exclude_hz=(RIGHT_HZ,))
    sep = 10 * np.log10(band_power(settled[:, 0], 48000, LEFT_HZ)
                        / max(band_power(settled[:, 1], 48000, LEFT_HZ),
                              1e-30))
    print(f"  left {LEFT_HZ:.0f} Hz tone SNR {snr:.2f} dB (> 30), stereo "
          f"separation {sep:.2f} dB (> 25)")
    check(snr > 30.0, f"left tone SNR {snr:.2f} dB <= 30")
    check(sep > 25.0, f"stereo separation {sep:.2f} dB <= 25")


def phase_rx_scan(s: Smoke):
    cap, _ = _capture_paths(s)
    s.rx("rx_scan", cap, ["--runner", "scan"])
    # raw bit streams may differ at a block edge (a marginal bit-clock
    # tick); the decoded groups may not
    a = rds_identity(s.reports["rx_loop"]["rds"])
    b = rds_identity(s.reports["rx_scan"]["rds"])
    check(a == b, f"scan runner decoded other RDS: {a} vs {b}")
    print(f"  decoded RDS identical to rx_loop ({a['groups_decoded']} "
          f"groups); audio agreement with rx_loop "
          f"{agreement_db(s.audio['rx_loop'], s.audio['rx_scan']):.2f} dB")


def phase_rx_u8(s: Smoke):
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.io.wavio import read_iq_wav
    cap, raw = _capture_paths(s)
    iq, _ = read_iq_wav(cap)
    synth.iq_to_u8(iq).tofile(raw)
    s.rx("rx_u8", raw, ["--iq-format", "u8"])
    a = s.reports["rx_loop"]["rds"]
    b = s.reports["rx_u8"]["rds"]
    for k in ("pi_code", "station_label", "radio_text"):
        check(a[k] == b[k], f"u8 decoded {k}={b[k]!r}, i16 {a[k]!r}")
    print(f"  same PI/PS/RadioText as the i16 capture; audio agreement "
          f"with rx_loop "
          f"{agreement_db(s.audio['rx_loop'], s.audio['rx_u8']):.2f} dB "
          "(u8 quantisation)")


def phase_cpu_parity(s: Smoke):
    import jax
    from sdrjfm_tpu.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
    cap, _ = _capture_paths(s)
    cpu = jax.devices("cpu")[0]          # raises if the backend is absent
    rx = Receiver(ReceiverConfig(block_fm=s.block_fm or CLI_BLOCK_FM,
                                 rds="block", audio_filter_hz=15000,
                                 iq_format="i16", emit_taps=True))
    wire, _ = read_iq_wav_raw(cap)
    T = rx.cfg.wire_len
    blocks = [wire[b * T:(b + 1) * T] for b in range(PARITY_BLOCKS)]
    r = backend_parity(rx, blocks, cpu, jax.devices()[0])
    print(f"  GPU vs CPU over {PARITY_BLOCKS} blocks: front end (÷12 out) "
          f"{r['front_end_db']:.2f} dB (>= 100), demod "
          f"{r['demod_db']:.2f} dB, audio from block {PARITY_SETTLED} "
          f"{r['audio_db']:.2f} dB (>= 60), RDS bits differing "
          f"{r['rds_bits_differ']} of {r['rds_bits']} (0)")
    check(r["front_end_db"] >= 100.0, "front end below 100 dB")
    check(r["audio_db"] >= 60.0, "audio below 60 dB")
    check(r["rds_bits_differ"] == 0, "RDS bits differ")


def _station_capture(s: Smoke) -> str:
    from sdrjfm_tpu import constants as C
    from sdrjfm_tpu.io import synth
    from sdrjfm_tpu.io.wavio import write_iq_wav
    path = s.path("stations.wav")
    iq = synth.multistation_iq(STATIONS, seconds=s.station_seconds,
                               noise=STATION_NOISE)
    write_iq_wav(path, iq, C.INPUT_RATE, float32=True)
    return path


def _check_identified(hits, label: str):
    by_offset = {h["offset_hz"]: h for h in hits}
    for st in STATIONS:
        h = by_offset.get(st["offset"], {})
        check(h.get("pi_code") == f"0x{st['pi']:04X}"
              and h.get("station") == st["name"],
              f"{label}: station at {st['offset']:+d} Hz not identified: "
              f"{h}")
        print(f"  {label} {st['offset']:+8d} Hz: PI={h['pi_code']} "
              f"PS={h['station']!r} groups={h['groups']} BER={h['ber']} "
              f"pilot_locked={h['pilot_locked']}")


def phase_identify(s: Smoke):
    cap = _station_capture(s)
    hits = json.loads(s.cli(["scan", "--iq", cap, "--identify",
                             *s.geometry()]))["hits"]
    _check_identified(hits, "identify")
    print(f"  {len(STATIONS)} of {len(STATIONS)} stations identified "
          f"({len(hits)} scan hits)")


def phase_four_identify(s: Smoke):
    """`scan --identify` with the station axis over the 4-GPU mesh, then
    the same stations through demodulate_stations on one card."""
    from sdrjfm_tpu.models import multistation
    from sdrjfm_tpu.models.bandscan import decode_rds_hit
    cap = _station_capture(s)
    calls = []
    sharded_fn = multistation.demodulate_stations

    def recording(*args, **kwargs):
        res = sharded_fn(*args, **kwargs)
        calls.append((args, kwargs, res))
        return res

    # record what the CLI's identify computed, to compare its audio
    multistation.demodulate_stations = recording
    try:
        hits = json.loads(s.cli(["scan", "--iq", cap, "--identify",
                                 *s.geometry()]))["hits"]
    finally:
        multistation.demodulate_stations = sharded_fn
    _check_identified(hits, "4-GPU identify")
    check(len(calls) == 1 and calls[0][1].get("mesh") is not None,
          "identify did not put the station axis on a mesh")
    (rx, iq, offsets), kwargs, sharded = calls[0]
    mesh = kwargs["mesh"]
    print(f"  station axis on a {mesh.devices.size}-device mesh "
          f"({mesh.axis_names})")
    single = multistation.demodulate_stations(rx, iq, offsets, mesh=None)
    for a, b in zip(sharded, single):
        ia, ib = decode_rds_hit(a["rds_bits"]), decode_rds_hit(b["rds_bits"])
        db = agreement_db(b["audio"], a["audio"])
        print(f"  {a['offset_hz']:+8d} Hz: 4-GPU PI={ia.get('pi_code')} "
              f"PS={ia.get('station')!r}, 1-GPU PI={ib.get('pi_code')} "
              f"PS={ib.get('station')!r}, audio agreement {db:.2f} dB "
              "(>= 60)")
        check((ia.get("pi_code"), ia.get("station"))
              == (ib.get("pi_code"), ib.get("station")),
              f"{a['offset_hz']:+d} Hz: PI/PS differ between 4 and 1 GPU")
        check(db >= 60.0, f"{a['offset_hz']:+d} Hz: audio {db:.2f} dB")


def phase_footprint(s: Smoke):
    import jax
    from sdrjfm_tpu.io.wavio import read_iq_wav_raw
    from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
    from sdrjfm_tpu.runtime.stream import run_offline_scan
    cap, _ = _capture_paths(s)
    rx = Receiver(ReceiverConfig(block_fm=s.block_fm or CLI_BLOCK_FM,
                                 rds="block", audio_filter_hz=15000,
                                 iq_format="i16"))
    wire, _ = read_iq_wav_raw(cap)
    T = rx.cfg.wire_len
    nblocks = len(wire) // T
    block_s = T / rx.cfg.wire_rate
    state, controls = rx.init_state(), rx.initial_controls()
    blk = jax.device_put(wire[:T])

    snap = s.compile_log.snapshot()
    t0 = time.perf_counter()
    compiled = jax.jit(rx.step).lower(state, controls, blk).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    print(f"  step compile (lower excluded): {compile_s:.2f} s "
          f"[{s.compile_log.since(snap)}]; memory_analysis {mem}")

    def best(fn, n):
        dt = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            dt = min(dt, time.perf_counter() - t0)
        return dt

    scan_run = lambda: run_offline_scan(rx, wire, controls)  # noqa: E731
    jax.block_until_ready(scan_run())
    scan_s = best(scan_run, 5) / nblocks
    fe = jax.jit(rx.front_end)
    fe_run = lambda: fe(state, controls, blk)[0]  # noqa: E731
    jax.block_until_ready(fe_run())
    fe_s = best(fe_run, 20)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"  footprint, a smoke reading and not a benchmark "
          f"[{s.gpu_line}]: run_offline_scan best of 5 over {nblocks} "
          f"blocks {scan_s * 1e3:.4f} ms/block "
          f"({block_s / scan_s:.1f}x real time, H2D of the capture "
          f"included); Receiver.front_end alone best of 20 "
          f"{fe_s * 1e3:.4f} ms/block; peak_bytes_in_use {peak}")


def phase_gpu_tests(s: Smoke):
    print("  none: no test in this repository needs the card")


ONE_GPU = [("rx_loop", phase_rx_loop), ("rx_scan", phase_rx_scan),
           ("rx_u8", phase_rx_u8), ("cpu_parity", phase_cpu_parity),
           ("identify", phase_identify), ("footprint", phase_footprint),
           ("gpu tests", phase_gpu_tests)]
FOUR_GPU = [("four_identify", phase_four_identify)]


def _run_phase(s: Smoke, name: str, fn, *args):
    print(f"[{name}]", flush=True)
    snap = s.compile_log.snapshot()
    t0 = time.perf_counter()
    out = fn(s, *args)
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s "
          f"({s.compile_log.since(snap)})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for captures, audio and reports")
    ap.add_argument("--four", action="store_true",
                    help="only the station-axis identify over four GPUs "
                         "and its one-card comparison")
    args = ap.parse_args(argv)
    # cpu_parity compares against this process's CPU backend, so keep it
    # available beside the GPU when JAX_PLATFORMS names platforms
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    s = Smoke(out)
    devs = _run_phase(s, "env", phase_env, 4 if args.four else 1)
    for name, fn in (FOUR_GPU if args.four else ONE_GPU):
        _run_phase(s, name, fn)
    from sdrjfm_tpu.runtime.accelerator import device_record
    print(json.dumps({"ok": True, "device": device_record(devs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
