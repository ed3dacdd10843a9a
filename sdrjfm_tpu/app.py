"""Command-line receiver — the framework's user-facing surface.

Replaces the reference's Qt GUI (radio.cpp / main.cpp) with a CLI for
offline/streaming use:

    python -m sdrjfm_tpu.app rx --iq capture.wav --audio out.wav \
        --freq-offset 100000 --mode stereo --rds --report report.json

    python -m sdrjfm_tpu.app synth --out iq.wav --seconds 5 \
        --station "TPU FM" --radiotext "hello"

`rx` mirrors the reference signal path wav-IQ -> audio wav + RDS report;
`synth` generates a spec-correct stereo+RDS test capture (no reference
equivalent — the reference has no fixtures).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _is_fifo(path: str) -> bool:
    import os
    import stat
    try:
        return stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


def _build_rx_parser(sub):
    p = sub.add_parser("rx", help="demodulate an IQ wav capture")
    p.add_argument("--iq", required=True,
                   help="input IQ: wav capture (I=left, Q=right), a "
                        "headerless raw file (rtl_sdr/hackrf convention; "
                        "needs --iq-format u8/i8/i16), or a live "
                        "rtl_tcp://host:port network SDR (u8 stream; "
                        "implies --follow), or '-'/a FIFO for a headerless "
                        "stream piped from any SDR tool (needs --iq-format; "
                        "implies --follow)")
    p.add_argument("--tune-hz", type=int,
                   help="with an rtl_tcp source: tune the device to this "
                        "center frequency")
    p.add_argument("--input-rate", type=int, default=0,
                   help="device-native sample rate of a raw/pipe capture "
                        "(e.g. 2500000 airspy, 8000000 hackrf); inserts "
                        "the device zoo's linear-interpolation conversion "
                        "to 2.304 MS/s on-device (airspy-handler.cpp:"
                        "118-127 mapTable; needs a block_fm whose "
                        "block_in*ratio is integral — 12288*k covers the "
                        "common rates)")
    p.add_argument("--iq-format", default="auto",
                   choices=["auto", "c64", "i16", "i8", "u8"],
                   help="wire format fed to the device: i16/u8 keep integer "
                        "captures raw (half / quarter the input bytes; "
                        "i16-from-wav is bit-identical to c64); auto picks "
                        "i16 for PCM16 stereo wavs")
    p.add_argument("--audio", help="output audio wav (48 kHz stereo)")
    p.add_argument("--report", help="write JSON report (metadata + RDS)")
    p.add_argument("--freq-offset", type=int, default=0,
                   help="LO offset in Hz (station offset within the capture)")
    p.add_argument("--mode", default="stereo",
                   choices=["mono", "stereo", "stereo_pano"])
    p.add_argument("--decoder", default="complex_baseband",
                   choices=["am", "pll", "mixed", "complex_baseband",
                            "real_baseband", "difference"])
    p.add_argument("--sound", default="stereo")
    p.add_argument("--panorama", type=float, default=1.0,
                   help="stereo panorama factor (slider/100: 0 mono .. "
                        "1 stereo .. 2 widened, fm-processor.cpp:277-279). "
                        "Applies in EVERY stereo mode, not just "
                        "stereo_pano — a deliberate superset of the "
                        "reference, which gates it on StereoPano "
                        "(fm-processor.cpp:520-521); live-editable via "
                        "the control channel's pano/mono commands")
    p.add_argument("--rds", action="store_true", help="decode RDS")
    p.add_argument("--rds-decoder", default="block",
                   choices=["block", "scan1", "scan2", "scan3"],
                   help="bit decoder: the block-batched demodulator or the "
                        "reference's per-sample algorithms")
    p.add_argument("--no-pss", action="store_true")
    p.add_argument("--deemphasis", default="50",
                   help="deemphasis time constant in us, or a preset: "
                        "eu=50, us=75, off=0")
    p.add_argument("--audio-filter", type=int, default=15000,
                   help="audio lowpass cutoff Hz (0 = off)")
    p.add_argument("--input-filter", action="store_true",
                   help="enable the strong 65536-pt channel filter")
    p.add_argument("--fm-bandwidth", default=None,
                   help="channel filter bandwidth in kHz, or 'off' "
                        "(setBandwidth, fm-processor.cpp:232-239; a numeric "
                        "value implies --input-filter)")
    p.add_argument("--dc-remove", default="on", choices=["on", "off"],
                   help="input DC-removal servo (setDCRemove, "
                        "fm-processor.h:148)")
    p.add_argument("--afc", action="store_true",
                   help="automatic frequency control: close the loop around "
                        "the demodulator's DC component every block "
                        "(radio.cpp:1786-1809; loop/pcm-out/follow runners)")
    p.add_argument("--squelch", default="off", choices=["off", "nsq", "lsq"])
    p.add_argument("--squelch-level", default="0",
                   help="0..100, or 'auto' (nsq only: profile the first "
                        "block's band-energy ratio and pick a threshold)")
    p.add_argument("--volume-db", type=float, default=0.0)
    p.add_argument("--balance", type=int, default=0, help="-100..100")
    p.add_argument("--frontend", default="flat", choices=["flat", "reference"])
    p.add_argument("--block-fm", type=int, default=131072)
    p.add_argument("--pty-locale", type=int, default=0, choices=[0, 1])
    p.add_argument("--float32", action="store_true",
                   help="write float32 wav instead of PCM16")
    p.add_argument("--audio-192k", action="store_true",
                   help="output 192 kHz audio (the reference's -m flag)")
    p.add_argument("--dump-input", help="dump the 2.304 MS/s input IQ after "
                                        "DC removal (complex wav — the "
                                        "reference's raw dump for offline "
                                        "A/B, fm-processor.cpp:448-455)")
    p.add_argument("--dump-if", help="dump the 192 kHz IF (complex wav)")
    p.add_argument("--dump-mpx", help="dump the demodulated MPX (192 kHz wav)")
    p.add_argument("--test-tone", action="store_true",
                   help="compile in the 1 kHz/25 ms/2 s test-tone injector "
                        "(insertTestTone, fm-processor.cpp:800-823); the "
                        "control channel's 'tone on|off' gates it live "
                        "(handle_cbTestTone, radio.cpp:243)")
    p.add_argument("--taps", action="store_true",
                   help="emit the debug taps (incl. the input tap) without "
                        "opening any dump file, so a --control channel can "
                        "start/stop dumps at runtime (the GUI dump "
                        "buttons; 'dump audio <path>' needs no taps)")
    p.add_argument("--spectra", help="write hf/lf spectra + waterfall + RDS "
                                     "constellation to an npz")
    p.add_argument("--lf-plot", default="demod",
                   choices=["if_filtered", "demod", "af_sum", "af_diff",
                            "af_left_filtered", "af_right_filtered",
                            "af_mono_filtered", "rds_input", "rds_baseband",
                            "rds_demod"],
                   help="LF scope tap for --spectra (ELfPlot, "
                        "fm-processor.h:84-86; rds_input/rds_demod need "
                        "--rds)")
    p.add_argument("--lf-zoom", type=int, default=1,
                   help="LF spectrum zoom factor (ls-scope.cpp:131-176 "
                        "display fold)")
    p.add_argument("--save-state", help="write the DSP carry state (npz) at "
                                        "the end of the run")
    p.add_argument("--ckpt-backend", default="npz", choices=["npz", "orbax"],
                   help="checkpoint writer for --save-state (orbax writes a "
                        "directory; --load-state auto-detects)")
    p.add_argument("--load-state", help="resume from a saved DSP state "
                                        "(file, orbax dir, or a --ckpt-dir "
                                        "— resumes its latest step)")
    p.add_argument("--ckpt-dir", help="periodic checkpointing: write the "
                                      "DSP carry every --ckpt-every blocks "
                                      "into this directory (loop/follow/"
                                      "--pcm-out runners)")
    p.add_argument("--ckpt-every", type=int, default=64,
                   help="blocks between periodic checkpoints (default 64 "
                        "≈ 3.6 s of signal)")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="retention: keep the newest N periodic checkpoints")
    p.add_argument("--ckpt-keep-period", type=int,
                   help="retention: additionally keep every checkpoint "
                        "whose block count is a multiple of this")
    p.add_argument("--runner", default="loop", choices=["loop", "scan"],
                   help="block driver: python loop (streaming-shaped) or one "
                        "lax.scan dispatch over the whole capture (fastest)")
    p.add_argument("--chunk-blocks", type=int,
                   help="with --runner scan: dispatch in chunks of this many "
                        "blocks (bounds device memory for long captures; "
                        "bit-exact)")
    p.add_argument("--log-meta", help="write per-block metadata as JSON lines "
                                      "(the reference's periodic freq/pilot "
                                      "log, radio.cpp:1811-1823)")
    p.add_argument("--pcm-out", help="stream raw s16le PCM as blocks complete "
                                     "('-' = stdout; pipe to aplay/ffplay — "
                                     "the live audioSink equivalent). Uses "
                                     "the streaming runner.")
    p.add_argument("--pcm-pace", action="store_true",
                   help="throttle --pcm-out to real time")
    p.add_argument("--follow", action="store_true",
                   help="live streaming mode: pull blocks from the native "
                        "C++ paced ring (real-time emission, overrun drops "
                        "accounted) instead of loading the capture into "
                        "memory — the reference's device-thread -> ring -> "
                        "engine path (filehulp.cpp:159-202, "
                        "fm-processor.cpp:387-417)")
    p.add_argument("--no-pace", action="store_true",
                   help="with --follow: stream at full speed instead of "
                        "real time")
    p.add_argument("--loop-seconds", type=float,
                   help="with --follow: loop the capture and process this "
                        "many seconds of signal (default: stop at EOF)")
    p.add_argument("--profile", help="capture a jax profiler trace of the "
                                     "run into this directory (TensorBoard/"
                                     "xprof format; the reference had only "
                                     "a CPU-percent meter, radio.cpp:1222)")
    p.add_argument("--control",
                   help="runtime control channel: '-' reads commands from "
                        "stdin, a FIFO path reads lines written to it, any "
                        "other path becomes a unix socket server. Commands "
                        "(tune/volume/balance/mute/squelch/afc/gain/agc/ppm/"
                        "status/quit) are serviced between blocks — the "
                        "reference's live GUI control surface "
                        "(radio.cpp:1040-1075, :1366+). Needs a per-block "
                        "runner (loop/--pcm-out/--follow)")
    p.add_argument("--gain", type=int,
                   help="rtl_tcp: manual tuner gain in tenths of dB "
                        "(implies manual gain mode; rtlsdr-handler.cpp "
                        "gain plumbing)")
    p.add_argument("--agc", action="store_true",
                   help="rtl_tcp: enable the tuner AGC (opcode 0x08)")
    p.add_argument("--ppm", type=int,
                   help="rtl_tcp: frequency correction in ppm (opcode 0x05)")
    p.add_argument("--linearity", type=int,
                   help="airspy: composite linearity gain 0-21 "
                        "(airspy-handler.cpp:399-408)")
    p.add_argument("--sensitivity", type=int,
                   help="airspy: composite sensitivity gain 0-21 "
                        "(airspy-handler.cpp:390-397)")
    p.add_argument("--grdb", type=int,
                   help="sdrplay: IF gain reduction dB 20-59 "
                        "(Rsp-device.cpp:174-182)")
    p.add_argument("--lna-state", type=int,
                   help="sdrplay: LNA state (model-dependent bound, "
                        "Rsp-device.cpp:184-190)")
    p.add_argument("--lna-gain", type=int,
                   help="hackrf: LNA (IF) gain dB 0-40 step 8 "
                        "(hackrf-handler.cpp:268-280)")
    p.add_argument("--vga-gain", type=int,
                   help="hackrf: VGA (baseband) gain dB 0-62 step 2 "
                        "(hackrf-handler.cpp:283-295)")
    p.add_argument("--amp", action="store_true",
                   help="hackrf: enable the RF amp "
                        "(hackrf-handler.cpp:299-303)")
    p.add_argument("--reconnect-timeout", type=float, default=0.0,
                   help="rtl_tcp: if the server drops mid-run, retry with "
                        "backoff for up to this many seconds, replay the "
                        "device settings, and resume (outage counted as "
                        "drops); 0 disables")
    p.add_argument("--stations",
                   help="station list JSON (written by `scan --stations`): "
                        "the control channel can `tune <name>` through it "
                        "and `save <name>` the current tuning back (the "
                        "reference's programList, program-list.cpp:33-60)")
    p.add_argument("--meter", action="store_true",
                   help="live one-line status meter on stderr (pilot lock/"
                        "strength, peaks, drops, latency, RDS PI/PS — the "
                        "GUI's persistent displays; --follow/--pcm-out "
                        "runners)")
    p.add_argument("--config",
                   help="settings profile JSON (the reference's "
                        ".jsdr-fm.ini QSettings, main.cpp:33,69): keys are "
                        "rx flag names and become the flag defaults "
                        "(explicit flags still win); on clean exit the "
                        "final tuning/volume/balance/squelch are saved "
                        "back, so the next run resumes where this one "
                        "left off")
    return p


def _build_scan_parser(sub):
    p = sub.add_parser("scan", help="band-scan a capture or a live rtl_tcp "
                                    "device, identify stations")
    p.add_argument("--iq", required=True,
                   help="IQ capture: wav, a headerless raw file "
                        "(rtl_sdr/hackrf convention; needs --iq-format), or "
                        "a live rtl_tcp://host:port device — that sweeps "
                        "the hardware across the whole FM band "
                        "(radio.cpp:1115-1158)")
    p.add_argument("--iq-format", default="auto",
                   choices=["auto", "c64", "i16", "i8", "u8"],
                   help="raw-capture wire format (wav inputs: auto)")
    p.add_argument("--grid", type=int, default=100_000,
                   help="scan grid in Hz (the FM band raster)")
    p.add_argument("--threshold", type=float, default=20.0,
                   help="signal/noise contrast threshold in dB")
    p.add_argument("--identify", action="store_true",
                   help="tune each hit and decode RDS (PI/station/PTY)")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="capture seconds to demodulate per station")
    p.add_argument("--stations", help="write/update a station list JSON")
    p.add_argument("--block-fm", type=int, default=32768)
    p.add_argument("--scan-blocks", type=int, default=4,
                   help="blocks averaged per decision (clearAverage depth, "
                        "fm-processor.cpp:480-495; a station flickering in "
                        "one block is not a hit)")
    p.add_argument("--band-start", type=float, default=87.5,
                   help="rtl_tcp sweep start in MHz")
    p.add_argument("--band-stop", type=float, default=108.0,
                   help="rtl_tcp sweep stop in MHz")
    p.add_argument("--settle-ms", type=int, default=30,
                   help="rtl_tcp: stale-sample discard after each hardware "
                        "retune (tuner PLL settle)")


def _build_synth_parser(sub):
    p = sub.add_parser("synth", help="generate a stereo+RDS IQ test capture")
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--left-freq", type=float, default=1000.0)
    p.add_argument("--right-freq", type=float, default=440.0)
    p.add_argument("--pi", type=lambda v: int(v, 0), default=0x10F0)
    p.add_argument("--pty", type=int, default=10)
    p.add_argument("--station", default="TPU FM")
    p.add_argument("--radiotext", default="JAX/XLA broadcast FM receiver")
    p.add_argument("--carrier-offset", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--int16", action="store_true",
                   help="write 16-bit PCM IQ (rx reads it raw via "
                        "--iq-format auto/i16 — half the input bytes)")


def _rtltcp_hostport(url: str):
    hostport = url.split("://", 1)[1]
    host, _, port = hostport.partition(":")
    return host, int(port or 1234)


def _rtlsdr_index(spec: str) -> int:
    """'rtlsdr' / 'rtlsdr:1' / 'rtlsdr://1' -> dongle index (default 0)."""
    _, _, idx = spec.partition(":")
    idx = idx.lstrip("/")
    return int(idx) if idx else 0


def _lf_row(block, rate: int, zoom: int):
    """One LF-scope waterfall row (dB) + its kHz axis from one block's tap
    (shared by the offline spectra writer and the live follow-mode one)."""
    import numpy as np
    import jax.numpy as jnp
    from .models import scopes
    xa, amp, _ = scopes.lf_spectrum(
        jnp.asarray(block).astype(jnp.complex64), rate, zoom_factor=zoom)
    return (20.0 * np.log10(np.maximum(np.asarray(amp), 1e-10)),
            np.asarray(xa))


class _FollowDumps:
    """Incremental dump/tap writers for live (--follow) runs.

    The reference dumps input IQ and audio to wav *while receiving*
    (fm-processor.cpp:338-349,448-455; audiosink.cpp:268-274); the offline
    runners collect taps in memory, but a live run has no capture to go
    back to — so each block's taps are appended as they stream.  The wav
    dumps are byte-identical to the offline dumps of the same capture;
    --spectra accumulates its LF waterfall per block (same math as
    offline) and takes the HF spectrum from the first block's input tap.
    """

    def __init__(self, args, cfg):
        from .io.wavio import StreamingWavWriter
        self.args, self.cfg = args, cfg
        self.w_input = (StreamingWavWriter(args.dump_input, cfg.input_rate,
                                           2) if args.dump_input else None)
        self.w_if = (StreamingWavWriter(args.dump_if, cfg.fm_rate, 2)
                     if args.dump_if else None)
        self.w_mpx = (StreamingWavWriter(args.dump_mpx, cfg.fm_rate, 1)
                      if args.dump_mpx else None)
        self.w_audio = None
        self.lf_rows = []
        self.lf_axis = None
        self.hf = None

    # -- runtime toggling (the GUI dump buttons start/stop dumps while
    # receiving, radio.cpp:208-209 handle_dumpButton/audioDumpButton) ----
    _KIND_ATTR = {"input": "w_input", "if": "w_if", "mpx": "w_mpx",
                  "audio": "w_audio"}

    def start(self, kind: str, path: str):
        """Open a dump writer mid-run; returns an error string or None.
        The audio dump is always possible (audio reaches the host every
        block); input/if/mpx need their taps compiled into the step."""
        from .io.wavio import StreamingWavWriter
        if kind in ("if", "mpx") and not self.cfg.emit_taps:
            return (f"the {kind} tap is not emitted by this run; start "
                    "with --taps (or a --dump-* flag)")
        if kind == "input" and not self.cfg.emit_input_tap:
            return ("the input tap is not emitted by this run; start "
                    "with --taps or --dump-input")
        rate, ch = {"input": (self.cfg.input_rate, 2),
                    "if": (self.cfg.fm_rate, 2),
                    "mpx": (self.cfg.fm_rate, 1),
                    "audio": (self.cfg.audio_rate, 2)}[kind]
        self.stop(kind)
        try:
            w = StreamingWavWriter(path, rate, ch)
        except OSError as e:   # unwritable path is a file error, not a
            return f"dump {path!r}: {e}"  # hardware-command failure
        setattr(self, self._KIND_ATTR[kind], w)
        return None

    def stop(self, kind: str):
        """Close a dump writer; returns its path (or None if not open)."""
        w = getattr(self, self._KIND_ATTR[kind])
        if w is None:
            return None
        w.close()
        setattr(self, self._KIND_ATTR[kind], None)
        return w.path

    def active(self):
        return {k: getattr(self, a).path
                for k, a in self._KIND_ATTR.items()
                if getattr(self, a) is not None}

    def on_audio(self, frames):
        if self.w_audio is not None:
            import numpy as np
            self.w_audio.write(np.asarray(frames))

    def on_taps(self, taps):
        # taps holds device arrays: only the taps actually written are
        # pulled to the host (the writers' np.asarray does the fetch)
        import numpy as np
        if self.w_input is not None and "input_dc" in taps:
            self.w_input.write_iq(np.asarray(taps["input_dc"]))
        if self.w_if is not None and "if_filtered" in taps:
            self.w_if.write_iq(np.asarray(taps["if_filtered"]))
        if self.w_mpx is not None and "demod" in taps:
            self.w_mpx.write(np.asarray(taps["demod"]))
        if self.args.spectra:
            from .models import scopes
            if self.hf is None and "input_dc" in taps:
                self.hf = np.asarray(scopes.spectrum_db(taps["input_dc"]))
            lf = self.args.lf_plot
            if lf in taps:
                rate = (self.cfg.rds_rate if lf.startswith("rds")
                        else self.cfg.fm_rate)
                row, self.lf_axis = _lf_row(taps[lf], rate,
                                            self.args.lf_zoom)
                self.lf_rows.append(row)

    def finish(self, res):
        import numpy as np
        for w in (self.w_input, self.w_if, self.w_mpx, self.w_audio):
            if w is not None:
                w.close()
                print(f"wrote {w.path}", file=sys.stderr)
        if self.args.spectra:
            from .models import scopes
            out_npz = {}
            if self.hf is not None:
                out_npz["hf_spectrum_db"] = self.hf
            if self.lf_rows:
                out_npz["lf_waterfall_db"] = scopes.waterfall(self.lf_rows)
                out_npz["lf_x_axis_khz"] = self.lf_axis
            if res.rds_iq is not None:
                out_npz["rds_constellation"] = scopes.iq_constellation(
                    res.rds_iq)
            np.savez(self.args.spectra, **out_npz)
            print(f"wrote {self.args.spectra}", file=sys.stderr)


def cmd_rx(args) -> int:
    import numpy as np
    import jax.numpy as jnp
    from . import constants as C
    from .io.wavio import read_iq_wav, write_wav
    from .models.receiver import Receiver, ReceiverConfig
    from .runtime.stream import run_offline, run_offline_scanned

    from .io.wavio import is_riff, probe_wav, read_iq_raw, read_iq_wav_raw
    iq_fmt = args.iq_format
    iq = None
    is_rtltcp = args.iq.startswith(("rtl_tcp://", "rtltcp://"))
    is_rtlsdr = args.iq == "rtlsdr" or args.iq.startswith("rtlsdr:")
    is_airspy = args.iq == "airspy"
    is_hackrf = args.iq == "hackrf"
    is_sdrplay = args.iq == "sdrplay"
    is_pipe = (not is_rtlsdr and not is_airspy and not is_hackrf
               and not is_sdrplay
               and (args.iq == "-" or _is_fifo(args.iq)))
    if args.ckpt_backend == "orbax":
        try:
            import orbax.checkpoint  # noqa: F401
        except ImportError:
            print("--ckpt-backend orbax needs the orbax-checkpoint package, "
                  "which is not installed; use --ckpt-backend npz",
                  file=sys.stderr)
            return 2
    if args.gain is not None and not (is_rtltcp or is_rtlsdr):
        print("--gain controls an rtl tuner; pass --iq rtl_tcp://host:port "
              "or --iq rtlsdr[:index]", file=sys.stderr)
        return 2
    if (args.agc or args.ppm is not None) \
            and not (is_rtltcp or is_rtlsdr or is_sdrplay):
        print("--agc/--ppm control a hardware device; pass --iq "
              "rtl_tcp://host:port, rtlsdr[:index] or sdrplay",
              file=sys.stderr)
        return 2
    if (args.grdb is not None or args.lna_state is not None) \
            and not is_sdrplay:
        print("--grdb/--lna-state control an sdrplay; pass --iq sdrplay",
              file=sys.stderr)
        return 2
    if (args.linearity is not None or args.sensitivity is not None) \
            and not is_airspy:
        print("--linearity/--sensitivity control an airspy; pass "
              "--iq airspy", file=sys.stderr)
        return 2
    if (args.lna_gain is not None or args.vga_gain is not None
            or args.amp) and not is_hackrf:
        print("--lna-gain/--vga-gain/--amp control a hackrf; pass "
              "--iq hackrf", file=sys.stderr)
        return 2
    if args.input_rate and (is_rtltcp or is_rtlsdr or is_airspy
                            or is_hackrf or is_sdrplay):
        print("--input-rate applies to raw/pipe captures; SDR hardware "
              "negotiates its own rate", file=sys.stderr)
        return 2
    if args.reconnect_timeout and not is_rtltcp:
        print("--reconnect-timeout controls an rtl_tcp device; pass --iq "
              "rtl_tcp://host:port", file=sys.stderr)
        return 2
    # input probing/loading runs under the reference's device-load
    # contract (radio.cpp:758-831: every handler constructor throws, the
    # radio catches and warns "loading device failed" instead of dying):
    # a missing/unreadable/corrupt capture is a clean message + exit 2,
    # not a traceback
    try:
        is_wav = (False if (is_rtltcp or is_pipe or is_rtlsdr
                            or is_airspy or is_hackrf or is_sdrplay)
                  else is_riff(args.iq))
        if is_rtltcp or is_rtlsdr:
            # live SDR hardware (network rtl_tcp or in-process dlopen
            # dongle): u8 stream over the ring (streaming only)
            args.follow = True
            iq_fmt, rate = "u8", C.INPUT_RATE
        elif is_airspy:
            # airspy opens NOW: its negotiated native rate (closest
            # supported to 2 MS/s, airspy-handler.cpp:103-116) sets the
            # receiver's on-device rate adapter
            from .runtime.native_source import AirspyUsbSource
            airspy_src = AirspyUsbSource()
            args.follow = True
            iq_fmt, rate = "i16", C.INPUT_RATE
            args.input_rate = airspy_src.rate   # -> cfg.native_rate
        elif is_hackrf:
            # hackrf samples at the chain rate directly (arbitrary-rate
            # set_sample_rate, hackrf-handler.cpp:112) — signed-byte
            # wire, no rate adapter
            args.follow = True
            iq_fmt, rate = "i8", C.INPUT_RATE
        elif is_sdrplay:
            # sdrplay fs = the chain rate (above the RSP's 2 MHz ADC
            # floor, Rsp-device.cpp:71) — planar shorts interleaved into
            # the i16 ring, no rate adapter
            args.follow = True
            iq_fmt, rate = "i16", C.INPUT_RATE
        elif is_pipe:
            # stdin / FIFO: headerless stream from any external SDR tool
            # (`rtl_sdr -f 95M - | rx --iq - --iq-format u8`); streaming
            # only
            if iq_fmt not in ("u8", "i8", "i16"):
                print("pipe/stdin input: pass --iq-format u8, i8 or i16",
                      file=sys.stderr)
                return 2
            args.follow = True
            rate = C.INPUT_RATE
        elif not is_wav:
            # headerless raw capture (rtl_sdr u8 / hackrf i16 convention)
            if iq_fmt not in ("u8", "i8", "i16"):
                print("raw (non-wav) capture: pass --iq-format u8, i8 "
                      "(hackrf_transfer) or i16",
                      file=sys.stderr)
                return 2
            rate = C.INPUT_RATE
            if not args.follow:
                iq = read_iq_raw(args.iq, iq_fmt)
        elif iq_fmt in ("u8", "i8"):
            print(f"--iq-format {iq_fmt} applies to raw captures; wav "
                  "inputs use "
                  "auto/c64/i16", file=sys.stderr)
            return 2
        elif args.follow:
            # streaming: header-only probe, the native ring does the
            # reading
            info = probe_wav(args.iq)
            rate = info.rate
            pcm16 = (info.fmt == 1 and info.sampwidth == 2
                     and info.channels == 2)
            if iq_fmt == "i16" and not pcm16:
                print("--iq-format i16 needs a 16-bit PCM stereo wav",
                      file=sys.stderr)
                return 2
            iq_fmt = "i16" if (pcm16 and iq_fmt in ("auto", "i16")) \
                else "c64"
        elif iq_fmt in ("auto", "i16"):
            try:
                iq, rate = read_iq_wav_raw(args.iq)
                iq_fmt = "i16"
            except ValueError:
                if iq_fmt == "i16":
                    raise
                iq, rate = read_iq_wav(args.iq)
                iq_fmt = "c64"
        else:
            iq, rate = read_iq_wav(args.iq)
    except (OSError, ValueError) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    if rate != C.INPUT_RATE:
        print(f"warning: capture rate {rate} != {C.INPUT_RATE}; "
              "proceeding with the contract rate", file=sys.stderr)
    deemph_us = {"eu": 50.0, "us": 75.0, "off": 0.0}.get(
        str(args.deemphasis).lower(), None)
    if deemph_us is None:
        deemph_us = float(args.deemphasis)
    want_taps = bool(args.dump_if or args.dump_mpx or args.spectra
                     or args.dump_input or args.taps)
    if args.afc and not args.follow and args.runner == "scan" \
            and not args.pcm_out:
        print("--afc closes a per-block host loop; use --runner loop, "
              "--pcm-out, or --follow", file=sys.stderr)
        return 2
    if args.control and args.runner == "scan" and not (args.follow
                                                       or args.pcm_out):
        print("--control services commands between blocks; use --runner "
              "loop, --pcm-out, or --follow", file=sys.stderr)
        return 2
    # setBandwidth semantics: 'off' disables the channel filter, a number
    # (re)designs it at that bandwidth and turns it on
    input_filter = args.input_filter
    fm_bw_hz = None
    if args.fm_bandwidth is not None:
        if str(args.fm_bandwidth).lower() == "off":
            input_filter = False
        else:
            input_filter = True
            fm_bw_hz = float(args.fm_bandwidth) * 1000.0
    cfg_kw = {}
    if fm_bw_hz is not None:
        cfg_kw["fm_bandwidth_hz"] = fm_bw_hz
    if args.block_fm < 4096:
        # ultra-low-latency geometry (block_fm 2048 ≈ 10.7 ms): the
        # overlap-save hops shrink to the block; the scan RDS decoders
        # have no bit grid so they admit any block size
        cfg_kw["fm_hop"] = args.block_fm
        cfg_kw["input_hop"] = args.block_fm * 12
    cfg = ReceiverConfig(
        block_fm=args.block_fm, decoder=args.decoder, mode=args.mode,
        sound=args.sound, panorama=args.panorama,
        pss_active=not args.no_pss,
        deemphasis_us=deemph_us, audio_filter_hz=args.audio_filter,
        input_filter=input_filter, squelch=args.squelch,
        rds=args.rds_decoder if args.rds else "off",
        audio_rate=192000 if args.audio_192k else C.WORKING_RATE,
        frontend=args.frontend, emit_taps=want_taps,
        native_rate=(args.input_rate
                     if args.input_rate not in (0, C.INPUT_RATE) else 0),
        # follow-mode --spectra takes its HF spectrum from the input tap
        # (there is no in-memory capture to transform)
        emit_input_tap=bool(args.dump_input or args.taps
                            or (args.spectra and args.follow)),
        # streaming sinks take the on-device-quantized PCM16 wire form
        # (half the device->host audio bytes; s16le is what they emit
        # anyway) unless the user asked for float32 wav output
        emit_audio_i16=bool((args.pcm_out or args.follow)
                            and not args.float32),
        dc_remove=args.dc_remove == "on", iq_format=iq_fmt,
        test_tone=args.test_tone, **cfg_kw)
    rx = Receiver(cfg)
    balance = args.balance
    lg = (100 - balance) / 100.0 if balance > 0 else 1.0
    rg = (100 + balance) / 100.0 if balance < 0 else 1.0
    sq_auto = str(args.squelch_level).lower() == "auto"
    sq_level = 0.0 if sq_auto else float(args.squelch_level)
    controls = rx.initial_controls()._replace(
        lo_freq_hz=jnp.asarray(args.freq_offset, jnp.int32),
        volume=jnp.asarray(10.0 ** (args.volume_db / 20.0), jnp.float32),
        left_gain=jnp.asarray(lg, jnp.float32),
        right_gain=jnp.asarray(rg, jnp.float32),
        squelch_level=jnp.asarray(sq_level, jnp.float32))
    if sq_auto:
        if args.follow:
            print("--squelch-level auto needs the in-memory capture; "
                  "pass an explicit level with --follow", file=sys.stderr)
            return 2
        if args.squelch != "nsq":
            print("--squelch-level auto requires --squelch nsq (the profile "
                  "measures the noise-squelch band ratio)", file=sys.stderr)
            return 2
        if cfg.native_rate:
            print("--squelch-level auto profiles at 2.304 MS/s; pass an "
                  "explicit level with --input-rate", file=sys.stderr)
            return 2
        # profile the first block host-side (scipy demod — no second
        # device compile) and pick the slider level from the band-energy
        # ratio
        from .ops.squelch import auto_squelch_level, host_demod_profile
        demod0 = host_demod_profile(iq[: cfg.block_in], cfg.iq_format,
                                    args.freq_offset)
        lvl = auto_squelch_level(demod0, cfg.fm_rate)
        print(f"auto squelch level: {lvl:.1f}", file=sys.stderr)
        controls = controls._replace(
            squelch_level=jnp.asarray(lvl, jnp.float32))

    t0 = time.time()
    init_state = None
    if args.load_state:
        from .runtime.checkpoint import load_state
        init_state, ck_meta = load_state(args.load_state, rx.init_state(),
                                         cfg=cfg)
        print(f"resumed state from {args.load_state} {ck_meta}",
              file=sys.stderr)
    import contextlib
    profile_cm = contextlib.nullcontext()
    if args.profile:
        import jax
        profile_cm = jax.profiler.trace(args.profile)
    from .rds.live import LiveRDSDecoder
    live_rds = LiveRDSDecoder(pty_locale=args.pty_locale) if args.rds else None
    controls_update = None
    if args.afc and not args.control:
        from .models.tuner import AFCTracker
        _afc = AFCTracker(cfg.fm_rate)
        _base_lo = int(args.freq_offset)

        def controls_update(ctl, meta):
            off = _afc.update(meta["dc_if"])
            return ctl._replace(lo_freq_hz=jnp.asarray(
                int(round(_base_lo + off)), jnp.int32))
    ctl_channel = ctl_proc = command_hook = dev_info = None
    if args.control:
        from .runtime.control import ControlChannel, CommandProcessor
        stations = None
        if args.stations:
            from .io.stations import StationList
            stations = StationList.load(args.stations)
        try:
            ctl_channel = ControlChannel(args.control)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        ctl_proc = CommandProcessor(
            rx, ctl_channel, lo_hz=args.freq_offset,
            afc_active=args.afc,
            on_retune=(live_rds.reset if live_rds else None),
            meta_provider=(lambda: {"rds": live_rds.report()})
            if live_rds else None,
            stations=stations, stations_path=args.stations)
        ctl_proc.seed_from(controls)
        command_hook = ctl_proc.apply
    sink = None
    if args.pcm_out:
        from .io.pcmout import PCMSink
        sink = PCMSink(args.pcm_out, cfg.audio_rate, pace=args.pcm_pace)
    ckpt_mgr = None
    on_state = None
    if args.ckpt_dir:
        if args.runner == "scan" and not (args.follow or args.pcm_out):
            raise SystemExit("--ckpt-dir needs a per-block host loop "
                             "(--runner loop, --follow, or --pcm-out); the "
                             "single-dispatch scan runner cannot snapshot "
                             "mid-dispatch")
        from .runtime.checkpoint import CheckpointManager
        ckpt_mgr = CheckpointManager(
            args.ckpt_dir, cfg=cfg, backend=args.ckpt_backend,
            max_to_keep=args.ckpt_keep, keep_period=args.ckpt_keep_period)
        every = max(1, args.ckpt_every)

        def on_state(blocks_done, state):
            if blocks_done % every == 0:
                ckpt_mgr.save(blocks_done, state)
    follow_dumps = None
    if args.follow and (want_taps or args.control):
        # --control alone enables the runtime dump buttons (the audio dump
        # needs no taps; input/if/mpx additionally need --taps)
        follow_dumps = _FollowDumps(args, cfg)
        if ctl_proc is not None:
            ctl_proc.dumps = follow_dumps
    meter = None
    if args.meter:
        if not (args.follow or args.pcm_out):
            print("--meter needs a streaming runner (--follow or "
                  "--pcm-out)", file=sys.stderr)
            return 2
        _mtr = {"t": 0.0, "blocks": 0}
        blk_s = cfg.block_fm / cfg.fm_rate

        def meter(meta):
            _mtr["blocks"] += 1
            now = time.time()
            # repaint at most ~4 Hz in real time, but always every 8th
            # block so faster-than-real-time runs still show progress
            if now - _mtr["t"] < 0.25 and _mtr["blocks"] % 8:
                return
            _mtr["t"] = now
            parts = [f"[{_mtr['blocks'] * blk_s:7.1f}s]"]
            if ctl_proc is not None:
                parts.append(f"lo={ctl_proc.lo_hz:+d}")
            lock = "LOCK" if meta.get("pilot_locked") else "----"
            parts.append(f"pilot={lock} {meta.get('pilot_strength', 0):.2f}")
            parts.append(f"L={meta.get('peak_left_db', 0):+5.1f}dB "
                         f"R={meta.get('peak_right_db', 0):+5.1f}dB")
            if "ingest_dropped" in meta:
                parts.append(f"drops={meta['ingest_dropped']}")
            if "latency_ms" in meta:
                parts.append(f"lat={meta['latency_ms']:3.0f}ms")
            if live_rds is not None and live_rds.sync.groups_decoded:
                r = live_rds.result
                parts.append(f"PI=0x{r.pi_code:04X} "
                             f"PS={r.station_label.strip()!r}")
            sys.stderr.write("\r" + " ".join(parts) + "   ")
            sys.stderr.flush()
    try:
        with profile_cm:
            if args.follow:
                from .runtime.native_source import (NativePipeSource,
                                                    NativeRawSource,
                                                    NativeWavSource,
                                                    RtlTcpSource)
                from .runtime.stream import run_live
                pace = not args.no_pace
                loop = args.loop_seconds is not None
                # live-source constructors throw on failure; the
                # reference's device-load contract turns that into a
                # warning, not a crash (radio.cpp:758-831)
                try:
                    if is_rtltcp or is_rtlsdr:
                        if is_rtltcp:
                            host, port = _rtltcp_hostport(args.iq)
                            src = RtlTcpSource(
                                host, port, rate=C.INPUT_RATE,
                                reconnect_timeout_ms=int(
                                    args.reconnect_timeout * 1000))
                        else:
                            from .runtime.native_source import \
                                RtlSdrUsbSource
                            src = RtlSdrUsbSource(
                                device_index=_rtlsdr_index(args.iq),
                                rate=C.INPUT_RATE)
                        # settings in the rtlsdr-handler's order: ppm, gain
                        # mode/gain, AGC, then the frequency
                        # (rtlsdr-handler.cpp:102-116)
                        if args.ppm is not None:
                            src.set_freq_correction(args.ppm)
                        if args.gain is not None:
                            src.set_gain_mode(True)
                            src.set_gain(args.gain)
                        if args.agc:
                            src.set_agc(True)
                            src.set_gain_mode(False)
                        if args.tune_hz:
                            src.set_frequency(args.tune_hz)
                        if ctl_proc is not None:
                            ctl_proc.source = src
                            if args.tune_hz:
                                ctl_proc.center_hz = int(args.tune_hz)
                    elif is_airspy:
                        # opened during input probing (rate negotiation);
                        # settings in the airspy-handler's order: composite
                        # gains, then the frequency (airspy-handler.cpp:
                        # 209-231)
                        src = airspy_src
                        if args.linearity is not None:
                            src.set_linearity(args.linearity)
                        if args.sensitivity is not None:
                            src.set_sensitivity(args.sensitivity)
                        if args.tune_hz:
                            src.set_frequency(args.tune_hz)
                        if ctl_proc is not None:
                            ctl_proc.source = src
                            if args.tune_hz:
                                ctl_proc.center_hz = int(args.tune_hz)
                    elif is_hackrf:
                        # settings in the hackrf-handler's order: gains,
                        # amp, antenna, then frequency
                        # (hackrf-handler.cpp:112-151, 256-315)
                        from .runtime.native_source import HackRfUsbSource
                        src = HackRfUsbSource(rate=C.INPUT_RATE)
                        if args.lna_gain is not None:
                            src.set_lna_gain(args.lna_gain)
                        if args.vga_gain is not None:
                            src.set_vga_gain(args.vga_gain)
                        if args.amp:
                            src.set_amp(True)
                        src.set_antenna(True)
                        if args.tune_hz:
                            src.set_frequency(args.tune_hz)
                        if ctl_proc is not None:
                            ctl_proc.source = src
                            if args.tune_hz:
                                ctl_proc.center_hz = int(args.tune_hz)
                    elif is_sdrplay:
                        # settings in the Rsp-device order: gains, agc,
                        # ppm, then frequency (Rsp-device.cpp:160-198)
                        from .runtime.native_source import SdrplayUsbSource
                        src = SdrplayUsbSource(rate=C.INPUT_RATE)
                        if args.grdb is not None:
                            src.set_grdb(args.grdb)
                        if args.lna_state is not None:
                            src.set_lna_state(args.lna_state)
                        if args.agc:
                            src.set_agc(True)
                        if args.ppm is not None:
                            src.set_freq_correction(args.ppm)
                        if args.tune_hz:
                            src.set_frequency(args.tune_hz)
                        if ctl_proc is not None:
                            ctl_proc.source = src
                            if args.tune_hz:
                                ctl_proc.center_hz = int(args.tune_hz)
                    elif is_pipe:
                        src = NativePipeSource(args.iq, fmt=iq_fmt,
                                               rate=cfg.wire_rate)
                    elif iq_fmt == "c64":
                        src = NativeWavSource(args.iq, pace=pace, loop=loop)
                    elif is_wav:
                        src = NativeRawSource(args.iq, pace=pace, loop=loop)
                    else:
                        src = NativeRawSource(args.iq, fmt=iq_fmt,
                                              rate=cfg.wire_rate, pace=pace,
                                              loop=loop)
                    if ctl_proc is not None and ctl_proc.source is None:
                        # every live source takes control-plane commands
                        # that apply to it (pause = native reader stop;
                        # non-rtl_tcp sources simply have no tuner entry)
                        ctl_proc.source = src
                except (OSError, ValueError) as e:
                    print(f"loading device failed: {args.iq}: {e}",
                          file=sys.stderr)
                    return 2
                max_blocks = None
                if args.loop_seconds:
                    max_blocks = max(1, int(args.loop_seconds
                                            * cfg.wire_rate) // cfg.wire_len)
                # compile the step BEFORE the producer starts: a paced or
                # live source would overrun its ring during the first
                # dispatch's trace+compile (seconds) and drop the head of
                # the stream
                from .runtime.stream import _wire_dtype
                _z_shape = ((cfg.wire_len,) if cfg.iq_format == "c64"
                            else (cfg.wire_len, 2))
                rx.jit_step()(rx.init_state(), controls,
                              jnp.zeros(_z_shape, _wire_dtype(cfg)))
                src.start()
                try:
                    on_audio_cb = sink.write if sink else None
                    if follow_dumps is not None:
                        if sink is not None:
                            def on_audio_cb(fr, _w=sink.write,
                                            _d=follow_dumps.on_audio):
                                _w(fr)
                                _d(fr)
                        else:
                            on_audio_cb = follow_dumps.on_audio
                    res = run_live(
                        rx, src, controls, init_state=init_state,
                        max_blocks=max_blocks,
                        on_audio=on_audio_cb,
                        on_meta=meter,
                        rds_feedback=live_rds.feed if live_rds else None,
                        controls_update=controls_update,
                        command_hook=command_hook,
                        on_state=on_state,
                        on_taps=(follow_dumps.on_taps if follow_dumps
                                 else None))
                    if is_rtltcp:
                        dev_info = {"tuner_type": src.tuner_type,
                                    "tuner_gain_count": src.tuner_gain_count,
                                    "reconnects": src.reconnects}
                finally:
                    src.close()
            elif args.pcm_out:
                from .runtime.stream import run_streaming
                res = run_streaming(rx, iq, controls, init_state=init_state,
                                    on_audio=sink.write,
                                    on_meta=meter,
                                    rds_feedback=(live_rds.feed if live_rds
                                                  else None),
                                    controls_update=controls_update,
                                    command_hook=command_hook,
                                    on_state=on_state,
                                    collect_taps=want_taps)
            elif args.runner == "scan":
                res = run_offline_scanned(rx, iq, controls,
                                          collect_taps=want_taps,
                                          init_state=init_state,
                                          chunk_blocks=args.chunk_blocks)
            else:
                res = run_offline(rx, iq, controls, collect_taps=want_taps,
                                  init_state=init_state,
                                  rds_feedback=(live_rds.feed if live_rds
                                                else None),
                                  controls_update=controls_update,
                                  command_hook=command_hook,
                                  on_state=on_state)
    finally:
        if sink is not None:
            sink.close()
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        if ctl_channel is not None:
            ctl_channel.close()
    dt = time.time() - t0
    if meter is not None:
        sys.stderr.write("\n")
    if args.profile:
        print(f"wrote profiler trace to {args.profile}", file=sys.stderr)
    n_in = (len(res.meta) if args.follow
            else len(iq) // cfg.wire_len) * cfg.wire_len
    rt = n_in / cfg.wire_rate / dt if dt > 0 else float("inf")
    print(f"processed {n_in} IQ samples in {dt:.2f}s ({rt:.1f}x real-time)",
          file=sys.stderr)
    if args.follow:
        print(f"ingest overrun drops: {res.dropped_total}", file=sys.stderr)

    if args.audio:
        write_wav(args.audio, res.audio, cfg.audio_rate,
                  float32=args.float32)
        print(f"wrote {args.audio} ({len(res.audio)} frames)", file=sys.stderr)

    report = {
        "input_samples": int(n_in),
        "blocks": len(res.meta),
        "throughput_x_realtime": rt,
        "meta_last": res.meta[-1] if res.meta else {},
    }
    if args.follow:
        report["ingest_dropped"] = res.dropped_total
        lats = sorted(m["latency_ms"] for m in res.meta[2:]
                      if "latency_ms" in m)     # [2:]: skip jit warm-up
        if lats:
            q = lambda p: lats[min(len(lats) - 1,       # noqa: E731
                                   int(p * len(lats)))]
            report["latency_ms"] = {
                "block": round(1e3 * cfg.block_fm / cfg.fm_rate, 1),
                "p50": round(q(0.50), 1), "p95": round(q(0.95), 1),
                "max": round(lats[-1], 1)}
            print(f"end-to-end latency (ready->audio, post-warmup): "
                  f"p50 {report['latency_ms']['p50']} ms, "
                  f"p95 {report['latency_ms']['p95']} ms "
                  f"(+{report['latency_ms']['block']} ms block accumulation)",
                  file=sys.stderr)
    if dev_info is not None:
        report["device"] = dev_info
    if ctl_proc is not None:
        report["control"] = {"commands": ctl_proc.commands_handled,
                             "retunes": ctl_proc.retunes,
                             "hw_retunes": ctl_proc.hw_retunes,
                             "final_lo_hz": ctl_proc.lo_hz}
        if ctl_proc.center_hz is not None:
            report["control"]["tuned_hz"] = (ctl_proc.center_hz
                                             + ctl_proc.lo_hz)
    if args.rds and live_rds is not None:
        fed_incrementally = (args.follow or args.pcm_out
                             or args.runner != "scan")
        if not fed_incrementally and res.rds_bits is not None:
            live_rds.feed(res.rds_bits)
        r = live_rds.result
        report["rds"] = live_rds.report()
        print(f"RDS: PI={report['rds']['pi_code']} "
              f"station={r.station_label!r} text={r.radio_text!r} "
              f"groups={live_rds.sync.groups_decoded} "
              f"BER={live_rds.sync.bit_error_rate:.4f}",
              file=sys.stderr)
    if follow_dumps is not None:
        follow_dumps.finish(res)
    if args.dump_input and not args.follow and "input_dc" in res.taps:
        from .io.wavio import write_iq_wav
        write_iq_wav(args.dump_input, res.taps["input_dc"], cfg.input_rate)
        print(f"wrote {args.dump_input}", file=sys.stderr)
    if args.dump_if and not args.follow and "if_filtered" in res.taps:
        from .io.wavio import write_iq_wav
        write_iq_wav(args.dump_if, res.taps["if_filtered"], cfg.fm_rate)
    if args.dump_mpx and not args.follow and "demod" in res.taps:
        write_wav(args.dump_mpx, res.taps["demod"], cfg.fm_rate, float32=True)
    if args.spectra and not args.follow:
        from .models import scopes
        import jax.numpy as jnp
        iq_c = iq[: cfg.wire_len]
        if iq_fmt == "i16":
            iq_c = ((iq_c[:, 0] + 1j * iq_c[:, 1]) / 32768.0
                    ).astype(np.complex64)
        elif iq_fmt == "u8":
            iq_c = (((iq_c[:, 0].astype(np.float32) - 127.0)
                     + 1j * (iq_c[:, 1].astype(np.float32) - 127.0)) / 128.0
                    ).astype(np.complex64)
        hf = np.asarray(scopes.spectrum_db(jnp.asarray(iq_c)))
        # the HF axis spans ±wire_rate/2 — record it so a native-rate
        # capture's spectrum is not misread as ±1.152 MHz
        out_npz = {"hf_spectrum_db": hf,
                   "hf_rate": np.asarray(cfg.wire_rate)}
        if args.lf_plot in res.taps:
            d = res.taps[args.lf_plot]
            lf_rate = (cfg.rds_rate if args.lf_plot.startswith("rds")
                       else cfg.fm_rate)
            blk = (cfg.block_rds if args.lf_plot.startswith("rds")
                   else cfg.block_fm)
            nb = len(d) // blk
            rows = []
            for i in range(nb):
                row, xa = _lf_row(d[i * blk:(i + 1) * blk], lf_rate,
                                  args.lf_zoom)
                rows.append(row)
            out_npz["lf_waterfall_db"] = scopes.waterfall(rows)
            out_npz["lf_x_axis_khz"] = xa
        elif args.lf_plot != "demod":
            print(f"--lf-plot {args.lf_plot}: tap not present in this "
                  "config", file=sys.stderr)
        if res.rds_iq is not None:
            out_npz["rds_constellation"] = scopes.iq_constellation(res.rds_iq)
        np.savez(args.spectra, **out_npz)
        print(f"wrote {args.spectra}", file=sys.stderr)
    if args.save_state and res.final_state is not None:
        if args.ckpt_backend == "orbax":
            from .runtime.checkpoint import save_state_orbax as save_state
        else:
            from .runtime.checkpoint import save_state
        save_state(args.save_state, res.final_state,
                   {"blocks": len(res.meta)}, cfg=cfg)
        print(f"wrote {args.save_state}", file=sys.stderr)
    if args.log_meta:
        blk_s = cfg.block_fm / cfg.fm_rate
        with open(args.log_meta, "w") as f:
            for b, m in enumerate(res.meta):
                rec = {"block": b, "t_s": round((b + 1) * blk_s, 6),
                       "freq_offset_hz": args.freq_offset}
                rec.update(m)
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {args.log_meta} ({len(res.meta)} records)",
              file=sys.stderr)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.report}", file=sys.stderr)
    else:
        json.dump(report, sys.stdout, indent=2)
        print()
    if args.config:
        # save-on-exit (the reference writes its QSettings back on close):
        # runtime-control edits win over the flags the run started with
        import os
        profile = {}
        if os.path.exists(args.config):
            try:
                profile = json.load(open(args.config))
            except (ValueError, OSError):
                profile = {}
        profile.update({
            "freq_offset": (int(ctl_proc.lo_hz) if ctl_proc
                            else int(args.freq_offset)),
            "volume_db": (round(ctl_proc.volume_db, 2) if ctl_proc
                          else args.volume_db),
            "balance": ctl_proc.balance if ctl_proc else args.balance,
            "mode": args.mode, "decoder": args.decoder,
            "deemphasis": args.deemphasis, "squelch": args.squelch,
            "rds": bool(args.rds), "block_fm": args.block_fm,
            # live sound-mode / panorama edits win over the starting flags
            # (the reference persists both: radio.cpp:504-505 pano slider,
            # the channelSelector combobox)
            "sound": (ctl_proc.sound if ctl_proc is not None
                      and ctl_proc.sound is not None else args.sound),
            "panorama": (ctl_proc.pano if ctl_proc is not None
                         and ctl_proc.pano is not None else args.panorama),
        })
        if ctl_proc is not None and ctl_proc.squelch_level is not None:
            profile["squelch_level"] = ctl_proc.squelch_level
        elif not sq_auto:
            profile["squelch_level"] = args.squelch_level
        if ctl_proc is not None and ctl_proc.center_hz is not None:
            profile["tune_hz"] = int(ctl_proc.center_hz)
        elif args.tune_hz:
            profile["tune_hz"] = int(args.tune_hz)
        with open(args.config, "w") as f:
            json.dump(profile, f, indent=2)
            f.write("\n")
        print(f"saved settings profile to {args.config}", file=sys.stderr)
    return 0


def cmd_scan(args) -> int:
    import numpy as np
    from . import constants as C
    from .io.wavio import read_iq_wav
    from .models.bandscan import raw_to_c64, scan_band, scan_capture
    from .models.receiver import Receiver, ReceiverConfig

    from .io.wavio import is_riff, read_iq_raw
    is_scan_rtlsdr = args.iq == "rtlsdr" or args.iq.startswith("rtlsdr:")
    is_scan_hackrf = args.iq == "hackrf"
    if args.iq.startswith(("rtl_tcp://", "rtltcp://")) or is_scan_rtlsdr \
            or is_scan_hackrf:
        # full-band hardware sweep: step the device across the raster and
        # decide every channel of each stop in one vmapped dispatch —
        # network rtl_tcp or the in-process dlopen devices, same
        # scan_band source contract (set_frequency/read_block/fmt/rate)
        rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="off"))
        try:
            if is_scan_rtlsdr:
                from .runtime.native_source import RtlSdrUsbSource
                src = RtlSdrUsbSource(_rtlsdr_index(args.iq),
                                      rate=C.INPUT_RATE)
            elif is_scan_hackrf:
                from .runtime.native_source import HackRfUsbSource
                src = HackRfUsbSource(rate=C.INPUT_RATE)
                src.set_antenna(True)
            else:
                from .runtime.native_source import RtlTcpSource
                host, port = _rtltcp_hostport(args.iq)
                src = RtlTcpSource(host, port, rate=C.INPUT_RATE)
        except (OSError, ValueError) as e:
            print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
            return 2
        src.start()
        try:
            hits = scan_band(
                rx, src, f_start=int(args.band_start * 1e6),
                f_stop=int(args.band_stop * 1e6), grid_hz=args.grid,
                threshold_db=args.threshold, blocks=args.scan_blocks,
                settle_ms=args.settle_ms,
                identify_seconds=args.seconds if args.identify else 0.0,
                log=lambda m: print(m, file=sys.stderr))
        finally:
            src.close()
        for e in hits:
            print(f"  {e['freq_hz'] / 1e6:.1f} MHz: {e}", file=sys.stderr)
        if args.stations:
            from .io.stations import StationList
            sl = StationList.load(args.stations)
            for e in hits:
                if e.get("station"):
                    sl.add(e["station"], e["freq_hz"],
                           pi_code=int(e["pi_code"], 16), pty=e.get("pty"))
            sl.save(args.stations)
            print(f"wrote {args.stations}", file=sys.stderr)
        json.dump({"hits": hits}, sys.stdout, indent=2)
        print()
        return 0
    try:
        if is_riff(args.iq):
            iq, rate = read_iq_wav(args.iq)
        else:
            # headerless raw capture: scan is not a perf path, so convert
            # to complex host-side with the device conventions
            # (rtlsdr-handler.cpp:285-294 for u8)
            if args.iq_format not in ("u8", "i8", "i16"):
                print("raw (non-wav) capture: pass --iq-format u8, i8 "
                      "or i16", file=sys.stderr)
                return 2
            iq = raw_to_c64(read_iq_raw(args.iq, args.iq_format),
                            args.iq_format)
            rate = C.INPUT_RATE
    except (OSError, ValueError) as e:
        print(f"loading device failed: {args.iq}: {e}", file=sys.stderr)
        return 2
    rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="off"))
    T = rx.cfg.block_in
    if len(iq) < T:
        print(f"capture too short: need {T} samples", file=sys.stderr)
        return 1
    # decision averaged over blocks spread across the capture (clearAverage
    # depth, fm-processor.cpp:480-495) — not just the first block
    results = scan_capture(rx, iq, grid_hz=args.grid,
                           threshold_db=args.threshold,
                           max_blocks=args.scan_blocks)
    found = [e["offset_hz"] for e in results]
    print(f"scan: {len(found)} hit(s) at offsets {found}", file=sys.stderr)
    if args.identify and found:
        # ALL hits demodulate in one vmapped dispatch (models/multistation —
        # the reference identifies serially, one retune at a time)
        from .models.multistation import demodulate_stations
        n = min(len(iq), int(args.seconds * C.INPUT_RATE))
        rx = Receiver(ReceiverConfig(block_fm=args.block_fm, rds="block",
                                     audio_filter_hz=15000))
        from .models.bandscan import decode_rds_hit
        # >1 device: put the station axis on the mesh (zero collectives —
        # each device identifies whole stations, near-linear scaling)
        import jax
        mesh = None
        if len(jax.devices()) > 1:
            from .parallel.sharding import make_mesh
            mesh = make_mesh(axis="stations")
            print(f"identify: station axis sharded over "
                  f"{len(jax.devices())} devices", file=sys.stderr)
        per_station = demodulate_stations(rx, iq[:n], found, mesh=mesh)
        for entry, res in zip(results, per_station):
            entry["pilot_locked"] = bool(res["meta"]["pilot_locked"])
            if res["rds_bits"] is not None:
                entry.update(decode_rds_hit(res["rds_bits"]))
            print(f"  offset {entry['offset_hz']:+d} Hz: {entry}",
                  file=sys.stderr)
    if args.stations:
        from .io.stations import StationList
        sl = StationList.load(args.stations)
        for e in results:
            if e.get("station"):
                sl.add(e["station"], e["offset_hz"],
                       pi_code=int(e["pi_code"], 16), pty=e.get("pty"))
        sl.save(args.stations)
        print(f"wrote {args.stations}", file=sys.stderr)
    json.dump({"hits": results}, sys.stdout, indent=2)
    print()
    return 0


def cmd_synth(args) -> int:
    import numpy as np
    from . import constants as C
    from .io import synth
    from .io.wavio import write_iq_wav
    from .rds import encode

    n = int(args.seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    left = 0.6 * np.sin(2 * np.pi * args.left_freq * t)
    right = 0.6 * np.sin(2 * np.pi * args.right_freq * t)
    bits = encode.make_bitstream(pi=args.pi, pty=args.pty,
                                 station=args.station,
                                 radiotext=args.radiotext + "\r",
                                 repeats=max(2, int(args.seconds)))
    syms = encode.differential_encode(bits)
    mpx = synth.synth_mpx(left, right, synth.MPXParams(rds_level=0.07),
                          rds_bits=syms)
    iq = synth.fm_modulate(mpx, C.FM_RATE,
                           carrier_offset_hz=args.carrier_offset,
                           noise_std=args.noise)
    write_iq_wav(args.out, iq, C.INPUT_RATE, float32=not args.int16)
    print(f"wrote {args.out}: {len(iq)} IQ samples at {C.INPUT_RATE} S/s",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import os
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="sdrjfm_tpu",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rx = _build_rx_parser(sub)
    _build_scan_parser(sub)
    _build_synth_parser(sub)
    # settings profile: keys become flag DEFAULTS before parsing, so
    # explicit flags still win (the reference restores .jsdr-fm.ini the
    # same way: saved state first, UI actions override)
    if "--config" in argv:
        cfgpath = argv[argv.index("--config") + 1]
        if os.path.exists(cfgpath):
            try:
                profile = json.load(open(cfgpath))
            except (ValueError, OSError) as e:
                print(f"--config {cfgpath}: {e}", file=sys.stderr)
                return 2
            dests = {a.dest for a in p_rx._actions}
            p_rx.set_defaults(**{k: v for k, v in profile.items()
                                 if k in dests})
    args = ap.parse_args(argv)
    from .runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.cmd == "rx":
        return cmd_rx(args)
    if args.cmd == "scan":
        return cmd_scan(args)
    if args.cmd == "synth":
        return cmd_synth(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
