"""ctypes bindings for the native ingest runtime (runtime/native/).

Provides the framework's Source abstraction over the C++ SPSC-ring wav
streamer — the deviceHandler-shaped interface of the reference
(devices/device-handler.h:60-85: getRate / restartReader / stopReader /
getSamples / Samples / resetBuffer), backed by a producer thread and a
lock-free ring exactly like the reference's device zoo.  Builds on demand
with `make`; falls back cleanly (raises NativeUnavailable) when no compiler
is present.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_LIB_PATH = _NATIVE_DIR / "libsdrjfm_ingest.so"


class NativeUnavailable(RuntimeError):
    pass


_lib = None


def load_library(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if build:
        # the library is built from the committed sources at first use;
        # the lock serialises concurrent first users (test workers, a CLI
        # started beside another) so one builds and the others wait and
        # reuse it — make's own timestamp check decides whether to rebuild
        with open(_NATIVE_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError) as e:
                if not _LIB_PATH.exists():
                    raise NativeUnavailable(
                        f"cannot build native ingest: {e}")
    if not _LIB_PATH.exists():
        raise NativeUnavailable("libsdrjfm_ingest.so not built")
    lib = ctypes.CDLL(str(_LIB_PATH))
    try:
        lib.sdr_sdrplay_open          # newest ABI symbol; probes staleness
    except AttributeError:
        raise NativeUnavailable(
            "libsdrjfm_ingest.so is stale (missing sdr_sdrplay_open) and "
            "rebuilding failed; run `make -C sdrjfm_tpu/runtime/native -B`")
    lib.sdr_wav_source_open.restype = ctypes.c_void_p
    lib.sdr_wav_source_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_int, ctypes.c_int]
    lib.sdr_source_rate.restype = ctypes.c_uint32
    lib.sdr_source_rate.argtypes = [ctypes.c_void_p]
    lib.sdr_source_start.argtypes = [ctypes.c_void_p]
    lib.sdr_source_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_source_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_source_close.argtypes = [ctypes.c_void_p]
    lib.sdr_source_read.restype = ctypes.c_size_t
    lib.sdr_source_read.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_size_t]
    lib.sdr_source_read_blocking.restype = ctypes.c_size_t
    lib.sdr_source_read_blocking.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_float),
                                             ctypes.c_size_t, ctypes.c_long]
    lib.sdr_source_available.restype = ctypes.c_size_t
    lib.sdr_source_available.argtypes = [ctypes.c_void_p]
    lib.sdr_source_dropped.restype = ctypes.c_uint64
    lib.sdr_source_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_source_eof.restype = ctypes.c_int
    lib.sdr_source_eof.argtypes = [ctypes.c_void_p]
    # raw passthrough source (integer frames, no host float conversion)
    lib.sdr_raw_wav_open.restype = ctypes.c_void_p
    lib.sdr_raw_wav_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_int, ctypes.c_int]
    lib.sdr_raw_file_open.restype = ctypes.c_void_p
    lib.sdr_raw_file_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_uint32]
    lib.sdr_raw_pipe_open.restype = ctypes.c_void_p
    lib.sdr_raw_pipe_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_uint32,
                                      ctypes.c_int]
    lib.sdr_raw_rate.restype = ctypes.c_uint32
    lib.sdr_raw_rate.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_frame_bytes.restype = ctypes.c_int
    lib.sdr_raw_frame_bytes.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_start.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_raw_close.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_read_blocking.restype = ctypes.c_size_t
    lib.sdr_raw_read_blocking.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_size_t, ctypes.c_long]
    lib.sdr_raw_available.restype = ctypes.c_size_t
    lib.sdr_raw_available.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_dropped.restype = ctypes.c_uint64
    lib.sdr_raw_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_raw_eof.restype = ctypes.c_int
    lib.sdr_raw_eof.argtypes = [ctypes.c_void_p]
    # rtl_tcp network source
    lib.sdr_rtltcp_open.restype = ctypes.c_void_p
    lib.sdr_rtltcp_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_size_t]
    lib.sdr_rtltcp_open2.restype = ctypes.c_void_p
    lib.sdr_rtltcp_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_size_t, ctypes.c_long]
    lib.sdr_rtltcp_reconnects.restype = ctypes.c_uint32
    lib.sdr_rtltcp_reconnects.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_connected.restype = ctypes.c_int
    lib.sdr_rtltcp_connected.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_flush.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_tuner_type.restype = ctypes.c_uint32
    lib.sdr_rtltcp_tuner_type.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_gain_count.restype = ctypes.c_uint32
    lib.sdr_rtltcp_gain_count.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_command.restype = ctypes.c_int
    lib.sdr_rtltcp_command.argtypes = [ctypes.c_void_p, ctypes.c_uint8,
                                       ctypes.c_uint32]
    lib.sdr_rtltcp_start.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_rtltcp_close.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_read_blocking.restype = ctypes.c_size_t
    lib.sdr_rtltcp_read_blocking.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_uint8),
                                             ctypes.c_size_t, ctypes.c_long]
    lib.sdr_rtltcp_available.restype = ctypes.c_size_t
    lib.sdr_rtltcp_available.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_dropped.restype = ctypes.c_uint64
    lib.sdr_rtltcp_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_rtltcp_eof.restype = ctypes.c_int
    lib.sdr_rtltcp_eof.argtypes = [ctypes.c_void_p]
    # in-process dlopen(librtlsdr) device
    lib.sdr_rtlsdr_last_error.restype = ctypes.c_char_p
    lib.sdr_rtlsdr_open.restype = ctypes.c_void_p
    lib.sdr_rtlsdr_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.c_size_t, ctypes.c_uint32]
    lib.sdr_rtlsdr_rate.restype = ctypes.c_uint32
    lib.sdr_rtlsdr_rate.argtypes = [ctypes.c_void_p]
    for f in ("set_freq", "set_gain_mode", "set_gain", "set_agc",
              "set_ppm"):
        fn = getattr(lib, f"sdr_rtlsdr_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32
                       if f == "set_freq" else ctypes.c_int]
    lib.sdr_rtlsdr_get_freq.restype = ctypes.c_uint32
    lib.sdr_rtlsdr_get_freq.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_start.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_rtlsdr_flush.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_close.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_read_blocking.restype = ctypes.c_size_t
    lib.sdr_rtlsdr_read_blocking.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_uint8),
                                             ctypes.c_size_t, ctypes.c_long]
    lib.sdr_rtlsdr_available.restype = ctypes.c_size_t
    lib.sdr_rtlsdr_available.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_dropped.restype = ctypes.c_uint64
    lib.sdr_rtlsdr_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_rtlsdr_eof.restype = ctypes.c_int
    lib.sdr_rtlsdr_eof.argtypes = [ctypes.c_void_p]
    # in-process dlopen(libairspy) device
    lib.sdr_airspy_last_error.restype = ctypes.c_char_p
    lib.sdr_airspy_open.restype = ctypes.c_void_p
    lib.sdr_airspy_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.sdr_airspy_rate.restype = ctypes.c_uint32
    lib.sdr_airspy_rate.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_set_freq.restype = ctypes.c_int
    lib.sdr_airspy_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    for f in ("set_linearity", "set_sensitivity", "set_lna", "set_vga",
              "set_mixer", "set_lna_agc", "set_mixer_agc"):
        fn = getattr(lib, f"sdr_airspy_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_airspy_start.restype = ctypes.c_int
    lib.sdr_airspy_start.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_airspy_flush.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_close.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_read_blocking.restype = ctypes.c_size_t
    lib.sdr_airspy_read_blocking.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_uint8),
                                             ctypes.c_size_t, ctypes.c_long]
    lib.sdr_airspy_available.restype = ctypes.c_size_t
    lib.sdr_airspy_available.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_dropped.restype = ctypes.c_uint64
    lib.sdr_airspy_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_airspy_eof.restype = ctypes.c_int
    lib.sdr_airspy_eof.argtypes = [ctypes.c_void_p]
    # in-process dlopen(libhackrf) device
    lib.sdr_hackrf_last_error.restype = ctypes.c_char_p
    lib.sdr_hackrf_open.restype = ctypes.c_void_p
    lib.sdr_hackrf_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_uint32]
    lib.sdr_hackrf_rate.restype = ctypes.c_uint32
    lib.sdr_hackrf_rate.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_set_freq.restype = ctypes.c_int
    lib.sdr_hackrf_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    for f in ("set_lna", "set_vga", "set_amp", "set_antenna"):
        fn = getattr(lib, f"sdr_hackrf_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_hackrf_start.restype = ctypes.c_int
    lib.sdr_hackrf_start.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_hackrf_flush.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_close.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_read_blocking.restype = ctypes.c_size_t
    lib.sdr_hackrf_read_blocking.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_long]
    lib.sdr_hackrf_available.restype = ctypes.c_size_t
    lib.sdr_hackrf_available.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_dropped.restype = ctypes.c_uint64
    lib.sdr_hackrf_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_hackrf_eof.restype = ctypes.c_int
    lib.sdr_hackrf_eof.argtypes = [ctypes.c_void_p]
    # in-process dlopen(libsdrplay_api) device
    lib.sdr_sdrplay_last_error.restype = ctypes.c_char_p
    lib.sdr_sdrplay_open.restype = ctypes.c_void_p
    lib.sdr_sdrplay_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_uint32]
    lib.sdr_sdrplay_rate.restype = ctypes.c_uint32
    lib.sdr_sdrplay_rate.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_hw_ver.restype = ctypes.c_char
    lib.sdr_sdrplay_hw_ver.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_set_freq.restype = ctypes.c_int
    lib.sdr_sdrplay_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    for f in ("set_grdb", "set_lna_state", "set_agc"):
        fn = getattr(lib, f"sdr_sdrplay_{f}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_sdrplay_set_ppm.restype = ctypes.c_int
    lib.sdr_sdrplay_set_ppm.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.sdr_sdrplay_start.restype = ctypes.c_int
    lib.sdr_sdrplay_start.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_sdrplay_flush.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_stop.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_close.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_read_blocking.restype = ctypes.c_size_t
    lib.sdr_sdrplay_read_blocking.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_long]
    lib.sdr_sdrplay_available.restype = ctypes.c_size_t
    lib.sdr_sdrplay_available.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_dropped.restype = ctypes.c_uint64
    lib.sdr_sdrplay_dropped.argtypes = [ctypes.c_void_p]
    lib.sdr_sdrplay_eof.restype = ctypes.c_int
    lib.sdr_sdrplay_eof.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeWavSource:
    """Streaming IQ source: C++ producer thread -> lock-free ring -> blocks.

    pace=True emulates a live 2.304 MS/s front-end (real-time emission, drops
    on overrun — the live-SDR failure mode); pace=False streams at full speed
    for offline runs.
    """

    def __init__(self, path: str, ring_frames: int = 1 << 22,
                 pace: bool = False, loop: bool = False):
        self._lib = load_library()
        self._h = self._lib.sdr_wav_source_open(
            str(path).encode(), ring_frames, int(pace), int(loop))
        if not self._h:
            raise IOError(f"cannot open wav source {path}")

    @property
    def rate(self) -> int:
        return int(self._lib.sdr_source_rate(self._h))

    def start(self):
        self._lib.sdr_source_start(self._h)

    def pause(self, on: bool) -> None:
        """stopReader/restartReader while running (handle_pauseButton,
        radio.cpp:1871-1893): a file source holds its position."""
        self._lib.sdr_source_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_source_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_source_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_source_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_source_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read of one block; returns complex64 [got]."""
        buf = np.empty(2 * n_frames, dtype=np.float32)
        got = self._lib.sdr_source_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_frames, timeout_ms)
        iq = buf[: 2 * got].reshape(-1, 2)
        return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)

    def close(self):
        if self._h:
            self._lib.sdr_source_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class RtlTcpSource:
    """Network SDR source: client for the standard rtl_tcp protocol.

    The live-device analogue of the reference's rtlsdr-handler (which drives
    a local dongle via librtlsdr; rtl_tcp exposes the same dongle over TCP
    with the same u8 sample stream and control surface).  The u8 IQ frames
    land in the native ring untouched; ReceiverConfig.iq_format='u8' does
    the (v-127)/128 conversion on-device (rtlsdr-handler.cpp:285-294).

    Control commands follow the rtl_tcp opcode set: set_frequency(0x01),
    set_sample_rate(0x02), gain mode(0x03), tuner gain(0x04), ppm
    correction(0x05), AGC(0x08).

    reconnect_timeout_ms > 0 enables session recovery: if the server drops
    mid-run, the native reader retries with backoff for up to that long,
    replays the device settings (rate/ppm/gain/AGC/frequency), counts the
    outage as dropped frames, and resumes — `reconnects` reports how often.
    """

    CMD_SET_FREQ = 0x01
    CMD_SET_SAMPLE_RATE = 0x02
    CMD_SET_GAIN_MODE = 0x03
    CMD_SET_GAIN = 0x04
    CMD_SET_FREQ_CORRECTION = 0x05
    CMD_SET_AGC_MODE = 0x08

    fmt = "u8"

    def __init__(self, host: str, port: int = 1234,
                 rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 reconnect_timeout_ms: int = 0):
        self._lib = load_library()
        self._h = self._lib.sdr_rtltcp_open2(host.encode(), int(port),
                                             ring_frames,
                                             int(reconnect_timeout_ms))
        if not self._h:
            raise IOError(f"cannot connect to rtl_tcp at {host}:{port}")
        self._rate = int(rate)
        self.tuner_type = int(self._lib.sdr_rtltcp_tuner_type(self._h))
        self.tuner_gain_count = int(self._lib.sdr_rtltcp_gain_count(self._h))
        self.set_sample_rate(rate)

    @property
    def rate(self) -> int:
        return self._rate

    def command(self, cmd: int, param: int) -> None:
        if self._lib.sdr_rtltcp_command(self._h, cmd,
                                        int(param) & 0xFFFFFFFF) != 0:
            raise IOError("rtl_tcp command send failed")

    def set_frequency(self, hz: int) -> None:
        self.command(self.CMD_SET_FREQ, hz)

    def set_sample_rate(self, rate: int) -> None:
        self._rate = int(rate)
        self.command(self.CMD_SET_SAMPLE_RATE, rate)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(self.CMD_SET_GAIN_MODE, 1 if manual else 0)

    def set_gain(self, tenths_db: int) -> None:
        self.command(self.CMD_SET_GAIN, tenths_db)

    def set_agc(self, on: bool) -> None:
        self.command(self.CMD_SET_AGC_MODE, 1 if on else 0)

    def set_freq_correction(self, ppm: int) -> None:
        self.command(self.CMD_SET_FREQ_CORRECTION, ppm)

    def flush(self) -> None:
        """Discard buffered frames (resetBuffer, device-handler.h:75) —
        e.g. right after a retune so the next block is post-retune signal."""
        self._lib.sdr_rtltcp_flush(self._h)

    @property
    def reconnects(self) -> int:
        return int(self._lib.sdr_rtltcp_reconnects(self._h))

    @property
    def connected(self) -> bool:
        return bool(self._lib.sdr_rtltcp_connected(self._h))

    def start(self):
        self._lib.sdr_rtltcp_start(self._h)

    def pause(self, on: bool) -> None:
        """stopReader semantics for a live stream: the socket stays
        drained and alive, the paused-over samples count as drops."""
        self._lib.sdr_rtltcp_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_rtltcp_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_rtltcp_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_rtltcp_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_rtltcp_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] uint8 (iq_format='u8' layout)."""
        buf = np.empty(n_frames * 2, dtype=np.uint8)
        got = self._lib.sdr_rtltcp_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_rtltcp_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class RtlSdrUsbSource:
    """In-process RTL-SDR dongle via dlopen(librtlsdr) — the reference's
    rtlsdr-handler (devices/rtlsdr-handler/rtlsdr-handler.cpp): the vendor
    library is loaded at runtime (:102-116, absence degrades to a clean
    "loading device failed"), acquisition is librtlsdr's async-callback
    thread feeding the native u8 SPSC ring, and the u8->float conversion
    (:285-294) runs on-device via ReceiverConfig.iq_format='u8'.

    `libname` overrides the library path (tests drive the full path with
    an in-tree fake librtlsdr; the SDRJFM_LIBRTLSDR env var does the same
    for the CLI).  Same control surface as RtlTcpSource, so the runtime
    control channel's gain/agc/ppm/retune commands apply unchanged.
    """

    fmt = "u8"

    def __init__(self, device_index: int = 0, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, libname: str = None):
        self._lib = load_library()
        if libname is None:
            libname = os.environ.get("SDRJFM_LIBRTLSDR")
        self._h = self._lib.sdr_rtlsdr_open(
            libname.encode() if libname else None, int(device_index),
            ring_frames, int(rate))
        if not self._h:
            err = self._lib.sdr_rtlsdr_last_error().decode()
            raise IOError(f"rtlsdr device {device_index}: {err}")
        self._rate = int(rate)

    @property
    def rate(self) -> int:
        return self._rate

    # -- control surface (the reference handler's setters + the runtime
    # control channel's gain/agc/ppm contract) --------------------------
    def _ck(self, rc: int, what: str) -> None:
        if rc != 0:
            raise IOError(f"rtlsdr {what} failed ({rc})")

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_freq(self._h, int(hz)),
                 "set_center_freq")

    def get_frequency(self) -> int:
        return int(self._lib.sdr_rtlsdr_get_freq(self._h))

    def set_gain_mode(self, manual: bool) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_gain_mode(
            self._h, 1 if manual else 0), "set_tuner_gain_mode")

    def set_gain(self, tenths_db: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_gain(self._h, int(tenths_db)),
                 "set_tuner_gain")

    def set_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_agc(self._h, 1 if on else 0),
                 "set_agc_mode")

    def set_freq_correction(self, ppm: int) -> None:
        self._ck(self._lib.sdr_rtlsdr_set_ppm(self._h, int(ppm)),
                 "set_freq_correction")

    def flush(self) -> None:
        """resetBuffer (device-handler.h:75): discard pre-retune frames."""
        self._lib.sdr_rtlsdr_flush(self._h)

    # -- streaming surface (Source protocol) -----------------------------
    def start(self):
        self._lib.sdr_rtlsdr_start(self._h)

    def pause(self, on: bool) -> None:
        """stopReader semantics: the dongle keeps streaming, the paused-
        over samples count as drops."""
        self._lib.sdr_rtlsdr_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_rtlsdr_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_rtlsdr_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_rtlsdr_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_rtlsdr_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] uint8 (iq_format='u8' layout)."""
        buf = np.empty(n_frames * 2, dtype=np.uint8)
        got = self._lib.sdr_rtlsdr_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_rtlsdr_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class AirspyUsbSource:
    """In-process Airspy via dlopen(libairspy) — the reference's
    airspy-handler semantics (devices/airspy/airspy-handler.cpp): INT16_IQ
    sample type (:102), `airspy_get_samplerates` negotiation picking the
    supported rate closest to 2 MS/s (:103-116), streaming at the device's
    NATIVE rate with the rate conversion to 2.304 MS/s done by the
    receiver's on-device linear-interpolation adapter
    (ReceiverConfig(native_rate=src.rate, iq_format='i16') ≡ the
    handler's mapTable, :118-127), and the linearity/sensitivity/raw gain
    surface (:330-408).

    `libname` overrides the library path (tests drive an in-tree fake
    libairspy; the SDRJFM_LIBAIRSPY env var does the same for the CLI).
    Library absence or no device raises IOError -> the CLI's
    "loading device failed" contract.

    Scale note: airspy delivers 12-bit samples (±2048 over the i16 wire);
    the chain's i16 conversion divides by 32768 like the reference's
    filereader, leaving a constant 24 dB level offset that the
    unit-circle-normalizing discriminator cancels (fm-demodulator.cpp:
    119-126) — only absolute meters read lower.
    """

    fmt = "i16"

    def __init__(self, ring_frames: int = 1 << 22, libname: str = None):
        self._lib = load_library()
        if libname is None:
            libname = os.environ.get("SDRJFM_LIBAIRSPY")
        self._h = self._lib.sdr_airspy_open(
            libname.encode() if libname else None, ring_frames)
        if not self._h:
            err = self._lib.sdr_airspy_last_error().decode()
            raise IOError(f"airspy device: {err}")
        self._rate = int(self._lib.sdr_airspy_rate(self._h))

    @property
    def rate(self) -> int:
        """The NEGOTIATED native rate (e.g. 2_500_000), not 2.304 MS/s."""
        return self._rate

    # -- control surface (airspy-handler.cpp:180-195, 330-408) -----------
    def _ck(self, rc: int, what: str) -> None:
        if rc != 0:
            raise IOError(f"airspy {what} failed ({rc})")

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_airspy_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_linearity(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_linearity(self._h, int(gain)),
                 "set_linearity_gain")

    def set_sensitivity(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_sensitivity(self._h, int(gain)),
                 "set_sensitivity_gain")

    def set_lna_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_lna(self._h, int(gain)),
                 "set_lna_gain")

    def set_vga_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_vga(self._h, int(gain)),
                 "set_vga_gain")

    def set_mixer_gain(self, gain: int) -> None:
        self._ck(self._lib.sdr_airspy_set_mixer(self._h, int(gain)),
                 "set_mixer_gain")

    def set_lna_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_airspy_set_lna_agc(self._h, 1 if on else 0),
                 "set_lna_agc")

    def set_mixer_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_airspy_set_mixer_agc(
            self._h, 1 if on else 0), "set_mixer_agc")

    def flush(self) -> None:
        self._lib.sdr_airspy_flush(self._h)

    # -- streaming surface (Source protocol) -----------------------------
    def start(self):
        if self._lib.sdr_airspy_start(self._h) != 0:
            raise IOError(self._lib.sdr_airspy_last_error().decode())

    def pause(self, on: bool) -> None:
        self._lib.sdr_airspy_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_airspy_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_airspy_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_airspy_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_airspy_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] int16 (iq_format='i16')."""
        buf = np.empty(n_frames * 2, dtype=np.int16)
        got = self._lib.sdr_airspy_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_airspy_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class SdrplayUsbSource:
    """In-process SDRplay RSP via dlopen(libsdrplay_api) — the fourth
    vendor backend, covering the reference's service-API pattern
    (devices/sdrplay-handler-v3/): device-params struct tree edited in
    place and committed with Update reason masks, Init/Uninit around
    streaming, PLANAR short delivery interleaved into the i16 ring.
    The device samples at the chain rate directly (fsHz = 2.304 MHz,
    above the RSP's 2 MHz ADC floor — Rsp-device.cpp:71).
    SDRJFM_LIBSDRPLAY overrides the library path (tests drive an in-tree
    fake service).

    Scale note: RSP ADCs are 12/14-bit (denominator 2048/4096,
    sdrplay-handler-v3.cpp:556-640) over the i16 wire; the constant
    level offset vs /32768 cancels in the discriminator."""

    fmt = "i16"

    def __init__(self, rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 libname: str = None):
        self._lib = load_library()
        if libname is None:
            libname = os.environ.get("SDRJFM_LIBSDRPLAY")
        self._h = self._lib.sdr_sdrplay_open(
            libname.encode() if libname else None, ring_frames, int(rate))
        if not self._h:
            err = self._lib.sdr_sdrplay_last_error().decode()
            raise IOError(f"sdrplay device: {err}")
        self._rate = int(rate)

    @property
    def rate(self) -> int:
        return self._rate

    @property
    def hw_ver(self) -> int:
        """RSP model id (SDRPLAY_RSP1A_ID=255, ... sdrplay_api.h:33-37)."""
        return ord(self._lib.sdr_sdrplay_hw_ver(self._h))

    def _ck(self, rc: int, what: str) -> None:
        if rc != 0:
            raise IOError(f"sdrplay {what} failed ({rc})")

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_sdrplay_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_grdb(self, grdb: int) -> None:
        """IF gain reduction dB 20..59 (Rsp-device.cpp:174-182)."""
        self._ck(self._lib.sdr_sdrplay_set_grdb(self._h, int(grdb)),
                 "set_grdb")

    def set_lna_state(self, state: int) -> None:
        self._ck(self._lib.sdr_sdrplay_set_lna_state(self._h, int(state)),
                 "set_lna_state")

    def set_agc(self, on: bool) -> None:
        self._ck(self._lib.sdr_sdrplay_set_agc(self._h, 1 if on else 0),
                 "set_agc")

    def set_freq_correction(self, ppm: float) -> None:
        self._ck(self._lib.sdr_sdrplay_set_ppm(self._h, float(ppm)),
                 "set_ppm")

    def flush(self) -> None:
        self._lib.sdr_sdrplay_flush(self._h)

    def start(self):
        if self._lib.sdr_sdrplay_start(self._h) != 0:
            raise IOError(self._lib.sdr_sdrplay_last_error().decode())

    def pause(self, on: bool) -> None:
        self._lib.sdr_sdrplay_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_sdrplay_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_sdrplay_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_sdrplay_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_sdrplay_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] int16 (iq_format='i16')."""
        buf = np.empty(n_frames * 2, dtype=np.int16)
        got = self._lib.sdr_sdrplay_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_sdrplay_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class HackRfUsbSource:
    """In-process HackRF via dlopen(libhackrf) — the third vendor-lib
    backend, completing the wire-format triangle (u8 rtlsdr / i16 airspy /
    i8 hackrf).  Reference semantics (devices/hackrf-handler/
    hackrf-handler.cpp): the device samples at EXACTLY 2.304 MS/s
    (set_sample_rate takes an arbitrary double, :112 — no rate adapter),
    the callback delivers SIGNED 8-bit IQ (:357-368, iq_format='i8'
    converts on-device), baseband filter bw via
    compute_baseband_filter_bw (:124-126), lna/vga gains + amp/antenna
    enables (:256-315).  SDRJFM_LIBHACKRF overrides the library path
    (tests drive an in-tree fake)."""

    fmt = "i8"

    def __init__(self, rate: int = 2_304_000, ring_frames: int = 1 << 22,
                 libname: str = None):
        self._lib = load_library()
        if libname is None:
            libname = os.environ.get("SDRJFM_LIBHACKRF")
        self._h = self._lib.sdr_hackrf_open(
            libname.encode() if libname else None, ring_frames, int(rate))
        if not self._h:
            err = self._lib.sdr_hackrf_last_error().decode()
            raise IOError(f"hackrf device: {err}")
        self._rate = int(rate)

    @property
    def rate(self) -> int:
        return self._rate

    def _ck(self, rc: int, what: str) -> None:
        if rc != 0:
            raise IOError(f"hackrf {what} failed ({rc})")

    def set_frequency(self, hz: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_freq(self._h, int(hz)),
                 "set_freq")

    def set_lna_gain(self, db: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_lna(self._h, int(db)),
                 "set_lna_gain")

    def set_vga_gain(self, db: int) -> None:
        self._ck(self._lib.sdr_hackrf_set_vga(self._h, int(db)),
                 "set_vga_gain")

    def set_amp(self, on: bool) -> None:
        self._ck(self._lib.sdr_hackrf_set_amp(self._h, 1 if on else 0),
                 "set_amp_enable")

    def set_antenna(self, on: bool) -> None:
        self._ck(self._lib.sdr_hackrf_set_antenna(self._h,
                                                  1 if on else 0),
                 "set_antenna_enable")

    def flush(self) -> None:
        self._lib.sdr_hackrf_flush(self._h)

    def start(self):
        if self._lib.sdr_hackrf_start(self._h) != 0:
            raise IOError(self._lib.sdr_hackrf_last_error().decode())

    def pause(self, on: bool) -> None:
        self._lib.sdr_hackrf_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_hackrf_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_hackrf_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_hackrf_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_hackrf_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] int8 (iq_format='i8')."""
        buf = np.empty(n_frames * 2, dtype=np.int8)
        got = self._lib.sdr_hackrf_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * 2].reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_hackrf_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class NativePipeSource:
    """Unseekable headerless IQ stream: stdin (path '-'), a FIFO, or any
    pipe — lets ANY external SDR tool feed the receiver live without a
    vendor library (`rtl_sdr -f 95M - | rx --iq - --iq-format u8`).  The
    frames land in the raw integer ring untouched (iq_format='u8'/'i16'
    converts on-device).  No pacing (the producer paces); drop_on_full=False
    applies backpressure through the OS pipe (offline-correct), True drops
    frames like a live source and counts them.
    """

    def __init__(self, path: str, fmt: str, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, drop_on_full: bool = False):
        self._lib = load_library()
        if fmt not in ("u8", "i8", "i16"):
            raise ValueError("pipe stream needs fmt='u8', 'i8' or 'i16'")
        self._h = self._lib.sdr_raw_pipe_open(
            str(path).encode(), ring_frames, 2 if fmt == "i16" else 1,
            rate, int(drop_on_full))
        if not self._h:
            raise IOError(f"cannot open pipe source {path}")
        self.fmt = fmt
        self._dtype = {"u8": np.uint8, "i8": np.int8,
                       "i16": np.int16}[fmt]

    # identical consumer surface to NativeRawSource (same C object)
    @property
    def rate(self) -> int:
        return int(self._lib.sdr_raw_rate(self._h))

    def start(self):
        self._lib.sdr_raw_start(self._h)

    def pause(self, on: bool) -> None:
        self._lib.sdr_raw_pause(self._h, 1 if on else 0)

    def stop(self):
        self._lib.sdr_raw_stop(self._h)

    def available(self) -> int:
        return int(self._lib.sdr_raw_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.sdr_raw_dropped(self._h))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdr_raw_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] u8/i16 (the iq_format layout)."""
        fb = int(self._lib.sdr_raw_frame_bytes(self._h))
        buf = np.empty(n_frames * fb, dtype=np.uint8)
        got = self._lib.sdr_raw_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * fb].view(self._dtype).reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_raw_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRawSource:
    """Raw-passthrough streaming source: the ring carries native-width
    integer IQ frames (i16 from PCM16 wavs, u8/i16 from headerless rtl_sdr/
    hackrf captures) — 2-4x less ring traffic than the float source, and the
    blocks feed ReceiverConfig.iq_format='i16'/'u8' directly, so the
    int->float conversion happens on-device.

    path ending in .wav (RIFF): must be PCM16 stereo.  Otherwise a raw file;
    pass fmt='u8' or 'i16' and the rate (raw files carry no header).
    """

    def __init__(self, path: str, fmt: str = None, rate: int = 2_304_000,
                 ring_frames: int = 1 << 22, pace: bool = False,
                 loop: bool = False):
        self._lib = load_library()
        with open(path, "rb") as f:
            riff = f.read(4) == b"RIFF"
        if riff:
            self._h = self._lib.sdr_raw_wav_open(
                str(path).encode(), ring_frames, int(pace), int(loop))
            self.fmt = "i16"
        else:
            if fmt not in ("u8", "i8", "i16"):
                raise ValueError("raw capture needs fmt='u8', 'i8' or "
                                 "'i16'")
            self._h = self._lib.sdr_raw_file_open(
                str(path).encode(), ring_frames, int(pace), int(loop),
                2 if fmt == "i16" else 1, rate)
            self.fmt = fmt
        if not self._h:
            raise IOError(f"cannot open raw source {path}")
        self._dtype = {"u8": np.uint8, "i8": np.int8,
                       "i16": np.int16}[self.fmt]

    @property
    def rate(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_rate(self._h))

    def start(self):
        self._require_open()
        self._lib.sdr_raw_start(self._h)

    def pause(self, on: bool) -> None:
        """Backpressure pipes stop pulling (the writer blocks);
        drop-on-full pipes keep draining and lose the frames."""
        self._require_open()
        self._lib.sdr_raw_pause(self._h, 1 if on else 0)

    def stop(self):
        self._require_open()
        self._lib.sdr_raw_stop(self._h)

    def _require_open(self):
        if not self._h:
            raise RuntimeError("source is closed")

    def available(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_available(self._h))

    @property
    def dropped(self) -> int:
        self._require_open()
        return int(self._lib.sdr_raw_dropped(self._h))

    @property
    def eof(self) -> bool:
        self._require_open()
        return bool(self._lib.sdr_raw_eof(self._h))

    def read_block(self, n_frames: int, timeout_ms: int = 10_000):
        """Blocking read; returns [got, 2] u8/i16 (the iq_format layout)."""
        fb = int(self._lib.sdr_raw_frame_bytes(self._h))
        buf = np.empty(n_frames * fb, dtype=np.uint8)
        got = self._lib.sdr_raw_read_blocking(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_frames, timeout_ms)
        return buf[: got * fb].view(self._dtype).reshape(-1, 2)

    def close(self):
        if self._h:
            self._lib.sdr_raw_close(self._h)
            self._h = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
