"""ctypes binding for the reference receiver's own DSP core.

tools/reference_oracle/ compiles the Qt-free DSP sources of
/root/reference (fm-demodulator, pilot-recover, stereo-separation, the
filter/PLL/NCO primitives, and the full RDS stack) unmodified into
libsdrjfm_ref_oracle.so behind a C ABI (see oracle.cc for the stage-order
citations).  This binding drives it from Python so tests can A/B the JAX
chain against the reference's actual code — not against re-derived
oracles.

The oracle emits per-fm-rate-sample taps:
  demod        discriminator output      (fm-processor.cpp:497)
  pilot_phase  pilot PLL phase           (fm-processor.cpp:695-696)
  pss          accumulated PSS delay     (fm-processor.cpp:716-718)
  audio L/R    deemphasized stereo at fmRate (pre-resampler; the
               reference's 192k->48k step is libsamplerate, third-party)
  locked       pilot lock flag per sample
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ORACLE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "reference_oracle")
_SO_PATH = os.path.join(_ORACLE_DIR, "libsdrjfm_ref_oracle.so")

_lib = None


def build_oracle():
    """Compile the reference sources into the oracle .so (idempotent)."""
    r = subprocess.run(["make", "-C", _ORACLE_DIR], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"oracle build failed:\n{r.stdout}\n{r.stderr}")
    return _SO_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        build_oracle()
    lib = ctypes.CDLL(_SO_PATH)
    c_fp = ctypes.POINTER(ctypes.c_float)
    lib.oracle_create.restype = ctypes.c_void_p
    lib.oracle_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int, ctypes.c_int]
    lib.oracle_process.restype = ctypes.c_int
    lib.oracle_process.argtypes = [
        ctypes.c_void_p, c_fp, ctypes.c_int, c_fp, c_fp, c_fp, c_fp, c_fp,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.oracle_bit_count.restype = ctypes.c_long
    lib.oracle_bit_count.argtypes = [ctypes.c_void_p]
    for name in ("oracle_pilot_locked", "oracle_pss_established"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.oracle_pilot_strength.restype = ctypes.c_float
    lib.oracle_pilot_strength.argtypes = [ctypes.c_void_p]
    lib.oracle_dc_component.restype = ctypes.c_float
    lib.oracle_dc_component.argtypes = [ctypes.c_void_p]
    lib.oracle_af.restype = ctypes.c_int
    lib.oracle_af.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.oracle_rds_status.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.oracle_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class ReferenceOracle:
    """The reference receiver's chain, default-configured like the GUI:
    Mixed discriminator (fm-demodulator.cpp:66 selectedDecoder=3), stereo
    with auto-mono, PSS on, DC removal on, 50 us deemphasis."""

    def __init__(self, rds_mode=1, decoder=3, input_filter=False,
                 audio_filter_hz=0, lo_freq=0, deemphasis_us=50.0,
                 squelch_mode=0, squelch_value=0,
                 input_rate=2_304_000, fm_rate=192_000):
        self._lib = _load()
        self.fm_rate = fm_rate
        self.input_rate = input_rate
        self._h = self._lib.oracle_create(
            input_rate, fm_rate, rds_mode, decoder,
            1 if input_filter else 0, audio_filter_hz, lo_freq,
            deemphasis_us, squelch_mode, squelch_value)
        if not self._h:
            raise RuntimeError("oracle_create failed")

    def process(self, iq: np.ndarray) -> dict:
        """Run complex64 IQ at input_rate; returns fm-rate tap arrays."""
        iq = np.asarray(iq)
        n = len(iq)
        inter = np.empty((n, 2), np.float32)
        inter[:, 0] = iq.real
        inter[:, 1] = iq.imag
        cap = n // 12 + 16
        demod = np.empty(cap, np.float32)
        pilot = np.empty(cap, np.float32)
        pss = np.empty(cap, np.float32)
        al = np.empty(cap, np.float32)
        ar = np.empty(cap, np.float32)
        locked = np.empty(cap, np.uint8)

        def fp(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        m = self._lib.oracle_process(
            self._h, fp(inter), n, fp(demod), fp(pilot), fp(pss), fp(al),
            fp(ar), locked.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return {
            "demod": demod[:m], "pilot_phase": pilot[:m], "pss": pss[:m],
            "audio": np.stack([al[:m], ar[:m]], axis=-1),
            "locked": locked[:m].astype(bool),
        }

    def rds_status(self) -> dict:
        station = ctypes.create_string_buffer(64)
        text = ctypes.create_string_buffer(256)
        pi = ctypes.c_int()
        pty = ctypes.c_int()
        groups = ctypes.c_int()
        ber = ctypes.c_double()
        synced = ctypes.c_int()
        sync_err = ctypes.c_int()
        crc_err = ctypes.c_int()
        self._lib.oracle_rds_status(
            self._h, station, 64, text, 256, ctypes.byref(pi),
            ctypes.byref(pty), ctypes.byref(groups), ctypes.byref(ber),
            ctypes.byref(synced), ctypes.byref(sync_err),
            ctypes.byref(crc_err))
        return {
            "station": station.value.decode("utf-8", "replace"),
            "radio_text": text.value.decode("utf-8", "replace"),
            "pi": pi.value, "pty": pty.value, "groups": groups.value,
            "ber": ber.value, "synchronized": bool(synced.value),
            "sync_errors": sync_err.value, "crc_errors": crc_err.value,
            "bits": self._lib.oracle_bit_count(self._h),
            "pilot_locked": bool(self._lib.oracle_pilot_locked(self._h)),
            "pilot_strength": self._lib.oracle_pilot_strength(self._h),
            "pss_established": bool(
                self._lib.oracle_pss_established(self._h)),
            "dc_component": float(
                self._lib.oracle_dc_component(self._h)),
            "af_khz": self._af(),
        }

    def _af(self):
        buf = (ctypes.c_int * 32)()
        n = self._lib.oracle_af(self._h, buf, 32)
        return [int(buf[i]) for i in range(n)]

    def close(self):
        if self._h:
            self._lib.oracle_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
