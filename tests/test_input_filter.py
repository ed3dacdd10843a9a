"""Strong FFT input channel filter (BASELINE config 4).

The reference's 65536-point overlap-add lowpass (inputFilter,
fm-processor.cpp:77,147-149, off by default because it 'requires some serious
cpu use'; README.md:46-52 describes its purpose: separating overlapping
transmissions).  Here it's an overlap-save batched FFT conv.

Scenario: wanted station at 0 Hz, strong interferer at +150 kHz (inside the
capture, overlapping the decimation transition band).  The cascade alone leaves
interferer products; the sharp 251-tap channel filter must improve SNR.
"""

import numpy as np

from sdrjfm_tpu import constants as C
from sdrjfm_tpu.io import synth
from sdrjfm_tpu.models.receiver import Receiver, ReceiverConfig
from sdrjfm_tpu.runtime.stream import run_offline


def _two_station_iq(seconds=1.0):
    n = int(seconds * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    want = synth.fm_modulate(
        synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                        0.6 * np.sin(2 * np.pi * 1000 * t),
                        synth.MPXParams()), C.FM_RATE)
    interferer = synth.fm_modulate(
        synth.synth_mpx(0.7 * np.sin(2 * np.pi * 3000 * t),
                        0.7 * np.sin(2 * np.pi * 3000 * t),
                        synth.MPXParams()), C.FM_RATE,
        carrier_offset_hz=150_000.0, amplitude=3.0, seed=1)
    return (want + interferer).astype(np.complex64)


def _snr(res):
    x = res.audio[:, 0]
    w = np.hanning(len(x))
    X = np.abs(np.fft.rfft(x * w)) ** 2
    b = int(round(1000 * len(x) / C.WORKING_RATE))
    sig = X[b - 3:b + 4].sum()
    return 10 * np.log10(sig / max(X[8:].sum() - sig, 1e-30))


def test_input_filter_rejects_adjacent_station():
    iq = _two_station_iq()
    res_off = run_offline(Receiver(ReceiverConfig(
        block_fm=32768, mode="mono", rds="off", audio_filter_hz=15000)),
        iq, drop_blocks=2)
    res_on = run_offline(Receiver(ReceiverConfig(
        block_fm=32768, mode="mono", rds="off", audio_filter_hz=15000,
        input_filter=True)), iq, drop_blocks=2)
    s_off, s_on = _snr(res_off), _snr(res_on)
    assert s_on > s_off + 3.0, (s_on, s_off)
    assert s_on > 25.0, s_on


def test_input_filter_transparent_for_clean_signal():
    n = int(1.0 * C.FM_RATE)
    t = np.arange(n) / C.FM_RATE
    iq = synth.fm_modulate(
        synth.synth_mpx(0.6 * np.sin(2 * np.pi * 1000 * t),
                        0.6 * np.sin(2 * np.pi * 1000 * t),
                        synth.MPXParams()), C.FM_RATE)
    res = run_offline(Receiver(ReceiverConfig(
        block_fm=32768, mode="mono", rds="off", audio_filter_hz=15000,
        input_filter=True)), iq, drop_blocks=2)
    assert _snr(res) > 40.0
