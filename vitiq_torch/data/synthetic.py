"""Synthetic modulated-signal corpus (counterpart of
`vitiq/data/synthetic.py`; numpy, the same arithmetic, so one seed gives the
JAX package's frames, labels and SNRs bit for bit).

`SyntheticAMCDataset` is a CPU-generated labeled dataset of RadioML-style
1024-sample sps=1 frames, optionally through the 2018.01A-style channel
model (`ChannelModel`, `channel_from_config`). `generate_test_signal` is the
DSP fixture: an RRC-shaped signal with known symbol timing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from vitiq_torch.dsp.taps import rrc_filter

def _norm_power(points: np.ndarray) -> np.ndarray:
    """Scale a constellation to unit average power."""
    return points / np.sqrt(np.mean(np.abs(points) ** 2))


def _qam(levels: np.ndarray) -> np.ndarray:
    grid = levels[:, None] + 1j * levels[None, :]
    return _norm_power(grid.reshape(-1))


def _cross_qam(levels: np.ndarray, corner: int) -> np.ndarray:
    """Cross QAM: square grid minus `corner` x `corner` blocks at each corner
    (the standard 32/128-QAM cross shapes)."""
    m = len(levels)
    keep = []
    for a in range(m):
        for b in range(m):
            in_corner = ((a < corner or a >= m - corner)
                         and (b < corner or b >= m - corner))
            if not in_corner:
                keep.append(levels[a] + 1j * levels[b])
    return _norm_power(np.asarray(keep))


def _apsk(counts: Sequence[int], radii: Sequence[float],
          offsets: Sequence[float] | None = None) -> np.ndarray:
    """Concentric-ring APSK constellation (DVB-S2-style ring structure)."""
    if offsets is None:
        offsets = [np.pi / c for c in counts]
    pts = []
    for count, radius, off in zip(counts, radii, offsets):
        pts.append(radius * np.exp(1j * (2 * np.pi * np.arange(count) / count + off)))
    return _norm_power(np.concatenate(pts))


# unit-average-power constellations — the 17 memoryless classes of the
# RadioML 2018.01A list (ref class names: ViT/training/train.py:60-80 and
# the 24-class fallback ViT/training/evaluate.py:69-74). APSK ring
# counts/radius ratios follow the DVB-S2(X) shapes; cross-QAM uses the
# standard corner-cut grids. Exact bit mappings don't matter for AMC — the
# point-set geometry is the class signature.
_CONSTELLATIONS: Dict[str, np.ndarray] = {
    "OOK": _norm_power(np.array([0.0 + 0j, 1.0 + 0j])),
    "4ASK": _norm_power(np.arange(-3, 4, 2).astype(complex)),
    "8ASK": _norm_power(np.arange(-7, 8, 2).astype(complex)),
    "BPSK": np.array([1.0 + 0j, -1.0 + 0j]),
    "QPSK": np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2.0),
    "8PSK": np.exp(2j * np.pi * np.arange(8) / 8),
    "16PSK": np.exp(2j * np.pi * np.arange(16) / 16),
    "32PSK": np.exp(2j * np.pi * np.arange(32) / 32),
    "16APSK": _apsk([4, 12], [1.0, 2.57]),
    "32APSK": _apsk([4, 12, 16], [1.0, 2.53, 4.30]),
    "64APSK": _apsk([4, 12, 20, 28], [1.0, 2.2, 3.6, 5.2]),
    "128APSK": _apsk([8, 16, 24, 32, 48], [1.0, 1.9, 2.8, 3.8, 5.0]),
    "16QAM": _qam(np.arange(-3, 4, 2)),
    "32QAM": _cross_qam(np.arange(-5, 6, 2).astype(float), corner=1),
    "64QAM": _qam(np.arange(-7, 8, 2)),
    "128QAM": _cross_qam(np.arange(-11, 12, 2).astype(float), corner=2),
    "256QAM": _qam(np.arange(-15, 16, 2)),
}

# classes with memory / non-constellation structure, generated by dedicated
# waveform synthesizers below. CPFSK/GFSK extend coverage to the RadioML
# 2016.10a class list (BASELINE.json config 2) beyond the 2018.01A set.
_WAVEFORM_CLASSES: Tuple[str, ...] = (
    "GMSK", "OQPSK", "CPFSK", "GFSK",
    "AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC", "FM",
)

SYNTHETIC_MODULATIONS: Tuple[str, ...] = tuple(_CONSTELLATIONS) + _WAVEFORM_CLASSES


def _symbols(modulation: str, num_symbols: int, rng: np.random.Generator) -> np.ndarray:
    try:
        constellation = _CONSTELLATIONS[modulation]
    except KeyError:
        raise ValueError(f"Unknown modulation: {modulation}") from None
    return constellation[rng.integers(0, len(constellation), num_symbols)]


def _upfirdn_same(kern: np.ndarray, syms: np.ndarray, up: int,
                  n_out: int) -> np.ndarray:
    """Polyphase equivalent of
    ``fftconvolve(zero_stuffed(syms, up), kern[None], mode='same', axes=1)``
    where the zero-stuffed signal has length ``n_out`` with symbols at
    ``::up``. Computes only the non-zero MACs (scipy.signal.upfirdn), which
    is ~``up``x cheaper than the FFT for the corpus generator's hot path
    (single-core host; round-5 corpus regeneration). Exact same-alignment:
    full conv of the stuffed signal is the upfirdn output zero-padded to
    ``n_out + len(kern) - 1``; the 'same' window starts at
    ``(len(kern)-1)//2``."""
    from scipy.signal import upfirdn

    out = upfirdn(kern, syms, up=up, axis=-1)
    k0 = (len(kern) - 1) // 2
    need = k0 + n_out
    if out.shape[-1] < need:
        out = np.pad(out, [(0, 0)] * (out.ndim - 1)
                     + [(0, need - out.shape[-1])])
    return out[..., k0:need]


# --------------------------------------------------------------------------
# waveform synthesizers for the memory-bearing / analog classes
# --------------------------------------------------------------------------

def _unit_power_frames(sig: np.ndarray) -> np.ndarray:
    """Normalize each frame (last axis) to unit average power."""
    p = np.mean(np.abs(sig) ** 2, axis=-1, keepdims=True)
    return sig / np.sqrt(np.maximum(p, 1e-12))


def _lowpass_noise(rng: np.random.Generator, shape, cutoff: float = 0.08) -> np.ndarray:
    """Unit-power random analog message: white Gaussian noise brick-wall
    filtered to `cutoff` of Nyquist (the 'voice-like' message driving the
    analog modulations)."""
    w = rng.standard_normal(shape)
    W = np.fft.rfft(w, axis=-1)
    keep = max(2, int(cutoff * W.shape[-1]))
    W[..., keep:] = 0.0
    m = np.fft.irfft(W, n=shape[-1], axis=-1)
    return m / np.maximum(np.std(m, axis=-1, keepdims=True), 1e-12)


def _analytic(m: np.ndarray) -> np.ndarray:
    """Analytic signal (Hilbert one-sided spectrum) along the last axis."""
    n = m.shape[-1]
    M = np.fft.fft(m, axis=-1)
    h = np.zeros(n)
    h[0] = 1.0
    h[1:(n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    return np.fft.ifft(M * h, axis=-1)


def _cpm_frames(F: int, L: int, rng: np.random.Generator,
                pulse: str = "gauss", bt: float = 0.3, h: float = 0.5,
                sps_i: int = 4, out_sps: int = 1) -> np.ndarray:
    """Continuous-phase modulation at `out_sps` output samples/bit: NRZ bits
    -> frequency pulse -> continuous phase (h*pi per bit) -> decimate.
    Constant envelope + phase continuity are the family signature; the
    frequency pulse separates the classes — Gaussian (GMSK BT=0.3, GFSK
    BT=0.35, the GNU Radio defaults RadioML used) vs full-response
    rectangular (CPFSK). Internally runs at sps_i*out_sps samples/bit and
    decimates by sps_i, so out_sps=1 reproduces the historical waveform
    exactly while the channel path gets oversampled output."""
    rate = sps_i * out_sps
    nbits = L // out_sps + 8
    bits = (rng.integers(0, 2, (F, nbits)) * 2 - 1).astype(np.float32)
    if pulse == "gauss":
        # Gaussian pulse: -3 dB bandwidth B with B*T = bt
        sigma = rate * np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
        t = np.arange(-3 * rate, 3 * rate + 1, dtype=np.float64)
        kern = np.exp(-0.5 * (t / sigma) ** 2)
    else:  # rectangular full-response (CPFSK)
        kern = np.ones(rate)
    kern = (kern / kern.sum()).astype(np.float32)
    freq = _upfirdn_same(kern, bits, rate, nbits * rate)
    # phase accumulates to ~1e3 rad over a frame: cumsum in f64 (f32
    # sequential accumulation drifts), then decimate BEFORE the complex
    # exp (exp and stride-slice commute elementwise) — sps_i x fewer exps.
    phase = (h * np.pi) * np.cumsum(freq, axis=-1, dtype=np.float64)
    phase = phase[:, ::sps_i][:, -L:]
    out = np.exp(1j * phase)
    # channel path (out_sps>1) runs single-precision end-to-end; the
    # historical 1-sample/bit output keeps c128 (unit-envelope to 1e-16)
    return out.astype(np.complex64) if out_sps > 1 else out


def _gmsk_frames(F: int, L: int, rng: np.random.Generator,
                 bt: float = 0.3, sps_i: int = 4, out_sps: int = 1) -> np.ndarray:
    """GMSK (h=0.5, Gaussian BT=0.3): the 2018.01A class."""
    return _cpm_frames(F, L, rng, pulse="gauss", bt=bt, h=0.5, sps_i=sps_i,
                       out_sps=out_sps)


def _oqpsk_frames(F: int, L: int, rng: np.random.Generator,
                  sps_i: int = 4, out_sps: int = 1) -> np.ndarray:
    """OQPSK sampled at the I-symbol instants: RRC-shaped quadrature streams
    with Q delayed half a symbol, so I samples sit on constellation points
    while Q samples sit mid-transition — the offset signature that
    distinguishes the class from plain QPSK at 1 sample/symbol. out_sps>1
    keeps that many samples per symbol for the channel path (internal rate
    sps_i*out_sps, decimate by sps_i — out_sps=1 is the historical output)."""
    rate = sps_i * out_sps
    nsym = L // out_sps + 8
    syms = _CONSTELLATIONS["QPSK"][rng.integers(0, 4, (F, nsym))]
    rrc = rrc_filter(alpha=0.35, span=8, sps=rate).astype(np.float32)
    i_sh = _upfirdn_same(rrc, syms.real.astype(np.float32), rate, nsym * rate)
    q_sh = _upfirdn_same(rrc, syms.imag.astype(np.float32), rate, nsym * rate)
    q_sh = np.roll(q_sh, rate // 2, axis=-1)
    sig = (i_sh + 1j * q_sh).astype(np.complex64)[:, ::sps_i][:, -L:]
    return _unit_power_frames(sig)


def _analog_frames(mod: str, F: int, L: int, rng: np.random.Generator,
                   out_sps: int = 1) -> np.ndarray:
    """AM (DSB/SSB, with/without carrier) and FM over a lowpass random
    message, complex baseband, unit power (24-class list,
    ref: ViT/training/evaluate.py:69-74). out_sps>1 narrows the message
    bandwidth by the oversampling factor so the channel path's decimated
    output has the same occupied bandwidth as the out_sps=1 waveform."""
    m = _lowpass_noise(rng, (F, L), cutoff=0.08 / out_sps)
    if mod == "AM-DSB-SC":
        sig = m.astype(complex)
    elif mod == "AM-DSB-WC":
        sig = (1.0 + 0.5 * m).astype(complex)
    elif mod == "AM-SSB-SC":
        sig = _analytic(m)
    elif mod == "AM-SSB-WC":
        sig = 1.0 + 0.5 * _analytic(m)
    elif mod == "FM":
        sig = np.exp(2j * np.pi * (0.1 / out_sps) * np.cumsum(m, axis=-1))
    else:
        raise ValueError(f"Unknown analog modulation: {mod}")
    return _unit_power_frames(sig)


def _shaped_constellation_frames(mod: str, F: int, L: int,
                                 rng: np.random.Generator, sps: int,
                                 alpha: float = 0.35) -> np.ndarray:
    """RRC pulse-shaped oversampled frames: L samples at `sps`
    samples/symbol (L/sps symbols per frame) — the realistic waveform for
    the SPS-mode front-end (BASELINE config 3)."""
    nsym = L // sps
    syms = _symbols(mod, F * nsym, rng).reshape(F, nsym).astype(np.complex64)
    rrc = rrc_filter(alpha=alpha, span=8, sps=sps).astype(np.float32)
    return _unit_power_frames(_upfirdn_same(rrc, syms, sps, L))


# --------------------------------------------------------------------------
# 2018.01A-style channel impairments (VERDICT r3 item 1)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ChannelModel:
    """Per-frame transmit + channel impairments matching RadioML 2018.01A's
    generation recipe (the dataset's GNU Radio dynamic channel: pulse
    shaping, carrier frequency/phase offset, sample-clock offset, Rician
    selective fading, then AWGN — O'Shea et al. 2018 §III).

    The round-3 proxy corpora were iid symbols at sps=1 with AWGN + random
    phase only, which removes the temporal structure the rawIQ arm's
    sequence tokenization exploits — both round-3 head-to-heads inverted
    the reference's cross-arm ordering (docs/proxy19, docs/proxy24). This
    layer restores that structure: frames are synthesized at `sps`
    samples/symbol with RRC shaping, pass a per-frame channel, and are
    captured back at ~1 sample/symbol (the reference's domain rule,
    ref: test_sps_modes.py:103-127) with a random fractional symbol-timing
    phase and NO matched filter — so residual ISI from the RRC tails, CFO
    rotation, clock-offset timing drift and spectral tilt from multipath
    all survive into the stored frame.

    Every ingredient is independently toggleable (zero/False disables) so
    the head-to-head ablation can attribute the cross-arm ordering to a
    specific ingredient.
    """

    # transmit oversampling (samples/symbol) and RRC roll-off (the
    # reference's alpha, ref: test_dsp_functions.py:70-72)
    sps: int = 8
    rolloff: float = 0.35
    # |carrier frequency offset| max, cycles per OUTPUT sample, drawn
    # U(-max, max) per frame. 2018.01A's 500 Hz max at its ~200 kHz channel
    # rate is 2.5e-3 cycles/sample.
    cfo_max: float = 2.5e-3
    # |sample-clock offset| max in ppm, drawn U(-max, max) per frame; the
    # receiver's decimation stride becomes sps*(1+eps). 500 ppm drifts the
    # sampling instant ~0.5 symbol across a 1024-symbol frame.
    clock_ppm_max: float = 500.0
    # random fractional symbol-timing phase t0 ~ U[0, sps) at capture
    timing_jitter: bool = True
    # Rician selective fading: per-frame static taps (frames are ~5 ms at
    # 200 kHz; 1 Hz max Doppler makes intra-frame variation negligible).
    # Delays are in OVERSAMPLED samples (sub-symbol spread -> frequency-
    # selective across the signal band); the first tap carries the LOS
    # component with Rician K.
    fading: bool = True
    rician_k: float = 4.0
    tap_delays: Tuple[float, ...] = (0.0, 2.1, 4.3)
    tap_powers: Tuple[float, ...] = (1.0, 0.5, 0.25)

    # frames generated with this many guard symbols on each side so edge
    # transients and clock-drift overrun never enter the captured window
    guard_syms: int = 8


def apply_channel(sig_os: np.ndarray, rng: np.random.Generator,
                  ch: ChannelModel, L_out: int) -> np.ndarray:
    """[F, N_os] oversampled complex baseband -> [F, L_out] impaired frames
    captured at ~1 sample/symbol (vectorized over frames)."""
    F, N = sig_os.shape
    os_ = ch.sps
    sig_os = sig_os.astype(np.complex64, copy=False)
    if ch.fading:
        delays = np.asarray(ch.tap_delays, np.float64)
        powers = np.asarray(ch.tap_powers, np.float64)
        powers = powers / powers.sum()
        # scatter components: complex normal with per-tap power
        a = ((rng.standard_normal((F, len(delays)))
              + 1j * rng.standard_normal((F, len(delays))))
             * np.sqrt(powers / 2.0))
        # Rician LOS on the first (earliest) tap
        k = ch.rician_k
        los = np.exp(1j * rng.uniform(0, 2 * np.pi, F))
        a[:, 0] = np.sqrt(powers[0]) * (
            np.sqrt(k / (k + 1.0)) * los
            + np.sqrt(1.0 / (k + 1.0)) * a[:, 0] / np.sqrt(powers[0]))
        # windowed-sinc fractional-delay synthesis of the tap set
        klen = int(np.ceil(delays.max())) + 9
        n = np.arange(klen, dtype=np.float64)
        basis = np.sinc(n[None, :] - delays[:, None])          # [P, klen]
        h = (a @ basis).astype(np.complex64)                   # [F, klen]
        # direct per-frame FIR (klen~14 taps): same first-N-samples result
        # as the old [F, nfft=16K] c128 FFT conv, ~4x cheaper on the
        # single-core host (the corpus generator's bottleneck, round 5)
        faded = np.zeros((F, N), np.complex64)
        for k in range(klen):
            faded[:, k:] += h[:, k:k + 1] * sig_os[:, :N - k]
        sig_os = faded
    # clock-offset decimation with random symbol-timing phase (linear
    # interpolation; the sps-fold oversampling makes the interp error
    # negligible relative to the channel noise floor)
    eps = (rng.uniform(-ch.clock_ppm_max, ch.clock_ppm_max, (F, 1)) * 1e-6
           if ch.clock_ppm_max else np.zeros((F, 1)))
    t0 = (rng.uniform(0.0, os_, (F, 1)) if ch.timing_jitter
          else np.zeros((F, 1)))
    m = np.arange(L_out, dtype=np.float64)[None, :]
    t = ch.guard_syms * os_ + t0 + (os_ * (1.0 + eps)) * m
    i0 = np.floor(t).astype(np.int64)
    frac = (t - i0).astype(sig_os.real.dtype)
    i0 = np.clip(i0, 0, N - 2)
    g0 = np.take_along_axis(sig_os, i0, axis=1)
    g1 = np.take_along_axis(sig_os, i0 + 1, axis=1)
    out = g0 * (1.0 - frac) + g1 * frac
    # carrier frequency offset (phase offset comes from the caller's
    # existing per-frame random phase rotation)
    if ch.cfo_max:
        f0 = rng.uniform(-ch.cfo_max, ch.cfo_max, (F, 1))
        out = out * np.exp(2j * np.pi * f0 * m).astype(out.dtype)
    return _unit_power_frames(out)


def channel_from_config(data_cfg) -> "ChannelModel | None":
    """Build the corpus ChannelModel from a DataConfig-like object
    (duck-typed on .synthetic_channel / .synthetic_channel_params so this
    module stays import-independent of the config module). JSON round-tripped
    overrides arrive with lists where ChannelModel holds tuples — coerced
    here."""
    if not getattr(data_cfg, "synthetic_channel", False):
        return None
    params = dict(getattr(data_cfg, "synthetic_channel_params", None) or {})
    for k, v in params.items():
        if isinstance(v, list):
            params[k] = tuple(v)
    return ChannelModel(**params)


def _oversampled_frames(mod: str, F: int, n_out: int,
                        rng: np.random.Generator,
                        ch: ChannelModel) -> np.ndarray:
    """[F, n_out] frames at ch.sps samples/symbol for the channel path."""
    if mod == "GMSK":
        return _gmsk_frames(F, n_out, rng, out_sps=ch.sps)
    if mod == "GFSK":
        return _cpm_frames(F, n_out, rng, pulse="gauss", bt=0.35,
                           out_sps=ch.sps)
    if mod == "CPFSK":
        return _cpm_frames(F, n_out, rng, pulse="rect", out_sps=ch.sps)
    if mod == "OQPSK":
        return _oqpsk_frames(F, n_out, rng, out_sps=ch.sps)
    if mod in ("AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC", "FM"):
        return _analog_frames(mod, F, n_out, rng, out_sps=ch.sps)
    return _shaped_constellation_frames(mod, F, n_out, rng, ch.sps,
                                        alpha=ch.rolloff)


def generate_frames(mod: str, F: int, L: int, rng: np.random.Generator,
                    shaping_sps: int = 1,
                    channel: "ChannelModel | None" = None) -> np.ndarray:
    """Complex [F, L] unit-power frames for any of SYNTHETIC_MODULATIONS.

    Constellation classes: iid symbol draws at 1 sample/symbol
    (shaping_sps=1, the RadioML rule), or RRC-shaped at `shaping_sps`
    samples/symbol. CPM (GMSK/GFSK/CPFSK), OQPSK and analog classes use
    their dedicated synthesizers (their structure IS the class signature).

    With `channel`, every class is synthesized oversampled at channel.sps
    samples/symbol, passed through the 2018.01A-style impairment chain
    (RRC shaping + CFO + clock offset + Rician selective fading), and
    captured back at 1 sample/symbol — see ChannelModel."""
    if channel is not None:
        n_out = (L + 2 * channel.guard_syms) * channel.sps
        sig = _oversampled_frames(mod, F, n_out, rng, channel)
        return apply_channel(sig, rng, channel, L)
    if mod == "GMSK":
        return _gmsk_frames(F, L, rng)
    if mod == "GFSK":
        return _cpm_frames(F, L, rng, pulse="gauss", bt=0.35)
    if mod == "CPFSK":
        return _cpm_frames(F, L, rng, pulse="rect")
    if mod == "OQPSK":
        return _oqpsk_frames(F, L, rng)
    if mod in ("AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC", "FM"):
        return _analog_frames(mod, F, L, rng)
    if shaping_sps > 1:
        return _shaped_constellation_frames(mod, F, L, rng, shaping_sps)
    return _symbols(mod, F * L, rng).reshape(F, L)


def generate_test_signal(
    modulation: str = "QPSK",
    num_symbols: int = 100,
    sps: int = 2,
    snr_db: float = 20.0,
    seed: int | None = None,
):
    """RRC-shaped test signal with known symbol timing.

    Mirrors the reference fixture: symbols upsampled by zero-insertion at
    indices i*sps, shaped with rrc_filter(alpha=0.35, span=8, sps) via 'same'
    convolution (so true symbol peaks stay at i*sps), then AWGN at the
    requested measured-signal SNR.

    Returns (i_signal, q_signal, true_symbol_indices).
    """
    rng = np.random.default_rng(seed)
    syms = _symbols(modulation, num_symbols, rng)

    n = num_symbols * sps
    i_up = np.zeros(n)
    q_up = np.zeros(n)
    true_indices = np.arange(num_symbols) * sps
    i_up[true_indices] = syms.real
    q_up[true_indices] = syms.imag

    if sps > 1:
        rrc = rrc_filter(alpha=0.35, span=8, sps=sps)
        i_shaped = np.convolve(i_up, rrc, mode="same")
        q_shaped = np.convolve(q_up, rrc, mode="same")
    else:
        i_shaped, q_shaped = i_up, q_up

    signal_power = np.mean(i_shaped**2 + q_shaped**2)
    noise_power = signal_power / (10.0 ** (snr_db / 10.0))
    i_signal = i_shaped + np.sqrt(noise_power / 2) * rng.standard_normal(n)
    q_signal = q_shaped + np.sqrt(noise_power / 2) * rng.standard_normal(n)
    return i_signal, q_signal, true_indices


@dataclass
class SyntheticAMCDataset:
    """Deterministic in-memory AMC dataset of sps=1 frames.

    X: [N, frame_len, 2] float32 (I/Q last, matching the HDF5 layout
    X:(N,1024,2), ref README.md:226-232), Y: int labels, Z: SNR dB.

    Frames get a random phase rotation and unit-power scaling so the task is
    non-trivial; at sps=1 each sample is a symbol (the RadioML rule,
    ref test_sps_modes.py:103-127).
    """

    classes: Sequence[str] = ("BPSK", "QPSK", "16QAM")
    frames_per_class: int = 512
    frame_len: int = 1024
    snrs_db: Sequence[float] = (-8.0, 0.0, 8.0, 20.0)
    seed: int = 0
    # 1 = every sample is a symbol (RadioML sps=1 rule); >=2 = RRC-shaped
    # oversampled constellation frames (frame_len/shaping_sps symbols) for
    # SPS-mode experiments. Waveform classes (GMSK/OQPSK/analog) synthesize
    # their own structure regardless.
    shaping_sps: int = 1
    # 2018.01A-style impairments (pulse shaping + CFO + clock offset +
    # selective fading, captured at 1 sample/symbol) — see ChannelModel.
    # Overrides shaping_sps when set.
    channel: "ChannelModel | None" = None

    def __post_init__(self):
        for c in self.classes:
            if c not in SYNTHETIC_MODULATIONS:
                raise ValueError(
                    f"unsupported synthetic class {c!r}; available: {SYNTHETIC_MODULATIONS}"
                )
        if self.shaping_sps > 1 and self.frame_len % self.shaping_sps:
            raise ValueError(
                f"frame_len ({self.frame_len}) must be a multiple of "
                f"shaping_sps ({self.shaping_sps})")
        rng = np.random.default_rng(self.seed)
        n = len(self.classes) * self.frames_per_class
        F, L = self.frames_per_class, self.frame_len
        X = np.empty((n, L, 2), dtype=np.float32)
        Y = np.empty(n, dtype=np.int32)
        Z = np.empty(n, dtype=np.float32)
        for label, mod in enumerate(self.classes):
            sig = generate_frames(mod, F, L, rng, shaping_sps=self.shaping_sps,
                                  channel=self.channel)
            sig = sig * np.exp(1j * rng.uniform(0, 2 * np.pi, (F, 1)))  # random phase
            snr = rng.choice(np.asarray(self.snrs_db, np.float32), F)
            noise_scale = np.sqrt(10.0 ** (-snr / 10.0) / 2.0)[:, None]
            sig = sig + noise_scale * (
                rng.standard_normal((F, L)) + 1j * rng.standard_normal((F, L))
            )
            rows = slice(label * F, (label + 1) * F)
            X[rows, :, 0] = sig.real
            X[rows, :, 1] = sig.imag
            Y[rows] = label
            Z[rows] = snr
        perm = rng.permutation(n)
        self.X, self.Y, self.Z = X[perm], Y[perm], Z[perm]

    def __len__(self) -> int:
        return self.X.shape[0]
