"""The port's DSP front-end (`vitiq_torch/dsp/`) against `vitiq/dsp/` on the
same numpy inputs, made from seeds.

Tolerances, each with its reason:

* FIR (the RRC matched filter): atol 1e-6. Both are float32 sums of 17 or 33
  products of values below about 2, taken in another order: a few float32
  ulps at unit magnitude. Against a float64 `np.convolve` within 1e-5 of the
  signal's peak (TF32 would show about 1e-3).
* Phase pickers: the same phase a frame, so the same float32 symbols (atol
  1e-6, the FIR's).
* The error-feedback loops (Gardner, Mueller-Mueller): positions within
  POS_ATOL = 1e-3 samples. Each step feeds its rounding into the next, and
  XLA may contract a product and a sum into one FMA where the port rounds
  twice; a position carries an ulp of a few hundred (3e-5 at 256). The
  rounded indices are equal except where vitiq's position lies within
  POS_ATOL of a half-integer, where a rounding may fall to either side:
  the strobes rounded the other way are counted and must be under 1%.
* The hybrid loop: positions within POS_ATOL (the circular mean's sin, cos
  and atan2 are each library's own, within a few float32 ulps).
* The STFT images: atol 1e-4 (log10 of |FFT| of two FFT libraries, then
  standardized: a few float32 ulps of values of a few units).
* The amplitude/phase and MDF features: atol 1e-6 (sqrt, atan2 and the
  division of two libraries, within an ulp or two of values below 1).
* The channelizer: atol 1e-5 (a grouped FIR of 8 taps, then a 16-point FFT
  of each library, summed in other orders).
* `generate_test_signal`: bit for bit (the same numpy arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitiq.data as jdata
import vitiq.dsp as jdsp
from vitiq.dsp import filtering as jfilt
from vitiq.dsp import timing as jtiming
from vitiq.dsp import channelizer as jchan
from vitiq_torch import dsp as pdsp
from vitiq_torch.data import generate_test_signal
from vitiq_torch.dsp import channelizer as pchan
from vitiq_torch.dsp import filtering as pfilt
from vitiq_torch.dsp import frontend as pfront
from vitiq_torch.dsp import timing as ptiming
from vitiq_torch.ops.cuda import timing as tk

METHODS = ["simple_energy", "simple_correlation", "gardner", "mueller_muller"]
LOOPS = ["gardner", "mueller_muller"]
FIR_ATOL = 1e-6
POS_ATOL = 1e-3
FLIP_SHARE = 0.01


def _frames(B, frame_len, sps, modulation="QPSK", snr_db=20.0, seed=0):
    """[B, frame_len, 2] float32 RRC-shaped frames with known timing."""
    out = []
    for b in range(B):
        i, q, _ = jdata.generate_test_signal(modulation, frame_len // sps, sps, snr_db,
                                             seed=seed + b)
        out.append(np.stack([i, q], -1))
    return np.asarray(out, np.float32)


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check_positions(got, want, valid=None):
    """Positions within POS_ATOL; rounded indices equal except where vitiq's
    position lies within POS_ATOL of a half-integer (rare)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=POS_ATOL, rtol=0)
    near_half = np.abs(want - np.floor(want) - 0.5) <= POS_ATOL
    flipped = np.rint(got) != np.rint(want)
    assert not (flipped & ~near_half).any()
    assert flipped.mean() < FLIP_SHARE, f"{flipped.sum()} strobes rounded the other way"
    if valid is not None:
        assert valid[0].dtype == torch.bool
        np.testing.assert_array_equal(valid[0].numpy(), np.asarray(valid[1]))


# --------------------------------------------------------------------------
# filtering
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sps", [2, 4])
def test_matched_filter_batch_matches_vitiq_and_float64(sps):
    x = _noise((3, 256, 2), seed=sps)
    got = pfilt.matched_filter_batch(torch.as_tensor(x), sps)
    want = np.asarray(jfilt.matched_filter_batch(jnp.asarray(x), sps))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=FIR_ATOL, rtol=0)
    taps = jdsp.rrc_filter(sps=sps)
    f64 = np.stack([[np.convolve(xb[:, c].astype(np.float64), taps, mode="same")
                     for c in range(2)] for xb in x]).transpose(0, 2, 1)
    assert np.abs(got.numpy() - f64).max() <= 1e-5 * np.abs(f64).max()


def test_matched_filter_host_function_matches_vitiq():
    i, q, _ = jdata.generate_test_signal("QPSK", 100, 2, 15.0, seed=7)
    got = pfilt.matched_filter(i, q, sps=2, device="cpu")
    want = jfilt.matched_filter(i, q, sps=2)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=FIR_ATOL, rtol=0)


def test_the_filter_scope_leaves_the_global_tf32_flag():
    before = torch.backends.cudnn.allow_tf32
    with pfilt.f32_conv():
        if torch.backends.cudnn.is_available():
            assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == before


# --------------------------------------------------------------------------
# timing recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["energy", "correlation"])
def test_simple_timing_recovery_matches_vitiq(method):
    i, q, _ = jdata.generate_test_signal("QPSK", 120, 4, 20.0, seed=3)
    np.testing.assert_array_equal(ptiming.simple_timing_recovery(i, q, 4, method),
                                  jtiming.simple_timing_recovery(i, q, 4, method))


def test_lin_interp_matches_vitiq():
    x = _noise((50,), seed=1)
    pos = np.array([-3.0, 0.0, 0.25, 7.5, 48.999, 49.0, 60.0], np.float32)
    want = np.asarray(jax.vmap(lambda p: jtiming._lin_interp(jnp.asarray(x), p))(pos))
    got = tk.lin_interp(torch.as_tensor(x).expand(len(pos), 50), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("sps", [2, 4])
@pytest.mark.parametrize("method", LOOPS)
def test_full_loops_match_vitiq(method, sps):
    f = np.array(jfilt.matched_filter_batch(jnp.asarray(_frames(8, 256, sps, seed=sps)), sps))
    want = jtiming.batched_timing_positions(jnp.asarray(f[..., 0]), jnp.asarray(f[..., 1]),
                                            sps, method)
    got = ptiming.batched_timing_positions(torch.as_tensor(f[..., 0]),
                                           torch.as_tensor(f[..., 1]), sps, method)
    _check_positions(got[0].numpy(), want[0], (got[1], want[1]))


@pytest.mark.parametrize("method", LOOPS)
def test_loops_from_a_start_position_match_vitiq(method):
    """The scans with p0 (the hybrid's start) and a window shorter than the
    frame, one frame at a time in vitiq."""
    sps, window = 2, 24
    f = np.array(jfilt.matched_filter_batch(jnp.asarray(_frames(4, 256, sps, seed=9)), sps))
    p0 = np.array([2.0, 3.0, 2.0, 3.0], np.float32)
    scan = {"gardner": jtiming._gardner_scan, "mueller_muller": jtiming._mueller_muller_scan}
    want = [scan[method](jnp.asarray(f[b, :, 0]), jnp.asarray(f[b, :, 1]), sps, window,
                         p0=jnp.asarray(p0[b])) for b in range(4)]
    got = tk.timing_scan(torch.as_tensor(f), sps, window, method, p0=torch.as_tensor(p0))
    _check_positions(got[0].numpy(), np.stack([np.asarray(w[0]) for w in want]),
                     (got[1], np.stack([np.asarray(w[1]) for w in want])))


def test_the_full_loop_runs_past_the_frame_and_marks_it():
    """A drifting loop (strong noise, small frame) can leave the frame
    before its L//sps steps end: valid turns False there, as in vitiq."""
    f = np.array(jfilt.matched_filter_batch(jnp.asarray(_noise((6, 64, 2), seed=4)), 2))
    for method in LOOPS:
        want = jtiming.batched_timing_positions(jnp.asarray(f[..., 0]), jnp.asarray(f[..., 1]),
                                                2, method)
        got = ptiming.batched_timing_positions(torch.as_tensor(f[..., 0]),
                                               torch.as_tensor(f[..., 1]), 2, method)
        _check_positions(got[0].numpy(), want[0], (got[1], want[1]))


@pytest.mark.parametrize("sps", [2, 4])
@pytest.mark.parametrize("method", LOOPS)
def test_hybrid_matches_vitiq(method, sps):
    f = np.array(jfilt.matched_filter_batch(jnp.asarray(_frames(8, 256, sps, seed=20 + sps)),
                                              sps))
    want = jtiming.hybrid_timing_positions(jnp.asarray(f[..., 0]), jnp.asarray(f[..., 1]),
                                           sps, method, window=32)
    got = ptiming.hybrid_timing_positions(torch.as_tensor(f[..., 0]),
                                          torch.as_tensor(f[..., 1]), sps, method, window=32)
    _check_positions(got[0].numpy(), want[0], (got[1], want[1]))


@pytest.mark.parametrize("method", LOOPS)
@pytest.mark.parametrize("sps", [2, 4])
def test_host_loops_match_vitiq(method, sps):
    i, q, _ = jdata.generate_test_signal("QPSK", 100, sps, 20.0, seed=11)
    fi, fq = jfilt.matched_filter(i, q, sps=sps)
    fn = {"gardner": "timing_recovery_gardner",
          "mueller_muller": "timing_recovery_mueller_muller"}[method]
    got = getattr(ptiming, fn)(fi, fq, sps, device="cpu")
    want = getattr(jtiming, fn)(fi, fq, sps)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_loops_refuse_what_vitiq_refuses():
    for fn in (ptiming.timing_recovery_gardner, ptiming.timing_recovery_mueller_muller):
        with pytest.raises(ValueError):
            fn(np.ones(10), np.ones(10), sps=1, device="cpu")
    x = torch.zeros((2, 64), dtype=torch.float32)
    with pytest.raises(ValueError):
        ptiming.batched_timing_positions(x, x, 1, "gardner")
    with pytest.raises(ValueError):
        ptiming.hybrid_timing_positions(x, x, 2, "psychic")
    with pytest.raises(ValueError):
        tk.timing_scan(torch.zeros((2, 64, 2)), 2, 8, "psychic")


def test_the_scan_wrapper_takes_the_plain_loop_on_the_cpu_and_counts_nothing():
    tk.reset_launches()
    f = torch.as_tensor(_noise((3, 64, 2), seed=5))
    got = tk.timing_scan(f, 2, 16, "gardner")
    want = tk.timing_scan_plain(f, 2, 16, "gardner")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tk.launches["timing_scan"] == 0 and tk.kernel_launches() == 0


def test_host_functions_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    i, q, _ = generate_test_signal("QPSK", 40, 2, 20.0, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdsp.extract_symbols(i, q, sps=2, method="gardner")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdsp.matched_filter(i, q)
    pdsp.extract_symbols(i, q, sps=1)  # the bypass touches no device


# --------------------------------------------------------------------------
# extract_symbols and its contract bar (tests/test_dsp.py:104-130)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_extract_symbols_matches_vitiq(method):
    i, q, _ = jdata.generate_test_signal("QPSK", 100, 2, 20.0, seed=4)
    got = pdsp.extract_symbols(i, q, sps=2, method=method, device="cpu")
    want = jdsp.extract_symbols(i, q, sps=2, method=method)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["symbol_indices"], want["symbol_indices"])
    for key in ("symbol_i", "symbol_q", "filtered_i", "filtered_q"):
        np.testing.assert_allclose(got[key], want[key], atol=FIR_ATOL, rtol=0)


def test_extract_symbols_sps1_bypass_and_errors():
    i, q, _ = generate_test_signal("QPSK", 64, 1, 20.0, seed=2)
    res = pdsp.extract_symbols(i, q, sps=1, device="cpu")
    np.testing.assert_array_equal(res["filtered_i"], i.astype(np.float32))
    np.testing.assert_array_equal(res["symbol_indices"], np.arange(64))
    with pytest.raises(ValueError):
        pdsp.extract_symbols(i, q, sps=2, method="psychic", device="cpu")
    with pytest.raises(ValueError):
        pdsp.extract_symbols(i, q[:-1], sps=2, device="cpu")
    with pytest.raises(ValueError):
        pdsp.extract_symbols(i, q, sps=0, device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_extract_symbols_meets_the_contract_bar(method):
    num_symbols = 100
    i, q, true_idx = generate_test_signal("QPSK", num_symbols=num_symbols, sps=2, snr_db=20,
                                          seed=4)
    recovered = pdsp.extract_symbols(i, q, sps=2, method=method, device="cpu")["symbol_indices"]
    rate = len(recovered) / num_symbols
    assert 0.9 <= rate <= 1.1, f"{method}: recovery rate {rate:.2f}"
    errors = [np.min(np.abs(true_idx - r)) for r in recovered]
    assert float(np.mean(errors)) <= 0.75


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("sps", [2, 4])
def test_extract_symbols_contract_bar_sps4_and_bpsk(method, sps):
    i, q, true_idx = generate_test_signal("BPSK", num_symbols=80, sps=sps, snr_db=20, seed=5)
    res = pdsp.extract_symbols(i, q, sps=sps, method=method, device="cpu")
    assert 0.85 <= len(res["symbol_indices"]) / 80 <= 1.15
    errors = [np.min(np.abs(true_idx - r)) for r in res["symbol_indices"]]
    assert np.mean(errors) <= 0.3 * sps


# --------------------------------------------------------------------------
# the batched SPS front-end
# --------------------------------------------------------------------------

def _sps_symbols(x, sps, method, window):
    got = pfront.preprocess_batch_sps(torch.as_tensor(x), sps, method=method,
                                      hybrid_window=window)
    want = np.asarray(jdsp.preprocess_batch_sps(jnp.asarray(x), sps, method=method,
                                                hybrid_window=window))
    return got.numpy(), want


@pytest.mark.parametrize("sps", [2, 4])
@pytest.mark.parametrize("method", ["simple_energy", "simple_correlation"])
def test_phase_pickers_match_vitiq(method, sps):
    x = _frames(6, 256, sps, seed=30 + sps)
    x[3] = np.roll(x[3], 1, axis=0)  # another best phase in one frame
    got, want = _sps_symbols(x, sps, method, 64)
    assert got.shape == (6, 256 // sps, 2)
    np.testing.assert_allclose(got, want, atol=FIR_ATOL, rtol=0)


@pytest.mark.parametrize("window", [0, 16], ids=["full", "hybrid16"])
@pytest.mark.parametrize("method", LOOPS)
@pytest.mark.parametrize("sps", [2, 4])
def test_sps_front_end_loops_match_vitiq(method, window, sps):
    """Symbols at the rounded strobes: equal to vitiq's (within the FIR's
    tolerance) at every strobe whose rounding agrees (`_check_positions`
    holds the strobes themselves)."""
    x = _frames(6, 256, sps, seed=40 + sps)
    got, want = _sps_symbols(x, sps, method, window)
    assert got.shape == want.shape == (6, 256 // sps, 2)
    differ = np.abs(got - want).max(-1) > FIR_ATOL
    assert differ.mean() < FLIP_SHARE


@pytest.mark.parametrize("window", [0, 16], ids=["full", "hybrid16"])
@pytest.mark.parametrize("method", LOOPS)
@pytest.mark.parametrize("sps", [2, 4])
def test_timing_symbols_is_the_composition_and_matches_vitiq(method, window, sps):
    """`timing_symbols` on the CPU (its plain version) equals the tensor
    composition the front-end ran before it, bit for bit: the loop's
    positions (`hybrid_positions` / `full_positions`), rounded half to even,
    clamped, gathered. Against vitiq's front-end on the same frames the
    symbols differ only where a strobe rounds the other way (FLIP_SHARE)."""
    x = _frames(6, 256, sps, seed=50 + sps)
    f = pfilt.matched_filter_batch(torch.as_tensor(x), sps)
    got = tk.timing_symbols(f, sps, method, window)
    if window:
        positions = ptiming.hybrid_positions(f, sps, method, window)
    else:
        positions = ptiming.full_positions(f, sps, method)[0]
    idx = positions.round().clamp(0, 255).long()
    assert torch.equal(got, f.gather(1, idx[..., None].expand(6, 256 // sps, 2)))
    assert torch.equal(got, tk.timing_symbols_plain(f, sps, method, window))
    want = np.asarray(jdsp.preprocess_batch_sps(jnp.asarray(x), sps, method=method,
                                                hybrid_window=window))
    assert got.shape == want.shape == (6, 256 // sps, 2)
    assert (np.abs(got.numpy() - want).max(-1) > FIR_ATOL).mean() < FLIP_SHARE


def test_timing_symbols_refuses_what_vitiq_refuses():
    x = _noise((2, 64, 2), seed=8)
    with pytest.raises(ValueError):
        jtiming.hybrid_timing_positions(jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1]), 1,
                                        "gardner")
    with pytest.raises(ValueError):
        jdsp.preprocess_batch_sps(jnp.asarray(x), 2, method="psychic")
    tk.reset_launches()
    for sps, method in ((1, "gardner"), (0, "mueller_muller"), (2, "psychic")):
        for fn in (tk.timing_symbols, tk.timing_symbols_plain):
            with pytest.raises(ValueError):
                fn(torch.as_tensor(x), sps, method)
    assert tk.launches["timing_symbols"] == 0 and tk.kernel_launches() == 0


def test_timing_recovery_bounds_from_shapes():
    """chip_smoke.py's bounds of the kernel from the run's shapes: symbols
    mode reads the whole frame for the hybrid (its coarse pass) or the span
    its strobes touch in 32-byte sectors for the full loop, and writes the
    symbols; positions mode reads that span and writes 5 bytes a step; the
    chain is steps x 32 cycles."""
    import chip_smoke as cs

    B, L, sps, clock = 6, 256, 2, 2e9
    f = torch.zeros((B, L, 2))
    strobes = torch.arange(2, L + 2, sps, dtype=torch.float32).expand(B, L // sps)  # to 256
    hybrid = cs.symbol_bounds(f, strobes, sps, "gardner", 16, clock_hz=clock)
    assert hybrid["bytes"] == B * L * 8 + B * (L // sps) * 8
    assert hybrid["ops"] == B * 16 * cs.SCAN_OPS_PER_STEP["gardner"] + B * L * 4
    assert hybrid["bound"] == (hybrid["bytes"] / cs.PEAK_BYTES * 1e3, "bytes")
    assert hybrid["chain_ms"] == pytest.approx(16 * 32 / clock * 1e3)
    # the strobes span samples 0 to 255: all 64 sectors of 2,048 bytes a frame
    full = cs.symbol_bounds(f, strobes, sps, "mueller_muller", 0, clock_hz=clock)
    assert full["bytes"] == B * 64 * 32 + B * (L // sps) * 8
    assert full["ops"] == B * (L // sps) * cs.SCAN_OPS_PER_STEP["mueller_muller"]
    # a quarter of the frame (samples 62 to 127): sectors 15 to 31
    part = torch.arange(64, 128, sps, dtype=torch.float32).expand(B, 32)
    got = cs.scan_bounds(part, L, sps, "gardner", p0=torch.zeros(B), clock_hz=clock)
    assert got["bytes"] == B * 17 * 32 + B * 4 + B * 32 * 5


def test_timing_variants_edit_the_kernel_source_as_it_is():
    """`ops/cuda/timing_variants.py`'s experiments are text edits of
    `csrc/timing.cu`: each must still find its text there."""
    from vitiq_torch.ops.cuda import _build
    from vitiq_torch.ops.cuda import timing_variants as tv

    text = (_build.CSRC / tv.SOURCE).read_text()
    edits = [old for variants in tv.EXPERIMENTS.values() for edits in variants.values()
             for old, _ in edits]
    assert edits and all(old in text for old in edits)


def test_sps_front_end_identity_errors_and_log(caplog):
    x = _noise((2, 250, 2), seed=6)
    assert pfront.preprocess_batch_sps(torch.as_tensor(x), 1) is not None
    with pytest.raises(ValueError, match="multiple"):
        pfront.preprocess_batch_sps(torch.as_tensor(x), 4)
    with pytest.raises(ValueError, match="unknown"):
        pfront.preprocess_batch_sps(torch.as_tensor(x), 2, method="psychic")
    pfront._HYBRID_LOGGED.clear()
    with caplog.at_level("INFO", logger="vitiq_torch.dsp"):
        for _ in range(2):
            pfront.preprocess_batch_sps(torch.as_tensor(x[:, :248]), 2, method="gardner",
                                        hybrid_window=8)
    assert sum("HYBRID" in r.getMessage() for r in caplog.records) == 1


# --------------------------------------------------------------------------
# spectrogram, amplitude/phase, MDF
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nfft,hop", [(64, 32), (32, 7)])
def test_spectrogram_matches_vitiq(nfft, hop):
    x = _noise((3, 300, 2), seed=nfft)
    got = pfront.preprocess_batch_spectrogram(torch.as_tensor(x), nfft=nfft, hop=hop)
    want = np.asarray(jdsp.preprocess_batch_spectrogram(jnp.asarray(x), nfft=nfft, hop=hop))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("L,H,W", [(1024, 32, 64), (64, 16, 64), (2048, 32, 64)],
                         ids=["crop", "pad", "long"])
def test_vit_spectrogram_matches_vitiq(L, H, W):
    """Center crop where the STFT gives more than W frames, edge padding of
    the time axis where it gives fewer."""
    x = _noise((2, L, 2), seed=L)
    got = pfront.preprocess_batch_vit_spectrogram(torch.as_tensor(x), H=H, W=W)
    want = np.asarray(jdsp.preprocess_batch_vit_spectrogram(jnp.asarray(x), H=H, W=W))
    assert tuple(got.shape) == want.shape == (2, 1, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        pfront.preprocess_batch_vit_spectrogram(torch.as_tensor(x[:, : H - 1]), H=H, W=W)


def test_amplitude_phase_matches_vitiq():
    x = _noise((3, 256, 2), seed=8)
    x[0, :4] = 0.0  # atan2(0, 0) and a zero amplitude
    got = pfront.preprocess_batch_amplitude_phase(torch.as_tensor(x))
    want = np.asarray(jdsp.preprocess_batch_amplitude_phase(jnp.asarray(x)))
    assert tuple(got.shape) == want.shape == (3, 2, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("stats", [None, {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2,
                                          "q_std": 0.9},
                                   {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0,
                                    "amp_max": 4.5}], ids=["frame_max", "stats", "amp_max"])
def test_mdf_transform_matches_vitiq(stats):
    x = _noise((2, 256, 2), seed=9)
    got = pfront.preprocess_batch_mdf(torch.as_tensor(x), H=16, W=16, stats=stats)
    want = jdsp.preprocess_batch_mdf(jnp.asarray(x), H=16, W=16, stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        pfront.preprocess_batch_mdf(torch.as_tensor(x), H=16, W=8)


def test_single_frame_helpers_match_vitiq():
    stats = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
    i, q = _noise((1024,), 1), _noise((1024,), 2)
    for name in ("apply_normalization", "preprocess_for_transformer"):
        for g, w in zip(np.atleast_1d(getattr(pdsp, name)(i, q, stats)),
                        np.atleast_1d(getattr(jdsp, name)(i, q, stats))):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pdsp.preprocess_for_vit(i, q, stats),
                                  jdsp.preprocess_for_vit(i, q, stats))


def test_exports_are_vitiqs():
    names = {n for n in dir(jdsp) if not n.startswith("_") and callable(getattr(jdsp, n))}
    assert names <= {n for n in dir(pdsp) if callable(getattr(pdsp, n))}


# --------------------------------------------------------------------------
# channelizer and the test fixture
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K,P", [(8, 8), (16, 4)])
def test_channelizer_matches_vitiq(K, P):
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((2, K * 64)) + 1j * rng.standard_normal((2, K * 64))).astype(
        np.complex64)
    taps = pchan.design_prototype_lowpass(K, P)
    np.testing.assert_array_equal(taps, jchan.design_prototype_lowpass(K, P))
    got = pchan.polyphase_channelize(torch.as_tensor(x), K, taps)
    want = np.asarray(jchan.polyphase_channelize(jnp.asarray(x), K, taps))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == (2, K, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        pchan.polyphase_channelize(torch.as_tensor(x[:, :-1]), K, taps)
    with pytest.raises(ValueError):
        pchan.polyphase_channelize(torch.as_tensor(x), K, taps[:-1])


def test_channelizer_puts_a_tone_in_its_channel():
    K, M = 16, 256
    for ch in (0, 3, 9, 15):
        x = pchan.synthesize_multitone(K, M, active=((ch, 1.0),), noise_db=-60, seed=ch)
        np.testing.assert_array_equal(
            x, jchan.synthesize_multitone(K, M, active=((ch, 1.0),), noise_db=-60, seed=ch))
        y = pchan.polyphase_channelize(torch.as_tensor(x), K, pchan.design_prototype_lowpass(K))
        powers = (y[0].abs() ** 2).mean(-1).numpy()
        assert int(np.argmax(powers)) == ch
        assert powers[ch] > 50 * np.delete(powers, ch).max()


@pytest.mark.parametrize("modulation,sps,seed", [("QPSK", 2, 0), ("BPSK", 4, 5),
                                                 ("16QAM", 1, 3), ("8PSK", 8, None)])
def test_generate_test_signal_is_vitiqs_bit_for_bit(modulation, sps, seed):
    got = generate_test_signal(modulation, 50, sps, 12.0, seed=seed)
    want = jdata.generate_test_signal(modulation, 50, sps, 12.0, seed=seed)
    if seed is None:  # a fresh generator: only the shapes and the indices agree
        np.testing.assert_array_equal(got[2], want[2])
        assert got[0].shape == want[0].shape
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
